"""The port's five-axis mesh (parallel/mesh.py) on the CPU: ranks take
their coordinates as the reference's ``make_mesh`` lays a flat device
list out (the row-major reshape in ``AXES`` order), each axis' groups,
the collectives' values, ``torch.autograd.gradcheck`` (float64) of the
all-reduce and the ring shift, the slicing by spec and its inverse, and
what stays refused (``pp`` across a gang's processes; ``pp`` in one
process is tests/test_torch_pp.py's)."""

import itertools

import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.parallel import mesh as jmesh
from llm_d_fast_model_actuation_tpu_torch.parallel import mesh as tmesh

PLANS = [
    dict(dp=2, sp=2, tp=2),
    dict(dp=2, ep=2),
    dict(sp=2, tp=2),
    dict(tp=2, ep=2),
    dict(dp=2, sp=2),
    dict(sp=4),
]


def _mesh(**plan):
    p = tmesh.MeshPlan(**plan)
    return tmesh.make_mesh(p, ["cpu"] * p.size)


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: ",".join(f"{k}={v}" for k, v in p.items()))
def test_coordinates_follow_the_references_device_layout(plan, devices8):
    """Rank r sits where the reference's mesh puts the r-th device of its
    list: ``np.asarray(devices).reshape(plan.axis_sizes())``."""
    mesh = _mesh(**plan)
    jp = jmesh.MeshPlan(**plan)
    jm = jmesh.make_mesh(jp, devices8[: jp.size])
    ids = [d.id for d in devices8[: jp.size]]
    for idx in itertools.product(*(range(n) for n in jp.axis_sizes())):
        r = ids.index(jm.devices[idx].id)
        assert mesh.coords(r) == dict(zip(tmesh.AXES, idx))
    assert mesh.shape == dict(jm.shape)


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: ",".join(f"{k}={v}" for k, v in p.items()))
def test_groups_share_every_other_coordinate(plan):
    mesh = _mesh(**plan)
    for axes in ("dp", "sp", "tp", "ep", ("dp", "sp"), ("tp", "ep")):
        names = (axes,) if isinstance(axes, str) else axes
        groups = mesh.groups(axes)
        assert sorted(r for g in groups for r in g) == list(range(mesh.size))
        size = int(np.prod([mesh.shape[a] for a in names]))
        for g in groups:
            assert len(g) == size
            others = [{a: v for a, v in mesh.coords(r).items() if a not in names} for r in g]
            assert all(o == others[0] for o in others)
            # ordered row-major over the group's own axes
            assert [tuple(mesh.index(r, a) for a in tmesh.AXES if a in names) for r in g] == sorted(
                tuple(mesh.index(r, a) for a in tmesh.AXES if a in names) for r in g
            )


def test_collective_values():
    mesh = _mesh(dp=2, sp=2, tp=2)
    parts = [torch.full((3,), float(r)) for r in range(8)]
    red = mesh.all_reduce_sum(parts, "tp")
    for g in mesh.groups("tp"):
        for r in g:
            assert torch.equal(red[r], torch.full((3,), float(sum(g))))
    red = mesh.all_reduce_sum(parts, ("dp", "sp"))
    for g in mesh.groups(("dp", "sp")):
        for r in g:
            assert torch.equal(red[r], torch.full((3,), float(sum(g))))
    shifted = mesh.ring_shift(parts, "sp")
    for g in mesh.groups("sp"):
        for i, r in enumerate(g):
            assert torch.equal(shifted[r], parts[g[i - 1]])  # from its predecessor
    gathered = mesh.all_gather(parts, 0, "dp")
    for g in mesh.groups("dp"):
        for r in g:
            assert torch.equal(gathered[r], torch.cat([parts[q] for q in g]))
    assert torch.equal(mesh.gather(parts, 0, "tp"), torch.cat([parts[q] for q in mesh.group(0, "tp")]))


def test_a_tp_mesh_reduces_and_gathers_as_before():
    """A mesh of tp alone (the serving mesh) has the serving path's
    collectives: the sum in rank order through rank 0, the ranks on rank
    0's device sharing the one sum tensor."""
    mesh = tmesh.serving_mesh(3, ["cpu"] * 3)
    assert mesh.size == mesh.tp == 3 and mesh.plan == tmesh.MeshPlan(tp=3)
    parts = [torch.randn(4, dtype=torch.bfloat16) for _ in range(3)]
    out = mesh.all_reduce_sum(parts)
    want = parts[0] + parts[1] + parts[2]
    assert all(o is out[0] for o in out) and torch.equal(out[0], want)
    assert torch.equal(mesh.gather(parts, 0), torch.cat(parts))


@pytest.mark.parametrize("axes", ["tp", ("dp", "sp"), "sp"])
def test_all_reduce_passes_gradcheck(axes):
    mesh = _mesh(dp=2, sp=2, tp=2)
    gen = torch.Generator().manual_seed(0)
    inputs = tuple(torch.randn(2, 3, dtype=torch.float64, generator=gen, requires_grad=True) for _ in range(mesh.size))
    w = [torch.randn(2, 3, dtype=torch.float64, generator=gen) for _ in range(mesh.size)]

    def fn(*parts):
        # a different weight per rank, so each output's gradient differs
        return tuple(o * w[r] for r, o in enumerate(mesh.all_reduce_sum(list(parts), axes)))

    assert torch.autograd.gradcheck(fn, inputs)


@pytest.mark.parametrize("axis", ["sp", "dp", "tp"])
def test_ring_shift_passes_gradcheck(axis):
    mesh = _mesh(dp=2, sp=2, tp=2) if axis != "sp" else _mesh(sp=4)
    gen = torch.Generator().manual_seed(1)
    inputs = tuple(torch.randn(3, dtype=torch.float64, generator=gen, requires_grad=True) for _ in range(mesh.size))
    w = [torch.randn(3, dtype=torch.float64, generator=gen) for _ in range(mesh.size)]

    def fn(*parts):
        return tuple(o * w[r] for r, o in enumerate(mesh.ring_shift(list(parts), axis)))

    assert torch.autograd.gradcheck(fn, inputs)


def test_all_gather_passes_gradcheck():
    mesh = _mesh(tp=2, ep=2)
    gen = torch.Generator().manual_seed(2)
    inputs = tuple(torch.randn(2, dtype=torch.float64, generator=gen, requires_grad=True) for _ in range(mesh.size))
    w = [torch.randn(4, dtype=torch.float64, generator=gen) for _ in range(mesh.size)]

    def fn(*parts):
        return tuple(o * w[r] for r, o in enumerate(mesh.all_gather(list(parts), 0, "ep")))

    assert torch.autograd.gradcheck(fn, inputs)


def test_shard_for_and_join_for_round_trip():
    """An expert stack ``[L, E, h, f]`` split over ep (E) and tp (f):
    each rank's slice is the reference's ``NamedSharding`` piece, and the
    slices join back."""
    mesh = _mesh(tp=2, ep=2)
    x = torch.arange(2 * 4 * 3 * 6).reshape(2, 4, 3, 6)
    spec = tmesh.spec_for(("layers", "expert", "embed", "mlp"))
    assert spec == ("pp", "ep", None, "tp")
    parts = [tmesh.shard_for(x, spec, mesh, r) for r in range(mesh.size)]
    for r, p in enumerate(parts):
        e, t = mesh.index(r, "ep"), mesh.index(r, "tp")
        assert torch.equal(p, x[:, 2 * e:2 * e + 2, :, 3 * t:3 * t + 3])
    assert torch.equal(tmesh.join_for(parts, spec, mesh), x)
    # a replicated leaf: every rank is its own replica's first rank only at rank 0
    assert [tmesh.replica_of((None, None), mesh, r) for r in range(4)] == [0, 0, 0, 0]
    assert [tmesh.replica_of(spec, mesh, r) for r in range(4)] == [0, 1, 2, 3]
    assert [tmesh.replica_of(("pp", None, "tp"), mesh, r) for r in range(4)] == [0, 0, 2, 2]


def test_replicate_shares_one_tensor_per_device():
    mesh = _mesh(dp=2, sp=2)
    x = torch.ones(2)
    reps = mesh.replicate(x)
    assert all(t is x for t in reps)
    with pytest.raises(ValueError, match="3 per-rank tensors for a mesh of 4"):
        mesh.replicate([x, x, x])


def test_pp_stays_refused_naming_its_item():
    """pp is realised in one process (tests/test_torch_pp.py); a gang's
    mesh, whose stages would run a host each, still refuses it naming its
    ROADMAP item."""
    mesh = tmesh.make_mesh(tmesh.MeshPlan(pp=2), ["cpu", "cpu"])
    assert mesh.pp == 2 and [mesh.stage(r) for r in range(2)] == [0, 1]
    with pytest.raises(NotImplementedError, match="item 15"):
        tmesh.make_mesh(tmesh.MeshPlan(pp=2), ["cpu"], group=object())
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        tmesh.make_mesh(tmesh.MeshPlan(dp=2, sp=2), ["cpu", "cpu"])
