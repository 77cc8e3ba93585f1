"""Device meshes and named-axis sharding rules, tensor parallelism only.

Port of ``llm_d_fast_model_actuation_tpu/parallel/mesh.py``. There the
mesh is declarative: tensors carry logical axis names, the rules map
them to mesh axes, and XLA's partitioner derives every slice and inserts
every collective. PyTorch has no such partitioner, so the port keeps the
same tables (``AXES``, ``LOGICAL_RULES``, the per-weight logical axes in
``models/llama.py:param_logical_axes``) and writes out by hand what the
partitioner derives from them: :func:`tp_dim` answers "which dimension of
this weight is split over ``tp``", :func:`shard` cuts that slice, and
:class:`TpMesh` carries the two collectives the forward needs.

Only the ``tp`` axis is realised. One process drives all ``tp`` ranks (the
reference's single-process mesh); a rank is an index into an ordered list
of devices, **and a device may appear more than once**: two ranks on one
card run every line of the sharded path except the copy between cards,
which is how a one-card machine (and the CPU tests, mesh ``cpu,cpu``)
exercises it.

The collectives are plain functions on a list of per-rank tensors and are
deterministic: a fixed rank order, so a run repeats bit for bit. They move
bytes as copies through rank 0. NCCL replaces them in a later change, and
nothing else in the port may depend on how they move bytes.

Streams: a rank's work goes to its device's current stream; the ranks
have no streams of their own. Ranks on two cards run side by side as it
is, each card has its own queue, and PyTorch orders a copy between cards
after both cards' current streams, so the collectives need no event of
their own. Ranks that share one card serialise on its queue. A stream per
rank was tried there (NVIDIA H100, ``chip_smoke.py``): the two ranks'
ragged launches then overlap (0.90-0.98 ms for both against 1.23 ms in
series at 256 rows), but a serving step is bound by the host's launches
and got no faster (decode 79-135 ms a token with the streams, 85-115 ms
without), so the streams, their events and the allocator's cross-stream
bookkeeping went again.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

AXES = ("dp", "pp", "sp", "tp", "ep")


@dataclass(frozen=True)
class MeshPlan:
    """Degrees of each parallelism axis. Product must equal device count."""

    dp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.sp * self.tp * self.ep

    def axis_sizes(self) -> Tuple[int, ...]:
        return (self.dp, self.pp, self.sp, self.tp, self.ep)

    def describe(self) -> str:
        return ",".join(
            f"{n}={v}" for n, v in zip(AXES, self.axis_sizes()) if v > 1
        ) or "single-device"


# Logical axis name -> mesh axis: the reference's table, unchanged.
LOGICAL_RULES: Dict[Any, Any] = {
    "batch": "dp",
    "seq": "sp",
    "embed": None,  # replicated over tp (activations)
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "mlp": "tp",
    "vocab": "tp",
    "layers": "pp",
    "expert": "ep",
    "kv_batch": "dp",
    None: None,
}


def spec_for(
    logical_axes: Sequence[Optional[str]], rules: Optional[Dict[Any, Any]] = None
) -> Tuple[Optional[str], ...]:
    """Logical axis names -> the mesh axis of each dimension (None =
    replicated), via the rules table: the reference's ``PartitionSpec``
    as a plain tuple."""
    rules = rules or LOGICAL_RULES
    return tuple(rules.get(ax) for ax in logical_axes)


def tp_dim(logical_axes: Optional[Sequence[Optional[str]]]) -> Optional[int]:
    """The dimension of a tensor with these logical axes that is split
    over ``tp``; None when the tensor is replicated."""
    if logical_axes is None:
        return None
    dims = [i for i, ax in enumerate(spec_for(logical_axes)) if ax == "tp"]
    if len(dims) > 1:
        raise ValueError(f"{tuple(logical_axes)} splits more than one dimension over tp")
    return dims[0] if dims else None


def shard(x, dim: Optional[int], rank: int, tp: int):
    """Rank ``rank``'s slice of ``x`` (a tensor or a numpy array) along
    ``dim``: the ``rank``-th of ``tp`` equal contiguous pieces, as
    ``NamedSharding`` cuts them. ``dim`` None returns ``x`` whole."""
    if dim is None:
        return x
    n = x.shape[dim]
    if n % tp:
        raise ValueError(f"dimension {dim} of size {n} is not divisible by tp={tp}")
    index = [slice(None)] * len(x.shape)
    index[dim] = slice(rank * (n // tp), (rank + 1) * (n // tp))
    return x[tuple(index)]


def plan_for_devices(
    n: int, tp: Optional[int] = None, sp: int = 1, pp: int = 1, ep: int = 1
) -> MeshPlan:
    """Choose a plan for ``n`` devices: given tp (default the largest of
    8, 4, 2, 1 that divides n), the rest goes to dp."""
    if tp is None:
        tp = next(c for c in (8, 4, 2, 1) if c <= n and n % c == 0)
    inner = tp * sp * pp * ep
    if n % inner != 0:
        raise ValueError(f"{n} devices not divisible by tp*sp*pp*ep={inner}")
    return MeshPlan(dp=n // inner, pp=pp, sp=sp, tp=tp, ep=ep)


PerRank = List[torch.Tensor]


class TpMesh:
    """An ordered list of ``tp`` devices, one per rank (a device may
    repeat), and the two collectives of the tensor-parallel forward."""

    def __init__(self, devices: Sequence[Union[str, torch.device]]) -> None:
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        for d in self.devices:
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported device {d}")
        # an index on every CUDA device, so two spellings of one card compare equal
        self.devices = [
            torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d
            for d in self.devices
        ]

    @property
    def tp(self) -> int:
        return len(self.devices)

    def distinct_devices(self) -> List[torch.device]:
        """The mesh's devices, each once, in rank order."""
        return list(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"TpMesh({[str(d) for d in self.devices]})"

    # -- replicated inputs ----------------------------------------------------

    def replicate(self, x: "torch.Tensor | Sequence[torch.Tensor]") -> PerRank:
        """One tensor per rank holding ``x``: ranks on ``x``'s own device
        share it, every other device gets one copy. A per-rank list is
        taken as given."""
        if not isinstance(x, torch.Tensor):
            if len(x) != self.tp:
                raise ValueError(f"{len(x)} per-rank tensors for a mesh of {self.tp}")
            return list(x)
        copies = {x.device: x}
        for d in self.devices:
            if d not in copies:
                copies[d] = x.to(d)
        return [copies[d] for d in self.devices]

    # -- collectives ----------------------------------------------------------

    def _check(self, parts: Sequence[torch.Tensor]) -> None:
        if len(parts) != self.tp:
            raise ValueError(f"{len(parts)} per-rank tensors for a mesh of {self.tp}")

    def all_reduce_sum(self, parts: Sequence[torch.Tensor]) -> PerRank:
        """The sum of every rank's partial, on every rank. Each partial is
        brought to rank 0's device, added there in rank order in the
        tensors' own dtype (bf16 partials give a bf16 sum, as the
        reference's partitioner reduces the bf16 product), and the sum
        copied back to each rank; ranks on rank 0's device share the one
        sum tensor (the copies vanish), so nobody may write into it.
        Deterministic: the order never changes."""
        self._check(parts)
        if self.tp == 1:
            return list(parts)
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(self.devices[0])
        return [total.to(d) for d in self.devices]

    def gather(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        """The per-rank slices joined along ``dim`` in rank order, on rank
        0 only (where sampling runs)."""
        self._check(parts)
        if self.tp == 1:
            return parts[0]
        return torch.cat([p.to(self.devices[0]) for p in parts], dim=dim)

    def all_gather(self, parts: Sequence[torch.Tensor], dim: int) -> PerRank:
        """:meth:`gather`, copied to every rank."""
        whole = self.gather(parts, dim)
        return [whole.to(d) for d in self.devices]


def make_mesh(
    plan: MeshPlan, devices: Sequence[Union[str, torch.device]]
) -> TpMesh:
    """A mesh for ``plan`` over ``devices``. Only ``tp`` is realised: any
    other axis above 1 raises, naming where it is planned."""
    for axis, item in (("dp", "queue 1 item 15 (multi-host gangs)"), ("pp", "queue 1 item 15"),
                       ("sp", "queue 1 item 16 (ring attention)"), ("ep", "queue 1 item 16 (expert parallelism)")):
        if getattr(plan, axis) > 1:
            raise NotImplementedError(
                f"mesh axis {axis}={getattr(plan, axis)} is not ported yet: only tp is "
                f"realised (ROADMAP.md {item})"
            )
    if plan.size != len(devices):
        raise ValueError(f"mesh plan {plan} needs {plan.size} devices, have {len(devices)}")
    return TpMesh(devices)


def serving_mesh(
    tp: int, devices: Optional[Sequence[Union[str, torch.device]]] = None
) -> TpMesh:
    """The engine's tp mesh. ``devices=None`` takes the first ``tp`` CUDA
    devices and raises when there are fewer; an explicit list is taken as
    given (it may name one device more than once) and must have ``tp``
    entries."""
    if tp < 1:
        raise ValueError("tensor_parallel_size must be >= 1")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < tp:
            raise ValueError(f"tensor_parallel_size {tp} needs {tp} devices, have {have}")
        devices = [torch.device("cuda", i) for i in range(tp)]
    return make_mesh(MeshPlan(tp=tp), list(devices))
