"""The port's gang planning, its slice-gang coordinator, the lockstep frame
and the mesh across processes, against the JAX package.

Mirrors tests/test_multihost.py by meaning for cards: the planner over the
port's gpu-map (node -> cards, with ``origin:`` and ``slice:`` lines), held
to the JAX ``plan_slice`` on the inputs where both apply; the coordinator's
group/stamp/degrade lifecycle against the port's in-memory store and its
dual-pods harness. Then ``_frame_template`` against the JAX one, and the
mesh's collectives in two Gloo processes (one or two CPU ranks each)
against the one-process mesh on the same inputs, bit for bit.
"""

import asyncio
import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.engine import engine as jengine
from llm_d_fast_model_actuation_tpu.engine import multihost as jmh
from llm_d_fast_model_actuation_tpu.models import llama as jllama
from llm_d_fast_model_actuation_tpu.parallel import multihost as jplan
from llm_d_fast_model_actuation_tpu.parallel.topology import ChipMap, HostTopology
from llm_d_fast_model_actuation_tpu.utils import hashing as jhash
from llm_d_fast_model_actuation_tpu_torch.api import constants as C
from llm_d_fast_model_actuation_tpu_torch.api.types import EngineServerConfig
from llm_d_fast_model_actuation_tpu_torch.controller import gang as tgang
from llm_d_fast_model_actuation_tpu_torch.controller.gang import (
    GANG_ANNOTATION,
    GANG_ENV_ANNOTATION,
    SliceGangCoordinator,
    gang_env_of,
)
from llm_d_fast_model_actuation_tpu_torch.controller.store import InMemoryStore
from llm_d_fast_model_actuation_tpu_torch.engine import engine as tengine
from llm_d_fast_model_actuation_tpu_torch.engine import multihost as tmh
from llm_d_fast_model_actuation_tpu_torch.models import llama as tllama
from llm_d_fast_model_actuation_tpu_torch.parallel import mesh as tmesh
from llm_d_fast_model_actuation_tpu_torch.parallel.multihost import SlicePlanError, hosts_needed, plan_slice
from llm_d_fast_model_actuation_tpu_torch.parallel.topology import gang_places, parse_gpu_map
from llm_d_fast_model_actuation_tpu_torch.utils.hashing import instance_id_for

from conftest import REPO_ROOT, cpu_subprocess_env, free_port

NS = "ns1"


def _cards(node, n=8):
    return [(f"GPU-{node}-{i}", i) for i in range(n)]


def _gpu_map(nodes):
    """A gpu-map ConfigMap's data: node -> (origin or None, domain or "",
    card count)."""
    data = {}
    for node, (origin, domain, n) in nodes.items():
        lines = []
        if origin is not None:
            lines.append("origin: " + ",".join(map(str, origin)))
        if domain:
            lines.append(f"slice: {domain}")
        lines += [f"{i} {u}" for u, i in _cards(node, n)]
        data[node] = "\n".join(lines)
    return data


def two_host_map():
    """Two nodes of 8 cards, n1 at the zero corner, n2 at (2, 0)."""
    return _gpu_map({"n1": ((0, 0), "", 8), "n2": ((2, 0), "", 8)})


def _members(data, nodes):
    cards, places = parse_gpu_map(data), gang_places(data)
    return {n: (places[n][0], cards[n]) for n in nodes}


# ------------------------------------------------------------- the planner


def test_plan_slice_orders_by_origin():
    plan = plan_slice(16, _members(two_host_map(), ["n2", "n1"]))
    assert plan.num_processes == 2 and plan.chips == 16
    assert [h.node for h in plan.hosts] == ["n1", "n2"]  # the zero corner first
    assert plan.coordinator_node == "n1"
    assert plan.hosts[0].process_id == 0 and plan.hosts[1].process_id == 1
    assert plan.hosts[0].chip_ids == tuple(f"GPU-n1-{i}" for i in range(8))
    env = plan.coordination_env(1, "10.0.0.1")
    assert env == {"FMA_NUM_PROCESSES": "2", "FMA_PROCESS_ID": "1", "FMA_COORDINATOR_ADDRESS": "10.0.0.1:8476"}
    assert plan.assignment_for("n2").process_id == 1 and plan.assignment_for("n9") is None


def test_plan_slice_rejects_bad_tilings():
    data = two_host_map()
    with pytest.raises(SlicePlanError, match="!= 8 cards"):  # wrong card total
        plan_slice(8, _members(data, ["n1", "n2"]))
    with pytest.raises(SlicePlanError, match="share gang origin"):  # overlapping origins
        plan_slice(16, _members(_gpu_map({"n1": ((0, 0), "", 8), "n2": ((0, 0), "", 8)}), ["n1", "n2"]))
    with pytest.raises(SlicePlanError, match="no host at gang origin"):
        plan_slice(16, _members(_gpu_map({"n1": ((2, 0), "", 8), "n2": ((4, 0), "", 8)}), ["n1", "n2"]))
    with pytest.raises(SlicePlanError, match="mixed card counts"):
        plan_slice(12, _members(_gpu_map({"n1": ((0, 0), "", 8), "n2": ((2, 0), "", 4)}), ["n1", "n2"]))
    with pytest.raises(SlicePlanError, match="negative"):
        plan_slice(16, _members(_gpu_map({"n1": ((0, 0), "", 8), "n2": ((-2, 0), "", 8)}), ["n1", "n2"]))
    with pytest.raises(SlicePlanError, match="no member"):
        plan_slice(16, {})
    # the TPU slice's geometry has no card meaning: a topology is refused by
    # name, never read as a count (the JAX planner's alignment and bounds
    # rules go with it)
    for topo in ("4x4", "2x8"):
        with pytest.raises(SlicePlanError, match="slice topology .* refused"):
            plan_slice(topo, _members(data, ["n1", "n2"]))
    # an unaligned origin, refused by the JAX planner, only orders a card gang
    plan = plan_slice(16, _members(_gpu_map({"n1": ((0, 0), "", 8), "n2": ((1, 0), "", 8)}), ["n1", "n2"]))
    assert [h.node for h in plan.hosts] == ["n1", "n2"]


def _jax_map(origins, dims="2x4"):
    cm = ChipMap()
    for node, origin in origins.items():
        cm.set_host(node, HostTopology.make(dims, node=node))
        cm.set_origin(node, origin)
    return cm


@pytest.mark.parametrize("topology,origins", [
    ("4x4", {"n1": (0, 0), "n2": (2, 0)}),
    ("4x4", {"b": (2, 0), "a": (0, 0)}),
    ("4x8", {"n1": (0, 0), "n2": (2, 0), "n3": (0, 4), "n4": (2, 4)}),
])
def test_plan_slice_matches_the_jax_planner(topology, origins):
    """On inputs where both planners apply (hosts of one shape tiling the
    slice), the card planner orders the same members the same way, hands
    each the same ids and stamps the same env."""
    cm = _jax_map(origins)
    jp = jplan.plan_slice(topology, {n: (cm.origin(n), cm.host(n)) for n in origins})
    members = {n: (cm.origin(n), [(c.chip_id, c.index) for c in cm.host(n).chips]) for n in origins}
    tp = plan_slice(jp.topology.num_chips, members)
    assert tp.num_processes == jp.num_processes and tp.coordinator_node == jp.coordinator_node
    for a, b in zip(tp.hosts, jp.hosts):
        assert (a.node, a.process_id, a.origin, a.chip_ids) == (b.node, b.process_id, b.origin, b.chip_ids)
    for pid in range(tp.num_processes):
        assert tp.coordination_env(pid, "10.0.0.7", 9000) == jp.coordination_env(pid, "10.0.0.7", 9000)


@pytest.mark.parametrize("origins,topology,chips", [
    ({"n1": (0, 0), "n2": (0, 0)}, "4x4", 16),  # duplicate origins
    ({"n1": (2, 0), "n2": (4, 0)}, "4x4", 16),  # no member at the zero corner
    ({"n1": (0, 0), "n2": (2, 0)}, "2x4", 8),  # a count that does not tile
])
def test_both_planners_refuse_what_both_rules_forbid(origins, topology, chips):
    cm = _jax_map(origins)
    with pytest.raises(jplan.SlicePlanError):
        jplan.plan_slice(topology, {n: (cm.origin(n), cm.host(n)) for n in origins})
    with pytest.raises(SlicePlanError):
        plan_slice(chips, {n: (cm.origin(n), [(c.chip_id, c.index) for c in cm.host(n).chips]) for n in origins})


def test_hosts_needed():
    assert hosts_needed(8, 8) == 1
    assert hosts_needed(16, 8) == 2
    assert hosts_needed(32, 8) == 4
    with pytest.raises(SlicePlanError):
        hosts_needed(9, 8)
    with pytest.raises(SlicePlanError, match="refused"):
        hosts_needed("4x4", 8)


def test_gpu_map_origin_and_domain_lines():
    """``origin:`` orders a node in a gang and ``slice:`` names its fabric
    domain; the cards parse as before, and the JAX chip-map's dump reads
    the same."""
    data = _gpu_map({"n1": ((0, 0), "rackA", 8), "n2": ((2, 0), "rackA", 8), "n3": (None, "", 2)})
    assert gang_places(data) == {"n1": ((0, 0), "rackA"), "n2": ((2, 0), "rackA"), "n3": ((), "")}
    assert parse_gpu_map(data)["n3"] == [("GPU-n3-0", 0), ("GPU-n3-1", 1)]
    cm = _jax_map({"a1": (0, 0), "a2": (2, 0)})
    cm.set_slice_id("a2", "sliceA")
    places = gang_places(cm.dump())
    assert places == {"a1": ((0, 0), ""), "a2": ((2, 0), "sliceA")}
    assert [u for u, _ in parse_gpu_map(cm.dump())["a1"]] == [c.chip_id for c in cm.host("a1").chips]


# -------------------------------------------------------- gang coordinator


def _isc(name="isc-mh", hosts=2, chips=16, topology=""):
    acc = {"chips": chips, "hosts": hosts}
    if topology:
        acc["topology"] = topology
    return {
        "kind": "InferenceServerConfig",
        "metadata": {"name": name, "namespace": NS},
        "spec": {
            "modelServerConfig": {"port": 8000, "options": "--model tiny", "accelerator": acc},
            "launcherConfigName": "lc1",
        },
    }


def _requester(name, node, isc="isc-mh", chips=None, ip="127.0.0.1"):
    ann = {C.INFERENCE_SERVER_CONFIG_ANNOTATION: isc}
    if chips:
        ann[C.ACCELERATORS_ANNOTATION] = ",".join(chips)
    return {
        "kind": "Pod",
        "metadata": {"name": name, "namespace": NS, "annotations": ann},
        "spec": {"nodeName": node},
        "status": {"podIP": ip},
    }


def _store_with_map(data=None):
    store = InMemoryStore()
    store.create({"kind": "ConfigMap", "metadata": {"name": C.GPU_MAP_CONFIGMAP, "namespace": NS},
                  "data": data or two_host_map()})
    return store


def _uuids(node, n=8):
    return [u for u, _ in _cards(node, n)]


async def _settle(predicate, timeout=5.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while asyncio.get_running_loop().time() < deadline:
        if predicate():
            return
        await asyncio.sleep(0.05)
    raise TimeoutError("condition never settled")


def test_gang_forms_and_stamps_members():
    store = _store_with_map()
    store.create(_isc())
    store.create(_requester("req-1", "n1", chips=_uuids("n1")))
    store.create(_requester("req-2", "n2", chips=_uuids("n2")))

    async def body():
        coord = SliceGangCoordinator(store, NS)
        await coord.start()
        try:
            await _settle(lambda: all(
                (store.get("Pod", NS, n)["metadata"].get("annotations") or {}).get(GANG_ANNOTATION)
                for n in ("req-1", "req-2")))
        finally:
            await coord.stop()

    asyncio.run(body())
    p1, p2 = store.get("Pod", NS, "req-1"), store.get("Pod", NS, "req-2")
    assert p1["metadata"]["annotations"][GANG_ANNOTATION] == p2["metadata"]["annotations"][GANG_ANNOTATION]
    env1, env2 = gang_env_of(p1), gang_env_of(p2)
    # n1 is at the zero corner: process 0 and the coordinator address
    assert env1["FMA_PROCESS_ID"] == "0" and env2["FMA_PROCESS_ID"] == "1"
    assert env1["FMA_NUM_PROCESSES"] == env2["FMA_NUM_PROCESSES"] == "2"
    assert env1["FMA_COORDINATOR_ADDRESS"] == env2["FMA_COORDINATOR_ADDRESS"]
    assert env1["FMA_COORDINATOR_ADDRESS"].startswith("127.0.0.1:")
    assert env1["FMA_GANG_ID"] == env2["FMA_GANG_ID"] == p1["metadata"]["annotations"][GANG_ANNOTATION]
    assert not (store.get("InferenceServerConfig", NS, "isc-mh").get("status") or {}).get("gangErrors")


def test_gang_waits_for_enough_members_then_degrades_on_loss():
    store = _store_with_map()
    store.create(_isc())
    store.create(_requester("req-1", "n1", chips=_uuids("n1")))

    async def body():
        coord = SliceGangCoordinator(store, NS)
        await coord.start()
        try:
            await asyncio.sleep(0.3)
            ann = store.get("Pod", NS, "req-1")["metadata"].get("annotations") or {}
            assert GANG_ANNOTATION not in ann, "no gang with 1/2 members"
            store.create(_requester("req-2", "n2", chips=_uuids("n2")))  # the second member arrives
            await _settle(lambda: gang_env_of(store.get("Pod", NS, "req-2")) is not None)
            store.delete("Pod", NS, "req-1")  # a member goes: the survivor is relay-deleted
            await _settle(lambda: store.try_get("Pod", NS, "req-2") is None)
        finally:
            await coord.stop()

    asyncio.run(body())


@pytest.mark.parametrize("isc,want", [
    (_isc(chips=8), "slice planning"),  # two nodes of 8 cards cannot serve 8
    (_isc(topology="4x4"), "accelerator.topology=4x4 is refused"),
])
def test_gang_reports_planning_errors_on_isc_status(isc, want):
    store = _store_with_map()
    store.create(isc)
    store.create(_requester("req-1", "n1", chips=_uuids("n1")))
    store.create(_requester("req-2", "n2", chips=_uuids("n2")))

    async def body():
        coord = SliceGangCoordinator(store, NS)
        await coord.start()
        try:
            await _settle(lambda: (store.get("InferenceServerConfig", NS, "isc-mh").get("status") or {})
                          .get("gangErrors"))
        finally:
            await coord.stop()

    asyncio.run(body())
    errs = store.get("InferenceServerConfig", NS, "isc-mh")["status"]["gangErrors"]
    assert any(want in e for e in errs), errs
    assert gang_env_of(store.get("Pod", NS, "req-1")) is None


def test_single_host_isc_ignored():
    store = _store_with_map()
    store.create(_isc(hosts=1, chips=8))
    store.create(_requester("req-1", "n1", chips=_uuids("n1")))

    async def body():
        coord = SliceGangCoordinator(store, NS)
        await coord.start()
        await asyncio.sleep(0.3)
        await coord.stop()

    asyncio.run(body())
    ann = store.get("Pod", NS, "req-1")["metadata"].get("annotations") or {}
    assert GANG_ANNOTATION not in ann and GANG_ENV_ANNOTATION not in ann


def test_gang_never_spans_fabric_domains():
    """Nodes of two NVLink/InfiniBand domains may share origins but no
    fabric: candidates of two domains are never paired; a gang forms once
    one domain can field every origin."""
    data = _gpu_map({"a1": ((0, 0), "domA", 8), "b2": ((2, 0), "domB", 8), "a2": ((2, 0), "domA", 8)})
    store = _store_with_map(data)
    store.create(_isc())
    store.create(_requester("req-a1", "a1", chips=_uuids("a1")))
    store.create(_requester("req-b2", "b2", chips=_uuids("b2")))

    async def body():
        coord = SliceGangCoordinator(store, NS)
        await coord.start()
        try:
            await asyncio.sleep(0.4)
            for n in ("req-a1", "req-b2"):
                ann = store.get("Pod", NS, n)["metadata"].get("annotations") or {}
                assert GANG_ANNOTATION not in ann, "gang spanned two domains"
            store.create(_requester("req-a2", "a2", chips=_uuids("a2")))
            await _settle(lambda: gang_env_of(store.get("Pod", NS, "req-a2")) is not None)
            assert gang_env_of(store.get("Pod", NS, "req-a1")) is not None
            assert GANG_ANNOTATION not in (store.get("Pod", NS, "req-b2")["metadata"].get("annotations") or {})
        finally:
            await coord.stop()

    asyncio.run(body())


def test_cards_absent_from_the_gpu_map_are_reported():
    store = _store_with_map()
    store.create(_isc())
    store.create(_requester("req-1", "n1", chips=_uuids("n1")[:7] + ["GPU-stray"]))
    store.create(_requester("req-2", "n2", chips=_uuids("n2")))

    async def body():
        coord = SliceGangCoordinator(store, NS)
        await coord.start()
        try:
            await _settle(lambda: (store.get("InferenceServerConfig", NS, "isc-mh").get("status") or {})
                          .get("gangErrors"))
        finally:
            await coord.stop()

    asyncio.run(body())
    (err,) = store.get("InferenceServerConfig", NS, "isc-mh")["status"]["gangErrors"]
    assert "GPU-stray" in err and "absent from gpu-map" in err


# ------------------------------------------- full actuation through dualpods


def test_multihost_isc_actuates_gang_with_coordination_env():
    """Dual-pods and the gang coordinator on one store: a hosts=2 ISC of 16
    cards actuates two requester/provider pairs of 8 whose engine instance
    configs carry the coordination env; instance creation waits for the
    stamp."""
    from llm_d_fast_model_actuation_tpu_torch.testing import Harness, run_scenario

    h = Harness(ns=NS)
    h.store.create({"kind": "ConfigMap", "metadata": {"name": C.GPU_MAP_CONFIGMAP, "namespace": NS},
                    "data": two_host_map()})
    h.add_lc("lc1", max_instances=2)
    h.add_isc("isc-mh", "lc1", accelerator={"chips": 16, "hosts": 2})

    async def body():
        coord = SliceGangCoordinator(h.store, NS)
        await coord.start()
        try:
            h.add_requester("req-1", "isc-mh", node="n1", chips=_uuids("n1"))
            h.add_requester("req-2", "isc-mh", node="n2", chips=_uuids("n2"))

            def configs():
                return [inst.config for fl in h.launchers.values() for inst in fl.instances.values()]

            deadline = asyncio.get_running_loop().time() + 15
            while asyncio.get_running_loop().time() < deadline and len(configs()) < 2:
                await asyncio.sleep(0.1)
            assert len(configs()) == 2, "gang never actuated"
            envs = sorted((c["env_vars"]["FMA_PROCESS_ID"], c["env_vars"]["FMA_NUM_PROCESSES"],
                           c["env_vars"]["FMA_COORDINATOR_ADDRESS"]) for c in configs())
            assert [e[0] for e in envs] == ["0", "1"]
            assert {e[1] for e in envs} == {"2"}
            assert len({e[2] for e in envs}) == 1, "one coordinator address"
            assert sorted(len(c["gpu_uuids"]) for c in configs()) == [8, 8]
        finally:
            await coord.stop()

    run_scenario(h, body)


def test_gang_env_changes_instance_identity():
    """A sleeping member of a dead gang must never be woken into a new gang
    (a process joins one process group for its life): the gang env, which
    carries the unique gang id, is part of the instance identity, hashed
    as the JAX package hashes it."""
    esc = EngineServerConfig(port=8000, options="--model tiny")
    chips = ["c1", "c0"]
    base = instance_id_for(esc, chips)
    env_g1 = {"FMA_GANG_ID": "g1", "FMA_PROCESS_ID": "0"}
    env_g2 = {"FMA_GANG_ID": "g2", "FMA_PROCESS_ID": "0"}
    assert instance_id_for(esc, chips, extra_env=env_g1) != base
    assert instance_id_for(esc, chips, extra_env=env_g1) != instance_id_for(esc, chips, extra_env=env_g2)
    assert instance_id_for(esc, chips, extra_env=None) == base
    for env in (None, env_g1, env_g2):
        assert instance_id_for(esc, chips, extra_env=env) == jhash.instance_id_for(esc.to_dict(), chips,
                                                                                 extra_env=env)
    assert tgang.gang_env_from_instance_env({"FMA_PROCESS_ID": "0"}) is None
    assert tgang.gang_env_from_instance_env({**env_g1, "OTHER": "x"}) == env_g1


def test_the_names_are_the_jax_packages():
    from llm_d_fast_model_actuation_tpu.controller import gang as jgang

    assert (tgang.GANG_ANNOTATION, tgang.GANG_ENV_ANNOTATION, tgang.GANG_ENV_KEYS) == (
        jgang.GANG_ANNOTATION, jgang.GANG_ENV_ANNOTATION, jgang.GANG_ENV_KEYS)
    from llm_d_fast_model_actuation_tpu_torch.parallel import multihost as tplan

    assert tplan.COORDINATOR_PORT == jplan.COORDINATOR_PORT
    assert (tmh.HEARTBEAT_PORT_OFFSET, tmh.EXIT_GANG_PEER_LOST, tmh.GANG_HB_SECRET_ENV) == (
        jmh.HEARTBEAT_PORT_OFFSET, jmh.EXIT_GANG_PEER_LOST, jmh.GANG_HB_SECRET_ENV)
    kinds = ("IDLE", "PREFILL", "CHUNK", "SLEEP", "WAKE", "SHUTDOWN", "PREFILL_SUFFIX")
    assert [getattr(tmh, f"KIND_{k}") for k in kinds] == [getattr(jmh, f"KIND_{k}") for k in kinds]


# --------------------------------------------------------------- the frame


@pytest.mark.parametrize("max_batch,page_size,max_seq_len", [(2, 8, 64), (8, 16, 4096), (3, 12, 100)])
def test_frame_template_equals_the_jax_one(max_batch, page_size, max_seq_len):
    kw = dict(max_batch=max_batch, page_size=page_size, num_pages=64, max_seq_len=max_seq_len)
    jt = jmh._frame_template(jengine.EngineConfig(model=jllama.LlamaConfig.tiny(), **kw))
    tt = tmh._frame_template(tengine.EngineConfig(model=tllama.LlamaConfig.tiny(), **kw))
    assert list(tt) == list(jt)
    for k in jt:
        assert (tt[k].shape, tt[k].dtype) == (jt[k].shape, jt[k].dtype), k
        assert np.array_equal(tt[k], jt[k]), k  # the same resting values


def test_frame_pack_and_unpack_round_trip():
    cfg = tengine.EngineConfig(model=tllama.LlamaConfig.tiny(), max_batch=3, page_size=8, num_pages=32,
                               max_seq_len=64)
    t = tmh._frame_template(cfg)
    rng = np.random.default_rng(5)
    f = {k: (rng.standard_normal(a.shape) * 1e3).astype(a.dtype) if a.dtype.kind == "f"
         else rng.integers(0, 2**31 - 1, a.shape).astype(a.dtype) for k, a in t.items()}
    f["skeys"][0] = tmh.stream_seed_words(2**64 - 1)
    buf = tmh.pack_frame(f)
    assert buf.dtype == torch.uint8 and buf.numel() == sum(a.nbytes for a in t.values())
    back = tmh.unpack_frame(buf, t)
    assert all(np.array_equal(back[k], f[k]) and back[k].dtype == f[k].dtype for k in t)
    assert list(back["skeys"][0]) == [0xFFFF_FFFF, 0xFFFF_FFFF]
    with pytest.raises(ValueError):
        tmh.unpack_frame(buf[:-4], t)


# ------------------------------------------------ the mesh across processes


@pytest.mark.parametrize("tp", [2, 4])
def test_mesh_collectives_across_two_processes_are_bit_equal(tp, tmp_path):
    """Two Gloo processes, each holding tp / 2 CPU ranks: all_reduce_sum,
    gather, all_gather and ring_shift in fp32 and bf16 give, on every rank
    a process holds, the bits the one-process mesh gives on ``cpu`` x tp;
    gather gives rank 0's process the whole and the other None; and
    rank 0's tokens reach the other process."""
    sys.path.insert(0, f"{REPO_ROOT}/tests")
    from torch_gang_worker import run_collectives

    port = free_port()
    env = cpu_subprocess_env()
    env["PYTHONPATH"] = f"{REPO_ROOT}:{REPO_ROOT}/tests"
    outs = [tmp_path / f"p{pid}.pt" for pid in (0, 1)]
    procs = [subprocess.Popen([sys.executable, f"{REPO_ROOT}/tests/torch_gang_worker.py", "mesh", str(pid),
                               str(port), str(tp), str(outs[pid])], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for pid in (1, 0)]
    try:
        logs = [p.communicate(timeout=80)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    want = run_collectives(tmesh.serving_mesh(tp, ["cpu"] * tp), tp)
    got = [torch.load(o) for o in outs]
    assert got[0]["local_ranks"] == list(range(tp // 2)) and got[1]["local_ranks"] == list(range(tp // 2, tp))
    for key, ranks in want.items():
        for pid, g in enumerate(got):
            if key.startswith("gather"):
                if pid == 0:
                    assert torch.equal(g[key][0], ranks[0]) and g[key][0].dtype == ranks[0].dtype, key
                else:
                    assert g[key][0] is None, key
                continue
            if key == "broadcast":
                assert g[key][0].tolist() == [3, 1, 4, 1], (pid, g[key])
                continue
            for r, t in enumerate(ranks):
                if r in g["local_ranks"]:
                    assert torch.equal(g[key][r], t) and g[key][r].dtype == t.dtype, (key, pid, r)
                else:
                    assert g[key][r] is None, (key, pid, r)
    assert all(g["exchange_stats"]["exchanges"] == 9 and g["exchange_stats"]["bytes"] > 0 for g in got)


def test_a_gang_mesh_needs_its_share_of_devices(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    mesh = tmesh.make_mesh(tmesh.MeshPlan(tp=4), ["cpu", "cpu"], group=object())
    assert mesh.spans_processes and mesh.local_ranks == [2, 3] and mesh.size == 4
    assert mesh.per_rank(lambda r: r) == [None, None, 2, 3]
    assert mesh.distinct_devices() == [torch.device("cpu")]
    x = torch.ones(2)
    assert mesh.replicate(x) == [None, None, x, x]
    with pytest.raises(ValueError, match="2 local devices x 2 processes"):
        tmesh.make_mesh(tmesh.MeshPlan(tp=2), ["cpu", "cpu"], group=object())
    with pytest.raises(NotImplementedError, match="item 15"):
        tmesh.make_mesh(tmesh.MeshPlan(tp=2, pp=2), ["cpu", "cpu"], group=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="needs 2 devices, have 0"):
        tmesh.serving_mesh(4, group=object())
    with pytest.raises(ValueError, match="does not divide over 2 processes"):
        tmesh.serving_mesh(3, group=object())


def test_a_gang_model_builds_only_its_own_ranks(monkeypatch):
    """A follower's ShardedLlama holds rank 1 alone, under rank 1's state
    dict names, with the slices a one-process mesh gives rank 1 from the
    same seed."""
    import torch.distributed as dist

    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
    whole = tllama.init_params(cfg, torch.Generator().manual_seed(3), "cpu", mesh=tmesh.serving_mesh(2, ["cpu"] * 2))
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    mesh = tmesh.make_mesh(tmesh.MeshPlan(tp=2), ["cpu"], group=object())
    mine = tllama.init_params(cfg, torch.Generator().manual_seed(3), "cpu", mesh=mesh)
    assert mine.ranks[0] is None and list(mine.ranks)[1] is mine.ranks[1] and len(mine.ranks) == 2
    sd = mine.state_dict()
    assert sd and all(k.startswith("ranks.1.") for k in sd)
    ref = whole.state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in sd.items())
    assert mine.device == torch.device("cpu")
    pool = tengine.PagePool.create(cfg.num_layers, 8, 8, cfg.num_kv_heads, cfg.head_dim, dtype=cfg.dtype,
                                   mesh=mesh)
    assert pool.shards[0] is None and len(pool.tensors()) == 2


# ------------------------------------------------ the server's gang options

GANG = "--tensor-parallel-size 2 --num-processes 2 --process-id 0 --coordinator-address 127.0.0.1:9"


@pytest.mark.parametrize("flags,env", [
    ("--num-processes 2 --process-id 1 --coordinator-address 10.0.0.1:5", {}),
    ("", {"FMA_NUM_PROCESSES": "2", "FMA_PROCESS_ID": "1", "FMA_COORDINATOR_ADDRESS": "10.0.0.1:5"}),
    ("--process-id 0", {"FMA_NUM_PROCESSES": "4", "FMA_PROCESS_ID": "3", "FMA_COORDINATOR_ADDRESS": "h:7"}),
    ("", {}),
    ("--num-processes 1", {"FMA_NUM_PROCESSES": "2"}),
])
def test_resolve_distributed_is_the_references(flags, env, monkeypatch):
    """Flags over the gang env over one process, as the JAX server reads them."""
    from llm_d_fast_model_actuation_tpu.engine import server as jserver
    from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver

    for k in ("FMA_NUM_PROCESSES", "FMA_PROCESS_ID", "FMA_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ref = jserver.resolve_distributed(jserver.make_arg_parser().parse_args(flags.split()))
    assert tserver.resolve_distributed(tserver.make_arg_parser().parse_args(flags.split())) == ref


def test_an_incomplete_gang_is_refused_as_the_reference_refuses_it(monkeypatch):
    from llm_d_fast_model_actuation_tpu.engine import server as jserver
    from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver

    for k in ("FMA_NUM_PROCESSES", "FMA_PROCESS_ID", "FMA_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    for flags in ("--num-processes 2", "--num-processes 2 --process-id 2 --coordinator-address h:1"):
        with pytest.raises(ValueError) as want:
            jserver.resolve_distributed(jserver.make_arg_parser().parse_args(flags.split()))
        with pytest.raises(ValueError) as got:
            tserver.resolve_distributed(tserver.make_arg_parser().parse_args(flags.split()))
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("extra", [
    "--packed-serving on",
    "--packed-serving on --resident-variants 2",
    "--sleep-quant int8",
    "--zero-drain on",
])
def test_the_gang_refusals_are_the_references(extra, monkeypatch):
    """What the reference refuses for a gang, the port refuses in its words."""
    from llm_d_fast_model_actuation_tpu.engine import server as jserver
    from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver

    for k in ("FMA_NUM_PROCESSES", "FMA_PROCESS_ID", "FMA_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    opts = f"--model tiny {GANG} {extra}"
    with pytest.raises(ValueError) as want:
        jserver.parse_engine_options(opts)
    with pytest.raises(ValueError) as got:
        tserver.parse_engine_options(opts + " --device cpu")
    assert "multi-host gangs" in str(got.value) and str(got.value) == str(want.value)


def test_the_ports_own_gang_checks():
    from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver

    tserver.parse_engine_options(f"--model tiny {GANG} --device cpu")
    with pytest.raises(ValueError, match="does not divide over a gang of 2"):
        tserver.parse_engine_options("--model tiny --tensor-parallel-size 3 --num-processes 2 --process-id 0 "
                                     "--coordinator-address h:1 --device cpu")
    with pytest.raises(ValueError, match="device release is not supported for multi-host gangs"):
        tserver.parse_engine_options(f"--model tiny {GANG} --device cpu --sleep-release-devices always")
    with pytest.raises(ValueError, match="names 2 devices for --tensor-parallel-size 2 over 2 processes"):
        tserver.parse_engine_options(f"--model tiny {GANG} --device cpu,cpu")


def test_a_leaders_engine_refuses_what_its_frame_cannot_carry():
    """Under a LockstepLeader the engine refuses a variant, a logit bias and
    penalties (the frame carries none), as the JAX engine does, and runs
    no speculation."""
    cfg = tengine.EngineConfig(model=dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32),
                               max_batch=2, page_size=8, num_pages=32, max_seq_len=64, speculative_ngram=3)
    eng = tengine.InferenceEngine(cfg, seed=0, device="cpu")
    eng.lockstep = object()
    for kw, match in (({"logit_bias": {3: 1.0}}, "logit_bias is not supported for multi-host gangs"),
                      ({"presence_penalty": 0.5}, "repetition penalties are not supported for multi-host gangs"),
                      ({"frequency_penalty": 0.5}, "repetition penalties"),
                      ({"variant": 1}, "variant routing is not supported for multi-host gangs")):
        with pytest.raises(ValueError, match=match):
            eng.add_request([1, 2, 3], 4, **kw)
    eng.add_request([1, 2, 3], 4)
    assert eng._spec_candidate() is None
