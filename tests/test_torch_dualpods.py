"""The port's control plane held against the JAX package's, on the CPU.

The same scripts run on the JAX package's in-process ``Harness`` and on
the port's (``llm_d_fast_model_actuation_tpu_torch/testing.py``): the
final Pods, ISCs and LauncherConfigs (labels, annotations, finalizers,
specs, statuses, instance IDs), every fake launcher's creates, deletes
and instances, every engine's sleep and wake calls and every requester's
readiness must be equal, with uids, resourceVersions, timestamps and the
random suffixes of generated Pod names masked. Card ids are NVML-shaped
UUIDs on both sides. Only what the port maps by meaning may differ, and
:data:`MAPPED` names each: the provider's visible-devices env, the card
resource, and the direct path's nominal hash (its input holds those two;
each side's is checked against its own spec). Tolerance: none, these are
strings and objects.

Also here: the API objects, the identity hashes (hypothesis), the
initial-sync barrier, the gpu-map, the populator, the direct path's
pieces, the metrics' exposition, the refusals a GPU makes (a slice
topology, more than one host), and the port's ``KubeStore`` against
``tests/fake_apiserver.py``.
"""

import asyncio
import json
import re
import time
from types import SimpleNamespace

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from llm_d_fast_model_actuation_tpu import testing as jtesting
from llm_d_fast_model_actuation_tpu.api import constants as JC
from llm_d_fast_model_actuation_tpu.api import types as jtypes
from llm_d_fast_model_actuation_tpu.controller import directpath as jdirect
from llm_d_fast_model_actuation_tpu.controller import dualpods as jdual
from llm_d_fast_model_actuation_tpu.controller import populator as jpop
from llm_d_fast_model_actuation_tpu.controller import store as jstore
from llm_d_fast_model_actuation_tpu.utils import hashing as jhash
from llm_d_fast_model_actuation_tpu.utils import syncbarrier as jsync
from llm_d_fast_model_actuation_tpu_torch import testing as ptesting
from llm_d_fast_model_actuation_tpu_torch.api import constants as PC
from llm_d_fast_model_actuation_tpu_torch.api import types as ptypes
from llm_d_fast_model_actuation_tpu_torch.controller import directpath as pdirect
from llm_d_fast_model_actuation_tpu_torch.controller import dualpods as pdual
from llm_d_fast_model_actuation_tpu_torch.controller import metrics as pmetrics
from llm_d_fast_model_actuation_tpu_torch.controller import populator as ppop
from llm_d_fast_model_actuation_tpu_torch.controller import store as pstore
from llm_d_fast_model_actuation_tpu_torch.parallel import topology as ptopo
from llm_d_fast_model_actuation_tpu_torch.utils import hashing as phash
from llm_d_fast_model_actuation_tpu_torch.utils import syncbarrier as psync

SIDES = {
    "jax": SimpleNamespace(name="jax", t=jtesting, C=JC, dual=jdual, direct=jdirect, pop=jpop, store=jstore,
                           resource=JC.TPU_RESOURCE),
    "port": SimpleNamespace(name="port", t=ptesting, C=PC, dual=pdual, direct=pdirect, pop=ppop, store=pstore,
                            resource=PC.GPU_RESOURCE),
}
U0, U1, U2 = (ptesting.gpu_uuid(i) for i in range(3))

#: what the port maps by meaning, JAX name -> port name
MAPPED = {
    "visible devices env": (JC.TPU_VISIBLE_DEVICES_ENV, PC.VISIBLE_DEVICES_ENV),
    "process bounds env (JAX only)": (JC.TPU_PROCESS_BOUNDS_ENV, None),
    "chips per process bounds env (JAX only)": (JC.TPU_CHIPS_PER_PROCESS_BOUNDS_ENV, None),
    "device order env (port only)": (None, PC.DEVICE_ORDER_ENV),
    "card resource": (JC.TPU_RESOURCE, PC.GPU_RESOURCE),
    "nominal hash (over a spec holding the two above)": (jdirect.NOMINAL_HASH_ANNOTATION,
                                                          pdirect.NOMINAL_HASH_ANNOTATION),
}


# -- the scenarios ------------------------------------------------------------------


def _pods(h, S, component):
    return h.store.list("Pod", h.ns, selector={S.C.COMPONENT_LABEL: component})


def sc_basic_creation_and_metadata(S):
    h = S.t.Harness()
    h.add_lc("lc1", max_instances=2)
    h.add_isc("iscA", "lc1", port=8000, labels={"route-to": "iscA"})

    async def body():
        h.add_requester("reqA", "iscA", chips=[U0, U1])
        await h.settle()

    S.t.run_scenario(h, body)
    return h, {}


def sc_unbind_sleeps_and_deroutes(S):
    h = S.t.Harness()
    h.add_lc("lc1")
    h.add_isc("iscA", "lc1", labels={"route-to": "iscA"})

    async def body():
        h.add_requester("reqA", "iscA", chips=[U0])
        await h.settle()
        h.store.delete("Pod", h.ns, "reqA")
        await h.settle()

    S.t.run_scenario(h, body)
    return h, {}


def sc_wake_fast_path(S):
    h = S.t.Harness()
    h.add_lc("lc1")
    h.add_isc("iscA", "lc1")

    async def body():
        h.add_requester("reqA", "iscA", chips=[U0])
        await h.settle()
        h.store.delete("Pod", h.ns, "reqA")
        await h.settle()
        h.add_requester("reqA2", "iscA", chips=[U0])
        await h.settle()

    S.t.run_scenario(h, body)
    return h, {}


def sc_concurrent_requesters_get_separate_launchers(S):
    h = S.t.Harness()
    h.add_lc("lc1", max_instances=2)
    h.add_isc("iscA", "lc1", port=8000)
    h.add_isc("iscB", "lc1", port=8100)

    async def body():
        h.add_requester("reqA", "iscA", chips=[U0])
        await h.settle()
        h.add_requester("reqB", "iscB", chips=[U1])
        await h.settle()

    S.t.run_scenario(h, body)
    return h, {}


def sc_switch_instances_on_same_launcher(S):
    """Two ISCs time-sharing one card through one launcher: A sleeps, B
    runs beside it, then B sleeps and A wakes."""
    h = S.t.Harness()
    h.add_lc("lc1", max_instances=2)
    h.add_isc("iscA", "lc1", port=8000)
    h.add_isc("iscB", "lc1", port=8100)

    async def body():
        h.add_requester("reqA", "iscA", chips=[U0])
        await h.settle()
        h.store.delete("Pod", h.ns, "reqA")
        await h.settle()
        h.add_requester("reqB", "iscB", chips=[U0])
        await h.settle()
        h.store.delete("Pod", h.ns, "reqB")
        await h.settle()
        h.add_requester("reqA2", "iscA", chips=[U0])
        await h.settle()

    S.t.run_scenario(h, body)
    return h, {}


def sc_cap_reclaim_without_new_launcher(S):
    h = S.t.Harness()
    h.add_lc("lc1", max_instances=1)
    h.add_isc("iscA", "lc1", port=8000)
    h.add_isc("iscB", "lc1", port=8100)

    async def body():
        h.add_requester("reqA", "iscA", chips=[U0])
        await h.settle()
        h.store.delete("Pod", h.ns, "reqA")
        await h.settle()
        h.add_requester("reqB", "iscB", chips=[U0])
        await h.settle()

    S.t.run_scenario(h, body)
    return h, {}


def sc_port_conflict_reclaim(S):
    h = S.t.Harness()
    h.add_lc("lc1", max_instances=4)
    h.add_isc("iscA", "lc1", port=8000)
    h.add_isc("iscB", "lc1", port=8000)

    async def body():
        h.add_requester("reqA", "iscA", chips=[U0])
        await h.settle()
        h.store.delete("Pod", h.ns, "reqA")
        await h.settle()
        h.add_requester("reqB", "iscB", chips=[U1])
        await h.settle()

    S.t.run_scenario(h, body)
    return h, {}


def sc_live_port_conflict_forces_new_launcher(S):
    h = S.t.Harness()
    h.add_lc("lc1", max_instances=4)
    h.add_isc("iscA", "lc1", port=8000)
    h.add_isc("iscB", "lc1", port=8000)

    async def body():
        h.add_requester("reqA", "iscA", chips=[U0])
        await h.settle()
        h.add_requester("reqB", "iscB", chips=[U1])
        await h.settle()

    S.t.run_scenario(h, body)
    return h, {}


def sc_controller_restart_recovery(S):
    h = S.t.Harness()
    h.add_lc("lc1")
    h.add_isc("iscA", "lc1")

    async def body():
        h.add_requester("reqA", "iscA", chips=[U0])
        await h.settle()

    S.t.run_scenario(h, body)
    h.controller = S.dual.DualPodsController(h.store, h.transports, S.dual.DualPodsConfig(namespace=h.ns))

    async def body2():
        await h.settle()
        h.store.delete("Pod", h.ns, "reqA")
        await h.settle()

    S.t.run_scenario(h, body2)
    return h, {}


def _bump_options(options):
    def bump(isc):
        isc["spec"]["modelServerConfig"]["options"] = options
        return isc

    return bump


def sc_isc_update_gcs_obsolete_sleeping_instance(S):
    h = S.t.Harness()
    h.add_lc("lc1")
    h.add_isc("iscA", "lc1", options="--model tiny")

    async def body():
        h.add_requester("reqA", "iscA", chips=[U0])
        await h.settle()
        h.store.delete("Pod", h.ns, "reqA")
        await h.settle()
        h.store.mutate("InferenceServerConfig", h.ns, "iscA", _bump_options("--model tiny --seed 7"))
        await h.settle()

    S.t.run_scenario(h, body)
    return h, {}


def sc_obsolete_awake_instance_deleted_on_unbind(S):
    h = S.t.Harness()
    h.add_lc("lc1")
    h.add_isc("iscA", "lc1", options="--model tiny")

    async def body():
        h.add_requester("reqA", "iscA", chips=[U0])
        await h.settle()
        h.store.mutate("InferenceServerConfig", h.ns, "iscA", _bump_options("--model tiny --seed 9"))
        h.store.delete("Pod", h.ns, "reqA")
        await h.settle()

    S.t.run_scenario(h, body)
    return h, {}


def sc_isc_change_while_bound_keeps_committed_instance(S):
    h = S.t.Harness()
    h.add_lc("lc1")
    h.add_isc("iscA", "lc1", options="--model tiny")

    async def body():
        h.add_requester("reqA", "iscA", chips=[U0])
        await h.settle()
        h.store.mutate("InferenceServerConfig", h.ns, "iscA", _bump_options("--model tiny --v2"))
        await h.settle()

    S.t.run_scenario(h, body)
    return h, {}


def sc_routing_label_churn(S):
    h = S.t.Harness()
    h.add_lc("lc1")
    h.add_isc("iscA", "lc1", labels={"route-a": "1"})

    def relabel(isc):
        isc["spec"]["modelServerConfig"]["labels"] = {"route-b": "2"}
        return isc

    async def body():
        h.add_requester("reqA", "iscA", chips=[U0])
        await h.settle()
        h.store.mutate("InferenceServerConfig", h.ns, "iscA", relabel)
        await h.settle()
        h.store.delete("Pod", h.ns, "reqA")
        await h.settle()

    S.t.run_scenario(h, body)
    return h, {}


def sc_stopped_instance_recovery(S):
    h = S.t.Harness()
    h.add_lc("lc1")
    h.add_isc("iscA", "lc1")

    async def body():
        h.add_requester("reqA", "iscA", chips=[U0])
        await h.settle()
        lp = _pods(h, S, S.C.LAUNCHER_COMPONENT)[0]
        fl = h.launcher_for(lp["metadata"]["name"])
        fl.instances[lp["metadata"]["annotations"][S.C.INSTANCE_ID_ANNOTATION]].status = "stopped"

        def poke(p):
            p["metadata"]["annotations"][S.C.INSTANCE_SIGNATURE_ANNOTATION] = "changed"
            return p

        h.store.mutate("Pod", h.ns, lp["metadata"]["name"], poke)
        await h.settle()
        h.add_requester("reqA-2", "iscA", chips=[U0])
        await h.settle()

    S.t.run_scenario(h, body)
    return h, {}


def sc_provider_deletion_relays_to_requester(S):
    h = S.t.Harness()
    h.add_lc("lc1")
    h.add_isc("iscA", "lc1")

    async def body():
        h.add_requester("reqA", "iscA", chips=[U0])
        await h.settle()
        h.store.delete("Pod", h.ns, _pods(h, S, S.C.LAUNCHER_COMPONENT)[0]["metadata"]["name"])
        await h.settle()

    S.t.run_scenario(h, body)
    return h, {}


def sc_memory_budget_blocks_wake(S):
    """The JAX controller retries silently; the port also writes the
    budget's message into the requester's status while it waits
    (``observed``), and both clear it once the engine serves."""
    h = S.t.Harness(accelerator_sleeping_memory_limit_bytes=1000)
    h.add_lc("lc1")
    h.add_isc("iscA", "lc1")
    seen = {}

    async def body():
        h.add_requester("reqA", "iscA", chips=[U0])
        await h.settle()
        h.store.delete("Pod", h.ns, "reqA")
        await h.settle()
        h.add_requester("reqB", "iscA", chips=[U0])
        h.spis["reqB"].memory = {U0: 10_000}
        await asyncio.sleep(1.0)
        seen["ready_while_over"] = h.spis["reqB"].ready
        seen["status_while_over"] = h.store.get("Pod", h.ns, "reqB")["metadata"]["annotations"].get(
            S.C.STATUS_ANNOTATION)
        h.spis["reqB"].memory = {U0: 10}
        await h.settle()

    S.t.run_scenario(h, body)
    return h, seen


def sc_status_annotation_on_bad_isc(S):
    h = S.t.Harness()
    h.add_lc("lc1")

    async def body():
        h.add_requester("reqA", "missing-isc", chips=[U0])
        await asyncio.sleep(0.5)

    S.t.run_scenario(h, body)
    return h, {}


def sc_unschedulable_node_deletes_unbound_requester(S):
    h = S.t.Harness()
    h.add_lc("lc1")
    h.add_isc("iscA", "lc1")
    h.store.create({"kind": "Node", "metadata": {"name": "n1"}, "spec": {"unschedulable": True}})

    async def body():
        h.add_requester("reqA", "iscA", chips=[U0])
        await h.settle()

    S.t.run_scenario(h, body)
    return h, {}


def sc_unschedulable_node_keeps_bound_requester(S):
    h = S.t.Harness()
    h.add_lc("lc1")
    h.add_isc("iscA", "lc1")
    h.store.create({"kind": "Node", "metadata": {"name": "n1"}, "spec": {}})

    def cordon(node):
        node.setdefault("spec", {})["unschedulable"] = True
        return node

    def poke(p):
        p["metadata"].setdefault("annotations", {})["poke"] = "1"
        return p

    async def body():
        h.add_requester("reqA", "iscA", chips=[U0])
        await h.settle()
        h.store.mutate("Node", "", "n1", cordon)
        h.store.mutate("Pod", h.ns, "reqA", poke)
        await h.settle()

    S.t.run_scenario(h, body)
    return h, {}


PATCH = json.dumps({
    "metadata": {"labels": {"model": "tiny"}},
    "spec": {"containers": [{"name": "inference-server", "image": "engine:v1", "args": ["--model", "tiny"]}]},
})
PATCH_B = PATCH.replace("tiny", "small")


def _gpu_map(S, h, node="n1"):
    """The node's map in the side's own grammar: the port's gpu-map
    (``<index> <uuid>``) or the JAX package's chip-map (with coordinates)."""
    lines = [f"{i} {u}" + ("" if S.name == "port" else f" 0,{i}") for i, u in ((2, U0), (5, U1), (7, U2))]
    name = PC.GPU_MAP_CONFIGMAP if S.name == "port" else JC.CHIP_MAP_CONFIGMAP
    h.store.create({"kind": "ConfigMap", "metadata": {"name": name, "namespace": h.ns},
                    "data": {node: "\n".join(lines)}})


def sc_direct_pair_sleep_and_twin_reuse(S):
    h = S.t.Harness()
    _gpu_map(S, h)

    async def body():
        h.add_direct_requester("reqA", PATCH, chips=[U1, U0], port=8005)
        await h.settle()
        h.store.delete("Pod", h.ns, "reqA")
        await h.settle()
        h.add_direct_requester("reqA2", PATCH, chips=[U0, U1], port=8005)
        await h.settle()

    S.t.run_scenario(h, body)
    return h, {}


def sc_direct_sleeper_budget_lru_eviction(S):
    h = S.t.Harness(sleeper_limit=1)

    async def body():
        h.add_direct_requester("reqA", PATCH, chips=[U0])
        await h.settle()
        h.store.delete("Pod", h.ns, "reqA")
        await h.settle()
        h.add_direct_requester("reqB", PATCH_B, chips=[U0])
        await h.settle()
        h.store.delete("Pod", h.ns, "reqB")
        await h.settle()
        h.add_direct_requester("reqC", PATCH.replace("v1", "v2"), chips=[U0])
        await h.settle()

    S.t.run_scenario(h, body)
    return h, {}


def sc_direct_unknown_card_in_map(S):
    h = S.t.Harness()
    _gpu_map(S, h)

    async def body():
        h.add_direct_requester("reqA", PATCH, chips=["GPU-ffffffff-0000-4000-8000-00000000ffff"])
        await asyncio.sleep(0.5)

    S.t.run_scenario(h, body)
    return h, {}


def sc_mutually_exclusive_annotations(S):
    h = S.t.Harness()
    h.add_lc("lc1")
    h.add_isc("iscA", "lc1")

    def both(p):
        p["metadata"]["annotations"][S.C.SERVER_PATCH_ANNOTATION] = PATCH
        return p

    async def body():
        h.add_requester("reqA", "iscA", chips=[U0])
        await h.settle()
        h.store.mutate("Pod", h.ns, "reqA", both)
        await asyncio.sleep(0.3)

    S.t.run_scenario(h, body)
    return h, {}


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_basic_creation_and_metadata, sc_unbind_sleeps_and_deroutes, sc_wake_fast_path,
    sc_concurrent_requesters_get_separate_launchers, sc_switch_instances_on_same_launcher,
    sc_cap_reclaim_without_new_launcher, sc_port_conflict_reclaim, sc_live_port_conflict_forces_new_launcher,
    sc_controller_restart_recovery, sc_isc_update_gcs_obsolete_sleeping_instance,
    sc_obsolete_awake_instance_deleted_on_unbind, sc_isc_change_while_bound_keeps_committed_instance,
    sc_routing_label_churn, sc_stopped_instance_recovery, sc_provider_deletion_relays_to_requester,
    sc_memory_budget_blocks_wake, sc_status_annotation_on_bad_isc, sc_unschedulable_node_deletes_unbound_requester,
    sc_unschedulable_node_keeps_bound_requester, sc_direct_pair_sleep_and_twin_reuse,
    sc_direct_sleeper_budget_lru_eviction, sc_direct_unknown_card_in_map, sc_mutually_exclusive_annotations,
)}


# -- the snapshot -------------------------------------------------------------------


_GENERATED = re.compile(r"-(p?[0-9a-f]{6,8})$")


def _map_container(S, c, checks):
    """The mapped names of one container, replaced by neutral keys after
    their values are recorded."""
    env = c.get("env")
    if env is not None:
        by = {e["name"]: e.get("value") for e in env}
        if S.name == "jax":
            visible = by.get(JC.TPU_VISIBLE_DEVICES_ENV)
            mapped = {JC.TPU_VISIBLE_DEVICES_ENV, JC.TPU_PROCESS_BOUNDS_ENV, JC.TPU_CHIPS_PER_PROCESS_BOUNDS_ENV}
        else:
            visible = by.get(PC.VISIBLE_DEVICES_ENV)
            mapped = {PC.VISIBLE_DEVICES_ENV, PC.DEVICE_ORDER_ENV}
            if visible is not None:
                checks.append(by.get(PC.DEVICE_ORDER_ENV) == PC.DEVICE_ORDER)
        c["env"] = [e for e in env if e["name"] not in mapped]
        if visible is not None:
            c["env"].append({"name": "<visible devices>", "value": visible})
    for section in (c.get("resources") or {}).values():
        if S.resource in section:
            section["<cards>"] = section.pop(S.resource)


def snapshot(S, h, seen):
    """Everything a scenario leaves behind, masked and with the mapped
    names neutral; plus checks that must hold on that side."""
    checks = []
    objs = h.store.all_objects()
    rename, counters = {}, {}
    # creation order: the fakes' (which outlive a deleted Pod), then the store's
    names = list(h.launchers) + list(h.direct_engines) + [o["metadata"]["name"] for o in objs]
    for name in dict.fromkeys(names):
        m = _GENERATED.search(name)
        if m:
            stem = name[: m.start()]
            counters[stem] = counters.get(stem, 0) + 1
            rename[name] = f"{stem}-<{counters[stem]}>"
    out = {}
    for o in objs:
        o = json.loads(json.dumps(o))
        md = o["metadata"]
        for k in ("uid", "resourceVersion", "creationTimestamp"):
            md.pop(k, None)
        if md.get("deletionTimestamp") is not None:
            md["deletionTimestamp"] = "<set>"
        ann = md.get("annotations") or {}
        if S.direct.LAST_USED_ANNOTATION in ann:
            ann[S.direct.LAST_USED_ANNOTATION] = "<time>"
        req = ann.get(S.C.REQUESTER_ANNOTATION)
        if req and "/" in req:
            ann[S.C.REQUESTER_ANNOTATION] = req.split("/")[0] + "/<uid>"
        nominal = ann.pop(S.direct.NOMINAL_HASH_ANNOTATION, None)
        if nominal is not None:
            chips = [c for c in ann[S.C.ACCELERATORS_ANNOTATION].split(",") if c]
            checks.append(nominal == S.direct.nominal_hash(o["spec"], chips, o["spec"]["nodeSelector"][
                "kubernetes.io/hostname"]))
            ann["<nominal hash>"] = "<checked>"
        for c in (o.get("spec") or {}).get("containers") or []:
            _map_container(S, c, checks)
        if o["kind"] == "ConfigMap":
            o["data"] = "<the side's own map grammar>"
            md["name"] = "<card map>"
        out[f"{o['kind']}/{md['name']}"] = o
    fakes = {}
    for lname, fl in h.launchers.items():
        fakes[lname] = {
            "created": fl.created, "deleted": fl.deleted,
            "instances": {iid: {"status": i.status, "config": i.config, "sleeping": i.engine.sleeping,
                                "sleeps": i.engine.sleep_calls, "wakes": i.engine.wake_calls}
                          for iid, i in fl.instances.items()},
        }
    direct = {n: [e.sleeping, e.sleep_calls, e.wake_calls] for n, e in h.direct_engines.items()}
    ready = {n: s.ready for n, s in h.spis.items()}
    text = json.dumps({"objects": out, "launchers": fakes, "direct": direct, "ready": ready, "seen": seen},
                      sort_keys=True)
    for old in sorted(rename, key=len, reverse=True):
        text = text.replace(old, rename[old])
    return json.loads(text), checks


# -- the comparisons ----------------------------------------------------------------


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_ends_as_the_jax_controllers(name):
    got = {}
    for side, S in SIDES.items():
        h, seen = SCENARIOS[name](S)
        got[side] = snapshot(S, h, seen)
    (jsnap, jchecks), (psnap, pchecks) = got["jax"], got["port"]
    assert all(jchecks) and all(pchecks)
    if name == "memory_budget_blocks_wake":
        # the one difference by design: the port shows why it waits
        assert jsnap["seen"]["status_while_over"] is None
        status = json.loads(psnap["seen"]["status_while_over"])["Errors"]
        assert len(status) == 1 and "above sleeping budget (1000B)" in status[0]
        assert not jsnap["seen"]["ready_while_over"] and not psnap["seen"]["ready_while_over"]
        jsnap.pop("seen"), psnap.pop("seen")
    assert psnap == jsnap


def test_scenarios_cover_two_iscs_time_sharing_one_card():
    """The time-sharing script leaves A awake and B asleep on one
    launcher, each created once: the chip check's dualpods phase in
    miniature."""
    h, _ = sc_switch_instances_on_same_launcher(SIDES["port"])
    (lp,) = _pods(h, SIDES["port"], PC.LAUNCHER_COMPONENT)
    fl = h.launcher_for(lp["metadata"]["name"])
    by_isc = {i.config["annotations"]["isc-name"]: i for i in fl.instances.values()}
    assert set(by_isc) == {"iscA", "iscB"} and sorted(fl.created) == sorted(fl.instances)
    assert not by_isc["iscA"].engine.sleeping and by_isc["iscA"].engine.wake_calls == 1
    assert by_isc["iscB"].engine.sleeping and by_isc["iscB"].engine.sleep_calls == 1
    assert all(i.config["gpu_uuids"] == [U0] for i in fl.instances.values())


# -- the GPU refusals ---------------------------------------------------------------


@pytest.mark.parametrize("accelerator,field", [
    ({"chips": 4, "topology": "2x2"}, "accelerator.topology=2x2"),
    ({"chips": 1, "hosts": 2}, "accelerator.hosts=2"),
])
def test_an_isc_a_gpu_cannot_honour_is_refused_into_the_status(accelerator, field):
    spec = ptypes.AcceleratorSpec.from_dict(accelerator)
    (msg,) = spec.validate()
    assert msg.startswith(field) and "refused" in msg
    if "hosts" in accelerator:
        assert "item 15" in msg
    h = ptesting.Harness()
    h.add_lc("lc1")
    h.add_isc("iscA", "lc1", accelerator=accelerator)

    async def body():
        h.add_requester("reqA", "iscA", chips=[U0, U1, U2, ptesting.gpu_uuid(3)][: accelerator["chips"]])
        await asyncio.sleep(0.4)

    ptesting.run_scenario(h, body)
    status = json.loads(h.store.get("Pod", h.ns, "reqA")["metadata"]["annotations"][PC.STATUS_ANNOTATION])
    assert status["Errors"] == [msg]
    assert h.launcher_pods() == []  # nothing actuated


def test_the_card_count_is_checked_as_the_jax_controller_checks_it():
    accel = {"chips": 2}
    statuses = {}
    for side, S in SIDES.items():
        h = S.t.Harness()
        h.add_lc("lc1")
        h.add_isc("iscA", "lc1", accelerator=accel)

        async def body():
            h.add_requester("reqA", "iscA", chips=[U0])
            await asyncio.sleep(0.4)

        S.t.run_scenario(h, body)
        statuses[side] = h.store.get("Pod", h.ns, "reqA")["metadata"]["annotations"][S.C.STATUS_ANNOTATION]
    assert statuses["port"] == statuses["jax"]
    assert "accelerator.chips=2 but requester reports 1 chip(s)" in statuses["port"]


def test_a_failed_memory_query_holds_the_wake_and_says_so():
    """The JAX controller wakes when the SPI's memory query fails; the
    port does not (no fallback hides the card) and writes why."""

    class Broken(ptesting.FakeSpi):
        async def accelerator_memory(self):
            raise RuntimeError("NVML: no library")

    h = ptesting.Harness(accelerator_sleeping_memory_limit_bytes=1 << 30)
    h.add_lc("lc1")
    h.add_isc("iscA", "lc1")

    async def body():
        h.add_requester("reqA", "iscA", chips=[U0])
        await h.settle()
        h.store.delete("Pod", h.ns, "reqA")
        await h.settle()
        h.add_requester("reqB", "iscA", chips=[U0])
        h.spis["reqB"] = Broken([U0])
        await asyncio.sleep(0.8)

    ptesting.run_scenario(h, body)
    (lp,) = h.launcher_pods()
    (inst,) = h.launcher_for(lp["metadata"]["name"]).instances.values()
    assert inst.engine.sleeping and inst.engine.wake_calls == 0
    status = json.loads(h.store.get("Pod", h.ns, "reqB")["metadata"]["annotations"][PC.STATUS_ANNOTATION])
    assert "NVML: no library" in status["Errors"][0]


# -- API objects and identity -------------------------------------------------------


ISC = {"metadata": {"name": "llama8b", "namespace": "ns", "labels": {"a": "b"}},
       "spec": {"modelServerConfig": {"port": 8000, "options": "--model llama3-8b --tensor-parallel-size 2",
                                      "env_vars": {"X": "1"}, "labels": {"route": "r"},
                                      "accelerator": {"chips": 2}},
                "launcherConfigName": "lc1"}}
LC = {"metadata": {"name": "lc1", "namespace": "ns"},
      "spec": {"podTemplate": {"metadata": {"labels": {"x": "y"}},
                               "spec": {"containers": [{"name": "launcher", "env": [{"name": "B"}, {"name": "A"}]}]}},
               "maxInstances": 3}}
LPP = {"metadata": {"name": "p1", "namespace": "ns"},
       "spec": {"enhancedNodeSelector": {"labelSelector": {"matchLabels": {"pool": "h100"}},
                                         "allocatableResources": {PC.GPU_RESOURCE: {"min": "1", "max": "8"}}},
                "countForLauncher": [{"launcherConfigName": "lc1", "launcherCount": 2}]}}


@pytest.mark.parametrize("kind,doc", [("InferenceServerConfig", ISC), ("LauncherConfig", LC),
                                      ("LauncherPopulationPolicy", LPP)])
def test_api_objects_round_trip_as_the_jax_packages(kind, doc):
    pobj = getattr(ptypes, kind).from_dict(doc)
    jobj = getattr(jtypes, kind).from_dict(doc)
    assert pobj.to_dict() == jobj.to_dict()
    assert getattr(ptypes, kind).from_dict(pobj.to_dict()).to_dict() == pobj.to_dict()


@pytest.mark.parametrize("q", ["4", "16Gi", "500m", "2k", 7, "1e3", "1.5Ti"])
def test_quantities_parse_as_the_jax_packages(q):
    assert ptypes.parse_quantity(q) == jtypes.parse_quantity(q)


def test_resource_range_and_node_matching_as_the_jax_packages():
    for rng, v in ((("4", "8"), "6"), (("4", "8"), "16"), (("8Gi", None), "16Gi")):
        assert ptypes.ResourceRange(*rng).matches(v) == jtypes.ResourceRange(*rng).matches(v)
    node = {"metadata": {"labels": {"pool": "h100"}}, "status": {"allocatable": {PC.GPU_RESOURCE: "8"}}}
    sel = LPP["spec"]["enhancedNodeSelector"]
    assert ppop.node_matches(node, ptypes.EnhancedNodeSelector.from_dict(sel))
    assert jpop.node_matches(node, jtypes.EnhancedNodeSelector.from_dict(sel))


_json = st.recursive(
    st.none() | st.booleans() | st.integers(-10**6, 10**6) | st.text(max_size=8),
    lambda inner: st.lists(inner, max_size=4) | st.dictionaries(st.text(max_size=6), inner, max_size=4),
    max_leaves=12,
)
_ids = st.lists(st.text("0123456789abcdef-GPU", min_size=1, max_size=12), max_size=4)


@settings(max_examples=60, deadline=None)
@given(obj=_json, ids=_ids, parts=st.lists(st.text(max_size=10), max_size=4))
def test_identity_hashes_are_byte_equal(obj, ids, parts):
    assert phash.canonical_json(obj) == jhash.canonical_json(obj)
    assert phash.sha256_hex(*parts) == jhash.sha256_hex(*parts)
    assert phash.template_hash(obj) == jhash.template_hash(obj)
    named = {"spec": {"containers": [{"name": n, "v": obj} for n in ids]}}
    assert phash.template_hash(named) == jhash.template_hash(named)
    assert phash.instance_id_for(obj, ids) == jhash.instance_id_for(obj, ids)
    spec = {"containers": [{"name": "inference-server", "v": obj}]}
    assert pdirect.nominal_hash(spec, ids, "n1") == jdirect.nominal_hash(spec, ids, "n1")


@settings(max_examples=40, deadline=None)
@given(port=st.integers(1, 65535), options=st.text(max_size=30), ids=_ids,
       env=st.dictionaries(st.text(min_size=1, max_size=5), st.text(max_size=5), max_size=3))
def test_instance_ids_of_engine_configs_are_byte_equal(port, options, ids, env):
    doc = {"port": port, "options": options, "env_vars": env}
    pid = phash.instance_id_for(ptypes.EngineServerConfig.from_dict(doc), ids)
    assert pid == jhash.instance_id_for(jtypes.EngineServerConfig.from_dict(doc), ids)
    assert pid.startswith("I") and pid.endswith("i")


# -- the initial-sync barrier ------------------------------------------------------


@pytest.mark.parametrize("mod", [jsync, psync], ids=["jax", "port"])
def test_initial_sync_barrier(mod):
    async def scenario():
        b = mod.KnowsProcessedSync()
        b.note_pending("a")
        b.note_pending("b")
        b.arm()
        b.note_pending("late")  # after arm: a live event, not initial state
        b.note_processed("a")
        first = b.processed
        b.note_processed("b")
        await b.wait(timeout=1)
        empty = mod.KnowsProcessedSync()
        empty.arm()
        return first, b.processed, empty.processed

    assert asyncio.run(scenario()) == (False, True, True)


def test_the_controllers_initial_sync_fires_after_its_first_pass():
    h = ptesting.Harness()
    h.add_lc("lc1")
    h.add_isc("iscA", "lc1")
    h.add_requester("reqA", "iscA", chips=[U0])

    async def body():
        await h.controller.initial_sync.wait(timeout=10)
        assert h.controller.initial_sync.processed

    ptesting.run_scenario(h, body)


# -- the gpu-map --------------------------------------------------------------------


def test_one_parser_reads_the_gpu_map_and_the_jax_chip_map():
    from llm_d_fast_model_actuation_tpu.parallel.topology import ChipMap, HostTopology

    gpu = ptopo.parse_gpu_map({"n1": f"0 {U0}\n3 {U1}\n", "n2": ""})
    assert gpu == {"n1": [(U0, 0), (U1, 3)], "n2": []}
    assert ptopo.indices_for(gpu["n1"], [U1, U0]) == [3, 0]
    with pytest.raises(KeyError, match=U2):
        ptopo.indices_for(gpu["n1"], [U2])
    cm = ChipMap()
    cm.set_host("h", HostTopology.make("2x2", node="h"))
    read = ptopo.parse_gpu_map(cm.dump())["h"]
    assert read == [(c.chip_id, c.index) for c in cm.host("h").chips]
    assert ptopo.visible_devices_env([5, 2]) == {"CUDA_VISIBLE_DEVICES": "5,2", "CUDA_DEVICE_ORDER": "PCI_BUS_ID"}


def test_the_launcher_translator_and_the_direct_path_share_the_parser():
    import inspect

    from llm_d_fast_model_actuation_tpu_torch.launcher import chiptranslator

    assert chiptranslator.parse_gpu_map is ptopo.parse_gpu_map
    assert pdirect.parse_gpu_map is ptopo.parse_gpu_map
    assert "def parse_" not in inspect.getsource(chiptranslator)


# -- the direct path's pieces -------------------------------------------------------


def _requester(resource):
    return {"metadata": {"name": "r", "labels": {"app": "x"}},
            "spec": {"nodeName": "n1",
                     "volumes": [{"name": "kube-api-access-abc"}, {"name": "data"}],
                     "containers": [{"name": "inference-server", "image": "stub",
                                     "volumeMounts": [{"name": "kube-api-access-abc", "mountPath": "/t"}],
                                     "readinessProbe": {"httpGet": {"port": "http"}},
                                     "ports": [{"name": "http", "containerPort": 8123}],
                                     "resources": {"limits": {resource: "2"}, "requests": {resource: "2"}}}]}}


def test_the_nominal_provider_is_the_jax_packages_with_the_cards_named_by_meaning():
    from llm_d_fast_model_actuation_tpu.parallel.topology import ChipMap, ChipInfo, HostTopology
    from llm_d_fast_model_actuation_tpu.api.types import SliceTopology

    patch = pdirect.render_server_patch(PATCH, pdirect.ProviderData(node_name="n1"))
    assert patch == jdirect.render_server_patch(PATCH, jdirect.ProviderData(node_name="n1"))
    gpu_map = {"n1": [(U0, 4), (U1, 1)]}
    cm = ChipMap()
    cm.set_host("n1", HostTopology(SliceTopology.parse("2"), [ChipInfo(U0, 4, (0, 4)), ChipInfo(U1, 1, (0, 1))]))
    p = pdirect.nominal_provider_pod(_requester(PC.GPU_RESOURCE), patch, "n1", [U1, U0], gpu_map)
    j = jdirect.nominal_provider_pod(_requester(JC.TPU_RESOURCE), patch, "n1", [U1, U0], cm)
    (pc,), (jc,) = p["spec"]["containers"], j["spec"]["containers"]
    pe = {e["name"]: e["value"] for e in pc["env"]}
    je = {e["name"]: e["value"] for e in jc["env"]}
    assert pe == {"CUDA_VISIBLE_DEVICES": "4,1", "CUDA_DEVICE_ORDER": "PCI_BUS_ID"}
    assert je["TPU_VISIBLE_DEVICES"] == pe["CUDA_VISIBLE_DEVICES"]
    assert pc["resources"] == {"limits": {PC.GPU_RESOURCE: "0"}, "requests": {PC.GPU_RESOURCE: "0"}}
    assert jc["resources"] == {"limits": {JC.TPU_RESOURCE: "0"}, "requests": {JC.TPU_RESOURCE: "0"}}
    assert p["metadata"]["annotations"][PC.SERVER_PORT_ANNOTATION] == "8123"
    for pod in (p, j):
        pod["metadata"]["annotations"].pop(pdirect.NOMINAL_HASH_ANNOTATION)
        pod["spec"]["containers"][0].pop("env")
        pod["spec"]["containers"][0].pop("resources")
    assert p == j
    with pytest.raises(ValueError, match="not in the chip map"):
        pdirect.nominal_provider_pod(_requester(PC.GPU_RESOURCE), patch, "n1", [U2], gpu_map)
    # no map entry for the node: sorted-rank indices, as the JAX package
    q = pdirect.nominal_provider_pod(_requester(PC.GPU_RESOURCE), patch, "n9", [U1, U0], gpu_map)
    assert {e["name"]: e["value"] for e in q["spec"]["containers"][0]["env"]}["CUDA_VISIBLE_DEVICES"] == "0,1"


@pytest.mark.parametrize("base,patch", [
    ({"containers": [{"name": "a", "image": "x", "env": [{"name": "E", "value": "1"}]}]},
     {"containers": [{"name": "a", "env": [{"name": "F", "value": "2"}]}, {"name": "b"}]}),
    ({"containers": [{"name": "a"}, {"name": "b"}], "x": 1},
     {"containers": [{"name": "b", "$patch": "delete"}], "x": None}),
    ({"volumes": [{"name": "v", "emptyDir": {}}], "tolerations": [1]}, {"tolerations": [2]}),
])
def test_strategic_merge_as_the_jax_packages(base, patch):
    assert pdirect.strategic_merge(base, patch) == jdirect.strategic_merge(base, patch)


def test_de_individualize_and_engine_port_as_the_jax_packages():
    for res in (PC.GPU_RESOURCE,):
        req = _requester(res)
        assert pdirect.de_individualize(req) == jdirect.de_individualize(req)
        assert pdirect.engine_port_of(req["spec"]) == jdirect.engine_port_of(req["spec"]) == 8123
    with pytest.raises(ValueError):
        pdirect.render_server_patch("{{ .Nope }}", pdirect.ProviderData(node_name="n1"))


def test_load_gpu_map_reads_the_configmap():
    store = pstore.InMemoryStore()
    assert pdirect.load_gpu_map(store, "ns") is None
    store.create({"kind": "ConfigMap", "metadata": {"name": "gpu-map", "namespace": "ns"},
                  "data": {"n1": f"0 {U0}"}})
    assert pdirect.load_gpu_map(store, "ns") == {"n1": [(U0, 0)]}


# -- the populator ------------------------------------------------------------------


def _pop_world(S):
    store = S.store.InMemoryStore()

    async def runtime(pod):
        def run(p):
            p.setdefault("status", {})["podIP"] = "10.0.0.2"
            return p

        store.mutate("Pod", pod["metadata"]["namespace"], pod["metadata"]["name"], run)

    pop = S.pop.Populator(store, S.pop.PopulatorConfig(namespace="ns", launcher_runtime=runtime))
    for n, labels in (("n1", {"pool": "h100"}), ("n2", {"pool": "h100"}), ("n3", {"pool": "other"})):
        store.create({"kind": "Node", "metadata": {"name": n, "labels": labels},
                      "status": {"allocatable": {PC.GPU_RESOURCE: "8"}}})
    store.create({"kind": "LauncherConfig", **json.loads(json.dumps(LC))})
    store.create({"kind": "LauncherConfig", "metadata": {"name": "broken", "namespace": "ns"},
                  "spec": {"podTemplate": {"spec": {}}, "maxInstances": 1}})
    return store, pop


def _pop_script(S):
    store, pop = _pop_world(S)
    seen = []

    def launchers():
        pods = store.list("Pod", "ns", selector={S.C.COMPONENT_LABEL: S.C.LAUNCHER_COMPONENT})
        return sorted((p["spec"]["nodeName"], p["metadata"]["labels"][S.C.LAUNCHER_CONFIG_NAME_LABEL],
                       p["metadata"]["annotations"][S.C.LAUNCHER_CONFIG_HASH_ANNOTATION],
                       p["metadata"]["annotations"][S.C.LAUNCHER_TEMPLATE_HASH_ANNOTATION],
                       json.dumps(p["spec"], sort_keys=True),
                       json.dumps(p["metadata"]["labels"], sort_keys=True))
                      for p in pods if p["metadata"].get("deletionTimestamp") is None)

    def bind_one(p):
        p["metadata"]["annotations"][S.C.REQUESTER_ANNOTATION] = "reqX/uid"
        return p

    def drift(lc):
        lc["spec"]["podTemplate"]["spec"]["containers"][0]["image"] = "launcher:v2"
        return lc

    async def body():
        await pop.start()
        try:
            lpp = json.loads(json.dumps(LPP))
            store.create({"kind": "LauncherPopulationPolicy", **lpp})
            store.create({"kind": "LauncherPopulationPolicy", "metadata": {"name": "p2", "namespace": "ns"},
                          "spec": {"enhancedNodeSelector": {"labelSelector": {"matchLabels": {"pool": "h100"}}},
                                   "countForLauncher": [{"launcherConfigName": "lc1", "launcherCount": 1},
                                                        {"launcherConfigName": "broken", "launcherCount": 1},
                                                        {"launcherConfigName": "missing", "launcherCount": 1}]}})
            await pop.quiesce()
            seen.append(launchers())
            first = store.list("Pod", "ns", selector={S.C.COMPONENT_LABEL: S.C.LAUNCHER_COMPONENT})[0]
            store.mutate("Pod", "ns", first["metadata"]["name"], bind_one)
            store.mutate("LauncherConfig", "ns", "lc1", drift)
            await pop.quiesce()
            seen.append(launchers())
            store.delete("LauncherPopulationPolicy", "ns", "p1")
            await pop.quiesce()
            seen.append(launchers())
        finally:
            await pop.stop()

    asyncio.run(body())
    statuses = {f"{o['kind']}/{o['metadata']['name']}": o.get("status") for o in store.all_objects()
                if o["kind"] in ("LauncherConfig", "LauncherPopulationPolicy")}
    return seen, statuses


def test_the_populator_populates_binds_drifts_and_scales_down_as_the_jax_populators():
    assert _pop_script(SIDES["port"]) == _pop_script(SIDES["jax"])


def test_launcher_templates_and_specialization_as_the_jax_packages():
    plc, jlc = ptypes.LauncherConfig.from_dict(LC), jtypes.LauncherConfig.from_dict(LC)
    assert ppop.build_launcher_template(plc) == jpop.build_launcher_template(jlc)
    _, thash = ppop.build_launcher_template(plc)
    assert ppop.specialize_to_node(plc, "n1", thash) == jpop.specialize_to_node(jlc, "n1", thash)
    exp = ppop.PendingExpectations(timeout_s=0.05)
    exp.expect_creation("u1")
    assert exp.check(set()) == ppop.WAITING
    assert exp.check({"u1"}) == ppop.SATISFIED
    exp.expect_deletion("u2")
    time.sleep(0.06)
    assert exp.check({"u2"}) == ppop.TIMED_OUT


# -- metrics ------------------------------------------------------------------------


def test_metrics_expose_the_jax_packages_names_and_the_prometheus_text_format():
    import prometheus_client as pc

    from llm_d_fast_model_actuation_tpu.controller import metrics as jmetrics

    for name in ("ACTUATION_SECONDS", "LAUNCHER_CREATE_SECONDS", "HTTP_LATENCY", "DUALITY", "REQUESTER_COUNT",
                 "ISC_COUNT", "LAUNCHER_POD_COUNT", "INNER_QUEUE_DEPTH", "INNER_QUEUE_ADDS",
                 "INNER_QUEUE_RETRIES", "WORK_DURATION", "QUEUE_DURATION"):
        j, p = getattr(jmetrics, name), getattr(pmetrics, name)
        assert (p.name, p.documentation, p.labelnames) == (j._name, j._documentation, j._labelnames)
        if hasattr(j, "_upper_bounds"):
            assert list(p.buckets) + [float("inf")] == list(j._upper_bounds)
    reg = pc.CollectorRegistry()
    jh = pc.Histogram("t_seconds", "doc", ["a"], buckets=(0.5, 1, 5), registry=reg)
    jc = pc.Counter("t_events_total", "doc", ["a"], registry=reg)
    jg = pc.Gauge("t_depth", "doc", ["a"], registry=reg)
    n0 = len(pmetrics.REGISTRY)
    ph = pmetrics.Histogram("t_seconds", "doc", ["a"], buckets=(0.5, 1, 5))
    pcnt = pmetrics.Counter("t_events_total", "doc", ["a"])
    pg = pmetrics.Gauge("t_depth", "doc", ["a"])
    try:
        for v in (0.2, 0.7, 3.0, 9.0):
            jh.labels(a='x"y').observe(v)
            ph.labels(a='x"y').observe(v)
        jc.labels(a="1").inc(2)
        pcnt.labels(a="1").inc(2)
        jg.labels(a="z").set(7)
        pg.labels(a="z").set(7)
        want = [ln for ln in pc.generate_latest(reg).decode().splitlines() if "_created" not in ln]
        got = pmetrics.exposition().splitlines()
        assert [ln for ln in got if ln.startswith(("t_", "# HELP t_", "# TYPE t_"))] == want
    finally:
        del pmetrics.REGISTRY[n0:]


def test_metrics_are_served_over_http():
    import urllib.request

    server = pmetrics.serve_metrics(0, "127.0.0.1")
    try:
        pmetrics.INNER_QUEUE_ADDS.labels(node="n-metrics").inc()
        with urllib.request.urlopen(f"http://127.0.0.1:{server.server_address[1]}/metrics", timeout=5) as r:
            body = r.read().decode()
        assert 'fma_dpc_innerqueue_adds_total{node="n-metrics"} 1.0' in body
        assert "# TYPE fma_actuation_seconds histogram" in body
    finally:
        server.shutdown()
        server.server_close()


# -- the kube store -----------------------------------------------------------------


@pytest.fixture(scope="module")
def apiserver():
    """One fake apiserver for the module: stopping one waits 10 s."""
    from fake_apiserver import FakeApiServer

    srv = FakeApiServer()
    srv.start()
    yield srv
    srv.stop()


def _pod(name, labels=None, big=0):
    return {"kind": "Pod", "metadata": {"name": name, "namespace": "ns", "labels": dict(labels or {}),
                                        "annotations": {"blob": "x" * big} if big else {}},
            "spec": {"nodeName": "n1"}}


async def _until(cond, timeout=15.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError("condition not met")
        await asyncio.sleep(0.05)


def test_kubestore_reads_writes_watches_and_conflicts_over_the_kube_protocol(apiserver):
    from llm_d_fast_model_actuation_tpu_torch.controller.kubestore import KubeStore

    async def scenario():
        ks = KubeStore(f"http://127.0.0.1:{apiserver.port}", "ns", kinds=["Pod"])
        await ks.start()
        try:
            created = ks.create(_pod("p1", {"app": "x"}))
            assert created["metadata"]["uid"] and ks.get("Pod", "ns", "p1")["metadata"]["labels"] == {"app": "x"}
            ks.create(_pod("p2", {"app": "y"}))
            assert [p["metadata"]["name"] for p in ks.list("Pod", "ns", selector={"app": "x"})] == ["p1"]
            # an external writer's change arrives through the watch stream,
            # an event larger than 64 KB included
            apiserver.store.create(_pod("p3", big=200_000))
            await _until(lambda: ks.try_get("Pod", "ns", "p3") is not None)
            assert len(ks.get("Pod", "ns", "p3")["metadata"]["annotations"]["blob"]) == 200_000
            # optimistic concurrency: a stale resourceVersion conflicts
            stale = ks.get("Pod", "ns", "p1")
            ks.mutate("Pod", "ns", "p1", lambda p: p["metadata"]["labels"].update(v="1") or p)
            with pytest.raises(pstore.Conflict):
                ks.update(stale)
            # finalizers: delete leaves it terminating until they clear
            ks.mutate("Pod", "ns", "p2", lambda p: p["metadata"].update(finalizers=["f"]) or p)
            ks.delete("Pod", "ns", "p2")
            assert ks.get("Pod", "ns", "p2")["metadata"].get("deletionTimestamp") is not None
            ks.mutate("Pod", "ns", "p2", lambda p: p["metadata"].update(finalizers=[]) or p)
            await _until(lambda: ks.try_get("Pod", "ns", "p2") is None)
            apiserver.store.delete("Pod", "ns", "p3")
            await _until(lambda: ks.try_get("Pod", "ns", "p3") is None)
            with pytest.raises(pstore.NotFound):
                ks.get("Pod", "ns", "p3")
        finally:
            await ks.stop()

    asyncio.run(scenario())


def test_the_controller_binds_and_unbinds_over_the_kube_protocol(apiserver):
    from llm_d_fast_model_actuation_tpu_torch.controller.kubestore import KubeStore

    async def scenario():
        ks = KubeStore(f"http://127.0.0.1:{apiserver.port}", "ns", kinds=None)
        await ks.start()
        h = ptesting.Harness(store=ks)
        await h.controller.start()
        try:
            h.add_lc("lc1")
            h.add_isc("isc1", "lc1")
            h.add_requester("req1", "isc1", chips=[U0])
            await _until(lambda: h.spis["req1"].ready)
            (lp,) = ks.list("Pod", "ns", selector={PC.COMPONENT_LABEL: PC.LAUNCHER_COMPONENT})
            assert lp["metadata"]["annotations"][PC.REQUESTER_ANNOTATION].startswith("req1/")
            ks.delete("Pod", "ns", "req1")

            def asleep():
                pods = ks.list("Pod", "ns", selector={PC.COMPONENT_LABEL: PC.LAUNCHER_COMPONENT})
                return pods and pods[0]["metadata"]["labels"].get(PC.SLEEPING_LABEL) == "true"

            await _until(asleep)
            await _until(lambda: ks.try_get("Pod", "ns", "req1") is None)
        finally:
            await h.controller.stop()
            await ks.stop()

    asyncio.run(scenario())
