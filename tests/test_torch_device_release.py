"""Device release on sleep (``engine/device.py``, ``sleep(level,
release=True)``, ``--sleep-release-devices``) against the JAX package's
``tests/test_device_release.py``, by meaning.

The reference destroys its PJRT client, because a TPU chip admits one
live client. On a GPU, contexts coexist: a release gives back the card
memory a sleeping engine holds beyond its CUDA context (its captured
graphs and their pool, the allocator's cache, cuBLAS's workspaces), and
the wake captures the graphs again. On the CPU an engine captures no
graph, so the graph cases give every engine stand-in graphs whose
replays rerun the chunk's body (``test_torch_exec_pool.py``'s
``stand_in_graphs``): a release drops them and a wake captures them again.

Each case compares greedy tokens with the JAX engine on converted weights
(float32 tiny Llama, so greedy decoding is off the bf16 near-tie edge):
exact, no tolerance.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_exec_pool import stand_in_graphs  # noqa: F401 — a fixture

from llm_d_fast_model_actuation_tpu.engine import engine as jengine
from llm_d_fast_model_actuation_tpu.engine import server as jserver
from llm_d_fast_model_actuation_tpu.models import llama as jllama
from llm_d_fast_model_actuation_tpu_torch.engine import engine as tengine
from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver
from llm_d_fast_model_actuation_tpu_torch.engine.device import reacquire_devices, release_devices
from llm_d_fast_model_actuation_tpu_torch.engine.sleep import attach_sleep
from llm_d_fast_model_actuation_tpu_torch.models.convert import config_from_jax, params_from_jax
from llm_d_fast_model_actuation_tpu_torch.parallel.mesh import MeshPlan, make_mesh

BASE = dict(max_batch=2, page_size=8, num_pages=32, max_seq_len=64)


def _pair():
    """The JAX engine and the port's on its converted weights (fp32)."""
    jm = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    jeng = jengine.InferenceEngine(jengine.EngineConfig(model=jm, **BASE), seed=0)
    state = params_from_jax(jax.tree.map(np.asarray, jeng.params))
    tcfg = tengine.EngineConfig(model=config_from_jax(jm), **BASE)
    return jeng, tcfg, state


def _port(**kw):
    jeng, tcfg, state = _pair()
    return jeng, tengine.InferenceEngine(tcfg, params=state, device="cpu", **kw)


def test_release_and_reacquire_roundtrip(stand_in_graphs):  # noqa: F811
    """Bare: the graphs dropped, then captured again, one set; the
    engine serves what it served, through replays."""
    jeng, eng = _port()
    gold = jeng.generate([[5, 6, 7, 8]], max_new_tokens=6)
    assert eng.graphs.captured and eng.graph_captures == 4
    mgr = attach_sleep(eng)
    mgr.sleep(1)
    got = release_devices([eng])
    assert got["graphs_released"] == 1 and not eng.graphs.captured
    mgr.wake_up()
    assert reacquire_devices([eng]) >= 0.0
    assert eng.graphs.captured and eng.graph_captures == 8
    replays = eng.graph_replays
    assert eng.generate([[5, 6, 7, 8]], max_new_tokens=6) == gold
    assert eng.graph_replays > replays


def test_sleep_with_release_preserves_generation(stand_in_graphs):  # noqa: F811
    jeng, eng = _port()
    gold = jeng.generate([[5, 6, 7, 8]], max_new_tokens=6)[0]
    assert eng.generate([[5, 6, 7, 8]], max_new_tokens=6)[0] == gold
    mgr = attach_sleep(eng)
    info = mgr.sleep(1, release=True)
    assert info["is_sleeping"] and info["devices_released"] and mgr.devices_released
    assert not eng.graphs.captured and mgr.stats.releases_total == 1
    assert mgr.last_release["graphs_released"] == 1
    info = mgr.wake_up()
    assert not info["is_sleeping"] and not info["devices_released"]
    assert info["last_reacquire_seconds"] >= 0.0 and eng.graphs.captured and eng.graph_captures == 8
    replays = eng.graph_replays
    assert eng.generate([[5, 6, 7, 8]], max_new_tokens=6)[0] == gold, "bit-identical across release"
    assert eng.graph_replays > replays, "the released wake replays the chunk, not eager"


def test_release_midstream_resumes(stand_in_graphs):  # noqa: F811
    """A releasing sleep in the middle of a generation: the KV pages come
    back, the graphs are captured on a blank scheduler state (the live
    sequences untouched) and the sequence goes on bit-exact."""
    jeng, eng = _port()
    gold = jeng.generate([[9, 8, 7]], max_new_tokens=24)[0]
    eng.add_request([9, 8, 7], max_new_tokens=24)
    for _ in range(2):
        eng.step()
    assert eng.has_work()
    pool = [t.clone() for t in eng.pool.tensors()]
    mgr = attach_sleep(eng)
    mgr.sleep(1, release=True)
    mgr.wake_up()
    assert eng.graphs.captured and eng.graph_captures == 8
    # the re-capture's warm-ups wrote the null page (page 0) alone
    for before, after in zip(pool, eng.pool.tensors()):
        assert torch.equal(before[:, 1:], after[:, 1:])
    outs = []
    while eng.has_work():
        outs.extend(eng.step())
    assert outs[0].out_tokens == gold


def test_release_with_mesh_keeps_its_devices(devices8):
    """A tp-2 engine on a ``cpu,cpu`` mesh: GPU (and CPU) devices do not
    die, so the mesh and its devices stay, the state comes back on the
    same ranks, and the tokens are the JAX mesh engine's."""
    from llm_d_fast_model_actuation_tpu.parallel.mesh import MeshPlan as JPlan
    from llm_d_fast_model_actuation_tpu.parallel.mesh import make_mesh as jmake

    jm = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    jeng = jengine.InferenceEngine(jengine.EngineConfig(model=jm, **BASE), mesh=jmake(JPlan(tp=2), devices8[:2]),
                                   seed=0)
    gold = jeng.generate([[1, 2, 3]], max_new_tokens=5)[0]
    mesh = make_mesh(MeshPlan(tp=2), [torch.device("cpu")] * 2)
    state = params_from_jax(jax.tree.map(np.asarray, jeng.params), mesh=mesh, cfg=config_from_jax(jm))
    eng = tengine.InferenceEngine(tengine.EngineConfig(model=config_from_jax(jm), **BASE), params=state, mesh=mesh)
    assert eng.generate([[1, 2, 3]], max_new_tokens=5)[0] == gold
    ptrs = [p.data_ptr() for p in eng.model.parameters()]
    mgr = attach_sleep(eng)
    assert mgr.sleep(1, release=True)["devices_released"]
    old_mesh = eng.mesh
    mgr.wake_up()
    assert eng.mesh is old_mesh and eng.mesh.devices == old_mesh.devices
    assert [p.data_ptr() for p in eng.model.parameters()] == ptrs
    assert eng.generate([[1, 2, 3]], max_new_tokens=5)[0] == gold


def test_level2_release_discards_and_reinit(stand_in_graphs):  # noqa: F811
    """A releasing level-2 sleep keeps no host copy; the wake writes the
    weights again in place (here the JAX engine's, converted), zeroes the
    pool, captures the graphs again and serves the JAX engine's tokens."""
    jeng, eng = _port()
    gold = jeng.generate([[3, 1, 4]], max_new_tokens=3)[0]
    state = {k: v.clone() for k, v in eng.model.state_dict().items()}
    eng.generate([[3, 1, 4]], max_new_tokens=3)
    mgr = attach_sleep(eng)
    info = mgr.sleep(2, release=True)
    assert info["devices_released"] and info["bytes_offloaded"] == 0
    assert mgr._host_state is None and not eng.graphs.captured

    def reinit():
        eng.model.load_state_dict(state)
        for t in eng.pool.tensors():
            t.zero_()

    mgr.wake_up(reinit=reinit)
    assert eng.graphs.captured and not mgr.devices_released
    assert eng.generate([[3, 1, 4]], max_new_tokens=3)[0] == gold


def test_level2_discard_and_reinit():
    """The mirror of ``tests/test_engine.py::test_level2_discard_and_reinit``:
    a level-2 sleep keeps no host copy, and a wake that writes the same
    weights again serves the JAX engine's tokens."""
    jeng, eng = _port()
    gold = jeng.generate([[3, 1, 4, 1, 5]], max_new_tokens=6)[0]
    state = {k: v.clone() for k, v in eng.model.state_dict().items()}
    mgr = attach_sleep(eng)
    info = mgr.sleep(2)
    assert info["level"] == 2 and info["bytes_offloaded"] == 0 and not info["devices_released"]
    with pytest.raises(ValueError, match="reinit"):
        mgr.wake_up()

    def reinit():
        eng.model.load_state_dict(state)
        for t in eng.pool.tensors():
            t.zero_()

    mgr.wake_up(reinit=reinit)
    assert eng.generate([[3, 1, 4, 1, 5]], max_new_tokens=6)[0] == gold


def test_a_release_escalates_a_sleep_and_is_refused_without_a_device():
    _, eng = _port()
    mgr = attach_sleep(eng)
    mgr.sleep(1)
    assert not mgr.devices_released
    assert mgr.sleep(2, release=True)["devices_released"] and mgr.stats.releases_total == 1
    from llm_d_fast_model_actuation_tpu_torch.engine.sleep import SleepManager

    bare = SleepManager(lambda: {}, lambda s: None, "cpu", [])
    with pytest.raises(ValueError, match="no device to release"):
        bare.sleep(1, release=True)


OPTS = "--model tiny --num-pages 32 --page-size 8 --max-batch 2 --max-model-len 64 --seed 0"


@pytest.mark.parametrize("mode,released", [("auto", False), ("always", True), ("never", False)])
def test_the_flag_resolves_as_the_references_off_the_tpu(monkeypatch, mode, released):
    """auto is off off the TPU in both packages (the default path does not
    change), always releases, never does not; zero-drain parking is off
    for a releasing sleep; /is_sleeping and /v1/device report it."""
    import json
    import urllib.request

    ref = jserver.EngineService(jserver.parse_engine_options(f"{OPTS} --sleep-release-devices {mode}"))
    svc = tserver.EngineService(tserver.parse_engine_options(
        f"{OPTS} --sleep-release-devices {mode} --device cpu --zero-drain on"))
    http = tserver.serve(svc, "127.0.0.1", 0)
    port = http.server_address[1]
    try:
        assert svc.release_on_sleep == ref.release_on_sleep == released
        assert svc.engine.zero_drain_park == (not released)
        before = svc.submit(prompt=[1, 2, 3], max_new_tokens=5).result(timeout=120).out_tokens
        out = svc.sleep(1)
        assert out["devices_released"] == released
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/is_sleeping", timeout=30) as r:
            assert json.loads(r.read()) == {"is_sleeping": True, "devices_released": released}
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/device", timeout=30) as r:
            dev = json.loads(r.read())
        assert dev["devices_released"] == released and dev["memory"]["mapped_bytes"] == 0
        assert ("graphs_released" in dev["released"]) == released and "released" not in dev["memory"]
        svc.wake_up()
        assert svc.submit(prompt=[1, 2, 3], max_new_tokens=5).result(timeout=120).out_tokens == before
        assert svc.sleeper.stats.releases_total == int(released)
    finally:
        http.shutdown()
        svc.shutdown()
        ref.shutdown()


def test_the_launcher_reads_devices_released_and_a_sleeper_never_blocks():
    """The GPU exclusivity rule: a sleeping holder does not block, released
    or not (the reference's TPU rule needs it released); the launcher's
    probe reads the engine's ``/is_sleeping`` over HTTP."""
    import http.server
    import threading
    import types

    from conftest import free_port

    from llm_d_fast_model_actuation_tpu_torch.launcher import manager as pmgr

    answer = {}

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps(answer).encode()
            self.send_response(200 if self.path == "/is_sleeping" else 404)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    port = free_port()
    inst = types.SimpleNamespace(config=types.SimpleNamespace(options=f"--model tiny --port {port}"))
    assert pmgr.probe_instance_awake(inst) is None  # nothing listens yet
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        for body, awake in (({"is_sleeping": True, "devices_released": True}, False),
                            ({"is_sleeping": True, "devices_released": False}, False),
                            ({"is_sleeping": False, "devices_released": False}, True)):
            answer.clear()
            answer.update(body)
            assert pmgr.probe_instance_awake(inst) is awake
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()
