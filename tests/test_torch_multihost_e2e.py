"""The port's gang, for real: TWO engine processes joined by a
``torch.distributed`` Gloo group, a tp 2 mesh spanning them (one CPU rank
each), leader/follower lockstep stepping (engine/multihost.py).

The port's counterpart of tests/test_multihost_e2e.py, with the same
traffic (tests/torch_gang_worker.py): the tiny Llama at fp32, its weights
the JAX engine's carried by ``models/convert.py``. The gang's greedy
tokens must equal, bit for bit, those of the port's one-process tp 2
engine on ``cpu,cpu`` serving the same traffic and those of the JAX
``InferenceEngine`` for the same prompts; a prefix-cache hit and a chunked
prefill are replayed by the follower; a level-1 sleep and wake keep the
first token; the shutdown is clean. A follower killed mid-serve makes the
leader exit ``EXIT_GANG_PEER_LOST``, and an idle gang outlives a short
timeout on its exchanges' group. Every wait on a child has its own
timeout, so a hang fails the test.
"""

import dataclasses
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_d_fast_model_actuation_tpu.engine import engine as jengine
from llm_d_fast_model_actuation_tpu.models import llama as jllama
from llm_d_fast_model_actuation_tpu_torch.engine.multihost import EXIT_GANG_PEER_LOST

from conftest import REPO_ROOT, cpu_subprocess_env, free_port

sys.path.insert(0, f"{REPO_ROOT}/tests")
import torch_gang_worker as worker  # noqa: E402

JAX_CFG = dict(max_batch=2, page_size=8, num_pages=32, max_seq_len=64, decode_chunk=4, max_prefill_tokens=8)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX engine (fp32 tiny) and its parameters saved for the workers."""
    jm = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32, attention_impl="reference")
    jeng = jengine.InferenceEngine(jengine.EngineConfig(model=jm, **JAX_CFG), seed=0)
    tree = jax.tree.map(np.asarray, jeng.params)
    path = tmp_path_factory.mktemp("gang") / "weights.npz"
    worker.save_tree(tree, str(path))
    return jeng, tree, str(path)


def _spawn(pid, port, path, *mode, env=None, out=subprocess.PIPE):
    e = cpu_subprocess_env(**(env or {}))
    e["PYTHONPATH"] = f"{REPO_ROOT}:{REPO_ROOT}/tests"
    return subprocess.Popen([sys.executable, f"{REPO_ROOT}/tests/torch_gang_worker.py", str(pid), "2", str(port),
                             path, *mode], env=e, stdout=out, stderr=subprocess.STDOUT, text=True)


def _gang(path, *mode, env=None, timeout=85):
    """Start the follower, then the leader; their outputs once both ended."""
    port = free_port()
    procs = [_spawn(pid, port, path, *mode, env=env) for pid in (1, 0)]
    try:
        follower, leader = procs
        out, _ = leader.communicate(timeout=timeout)
        fout, _ = follower.communicate(timeout=30)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert leader.returncode == 0, f"leader failed:\n{out}\n--follower--\n{fout}"
    assert follower.returncode == 0, f"follower failed:\n{fout}\n--leader--\n{out}"
    return out, fout


def _lines(out):
    return {tag: rest for tag, _, rest in (line.partition(" ") for line in out.splitlines())
            if tag and tag[0].isupper() and tag.isalnum()}


def _tokens(s):
    return [int(t) for t in s.split(",")]


@pytest.mark.e2e
def test_two_process_gang_serves_and_sleeps(weights, monkeypatch):
    jeng, tree, path = weights
    out, fout = _gang(path)
    got = {k: v for k, v in _lines(out).items() if k not in ("READY", "DONE", "SLEPT", "OUT3")}

    # the port's one-process tp 2 engine on cpu,cpu, the same traffic
    from llm_d_fast_model_actuation_tpu_torch.engine import server

    worker.carry(tree, monkeypatch)
    svc = server.EngineService(server.parse_engine_options(f"{worker.OPTIONS} --device cpu,cpu"))
    one = {}
    try:
        worker.traffic(svc, lambda tag, toks: one.__setitem__(tag, ",".join(map(str, toks))))
    finally:
        svc.shutdown()
    assert got == one

    # the JAX engine, for the same prompts
    assert _tokens(got["OUT1"]) == jeng.generate([[5, 6, 7]], max_new_tokens=6)[0]
    assert [_tokens(got["OUT2A"]), _tokens(got["OUT2B"])] == jeng.generate([[1, 2], [3, 4]], max_new_tokens=5)
    assert _tokens(got["PREFIXA"]) == _tokens(got["PREFIXB"]) == jeng.generate([list(range(1, 12))],
                                                                               max_new_tokens=3)[0]
    assert _tokens(got["CHUNKED"]) == jeng.generate([list(range(30, 50))], max_new_tokens=4)[0]

    lines = _lines(out)
    after, before = lines["OUT3"].split()
    assert after == before, "generation changed across the gang's sleep and wake"
    assert int(lines["SLEPT"]) > 0
    assert "DONE 0" in out and "DONE 1" in fout


@pytest.mark.e2e
def test_gang_member_death_tears_down_the_gang(weights, tmp_path):
    """A follower killed mid-serve must not leave the gang wedged in an
    exchange: the watchdog turns the death into the leader exiting
    EXIT_GANG_PEER_LOST, the signal the launcher's sentinel turns into
    the crash chain."""
    _, _, path = weights
    port = free_port()
    logs = {pid: open(tmp_path / f"gang-{pid}.log", "w+") for pid in (1, 0)}
    procs = {pid: _spawn(pid, port, path, "serve-wait", env={"FMA_GANG_HEARTBEAT_TIMEOUT": "2"}, out=logs[pid])
             for pid in (1, 0)}
    try:
        deadline = time.time() + 80
        served = False
        while time.time() < deadline:
            logs[0].seek(0)
            if "SERVED" in logs[0].read():
                served = True
                break
            if any(p.poll() is not None for p in procs.values()):
                break
            time.sleep(0.2)
        assert served, _tail(logs)
        t0 = time.monotonic()
        procs[1].send_signal(signal.SIGKILL)
        procs[0].wait(timeout=60)
        assert procs[0].returncode == EXIT_GANG_PEER_LOST, (procs[0].returncode, _tail(logs))
        assert time.monotonic() - t0 < 30, _tail(logs)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        for f in logs.values():
            f.close()


@pytest.mark.e2e
def test_an_idle_gang_outlives_a_short_exchange_timeout(weights):
    """The follower waits for its next frame for as long as the leader is
    idle: with the exchanges' group timeout at 2 s, a 5 s idle spell must
    not end the gang (the frame group has its own, long timeout)."""
    _, _, path = weights
    out, fout = _gang(path, "idle", "5")
    lines = _lines(out)
    assert lines["BEFORE"] == lines["AFTER"] and len(_tokens(lines["AFTER"])) == 4
    assert "DONE 1" in fout


def _tail(logs):
    out = {}
    for pid, f in logs.items():
        f.seek(0)
        out[pid] = f.read()[-2000:]
    return out
