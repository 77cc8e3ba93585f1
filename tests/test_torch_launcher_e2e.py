"""End to end on the CPU: the port's launcher as its own process (mock
cards) forks a real port engine child (``--model tiny --device cpu``),
driven only through the launcher's REST API and the child's HTTP, with
``urllib`` (the card's machine has no ``requests``). Mirrors
``tests/test_e2e_launcher.py::test_full_instance_lifecycle``."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
from conftest import REPO_ROOT, cpu_subprocess_env, free_port


def call(url, method="GET", body=None, headers=None, timeout=60):
    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def wait_ok(url, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if call(url, timeout=2)[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise TimeoutError(f"{url} never answered 200")


def closed(url) -> bool:
    try:
        call(url, timeout=2)
    except OSError:
        return True
    return False


def start_launcher(log_dir):
    port = free_port()
    out = open(os.path.join(log_dir, "launcher.log"), "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "llm_d_fast_model_actuation_tpu_torch.launcher.main", "--mock-chips",
         "--mock-chip-count", "4", "--mock-topology", "2x2", "--host", "127.0.0.1", "--port", str(port),
         "--log-dir", str(log_dir)],
        cwd=REPO_ROOT, env=cpu_subprocess_env(), stdout=out, stderr=subprocess.STDOUT,
    )
    base = f"http://127.0.0.1:{port}"
    wait_ok(base + "/health")
    return proc, base


@pytest.fixture(scope="module")
def launcher(tmp_path_factory):
    proc, base = start_launcher(tmp_path_factory.mktemp("launcher-logs"))
    try:
        yield base
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()


def tiny_options(port: int) -> str:
    return (f"--model tiny --device cpu --port {port} --num-pages 32 --max-batch 2 "
            f"--page-size 8 --max-model-len 64")


@pytest.mark.e2e
def test_full_instance_lifecycle(launcher):
    status, body = call(launcher + "/v2/vllm/instances")
    assert status == 200 and json.loads(body)["total_instances"] == 0
    engine_port = free_port()
    status, body = call(launcher + "/v2/vllm/instances/e2e-1", "PUT",
                        {"options": tiny_options(engine_port), "gpu_uuids": ["tpu-mock-0-1"]})
    assert status == 201, body
    created = json.loads(body)
    assert created["status"] == "started" and created["env_vars"]["CUDA_VISIBLE_DEVICES"] == "1"
    engine = f"http://127.0.0.1:{engine_port}"
    wait_ok(engine + "/health")

    prompt = {"prompt": [1, 2, 3, 4], "max_tokens": 4}
    status, body = call(engine + "/v1/completions", "POST", prompt)
    assert status == 200, body
    out1 = json.loads(body)["choices"][0]["token_ids"]
    assert len(out1) == 4

    # the admin contract: sleep -> is_sleeping -> wake -> the same greedy tokens
    assert json.loads(call(engine + "/is_sleeping")[1])["is_sleeping"] is False
    status, body = call(engine + "/sleep?level=1", "POST", {})
    assert status == 200 and json.loads(body)["is_sleeping"] is True
    assert json.loads(call(engine + "/is_sleeping")[1])["is_sleeping"] is True
    status, body = call(engine + "/wake_up", "POST", {})
    assert status == 200 and json.loads(body)["is_sleeping"] is False
    assert json.loads(call(engine + "/v1/completions", "POST", prompt)[1])["choices"][0]["token_ids"] == out1
    dev = json.loads(call(engine + "/v1/device")[1])
    assert dev["device"] == "cpu" and dev["launches"]["probe"] == 0
    # on the CPU: no allocator and no graphs; the arena holds the awake state
    memory = dev["memory"]
    assert memory["mapped_bytes"] > 0
    assert memory == {"reserved_bytes": 0, "allocated_bytes": 0, "graph_kernel_nodes": 0, "mapped_bytes": memory["mapped_bytes"]}

    # the launcher sees it running; a ranged log read
    assert json.loads(call(launcher + "/v2/vllm/instances/e2e-1")[1])["status"] == "running"
    status, body = call(launcher + "/v2/vllm/instances/e2e-1/log", headers={"Range": "bytes=0-63"})
    assert status == 206 and 0 < len(body) <= 64

    # delete tears the child down
    status, body = call(launcher + "/v2/vllm/instances/e2e-1", "DELETE", timeout=30)
    assert status == 200 and json.loads(body)["status"] == "terminated"
    assert json.loads(call(launcher + "/v2/vllm/instances")[1])["total_instances"] == 0
    time.sleep(0.3)
    assert closed(engine + "/health")


@pytest.mark.e2e
def test_sigterm_to_the_launcher_stops_its_children(tmp_path):
    proc, base = start_launcher(tmp_path)
    try:
        engine_port = free_port()
        status, body = call(base + "/v2/vllm/instances/x", "PUT", {"options": tiny_options(engine_port)})
        assert status == 201, body
        wait_ok(f"http://127.0.0.1:{engine_port}/health")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert closed(f"http://127.0.0.1:{engine_port}/health")
    finally:
        if proc.poll() is None:
            proc.kill()
