"""End to end on the CPU: one trace across three processes of the port,
as ``tests/test_tracing_e2e.py`` shows it for the JAX package. This test
(the controller's seat, a client span) -> the port's launcher (REST with a
``traceparent``) -> its fork server's engine child (the launcher's rpc
header, and the create's context as the child body's argument): the
merged spans hold the launcher's verbs and rpcs, the child's startup
parented on the create, and the swap's device-transfer spans, all one
trace; each process exports Chrome trace events, which the JAX module's
``spans_from_chrome`` reads too."""

import json
import subprocess
import sys

import pytest
from conftest import REPO_ROOT, cpu_subprocess_env, free_port

from llm_d_fast_model_actuation_tpu.utils import tracing as jtracing
from llm_d_fast_model_actuation_tpu_torch.utils import tracing
from tests.test_torch_launcher_e2e import call, tiny_options, wait_ok


def _chrome_spans(url: str):
    status, body = call(url, timeout=30)
    payload = json.loads(body)
    assert status == 200 and payload["traceEvents"], url
    for e in payload["traceEvents"]:
        assert {"name", "ph", "ts", "dur", "pid", "tid", "args"} <= set(e) and e["ph"] == "X"
    assert len(jtracing.spans_from_chrome(payload)) == len(payload["traceEvents"])
    return tracing.spans_from_chrome(payload)


@pytest.mark.e2e
@pytest.mark.tracing
def test_single_trace_across_launcher_and_engine(tmp_path):
    launcher_port, engine_port = free_port(), free_port()
    out = open(tmp_path / "launcher.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "llm_d_fast_model_actuation_tpu_torch.launcher.main", "--mock-chips",
         "--mock-chip-count", "2", "--mock-topology", "1x2", "--host", "127.0.0.1", "--port", str(launcher_port),
         "--log-dir", str(tmp_path)],
        cwd=REPO_ROOT, env=cpu_subprocess_env(), stdout=out, stderr=subprocess.STDOUT,
    )
    base, engine = f"http://127.0.0.1:{launcher_port}", f"http://127.0.0.1:{engine_port}"
    trace_id, root_span = "ab" * 16, "cd" * 8
    header = {"traceparent": f"00-{trace_id}-{root_span}-01", "Content-Type": "application/json"}
    try:
        wait_ok(base + "/health")
        status, body = call(base + "/v2/vllm/instances/tr1", "PUT",
                            {"options": f"{tiny_options(engine_port)} --swap-bucket-mib 1"}, headers=header)
        assert status == 201, body
        wait_ok(engine + "/health")
        # the launcher's family stays on the launcher's port: the child
        # drops the copy its fork server's registry held
        assert b"fma_launcher_rpc_seconds" in call(base + "/metrics")[1]
        assert b"fma_launcher_rpc_seconds" not in call(engine + "/metrics")[1]
        for model in ("tiny-gemma", "tiny"):  # cold, then a pool hit
            status, body = call(base + "/v2/vllm/instances/tr1/swap", "POST", {"model": model}, headers=header,
                                timeout=300)
            assert status == 200, body
        assert json.loads(body)["swap"]["pool_hit"] is True

        launcher_spans = _chrome_spans(base + "/v2/vllm/traces")
        engine_spans = _chrome_spans(engine + "/v1/traces")
        creates = [s for s in launcher_spans if s.name == "launcher.create_instance" and s.trace_id == trace_id]
        assert creates and creates[0].parent_id == root_span
        lswaps = [s for s in launcher_spans if s.name == "launcher.swap" and s.trace_id == trace_id]
        rpcs = [s for s in launcher_spans if s.name == "launcher.rpc" and s.trace_id == trace_id]
        assert len(lswaps) == 2 and rpcs and all(s.attrs.get("outcome") == "ok" for s in rpcs)
        eswaps = [s for s in engine_spans if s.name == "engine.swap" and s.trace_id == trace_id]
        assert len(eswaps) == 2 and all(s.parent_id in {r.span_id for r in rpcs} for s in eswaps)
        starts = [s for s in engine_spans if s.name == "engine.start"]
        assert starts and starts[0].trace_id == trace_id and starts[0].parent_id == creates[0].span_id
        assert starts[0].pid != creates[0].pid

        merged = {s.span_id: s for s in launcher_spans + engine_spans}

        def ancestors(s):
            names, cur = set(), s
            while cur.parent_id in merged:
                cur = merged[cur.parent_id]
                names.add(cur.name)
            return names

        xfers = [s for s in engine_spans if s.name in ("swap.d2h", "swap.h2d") and s.trace_id == trace_id]
        assert xfers and all(int(s.attrs["bytes"]) > 0 for s in xfers)
        assert any({"swap.transfer", "engine.swap", "launcher.rpc", "launcher.swap"} <= ancestors(s) for s in xfers)
        assert {s.trace_id for s in creates + lswaps + rpcs + eswaps + starts + xfers} == {trace_id}
        tree = tracing.render_tree([s for s in merged.values() if s.trace_id == trace_id])
        assert "launcher.swap" in tree and "swap.transfer" in tree and "engine.start" in tree
    finally:
        call(base + "/v2/vllm/instances", "DELETE", timeout=30)
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
        out.close()
