"""The port's standard-library HTTP server (engine/server.py), driven over
real sockets with urllib on port 0, on the CPU; its completion response
is held to the JAX EngineService's JSON keys for the same token-id
request."""

import asyncio
import json
import urllib.error
import urllib.request

import pytest
from aiohttp.test_utils import TestClient, TestServer

from llm_d_fast_model_actuation_tpu.engine import server as jserver
from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver

OPTS = "--model tiny --num-pages 32 --page-size 8 --max-batch 2 --max-model-len 64 --seed 0"


@pytest.fixture
def port_server():
    svc = tserver.EngineService(tserver.parse_engine_options(OPTS + " --device cpu"))
    http = tserver.serve(svc, "127.0.0.1", 0)
    yield svc, http.server_address[1]
    http.shutdown()
    svc.shutdown()


def _call(port, method, path, body=None, raw=None):
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _keys(body):
    return (
        set(body),
        set(body["choices"][0]),
        set(body["usage"]),
    )


def _jax_completion(request_body):
    svc = jserver.EngineService(jserver.parse_engine_options(OPTS))

    async def scenario():
        client = TestClient(TestServer(jserver.build_app(svc)))
        await client.start_server()
        try:
            r = await client.post("/v1/completions", json=request_body)
            assert r.status == 200
            return await r.json()
        finally:
            await client.close()

    try:
        return asyncio.run(scenario())
    finally:
        svc.shutdown()


def test_completion_keys_match_the_jax_service(port_server):
    _, port = port_server
    body = {"prompt": [1, 2, 3], "max_tokens": 3}
    status, got = _call(port, "POST", "/v1/completions", body)
    assert status == 200
    assert len(got["choices"][0]["token_ids"]) == 3
    assert got["usage"]["prompt_tokens"] == 3
    assert _keys(got) == _keys(_jax_completion(body))


def test_health_models_and_bad_requests(port_server):
    _, port = port_server
    assert _call(port, "GET", "/health") == (200, {"status": "OK"})
    status, two = _call(port, "POST", "/v1/completions", {"prompt": [3, 4], "max_tokens": 2, "n": 2})
    assert status == 200 and [c["index"] for c in two["choices"]] == [0, 1]
    assert _call(port, "POST", "/v1/completions", {"prompt": [3], "n": 3})[0] == 400  # > max_batch
    status, models = _call(port, "GET", "/v1/models")
    assert status == 200 and models["data"][0]["id"] == "tiny"
    # the reference's 400s for token-id prompts
    assert _call(port, "POST", "/v1/completions", raw=b"junk")[0] == 400
    assert _call(port, "POST", "/v1/completions", {"prompt": []})[0] == 400
    assert _call(port, "POST", "/v1/completions", {"prompt": [1] * 63, "max_tokens": 10})[0] == 400
    # a string prompt goes through the byte tokenizer; chat validates its
    # messages; echo with logprobs answers the prompt's logprobs too
    status, text = _call(port, "POST", "/v1/completions", {"prompt": "hi", "max_tokens": 2})
    assert status == 200 and text["usage"]["prompt_tokens"] == 2
    assert _call(port, "POST", "/v1/completions", {"prompt": [1], "stream": True, "n": 2})[0] == 400
    status, err = _call(port, "POST", "/v1/chat/completions", {"messages": []})
    assert status == 400 and "messages" in err["error"]
    status, echo = _call(port, "POST", "/v1/completions", {"prompt": [1, 2], "echo": True, "logprobs": True,
                                                           "max_tokens": 1})
    lp = echo["choices"][0]["logprobs"]
    assert status == 200 and lp["tokens"][:2] == [1, 2] and lp["token_logprobs"][0] is None
    assert len(lp["token_logprobs"]) == 3 and all(v <= 0 for v in lp["token_logprobs"][1:])


def test_sleep_wake_over_http(port_server):
    svc, port = port_server
    body = {"prompt": [5, 6, 7, 8], "max_tokens": 6}
    _, before = _call(port, "POST", "/v1/completions", body)
    status, info = _call(port, "POST", "/sleep?level=1")
    assert status == 200 and info["is_sleeping"] and info["bytes_offloaded"] > 0
    assert _call(port, "GET", "/is_sleeping")[1]["is_sleeping"] is True
    status, info = _call(port, "POST", "/wake_up")
    assert status == 200 and not info["is_sleeping"]
    assert _call(port, "GET", "/is_sleeping")[1]["is_sleeping"] is False
    _, after = _call(port, "POST", "/v1/completions", body)
    assert after["choices"][0]["token_ids"] == before["choices"][0]["token_ids"]
    assert _call(port, "POST", "/sleep?level=3")[0] == 400
    # level 2, then wake: weights re-initialized from the seed, serving resumes
    assert _call(port, "POST", "/sleep?level=2")[1]["level"] == 2
    assert _call(port, "POST", "/wake_up")[0] == 200
    status, again = _call(port, "POST", "/v1/completions", body)
    assert status == 200 and again["choices"][0]["token_ids"] == before["choices"][0]["token_ids"]


def test_tensor_parallel_server_equals_one_rank():
    """``--tensor-parallel-size 2 --device cpu,cpu``: two ranks driven by
    the one engine thread serve the completion one rank serves, and a
    sleep/wake cycle in between leaves it unchanged."""
    body = {"prompt": [5, 6, 7, 8], "max_tokens": 6}
    got = {}
    for opts in ("--device cpu", "--tensor-parallel-size 2 --device cpu,cpu",
                 "--tensor-parallel-size 2 --device cpu --packed-serving on"):
        svc = tserver.EngineService(tserver.parse_engine_options(OPTS + " " + opts))
        http = tserver.serve(svc, "127.0.0.1", 0)
        try:
            port = http.server_address[1]
            status, first = _call(port, "POST", "/v1/completions", body)
            assert status == 200
            if "parallel" in opts:
                assert svc.engine.mesh.tp == 2 and len(svc.engine.pool.shards) == 2
                assert _call(port, "POST", "/sleep?level=1")[1]["bytes_offloaded"] == got["sleep"]
                assert _call(port, "POST", "/wake_up")[0] == 200
                assert _call(port, "POST", "/v1/completions", body)[1]["choices"] == first["choices"]
            else:
                assert svc.engine.mesh is None
                got["sleep"] = _call(port, "POST", "/sleep?level=1")[1]["bytes_offloaded"]
                assert _call(port, "POST", "/wake_up")[0] == 200
            got[opts] = first["choices"][0]["token_ids"]
        finally:
            http.shutdown()
            svc.shutdown()
    assert len({tuple(ids) for o, ids in got.items() if o != "sleep"}) == 1


@pytest.mark.parametrize("bad", [
    "--tensor-parallel-size 0",
    "--tensor-parallel-size -2",
    "--tensor-parallel-size 2 --device cpu,cpu,cpu",  # a list of the wrong length
    "--device cpu,cpu",  # a list for one rank
    "--tensor-parallel-size two",
])
def test_tensor_parallel_options_are_checked(bad):
    with pytest.raises(ValueError):
        tserver.parse_engine_options(OPTS + " " + bad)


def test_tensor_parallel_on_cuda_needs_the_cards(monkeypatch):
    import torch

    args = tserver.parse_engine_options(OPTS + " --tensor-parallel-size 2")
    assert args.device == "cuda" and args.tensor_parallel_size == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="needs 2 devices, have 0"):
        tserver.EngineService(args)  # a single cuda means the first N cards
    assert tserver.mesh_from_options(tserver.parse_engine_options(OPTS + " --device cpu")) is None
    mesh = tserver.mesh_from_options(tserver.parse_engine_options(OPTS + " --tensor-parallel-size 2 --device cpu"))
    assert [str(d) for d in mesh.devices] == ["cpu", "cpu"]  # a single other device is every rank's


@pytest.mark.parametrize("opts,refused", [
    ("--page-size 12 --packed-serving on --device cuda", True),
    ("--page-size 12 --packed-serving on --tensor-parallel-size 2 --device cuda:0,cuda:0", True),
    ("--page-size 12 --packed-serving off --device cuda", False),  # decode takes any page size
    ("--page-size 12 --packed-serving on --device cpu", False),  # the plain versions do too
    ("--page-size 16 --packed-serving on --device cuda", False),
])
def test_packed_page_size_is_checked_at_start(opts, refused):
    """On the card the packed path's ragged kernel takes only the page
    sizes in ``ops/cuda/ragged.py:PAGE_SIZES``: another is refused when
    the options are parsed, naming them, not at the first packed step."""
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda.ragged import PAGE_SIZES

    opts = OPTS.replace("--page-size 8 ", "") + " " + opts
    if refused:
        with pytest.raises(ValueError, match=r"--page-size in \(8, 16, 32, 64\)"):
            tserver.parse_engine_options(opts)
        assert PAGE_SIZES == (8, 16, 32, 64)
    else:
        assert tserver.parse_engine_options(opts).page_size in (12, 16)
