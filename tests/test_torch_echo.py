"""Prompt logprobs (``echo`` with ``logprobs``) in the port's server,
held against the reference's ``build_app`` service at fp32 on one tiny
``hf:`` directory (the pattern of ``tests/test_torch_service.py``): the
same replies, logprobs within 1e-4, on the bucketed and on the packed
path (whose echo requests fall back to the bucketed prefill in the same
step). And the figure chip_smoke.py's ``ECHO_LOGPROB_TOL`` is argued
from: at fp32 a prompt's logprobs at the positions of its own greedy
continuation equal the decode's logprobs of those tokens within
``ECHO_FP32_TOL``."""

import asyncio
import json
import urllib.request

import pytest
from aiohttp.test_utils import TestClient, TestServer

from llm_d_fast_model_actuation_tpu.engine import server as jserver
from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver
from tests.test_torch_service import _same, fp32, model_dir  # noqa: F401 — fixtures

OPTS = "--num-pages 32 --page-size 8 --max-batch 2 --max-model-len 64 --seed 0"
REQUESTS = [
    {"prompt": [5, 6, 7, 8, 9, 10, 11], "max_tokens": 3, "ignore_eos": True, "logprobs": 2, "echo": True},
    {"prompt": "the quick brown fox", "max_tokens": 2, "ignore_eos": True, "logprobs": True, "echo": True},
    {"prompt": [5, 6, 7, 8, 9, 10, 11], "max_tokens": 2, "ignore_eos": True, "logprobs": True, "echo": True, "n": 2},
]
#: prompt logprobs against the decode's own at fp32 on the CPU: the two
#: paths sum in other orders, so they agree to fp32 rounding
ECHO_FP32_TOL = 2e-5


def _reference(model_dir, packed: str) -> list:
    svc = jserver.EngineService(jserver.parse_engine_options(f"--model hf:{model_dir} {OPTS} --packed-serving {packed}"))

    async def scenario():
        client = TestClient(TestServer(jserver.build_app(svc)))
        await client.start_server()
        try:
            out = []
            for body in REQUESTS:
                r = await client.post("/v1/completions", json=body)
                out.append((r.status, await r.json()))
            return out
        finally:
            await client.close()

    try:
        return asyncio.run(scenario())
    finally:
        svc.shutdown()


def _post(port: int, body: dict):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions", method="POST",
                                 data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


@pytest.mark.parametrize("packed", ["off", "on"], ids=["bucketed", "packed"])
def test_echo_logprobs_answer_as_the_reference(model_dir, fp32, packed):  # noqa: F811
    svc = tserver.EngineService(tserver.parse_engine_options(
        f"--model hf:{model_dir} {OPTS} --device cpu --packed-serving {packed}"))
    http = tserver.serve(svc, "127.0.0.1", 0)
    try:
        got = [_post(http.server_address[1], body) for body in REQUESTS]
        colds = svc.engine.cold_prefills
    finally:
        http.shutdown()
        svc.shutdown()
    want = _reference(model_dir, packed)
    for (status, body), (want_status, want_body) in zip(got, want):
        assert status == want_status == 200
        _same(body, want_body)
        lp = body["choices"][0]["logprobs"]
        assert lp["token_logprobs"][0] is None and len(lp["tokens"]) == len(lp["token_logprobs"])
    # every echo bypassed the prefix cache: a cold prefill each (the
    # n = 2 siblings: only the first asks for the prompt's logprobs)
    assert colds >= len(REQUESTS)


def test_prompt_logprobs_equal_the_decodes_at_fp32(model_dir, fp32):  # noqa: F811
    svc = tserver.EngineService(tserver.parse_engine_options(f"--model hf:{model_dir} {OPTS} --device cpu"))
    try:
        prompt = [5, 6, 7, 8, 9, 10, 11]
        own = svc.submit(prompt=prompt, max_new_tokens=12, ignore_eos=True).result(timeout=120)
        echo = svc.submit(prompt=prompt + own.out_tokens, max_new_tokens=1, ignore_eos=True,
                          want_prompt_logprobs=True).result(timeout=120)
    finally:
        svc.shutdown()
    plp = echo.prompt_logprobs
    assert len(plp) == len(prompt) + 12 and plp[0] is None
    err = max(abs(a - b) for a, b in zip(plp[len(prompt):], own.out_logprobs))
    assert err <= ECHO_FP32_TOL, err
