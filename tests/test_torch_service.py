"""The port's server on a Hugging Face checkpoint directory, held against
the reference's ``build_app`` service on the same ``hf:`` directory
(tests/conftest.py's tiny model with its tiny BPE tokenizer), through the
same requests in the same order: completions with string prompts and
stops, ``logprobs``, chat, the SSE streams of both, and ``/v1/stats``;
then what only the port checks here (a level-2 wake rereads the
directory, the refusal to start on tokenizer files without
transformers), sampling's static ``top_k`` against the reference's
``sample``, and chip_smoke.py's parity gate at a tiny size.

Both servers run the checkpoint in fp32 (``config_from_hf``'s ``dtype``
override, patched in on both sides for the test): two bf16 programs in
two frameworks round differently and meet bf16 near-ties within a few
tokens (the hazard the ROADMAP names), while what is held here is the
serving surface. So greedy text is compared exactly, and logprob values
within 1e-4."""

import asyncio
import builtins
import dataclasses
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from llm_d_fast_model_actuation_tpu.engine import sampling as jsampling
from llm_d_fast_model_actuation_tpu.engine import server as jserver
from llm_d_fast_model_actuation_tpu_torch.engine import sampling as tsampling
from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver
from tests.conftest import build_tiny_hf_model_dir

OPTS = "--num-pages 32 --page-size 8 --max-batch 2 --max-model-len 64 --seed 0"
CHAT = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hello world"}]
#: (method, path, body, streamed) in order, sent to both servers
REQUESTS = [
    ("POST", "/v1/completions", {"prompt": "hello world", "max_tokens": 6, "ignore_eos": True}, False),
    ("POST", "/v1/completions", {"prompt": "the quick brown fox", "max_tokens": 8, "ignore_eos": True,
                                 "logprobs": 2}, False),
    ("POST", "/v1/completions", {"prompt": "hello world", "max_tokens": 6, "ignore_eos": True}, True),
    ("POST", "/v1/chat/completions", {"messages": CHAT, "max_tokens": 6, "ignore_eos": True}, False),
    ("POST", "/v1/chat/completions", {"messages": CHAT, "max_tokens": 6, "ignore_eos": True, "logprobs": True,
                                      "top_logprobs": 2}, False),
    ("POST", "/v1/chat/completions", {"messages": CHAT, "max_tokens": 6, "ignore_eos": True}, True),
    ("POST", "/v1/completions", {"prompt": "günther", "max_tokens": 4, "n": 2, "ignore_eos": True}, False),
    ("POST", "/v1/completions", {"prompt": "x", "max_tokens": 2, "n": 2, "stream": True}, None),
    ("POST", "/v1/chat/completions", {"messages": [{"role": "user"}]}, None),
    ("GET", "/v1/models", None, False),
    ("GET", "/v1/stats", None, False),
    # after the stats: echo with logprobs, the prompt's logprobs too
    ("POST", "/v1/completions", {"prompt": [5, 6, 7], "max_tokens": 5, "ignore_eos": True, "logprobs": True,
                                 "echo": True}, False),
    ("POST", "/v1/completions", {"prompt": [5, 6, 7], "max_tokens": 5, "ignore_eos": True, "echo": True}, False),
]
#: per-request timings: their values differ from run to run
TIMES = {"time_to_first_token_s", "queue_wait_s", "decode_tpot_s", "uptime_s", "arrival_rate_rps"}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return build_tiny_hf_model_dir(str(tmp_path_factory.mktemp("hf") / "model"))


@pytest.fixture(scope="module")
def fp32():
    """Both packages' ``config_from_hf`` with ``dtype`` forced to fp32."""
    from llm_d_fast_model_actuation_tpu.models import hf as jhf
    from llm_d_fast_model_actuation_tpu_torch.models import hf as thf

    jcfg, tcfg = jhf.config_from_hf, thf.config_from_hf
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhf, "config_from_hf", lambda path, **kw: jcfg(path, **dict(kw, dtype=jnp.float32)))
        mp.setattr(thf, "config_from_hf", lambda path, **kw: tcfg(path, **dict(kw, dtype=torch.float32)))
        yield


def _sse(raw: bytes) -> list:
    events = []
    for line in raw.decode().splitlines():
        if line.startswith("data: "):
            p = line[6:]
            events.append(p if p == "[DONE]" else json.loads(p))
    return events


def _reference(model_dir) -> list:
    svc = jserver.EngineService(jserver.parse_engine_options(f"--model hf:{model_dir} {OPTS}"))

    async def scenario():
        client = TestClient(TestServer(jserver.build_app(svc)))
        await client.start_server()
        out = []
        try:
            for method, path, body, streamed in REQUESTS:
                r = await (client.post(path, json=body) if method == "POST" else client.get(path))
                raw = await r.read()
                out.append((r.status, _sse(raw) if streamed and r.status == 200 else
                            (json.loads(raw) if r.status == 200 else None)))
        finally:
            await client.close()
        return out

    try:
        return asyncio.run(scenario())
    finally:
        svc.shutdown()


def _port(svc) -> list:
    http = tserver.serve(svc, "127.0.0.1", 0)
    port = http.server_address[1]
    out = []
    try:
        for method, path, body, streamed in REQUESTS:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}", method=method,
                data=None if body is None else json.dumps(body).encode(),
                headers={"Content-Type": "application/json"},
            )
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    raw = r.read()
                    out.append((r.status, _sse(raw) if streamed else json.loads(raw)))
            except urllib.error.HTTPError as e:
                out.append((e.code, None))
    finally:
        http.shutdown()
    return out


def _same(got, want, path="") -> None:
    """Field for field: the same keys and types everywhere, equal values
    but for timings (types only) and logprobs (within 1e-4)."""
    assert type(got) is type(want) or {type(got), type(want)} <= {int, float}, (path, got, want)
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            if k in TIMES:
                assert (got[k] is None) == (want[k] is None), (path, k)
            else:
                _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), (path, got, want)
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{path}[{i}]")
    elif isinstance(want, float) and "logprob" in path:
        assert abs(got - want) <= 1e-4, (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.fixture(scope="module")
def both(model_dir, fp32):
    svc = tserver.EngineService(tserver.parse_engine_options(f"--model hf:{model_dir} {OPTS} --device cpu"))
    try:
        port = _port(svc)
    finally:
        svc.shutdown()
    return port, _reference(model_dir), svc


@pytest.mark.parametrize("i", range(len(REQUESTS)), ids=[f"{m} {p} {i}" for i, (m, p, _, _) in enumerate(REQUESTS)])
def test_the_port_answers_as_the_reference(both, i):
    """Each request's status and JSON (or SSE events) equal the
    reference's field for field, the greedy text equal; ``/v1/stats``
    over the blocks the port has (its ``load`` and ``pool`` blocks are its
    own), after
    the same requests. Echo with logprobs answers the prompt's logprobs
    as the reference does, within the same 1e-4."""
    port, ref, _ = both
    (status, got), (want_status, want) = port[i], ref[i]
    assert status == want_status
    if REQUESTS[i][1] == "/v1/stats":
        assert got.pop("load")["loads"] == 1
        pool = got.pop("pool")  # the port's own block, as load is
        assert pool["models"] == [] and pool["budget_bytes"] == 4096 << 20
        quant = got.pop("quant")  # the port's own block too
        assert quant["mode"] == "off" and quant["last_swap"] is None
        engine = got.pop("engine")  # and its step counters
        assert engine["cold_prefills"] >= 1 and engine["decode_steps"] >= 1
        # the oracle's summary: the same accuracy figures; the bandwidths
        # are measured, so only their kinds (a subset: the port's load
        # times its copies on the card only) compare
        costs, want_costs = got.pop("costs"), want["costs"]
        last, want_last = costs["prediction"].pop("last"), dict(want_costs["prediction"]["last"])
        assert last["kind"] == "coldload" and last["trigger"] == "startup" and last["actual_s"] >= 0
        for row in (last, want_last):  # the wall clock and the build's seconds
            del row["t_wall"], row["actual_s"]
        _same(last, want_last)
        _same(costs["prediction"], {k: v for k, v in want_costs["prediction"].items() if k != "last"})
        assert set(costs["bandwidth_gibps"]) <= set(want_costs["bandwidth_gibps"])
        shared = {k: want[k] for k in got}
        assert set(got) <= set(want)
        _same(got, shared)
        return
    if REQUESTS[i][1] == "/v1/models":
        assert got["data"][0]["id"].startswith("hf:")
    _same(got, want)


def test_the_service_resolves_the_directory(both, model_dir):
    _, _, svc = both
    assert svc.cfg.eos_token_id == 2 and svc.hf_dir == model_dir and svc.cfg.model.dtype == torch.float32
    assert isinstance(svc.tokenizer, tserver.tokenizer_mod.HFTokenizer)
    assert svc.load_stats.tensors == 21 and svc.load_stats.shards == 1


def test_level2_wake_rereads_the_directory(model_dir):
    """A level-2 sleep discards the weights; the wake writes them again
    from the directory into the same tensors: the loads counter moves,
    the weights and greedy tokens equal those before, no address moves."""
    svc = tserver.EngineService(tserver.parse_engine_options(f"--model hf:{model_dir} {OPTS} --device cpu"))
    try:
        eng = svc.engine
        before = svc.submit(prompt=[3, 1, 4, 1, 5], max_new_tokens=6).result(timeout=60).out_tokens
        weights = {k: v.clone() for k, v in eng.model.state_dict().items()}
        ptrs = [t.data_ptr() for t in list(eng.model.parameters()) + eng.pool.tensors()]
        svc.sleep(2)
        svc.wake_up()
        assert svc.loads == 2
        assert all(torch.equal(v, weights[k]) for k, v in eng.model.state_dict().items())
        assert [t.data_ptr() for t in list(eng.model.parameters()) + eng.pool.tensors()] == ptrs
        assert svc.submit(prompt=[3, 1, 4, 1, 5], max_new_tokens=6).result(timeout=60).out_tokens == before
        stats = svc.stats()
        assert stats["load"]["loads"] == 2 and stats["actuations"] == {"sleep": 1, "wake": 1}
    finally:
        svc.shutdown()


def test_tokenizer_files_without_transformers_refuse_to_start(model_dir, monkeypatch):
    real = builtins.__import__

    def no_transformers(name, *a, **kw):
        if name == "transformers" or name.startswith("transformers."):
            raise ImportError("No module named 'transformers'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(RuntimeError, match="transformers"):
        tserver.EngineService(tserver.parse_engine_options(f"--model hf:{model_dir} {OPTS} --device cpu"))


def test_parse_rejects_empty_hf_path():
    with pytest.raises(ValueError, match="hf:"):
        tserver.parse_engine_options("--model hf:")
    with pytest.raises(ValueError, match="hf:"):
        jserver.parse_engine_options("--model hf:")
    assert tserver.parse_engine_options("--model hf:/no/such/dir").model == "hf:/no/such/dir"


@pytest.mark.parametrize("top_k", [0, 1, 3, 40, 256])
def test_sample_top_k_matches_the_reference(top_k):
    """Greedy rows: token, logprob and alternatives equal the reference's
    ``sample`` with the same static ``top_k`` (the logprob normalized
    over the truncated logits); sampled rows draw only from the top k."""
    rng = np.random.default_rng(top_k)
    b, vocab = 4, 256
    logits = rng.normal(size=(b, vocab)).astype(np.float32) * 3
    temps = np.zeros((b,), np.float32)
    want = jsampling.sample(jnp.asarray(logits), jax.random.key(0), jnp.asarray(temps), top_k=top_k, alt_k=3)
    got = tsampling.sample(torch.from_numpy(logits), torch.from_numpy(temps), top_k=top_k, alt_k=3)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    finite = np.isfinite(np.asarray(want[2]))  # alternatives cut by top_k tie at -inf, in any order
    assert np.array_equal(got[3].numpy()[finite], np.asarray(want[3])[finite])
    if 0 < top_k < vocab:
        hot = torch.ones((b,), dtype=torch.float32)
        noise = tsampling.gumbel(torch.rand((b, tsampling.noise_width(vocab)), generator=torch.Generator().manual_seed(1)))
        tok = tsampling.sample(torch.from_numpy(logits), hot, noise, top_k=top_k)[0]
        kth = torch.from_numpy(logits).topk(top_k, dim=-1).values[:, -1]
        assert bool((torch.from_numpy(logits).gather(1, tok.long()[:, None])[:, 0] >= kth).all())


def test_parity_gate_at_a_tiny_size():
    """chip_smoke.py's parity gate on a four-layer model on the CPU: the
    port's bf16 paths at tp 1 and tp 2 (``cpu,cpu``) pass against its
    fp32 oracle, the pairwise figures of mixed_step/prefill and the two
    decode branches are what the CPU's plain versions give, and both
    planted faults are refused."""
    import chip_smoke as cs
    from llm_d_fast_model_actuation_tpu_torch.models import llama
    from llm_d_fast_model_actuation_tpu_torch.parallel.mesh import serving_mesh

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab=512), num_layers=4, hidden_size=128, head_dim=32,
                              intermediate_size=256, max_seq_len=512)
    one = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    two = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu", mesh=serving_mesh(2, ["cpu", "cpu"]))
    run = cs.parity_logits(torch, one, two, seed=5, n=60)
    oracle, figures, pairwise = cs.parity_figures(torch, one, run)
    assert cs.parity_gate(figures, cfg.num_layers) == [], figures
    assert all(f["rel_l2"] > 0 for f in figures.values())
    faults = cs.planted_faults(torch, one, two, run, oracle, figures)
    assert set(faults) == {"w_down_reduce_drops_rank1", "kv_heads_swapped"}
    assert all(f["refused"] and f["rel_l2"] > cs.parity_limit(cfg.num_layers) for f in faults.values())
    # the oracle is the plain forward: at fp32 weights and fp32 paths it
    # equals the port's forward to fp32 rounding
    one32 = llama.init_params(dataclasses.replace(cfg, dtype=torch.float32), torch.Generator().manual_seed(0), "cpu")
    two32 = llama.init_params(dataclasses.replace(cfg, dtype=torch.float32), torch.Generator().manual_seed(0), "cpu",
                              mesh=serving_mesh(2, ["cpu", "cpu"]))
    run32 = cs.parity_logits(torch, one32, two32, seed=5, n=60)
    _, figures32, _ = cs.parity_figures(torch, one32, run32)
    assert max(f["rel_l2"] for f in figures32.values()) < 1e-5, figures32
