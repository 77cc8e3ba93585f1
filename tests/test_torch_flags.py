"""The port's engine flags against the reference's ``make_arg_parser``, as
tests/test_torch_routes.py holds the routes: every flag of the reference is
the port's, or named here with the ROADMAP queue 1 item that ports it;
the port adds only ``--device``. The six serving flags (ROADMAP queue 3
item 11) and the two of co-residency reach the engine they build."""

import pytest

from llm_d_fast_model_actuation_tpu.engine import server as jserver
from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver

#: the reference's flags the port does not have yet, by ROADMAP queue 1 item
UNPORTED_FLAGS = {
    "--checkpoint-dir": 2,  # Orbax checkpoints
    "--sleep-release-devices": 6,  # device release
    "--quantization": 13,
    "--speculative-ngram": 13,
    "--pipeline-decode": 13,
    "--coordinator-address": 15,  # multi-host gangs
    "--num-processes": 15,
    "--process-id": 15,
}
#: the port's own: the card or the CPU, and a rank per device on a mesh
PORT_ONLY = {"--device"}


def _flags(parser) -> dict:
    return {s: a for a in parser._actions for s in a.option_strings if s.startswith("--") and s != "--help"}


def test_the_flag_set_is_the_references_less_the_named_ones():
    ref, port = _flags(jserver.make_arg_parser()), _flags(tserver.make_arg_parser())
    assert set(UNPORTED_FLAGS) <= set(ref) and not set(UNPORTED_FLAGS) & set(port)
    assert set(port) - set(ref) == PORT_ONLY
    assert set(ref) - set(port) == set(UNPORTED_FLAGS)


@pytest.mark.parametrize("flag", ["--prefix-caching", "--decode-chunk", "--drain-tail", "--max-prefill-tokens",
                                  "--logprobs-topk", "--arrival-ewma-tau-s", "--resident-variants",
                                  "--variant-hbm-mib"])
def test_a_ported_flag_keeps_the_references_default_and_choices(flag):
    ref, port = _flags(jserver.make_arg_parser())[flag], _flags(tserver.make_arg_parser())[flag]
    assert port.choices == ref.choices and port.type == ref.type
    # the one default the port changes: no budget (the reference's 1024 MiB
    # would refuse one Llama-3-8B lm_head pair, 2004 MiB)
    if flag != "--variant-hbm-mib":
        assert port.default == ref.default


def test_the_serving_flags_reach_the_engine():
    svc = tserver.EngineService(tserver.parse_engine_options(
        "--model tiny --num-pages 32 --page-size 8 --max-batch 2 --max-model-len 64 --device cpu "
        "--prefix-caching off --decode-chunk 4 --drain-tail single --max-prefill-tokens 16 --logprobs-topk 3 "
        "--arrival-ewma-tau-s 5"))
    try:
        cfg = svc.engine.cfg
        assert (cfg.prefix_caching, cfg.decode_chunk, cfg.max_prefill_tokens, cfg.logprobs_topk) == (False, 4, 16, 3)
        assert svc.engine.prefix_cache is None and svc._arrival.tau_s == 5.0
        out = svc.submit(prompt=list(range(1, 40)), max_new_tokens=6, want_top_logprobs=True).result(timeout=120)
        assert len(out.out_tokens) == 6 and all(len(a) == 3 for a in out.out_top_logprobs)
    finally:
        svc.shutdown()


def test_decode_chunk_0_means_8():
    svc = tserver.EngineService(tserver.parse_engine_options(
        "--model tiny --num-pages 32 --page-size 8 --max-batch 2 --max-model-len 64 --device cpu"))
    try:
        assert svc.engine.cfg.decode_chunk == 8 and svc.engine.prefix_cache is not None
    finally:
        svc.shutdown()


@pytest.mark.parametrize("opts,match", [
    ("--drain-tail chunk", "not ported"),
    ("--decode-chunk -1", "decode-chunk"),
    ("--max-prefill-tokens -1", "max-prefill-tokens"),
    ("--arrival-ewma-tau-s 0", "arrival-ewma-tau-s"),
    ("--prefix-caching maybe", "invalid"),
])
def test_a_bad_serving_flag_is_refused(opts, match):
    with pytest.raises(ValueError, match=match):
        tserver.parse_engine_options(f"--model tiny {opts}")
