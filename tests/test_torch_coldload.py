"""The port's pipelined loader (``models/hf.py:load_params``), held
against the reference's on the CPU.

* The host-only staging (``place=False``, the prefetch's path): the port's
  tree against the reference's ``load_params(place=False)``, leaf for
  leaf, bit-equal (a cast is round to nearest even on both sides; no
  tolerance), at a bf16 and an fp32 checkpoint into a bf16 config and at
  an fp32 config, and the digest strings equal.
* Within the port: one reader against four, into a model and on the
  host, bit-equal; an abort raises ``LoadAborted``, before a byte is
  staged or between tensors; a shard the index declares but the directory
  lacks fails before anything is read; a missing layer slice is named;
  the fault points and the throttle; ``estimate_param_bytes``.
* The engine's build order: the warm-up runs after the weights load, on
  the building thread, and the result is the same tokens; a load that
  fails runs no warm-up. ``/v1/stats`` never waits for the load's
  digests, and a sleep does.
"""

import json
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.models import hf as jhf
from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver
from llm_d_fast_model_actuation_tpu_torch.engine.chunk_store import DigestJob, digest_leaves
from llm_d_fast_model_actuation_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from llm_d_fast_model_actuation_tpu_torch.models import hf as thf
from llm_d_fast_model_actuation_tpu_torch.models import llama as tllama
from llm_d_fast_model_actuation_tpu_torch.utils import faults
from tests.conftest import build_sharded_hf_model_dir


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A four-layer checkpoint in several shards, fp32 and bf16."""
    root = tmp_path_factory.mktemp("coldload")
    return {
        "fp32": build_sharded_hf_model_dir(str(root / "fp32")),
        "bf16": build_sharded_hf_model_dir(str(root / "bf16"), torch_dtype=torch.bfloat16),
    }


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _bytes(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(t).tobytes()


@pytest.mark.parametrize("source,dtype", [("bf16", "bf16"), ("fp32", "bf16"), ("fp32", "fp32")])
def test_host_staging_is_bit_equal_to_the_reference(ckpt, source, dtype):
    d = ckpt[source]
    jcfg = jhf.config_from_hf(d, **({"dtype": jnp.float32} if dtype == "fp32" else {}))
    tcfg = thf.config_from_hf(d, **({"dtype": torch.float32} if dtype == "fp32" else {}))
    jst = jhf.LoadStats()
    want = dict(_flat(jhf.load_params(d, jcfg, place=False, stats=jst, want_digests=True)))
    tst = thf.LoadStats()
    got = dict(_flat(thf.load_params(d, tcfg, place=False, workers=3, stats=tst, want_digests=True)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in (got[k],))
        assert tuple(got[k].shape) == want[k].shape and str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert _bytes(got[k]) == _bytes(want[k]), k
    assert tst.digests == jst.digests and len(tst.digests) == 12
    assert tst.workers == 3 and tst.shards == jst.shards > 1 and not tst.streaming and tst.bytes_h2d == 0
    assert tst.bytes_read == jst.bytes_read and tst.tensors > 0


def test_one_reader_and_four_are_bit_equal(ckpt):
    d = ckpt["bf16"]
    cfg = thf.config_from_hf(d)
    one, four = tllama.Llama(cfg, "cpu"), tllama.Llama(cfg, "cpu")
    st1 = thf.load_params(d, one, workers=1)
    st4 = thf.load_params(d, four, workers=4, max_inflight_bytes=64 << 10)  # small buffers: many chunks
    for (k, a), (_, b) in zip(one.state_dict().items(), four.state_dict().items()):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), k
    assert (st1.workers, st4.workers) == (1, 3) and st1.streaming and st4.bytes_read == st1.bytes_read
    host1 = dict(_flat(thf.load_params(d, cfg, place=False, workers=1)))
    host4 = dict(_flat(thf.load_params(d, cfg, place=False, workers=4)))
    assert all(_bytes(host1[k]) == _bytes(host4[k]) for k in host1)
    # the staged tree placed into a model is the direct load, bit for bit
    placed = tllama.Llama(cfg, "cpu")
    st = thf.place_staged_params(thf.load_params(d, cfg, place=False), placed)
    assert st.bytes_h2d == sum(t.numel() * t.element_size() for t in placed.parameters())
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(one.state_dict().values(), placed.state_dict().values()))


def test_an_abort_raises_load_aborted(ckpt):
    d = ckpt["bf16"]
    cfg = thf.config_from_hf(d)
    ev = threading.Event()
    ev.set()
    model = tllama.Llama(cfg, "cpu")
    for p in model.parameters():
        p.fill_(7.0)
    with pytest.raises(thf.LoadAborted):
        thf.load_params(d, model, abort_event=ev, workers=2)
    assert all(bool((p == 7.0).all()) for p in model.parameters()), "an aborted load staged a tensor"
    with pytest.raises(thf.LoadAborted):
        thf.load_params(d, cfg, place=False, abort_event=ev)
    # set mid-read: the throttle holds the readers, the abort ends them
    ev = threading.Event()
    st = thf.LoadStats()
    threading.Timer(0.3, ev.set).start()
    t0 = time.monotonic()
    with pytest.raises(thf.LoadAborted):
        thf.load_params(d, cfg, place=False, abort_event=ev, throttle_bytes_per_s=100_000, stats=st)
    assert time.monotonic() - t0 < 5 and 0 < st.bytes_read < sum(
        t.numel() * t.element_size() for t in tllama.Llama(cfg, "cpu").parameters())


def test_an_absent_declared_shard_fails_before_staging(ckpt, tmp_path, monkeypatch):
    import shutil

    d = str(tmp_path / "m")
    shutil.copytree(ckpt["bf16"], d)
    os.remove(os.path.join(d, sorted(f for f in os.listdir(d) if f.endswith(".safetensors"))[-1]))
    opened = []
    real = thf._Shard.__init__
    monkeypatch.setattr(thf._Shard, "__init__", lambda self, *a: opened.append(a) or real(self, *a))
    cfg = thf.config_from_hf(d)
    for target, place in ((tllama.Llama(cfg, "cpu"), True), (cfg, False)):
        with pytest.raises(FileNotFoundError, match="not present"):
            thf.load_params(d, target, place=place, workers=4)
    assert not opened, "a shard was opened before the shard set was checked"


def test_a_missing_layer_slice_is_named_from_any_schedule(ckpt, tmp_path):
    import shutil

    from safetensors.torch import load_file, save_file

    d = str(tmp_path / "m")
    shutil.copytree(ckpt["bf16"], d)
    victim = "model.layers.1.mlp.gate_proj.weight"
    with open(os.path.join(d, "model.safetensors.index.json")) as f:
        shard = json.load(f)["weight_map"][victim]
    sd = load_file(os.path.join(d, shard))
    del sd[victim]
    save_file(sd, os.path.join(d, shard))
    cfg = thf.config_from_hf(d)
    for target, place, workers in ((tllama.Llama(cfg, "cpu"), True, 1), (cfg, False, 4)):
        with pytest.raises(ValueError, match="slices never staged") as e:
            thf.load_params(d, target, place=place, workers=workers)
        assert "layers.w_gate: 1/4 slices never staged" in str(e.value) and "(1,)" in str(e.value)


def test_the_fault_points_fire(ckpt):
    d = ckpt["bf16"]
    cfg = thf.config_from_hf(d)
    faults.arm_spec("coldload.read=fail:1")
    with pytest.raises(faults.FaultError, match="coldload.read"):
        thf.load_params(d, cfg, place=False, workers=2)
    faults.arm_spec("coldload.h2d=fail:1")
    with pytest.raises(faults.FaultError, match="coldload.h2d"):
        thf.load_params(d, tllama.Llama(cfg, "cpu"))
    tree = thf.load_params(d, cfg, place=False)  # no transfer: the point does not fire
    faults.arm_spec("coldload.h2d=fail:1")
    with pytest.raises(faults.FaultError, match="coldload.h2d"):
        thf.place_staged_params(tree, tllama.Llama(cfg, "cpu"))


def test_the_throttle_bounds_the_read_rate(ckpt):
    d = ckpt["bf16"]
    cfg = thf.config_from_hf(d)
    st = thf.LoadStats()
    rate = 1_000_000  # bytes/s: the 0.43 MB checkpoint takes at least 0.4 s
    thf.load_params(d, cfg, place=False, throttle_bytes_per_s=rate, stats=st, workers=2)
    assert st.total_s >= 0.9 * st.bytes_read / rate


def test_estimate_param_bytes_equals_the_staged_bytes_and_the_reference(ckpt):
    d = ckpt["fp32"]
    cfg = thf.config_from_hf(d)
    tree = dict(_flat(thf.load_params(d, cfg, place=False)))
    assert thf.estimate_param_bytes(cfg) == sum(t.numel() * t.element_size() for t in tree.values())
    assert thf.estimate_param_bytes(cfg) == jhf.estimate_param_bytes(jhf.config_from_hf(d))


def test_a_digest_job_equals_the_digests_waited_for(ckpt):
    cfg = thf.config_from_hf(ckpt["bf16"])
    model = tllama.Llama(cfg, "cpu")
    thf.load_params(ckpt["bf16"], model)
    leaves = thf.model_leaves(model)
    job = DigestJob(leaves, workers=3)
    got = job.result()
    assert got == digest_leaves(leaves, workers=1) == thf.model_digests(model)
    assert job.seconds > 0 and all(len(v) == 2 for v in job.times.values())


def _engine_cfg(cfg):
    return EngineConfig(model=cfg, max_batch=2, page_size=8, num_pages=32, max_seq_len=64)


def _tokens(eng):
    return eng.generate([[1, 2, 3], [5, 6, 7, 8, 9]], max_new_tokens=6)


def test_the_warmup_runs_after_the_load_and_changes_no_token(ckpt, monkeypatch):
    """Prefill buckets run once each on the building thread, after the
    loader wrote the weights; the tokens are the ones of an engine built
    without a warm-up."""
    d = ckpt["fp32"]
    cfg = thf.config_from_hf(d, dtype=torch.float32)
    plain = InferenceEngine(_engine_cfg(cfg), params=lambda m: thf.load_params(d, m), device="cpu")
    want = _tokens(plain)
    events = []
    real_prefill = InferenceEngine.warm_prefill

    def warm_prefill(self, bucket):
        events.append(("warm", threading.current_thread().name))
        real_prefill(self, bucket)

    def load(model):
        thf.load_params(d, model)
        events.append(("load", threading.current_thread().name))

    monkeypatch.setattr(InferenceEngine, "warm_prefill", warm_prefill)
    eng = InferenceEngine(_engine_cfg(cfg), params=load, device="cpu", warmup_buckets=(3, 16, 40))
    me = threading.current_thread().name
    assert events == [("load", me), ("warm", me), ("warm", me)]  # buckets 16 and 64
    w = eng.warmup_stats
    assert w["programs"] == w["compiled"] == 2 and w["capture_s"] == 0 and w["load_s"] > 0
    assert _tokens(eng) == want


def test_a_load_that_fails_runs_no_warmup(ckpt, monkeypatch):
    warmed = []
    monkeypatch.setattr(InferenceEngine, "warm_prefill", lambda self, bucket: warmed.append(bucket))

    def load(model):
        raise OSError("the disk went away")

    cfg = thf.config_from_hf(ckpt["fp32"], dtype=torch.float32)
    with pytest.raises(OSError, match="went away"):
        InferenceEngine(_engine_cfg(cfg), params=load, device="cpu", warmup_buckets=(16, 32))
    assert warmed == []


class _SlowDigests:
    """A digest job that ends only once ``finish`` is set."""

    def __init__(self, digests) -> None:
        self.digests, self.finish = digests, threading.Event()
        self.seconds, self.times = 0.5, {}

    def done(self) -> bool:
        return self.finish.is_set()

    def result(self):
        assert self.finish.wait(30)
        return self.digests


def test_stats_never_waits_for_the_digests_and_a_sleep_does(ckpt, monkeypatch):
    """While the load's digests are still hashed, ``/v1/stats`` answers at
    once (``digest_pending``), even with another thread waiting on the
    job; a sleep, which unmaps what the job reads, waits for it."""
    svc = tserver.EngineService(tserver.parse_engine_options(
        f"--model hf:{ckpt['bf16']} --num-pages 32 --page-size 8 --max-batch 2 --max-model-len 64 "
        "--seed 0 --content-hash on --device cpu"))
    job = _SlowDigests({})
    try:
        rt = svc._runtime
        want = svc._digests(rt)
        assert want and rt.digest_job is None
        job.digests = want
        rt.digest_job, rt.digests, rt.load_stats.digest_s = job, None, 0.0  # as right after the load
        asleep_with_job_done = []
        real_sleep = svc.sleeper.sleep

        def sleep(level):
            asleep_with_job_done.append(job.done())
            return real_sleep(level)

        monkeypatch.setattr(svc.sleeper, "sleep", sleep)
        joiner = threading.Thread(target=svc._digests, args=(rt,))
        joiner.start()
        t0 = time.monotonic()
        load = svc.stats()["load"]
        assert time.monotonic() - t0 < 5 and load["digest_pending"] and load["digest_s"] == 0
        sleeper = threading.Thread(target=svc.sleep, args=(1,))
        sleeper.start()
        time.sleep(0.3)
        assert sleeper.is_alive() and joiner.is_alive() and not asleep_with_job_done
        job.finish.set()
        joiner.join(30)
        sleeper.join(30)
        assert asleep_with_job_done == [True] and rt.digests == want and rt.digest_job is None
        load = svc.stats()["load"]
        assert not load["digest_pending"] and load["digest_s"] == 0.5
        svc.wake_up()
    finally:
        job.finish.set()
        svc.shutdown()

