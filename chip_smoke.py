#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

Usage, from the root of a checkout, on a machine with one card:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises, so the script
exits non-zero and never prints the final ``ok`` line):

  1. device  — card name, count, and ``nvidia-smi`` name and power limit;
  2. build   — both kernels built from ``csrc/`` with nvcc for sm_90a;
  3. kernels — each kernel against its plain PyTorch version at
     Llama-3-8B shapes (tolerance: bf16 I/O with fp32 math, so each output
     row — one head's vector of head_dim values — may differ by at most
     two bf16 ulps of its largest value: max |out - plain| <= 1.6e-2 x
     max |plain|, row by row), then timed with CUDA events beside
     its plain version, one PyTorch library call and its bound; then,
     correctness only, the head dims, GQA groups and page sizes of the
     other supported models;
  4. serve   — the port's HTTP server in process, full-width full-depth
     llama3-8b with seeded random weights; four greedy completions
     (prompts of 20, 300, 1500 and 3000 token ids, 64 tokens each), then
     a fifth sharing a 512-token prefix (the prefix-cache suffix path);
     the kernels' launch counters must show every decode step and cold
     prefill went through them;
  5. sleep   — level-1 sleep, ``memory_reserved`` under 1 GiB while
     asleep, wake, and identical greedy tokens after the wake;
  6. kernels line — every ported kernel with its TPU source and numbers;
     prefill gets one entry for each sequence bucket the serve run
     launched it at, with that bucket's launches.

The last line is ``{"ok": true, "device": {...}}``. Without a card the
script exits non-zero before printing any result. It imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
# bf16 I/O, fp32 math: two bf16 ulps (2 x 2**-7) of each row's largest
# value. A row-relative limit holds short rows (outputs of order 1) and
# long rows (outputs of order 1/sqrt(context)) to the same precision.
REL_TOL = 1.6e-2
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
GIB = 1 << 30


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30,
    ).stdout.strip()


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, from CUDA events over ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def errors(out, ref) -> tuple:
    """(max abs error, max row-relative error): rows are the last axis,
    each scaled by its largest plain value."""
    diff = (out.float() - ref.float()).abs()
    scale = ref.float().abs().amax(-1).clamp_min(1e-30)
    return diff.max().item(), (diff.amax(-1) / scale).max().item()


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# -- phase 3: the kernels against their plain versions --------------------


def check_decode(torch, gen) -> dict:
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import decode as mod

    b, h, kvh, d, ps = 8, 32, 8, 128, 16
    positions = [0, 1, 17, 250, 1000, 2049, 3001, 4095]  # ragged, partial pages
    pps = 4096 // ps
    layers = 8  # distinct layers rotate through the timing loop, so each
    #            launch finds its pages cold in L2, as the layer loop does
    num_pages = b * pps + 1
    dev = "cuda"
    bf16 = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(bf16)

    k_pool = rnd(layers, num_pages, ps, kvh, d)
    v_pool = rnd(layers, num_pages, ps, kvh, d)
    q, k_new, v_new = rnd(layers, b, h, d), rnd(layers, b, kvh, d), rnd(layers, b, kvh, d)
    perm = torch.randperm(num_pages - 1, generator=torch.Generator().manual_seed(1)) + 1
    page_table = perm.reshape(b, pps).to(torch.int32).to(dev)  # shuffled pages
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)

    def args(i):
        return (q[i], k_pool[i], v_pool[i], k_new[i], v_new[i], page_table, pos)

    out = mod.paged_decode_attention_inline(*args(0))
    ref = mod.paged_decode_attention_inline_plain(*args(0))
    torch.cuda.synchronize()
    err, rel = errors(out, ref)
    if not rel <= REL_TOL:
        raise AssertionError(f"decode kernel disagrees with its plain version: {rel}")
    it = iter(range(10**9))
    ms = time_ms(lambda: mod.paged_decode_attention_inline(*args(next(it) % layers)), 200)
    plain_ms = time_ms(lambda: mod.paged_decode_attention_inline_plain(*args(next(it) % layers)), 5)
    # library yardstick: SDPA over K/V already gathered, contiguous and
    # GQA-expanded, with the new token appended — it excludes the gather
    ctx = max(positions) + 1
    kg = torch.empty((b, h, ctx, d), dtype=bf16, device=dev)
    vg = torch.empty_like(kg)
    mask = torch.zeros((b, 1, 1, ctx), dtype=torch.bool, device=dev)
    for r, p in enumerate(positions):
        rows = k_pool[0][page_table[r].long()].reshape(-1, kvh, d)[:p]
        vrows = v_pool[0][page_table[r].long()].reshape(-1, kvh, d)[:p]
        kg[r, :, :p] = rows.repeat_interleave(h // kvh, dim=1).transpose(0, 1)
        vg[r, :, :p] = vrows.repeat_interleave(h // kvh, dim=1).transpose(0, 1)
        kg[r, :, p] = k_new[0][r].repeat_interleave(h // kvh, dim=0)
        vg[r, :, p] = v_new[0][r].repeat_interleave(h // kvh, dim=0)
        mask[r, 0, 0, : p + 1] = True
    qs = q[0][:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask), 50)
    pages = sum(-(-p // ps) for p in positions)
    nbytes = (
        2 * b * h * d * 2  # q in, out
        + 2 * b * kvh * d * 2  # k_new, v_new
        + 2 * pages * ps * kvh * d * 2  # the K and V pages the positions need
        + (pages + b) * 4  # page-table entries and positions
    )
    flops = sum(4 * h * d * (p + 1) for p in positions)
    bnd, by = bound_ms(nbytes, flops)
    return {
        "name": "paged_decode_attention_inline",
        "route": "cuda",
        "source": "llm_d_fast_model_actuation_tpu_torch/csrc/decode.cu",
        "replaces": "llm_d_fast_model_actuation_tpu/ops/pallas/decode.py:135",
        "shape": {"batch": b, "heads": h, "kv_heads": kvh, "head_dim": d,
                  "page_size": ps, "positions": positions},
        "max_abs_err": err, "max_row_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bnd, "bound_by": by, "library_ms": library_ms,
        "library": "scaled_dot_product_attention over pre-gathered contiguous K/V (excludes the gather)",
    }


# s=16 is the smallest bucket; 32, 512, 2048 and 4096 are those the serve
# phase's prompts (20, 300, 1500 and 3000 tokens) fall in
PREFILL_SEQS = (16, 32, 512, 2048, 4096)


def check_prefill(torch, gen) -> list:
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import prefill as mod

    h, kvh, d = 32, 8, 128
    dev = "cuda"
    bf16 = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for s in PREFILL_SEQS:
        n_sets = 4  # rotate inputs so each timed launch starts cold in L2

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(bf16)

        sets = [(rnd(1, s, h, d), rnd(1, s, kvh, d), rnd(1, s, kvh, d)) for _ in range(n_sets)]
        L = s - 3
        seq_lens = torch.tensor([L], dtype=torch.int32, device=dev)
        out = mod.causal_prefill_attention(*sets[0], seq_lens)
        ref = mod.causal_prefill_attention_plain(*sets[0], seq_lens)
        torch.cuda.synchronize()
        err, rel = errors(out, ref)  # padded rows too
        if not rel <= REL_TOL:
            raise AssertionError(f"prefill kernel disagrees with its plain version at s={s}: {rel}")
        it = iter(range(10**9))
        iters = 20 if s >= 2048 else 100
        ms = time_ms(lambda: mod.causal_prefill_attention(*sets[next(it) % n_sets], seq_lens), iters)
        plain_ms = time_ms(lambda: mod.causal_prefill_attention_plain(*sets[next(it) % n_sets], seq_lens), 3)
        # library: SDPA computing the same masked function (causal and
        # key < seq_len) on GQA-expanded [b, h, s, d] inputs
        pos = torch.arange(s, device=dev)
        mask = ((pos[None, :] <= pos[:, None]) & (pos[None, :] < L))[None, None]
        lib_sets = [
            (qq.transpose(1, 2), kk.repeat_interleave(h // kvh, dim=2).transpose(1, 2),
             vv.repeat_interleave(h // kvh, dim=2).transpose(1, 2))
            for qq, kk, vv in sets
        ]
        library_ms = time_ms(lambda: sdpa(*lib_sets[next(it) % n_sets], attn_mask=mask), iters)
        nbytes = (2 * s * h * d + 2 * s * kvh * d) * 2 + 4
        visible = sum(min(i, L - 1) + 1 for i in range(s))  # keys each row sees
        flops = 4 * h * d * visible
        bnd, by = bound_ms(nbytes, flops)
        rows.append({
            "name": f"causal_prefill_attention[s={s}]",
            "route": "cuda",
            "source": "llm_d_fast_model_actuation_tpu_torch/csrc/prefill.cu",
            "replaces": "llm_d_fast_model_actuation_tpu/ops/pallas/prefill.py:29",
            "shape": {"batch": 1, "seq": s, "seq_len": L, "heads": h, "kv_heads": kvh, "head_dim": d},
            "seq": s, "max_abs_err": err, "max_row_rel_err": rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by, "library_ms": library_ms,
            "library": "scaled_dot_product_attention with the same causal and seq_len mask",
        })
    return rows


def check_variants(torch, gen) -> list:
    """Correctness only, at small shapes: the head dims, GQA groups and
    page sizes the main path does not use (other supported models)."""
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import decode, prefill

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(torch.bfloat16)

    out = []
    for d, h, kvh, ps in ((64, 32, 4, 16), (256, 8, 4, 16), (128, 28, 4, 8), (128, 8, 8, 16)):
        b, pps = 3, 20
        num_pages = b * pps + 1
        pt = (torch.randperm(num_pages - 1, generator=torch.Generator().manual_seed(2)) + 1)
        args = (rnd(b, h, d), rnd(num_pages, ps, kvh, d), rnd(num_pages, ps, kvh, d),
                rnd(b, kvh, d), rnd(b, kvh, d), pt.reshape(b, pps).to(torch.int32).cuda(),
                torch.tensor([0, ps + 3, pps * ps - 1], dtype=torch.int32, device="cuda"))
        err, rel = errors(decode.paged_decode_attention_inline(*args),
                          decode.paged_decode_attention_inline_plain(*args))
        out.append({"kernel": "decode", "head_dim": d, "heads": h, "kv_heads": kvh,
                    "page_size": ps, "max_abs_err": err, "max_row_rel_err": rel})
    for d, h, kvh, s, lens in ((64, 32, 4, 128, [128, 70]), (128, 28, 4, 64, [1, 50])):
        args = (rnd(len(lens), s, h, d), rnd(len(lens), s, kvh, d), rnd(len(lens), s, kvh, d),
                torch.tensor(lens, dtype=torch.int32, device="cuda"))
        err, rel = errors(prefill.causal_prefill_attention(*args),
                          prefill.causal_prefill_attention_plain(*args))
        out.append({"kernel": "prefill", "head_dim": d, "heads": h, "kv_heads": kvh,
                    "seq": s, "seq_lens": lens, "max_abs_err": err, "max_row_rel_err": rel})
    torch.cuda.synchronize()
    bad = [v for v in out if not v["max_row_rel_err"] <= REL_TOL]
    if bad:
        raise AssertionError(f"kernel variants disagree with their plain versions: {bad}")
    return out


# -- phases 4 and 5: serve, sleep, wake -------------------------------------


def post(port: int, path: str, body=None, timeout: float = 600.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body or {}).encode(),
        method="POST", headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def serve_and_sleep(torch, smi: str) -> dict:
    import numpy as np

    from llm_d_fast_model_actuation_tpu_torch.engine import server as srv
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import decode, prefill

    # the reference EngineConfig's default pool: 2048 pages x 16 tokens
    opts = "--model llama3-8b --num-pages 2048 --seed 0 --max-batch 8 --device cuda"
    t0 = time.monotonic()
    service = srv.EngineService(srv.parse_engine_options(opts))
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    server = srv.serve(service, "127.0.0.1", 0)
    port = server.server_address[1]
    try:
        eng = service.engine
        L = eng.cfg.model.num_layers
        vocab = eng.cfg.model.vocab_size
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, vocab, n).tolist() for n in (20, 300, 1500, 3000)]
        torch.cuda.reset_peak_memory_stats()
        # the main path's run: counters start at 0 here
        decode.paged_decode_attention_inline.launches = 0
        prefill.causal_prefill_attention.launches = 0
        prefill.causal_prefill_attention.launches_by_seq.clear()
        steps0, cold0 = eng.decode_steps, eng.cold_prefills
        results = [None] * len(prompts)

        def one(i):
            results[i] = post(port, "/v1/completions", {"prompt": prompts[i], "max_tokens": 64})

        t1 = time.monotonic()
        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        batch_s = time.monotonic() - t1
        if any(r is None for r in results):
            raise RuntimeError("a completion failed")
        # fifth request: a 512-token prefix of the 1500-token prompt plus
        # 200 fresh ids -> a prefix-cache hit, the suffix path
        shared = prompts[2][:512] + rng.integers(0, vocab, 200).tolist()
        t2 = time.monotonic()
        fifth = post(port, "/v1/completions", {"prompt": shared, "max_tokens": 64})
        fifth_s = time.monotonic() - t2
        torch.cuda.synchronize()
        dec_launches = decode.paged_decode_attention_inline.launches
        pre_launches = prefill.causal_prefill_attention.launches
        pre_by_seq = dict(prefill.causal_prefill_attention.launches_by_seq)
        steps = eng.decode_steps - steps0
        colds = eng.cold_prefills - cold0
        if dec_launches != L * steps or steps == 0:
            raise AssertionError(f"decode kernel launches {dec_launches} != {L} x {steps} decode steps")
        if pre_launches != L * colds or colds != 4:
            raise AssertionError(f"prefill kernel launches {pre_launches} != {L} x {colds} cold prefills (want 4)")
        hits = eng.prefix_cache.stats()["hits"] if eng.prefix_cache else 0
        if hits < 1:
            raise AssertionError("the fifth request did not hit the prefix cache")
        for r in results + [fifth]:
            ids = r["choices"][0]["token_ids"]
            if len(ids) != 64 or not all(0 <= t < vocab for t in ids):
                raise AssertionError(f"bad completion {ids[:8]}...")
        completion = sum(r["usage"]["completion_tokens"] for r in results)
        emit({
            "phase": "serve", "model": "llama3-8b", "layers": L,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "init_s": init_s,
            "ttft_s": {str(len(p)): r["usage"]["time_to_first_token_s"] for p, r in zip(prompts, results)},
            "decode_tpot_s": {str(len(p)): r["usage"]["decode_tpot_s"] for p, r in zip(prompts, results)},
            "batch_wall_s": batch_s,
            "batch_tok_per_s": completion / batch_s,
            "decode_tok_per_s_per_seq": {
                str(len(p)): 1.0 / r["usage"]["decode_tpot_s"] for p, r in zip(prompts, results)
            },
            "prefix_hit_request_s": fifth_s,
            "prefix_hit_ttft_s": fifth["usage"]["time_to_first_token_s"],
            "decode_steps": steps, "decode_launches": dec_launches,
            "cold_prefills": colds, "prefill_launches": pre_launches,
            "prefill_launches_by_seq": pre_by_seq,
            "prefix_cache": eng.prefix_cache.stats(),
            "peak_allocated_gib": torch.cuda.max_memory_allocated() / GIB,
        })
        launches = {"decode": dec_launches, "prefill_by_seq": pre_by_seq}

        # -- sleep / wake, three cycles (the spread of one transfer per call
        #    is too wide to read): the reference output is a repeat of
        #    request 1 (a prefix-cache hit, the path every repeat takes)
        probe = {"prompt": prompts[0], "max_tokens": 64}
        before = post(port, "/v1/completions", probe)["choices"][0]["token_ids"]
        cycles = []
        for _ in range(3):
            info = post(port, "/sleep?level=1")
            if not get(port, "/is_sleeping")["is_sleeping"]:
                raise AssertionError("/is_sleeping is false after /sleep")
            reserved = torch.cuda.memory_reserved()
            allocated = torch.cuda.memory_allocated()
            if reserved >= GIB:
                segs = sorted(torch.cuda.memory_snapshot(), key=lambda g: -g["total_size"])[:6]
                raise AssertionError(
                    f"{reserved / GIB:.2f} GiB still reserved while asleep "
                    f"({allocated / GIB:.3f} GiB allocated); largest segments: "
                    + json.dumps([
                        {"total": g["total_size"], "allocated": g["allocated_size"],
                         "active": [b["size"] for b in g["blocks"] if b["state"] != "inactive"][:8]}
                        for g in segs
                    ])
                )
            pin_s = service.sleeper.stats.last_pin_seconds
            woke = post(port, "/wake_up")
            if get(port, "/is_sleeping")["is_sleeping"]:
                raise AssertionError("/is_sleeping is true after /wake_up")
            after = post(port, "/v1/completions", probe)["choices"][0]["token_ids"]
            if after != before:
                raise AssertionError(f"tokens changed across sleep/wake: {before[:8]} vs {after[:8]}")
            nbytes = info["bytes_offloaded"]
            cycles.append({
                "sleep_s": info["last_sleep_seconds"], "sleep_pin_s": pin_s,
                "wake_s": woke["last_wake_seconds"],
                "wake_alloc_s": service.sleeper.stats.last_alloc_seconds,
                "wake_gib_per_s": nbytes / GIB / woke["last_wake_seconds"],
                "reserved_while_asleep_bytes": reserved,
                "allocated_while_asleep_bytes": allocated,
            })
        emit({
            "phase": "sleep_wake", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "bytes_offloaded": nbytes, "cycles": cycles, "tokens_identical": True,
        })
        if get(port, "/health")["status"] != "OK":
            raise AssertionError("server is not healthy")
        return launches
    finally:
        server.shutdown()
        service.shutdown()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import build

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.monotonic()
    built = build.build_all()
    emit({"phase": "build", "seconds": time.monotonic() - t0, "nvcc": build.find_nvcc(),
          "ptxas": {n: [ln.strip() for ln in b.log.splitlines() if "registers" in ln or "spill" in ln]
                    for n, b in built.items()}})
    gen = torch.Generator(device="cuda").manual_seed(0)
    dec = check_decode(torch, gen)
    pre = check_prefill(torch, gen)
    for k in [dec] + pre:
        emit({"phase": "kernel", **k, "nvidia_smi": smi})
    emit({"phase": "kernel_variants", "checks": check_variants(torch, gen)})
    launches = serve_and_sleep(torch, smi)
    dec["launches"] = launches["decode"]
    by_seq = launches["prefill_by_seq"]
    untimed = sorted(set(by_seq) - set(PREFILL_SEQS))
    if untimed:
        raise AssertionError(f"the serve run launched prefill at untimed lengths {untimed}")
    kernels = [dec]
    for k in pre:  # one entry per bucket the serve run launched
        if by_seq.get(k["seq"]):
            kernels.append(dict(k, launches=by_seq[k["seq"]]))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: row.get(k) for k in keys} for row in kernels]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
