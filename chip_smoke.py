#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

Usage, from the root of a checkout, on a machine with one card:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises, so the script
exits non-zero and never prints the final ``ok`` line):

  1. device  — card name, count, and ``nvidia-smi`` name and power limit;
  2. build   — every kernel built from ``csrc/`` with nvcc for sm_90a, and
     the probe kernel's copy checked against its plain version;
  3. kernels — each kernel against its plain PyTorch version at
     Llama-3-8B shapes (tolerance: bf16 I/O with fp32 math, so each output
     row — one head's vector of head_dim values — may differ by at most
     two bf16 ulps of its largest value: max |out - plain| <= 1.6e-2 x
     max |plain|, row by row), then timed with CUDA events beside
     its plain version, one PyTorch library call and its bound: the
     inline and the scatter-first decode, prefill at every serve bucket
     (its library call is SDPA with the same mask on the fastest backend
     that takes a mask, named in the row; beside it, for reading, flash
     SDPA with ``is_causal`` over the valid prefix, ``library_causal_ms``),
     and ragged attention at both packed buffer shapes the packed serve
     uses (256 and 72 rows), and there also the sharded ragged op (the
     same kernel launched once per rank over the rank's heads) split over
     two and over four ranks that share the card, against the unsharded
     plain version and the unsharded kernel. The decode, ragged and
     probe rows also carry ``device_ms``, the device time of one launch
     from the replay of a CUDA graph (no host time; so each launch is
     also shown capturable), and one launch of each decode and ragged op
     runs under CUDA's sync debug mode set to error, so a wrapper that
     waits for the device fails. Then, correctness only, the
     head dims, GQA groups and page sizes of the other supported models,
     head_dim 256 (Gemma-3-4B) prefill included, and the per-rank head
     counts of Llama-3-8B at tp 2 and 4 (16/4 and 8/2); prefill also at
     GQA group 1, at s = 3000 (a bucket clamped to a max length that is
     not a power of two) and at s = 200 beside a one-token prompt; decode
     also at GQA groups 1, 2, 4, 5, 7 and 8 (clusters of 8 CTAs, two splits
     a CTA at group 1, and of 8, 4, 3 and 2), page sizes 8, 12 and 64, and
     batch 1 at 4095; ragged
     also with six sequences' decode rows in one CTA's window and a run
     over several CTAs, and a 512-token segment at position 7680;
  4. serve   — the port's HTTP server in process, full-width full-depth
     llama3-8b with seeded random weights; four greedy completions
     (prompts of 20, 300, 1500 and 3000 token ids, 64 tokens each), then
     a fifth sharing a 512-token prefix (the prefix-cache suffix path);
     the launch counts must show every decode step and cold prefill went
     through the kernels, and every decode chunk must be a replay of one
     of the four CUDA graphs the engine captured when it started
     (``graph_replays`` equal to the chunks run). A wrapper's counter
     counts its eager launches (the prefills, the warm-up runs before
     the captures, which count as decode steps too); what the replays
     launched is read from each captured graph's kernel nodes through
     the CUDA driver (each graph must hold L x T nodes of the path's
     decode kernel), times its replays. The counts are set to 0 before
     the engine starts;
  5. sleep   — three level-1 sleep/wake cycles: ``memory_reserved``
     under 1 GiB while asleep, nothing of the engine's arenas mapped, the
     card's free memory within 1 GiB of its free memory before the server
     started, identical greedy tokens after the wake, no graph captured
     again and every state tensor at its old address; ``wake_s`` and
     ``wake_map_s`` (the CUDA driver's mapping calls) beside the reference's
     bar scaled to this state (``WAKE_BAR_S``, reported). Then one
     level-2 sleep and wake: nothing mapped while asleep, the weights
     drawn anew from the seed into the same tensors (the same per-layer
     sums), the pool zero, under 3 GiB of ordinary memory at the wake's
     peak (``LEVEL2_WAKE_PEAK``), no state moved and no graph captured
     again;
  graphs — a llama3-8b engine at full width and depth built directly,
     eight requests of the serve traffic's lengths (two of them sampled,
     seeded) prefilled; then for T = 8 and T = 1, sampled and greedy, one
     chunk replayed from its graph and, on a copy of the state as it was,
     the same chunk run eagerly: tokens, logprobs, alternatives, KV pages
     and scheduler state must be bit-equal. Then TPOT and tokens/s of the
     eight requests over 64 tokens with the graphs and without them, in
     turns (on, off, off, on), with the same tokens each time; the device
     time of a replayed step (CUDA events) and its kernels by kind
     (``torch.profiler``, whose count of the decode kernel's runs in the
     replay must equal the graph's kernel nodes, L x T); and the capture seconds and the graph pool's
     reserved bytes;
  6. serve_packed — the same traffic through a second server with
     ``--packed-serving on``, started after the first is shut down and its
     memory freed: every packed step runs the ragged kernel in each layer,
     the prefill kernel never runs, the decode chunk runs the inline decode
     kernel; TTFT, TPOT and tok/s beside phase 4's;
  7. serve_tp2_packed — the same traffic through a server with
     ``--tensor-parallel-size 2 --device cuda:0,cuda:0 --packed-serving
     on``: two ranks on the one card, each with its half of every split
     weight and its KV-head half of the page pool. Every
     packed step runs the ragged kernel once per rank in each layer
     through the sharded op, the unsharded op never runs; then one
     level-1 sleep and wake (0 bytes reserved while asleep, nothing of the
     arena mapped and the card's free memory back as in phase 5, the same
     ``bytes_offloaded`` as one rank, identical tokens and state addresses
     after the wake). Its chunk runs eagerly (a graph belongs to one
     device). Two ranks on one card add launches and remove none, so its
     times are for reading beside phase 6's, not a claim;
  8. serve_reference — the same traffic through a server with
     ``--attention-impl reference``: every decode step runs the
     scatter-first decode kernel in each layer. Phases 6 and 8 replay
     a captured graph for every decode chunk, as phase 4 does. Phases 6 to 8 print, per
     completion, the first position where its greedy tokens leave phase
     4's (``first_difference_from_bucketed``);
  9. model_parity — on phase 8's weights at full width: ``mixed_step``
     over a 300-token prompt against ``prefill`` (last row's logits), and
     one scatter-first ``decode_step`` against the inline one on the same
     state, each within a tolerance stated from bf16 rounding; then
     phase 7's two-rank model (the same seed, so the same weights)
     against the one-rank model: ``mixed_step`` and ``decode_step``;
     then (``greedy_divergence``, not gated) one prefill of the one-rank
     model over each diverging request's prompt and agreed tokens, and
     the top-2 logit margin where the tokens part;
  10. kernels line — every ported kernel with its TPU source and numbers,
     one entry for each shape the serve runs launched it at (prefill by
     sequence bucket, ragged by buffer rows), with that shape's launches.
     Each serve phase sets every count to 0 just before it starts its
     server and reads them just after its traffic.

With two or more cards the sharded ragged check also runs with its ranks
on ``cuda:0,cuda:1`` and says so; with one it prints ``"two_cards": "not
run"``. The last line is ``{"ok": true, "device": {...}}``. Without a card the
script exits non-zero before printing any result. It imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import gc
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
# the reference's GPU wake claim, about 3 s for 64 GiB (SURVEY.md section 6),
# scaled to Llama-3-8B's 20.36 GB of weights and KV: reported, not gated
WAKE_BAR_S = 3.0 * 20_355_489_792 / (64 * GIB)


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


def graph_ms(fn, n: int) -> float:
    """Device time of one call: ``n`` calls captured in a CUDA graph, whose
    replays are timed with CUDA events (no host time in it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * n)


def sync_free(fn) -> bool:
    """Run ``fn`` once with CUDA's sync debug mode set to error: any call
    that waits for the device (``.item()``, ``.cpu()``, a blocking copy)
    raises."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return True


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


def check_decode(torch, gen) -> list:
    """The inline decode kernel at Llama-3-8B shapes, and the scatter-first one
    on the same inputs with ``positions + 1`` as ``seq_lens``."""
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
    seq_lens = pos + 1
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for name, fn, plain, args, replaces in (
        ("paged_decode_attention_inline", mod.paged_decode_attention_inline,
         mod.paged_decode_attention_inline_plain,
         lambda i: (q[i], k_pool[i], v_pool[i], k_new[i], v_new[i], page_table, pos),
         "llm_d_fast_model_actuation_tpu/ops/pallas/decode.py:135"),
        ("paged_decode_attention", mod.paged_decode_attention, mod.paged_decode_attention_plain,
         lambda i: (q[i], k_pool[i], v_pool[i], page_table, seq_lens),
         "llm_d_fast_model_actuation_tpu/ops/pallas/decode.py:34"),
    ):
        inline = fn is mod.paged_decode_attention_inline
        out = fn(*args(0))
        ref = plain(*args(0))
        torch.cuda.synchronize()
        err, rel = errors(out, ref)
        if not rel <= REL_TOL:
            raise AssertionError(f"{name} kernel disagrees with its plain version: {rel}")
        it = iter(range(10**9))
        ms = time_ms(lambda: fn(*args(next(it) % layers)), 200)
        device_ms = graph_ms(lambda: fn(*args(next(it) % layers)), 40)
        sync_free(lambda: fn(*args(1)))
        plain_ms = time_ms(lambda: plain(*args(next(it) % layers)), 5)
        # library yardstick: SDPA over K/V already gathered, contiguous and
        # GQA-expanded (the inline token appended for the inline variant);
        # it excludes the gather
        ctx = max(positions) + 1
        kg = torch.empty((b, h, ctx, d), dtype=bf16, device=dev)
        vg = torch.empty_like(kg)
        mask = torch.zeros((b, 1, 1, ctx), dtype=torch.bool, device=dev)
        for r, p in enumerate(positions):
            n = p if inline else p + 1  # cache entries read
            krows = k_pool[0][page_table[r].long()].reshape(-1, kvh, d)[:n]
            vrows = v_pool[0][page_table[r].long()].reshape(-1, kvh, d)[:n]
            kg[r, :, :n] = krows.repeat_interleave(h // kvh, dim=1).transpose(0, 1)
            vg[r, :, :n] = vrows.repeat_interleave(h // kvh, dim=1).transpose(0, 1)
            if inline:
                kg[r, :, p] = k_new[0][r].repeat_interleave(h // kvh, dim=0)
                vg[r, :, p] = v_new[0][r].repeat_interleave(h // kvh, dim=0)
            mask[r, 0, 0, : p + 1] = True
        qs = q[0][:, :, None, :]
        library_ms = time_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask), 50)
        lens = positions if inline else [p + 1 for p in positions]
        pages = sum(-(-n // ps) for n in lens)
        nbytes = (
            2 * b * h * d * 2  # q in, out
            + (2 * b * kvh * d * 2 if inline else 0)  # k_new, v_new
            + 2 * pages * ps * kvh * d * 2  # the K and V pages the lengths need
            + (pages + b) * 4  # page-table entries and positions
        )
        flops = sum(4 * h * d * (p + 1) for p in positions)
        bnd, by = bound_ms(nbytes, flops)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "llm_d_fast_model_actuation_tpu_torch/csrc/decode.cu",
            "replaces": replaces,
            "shape": {"batch": b, "heads": h, "kv_heads": kvh, "head_dim": d,
                      "page_size": ps, ("positions" if inline else "seq_lens"): lens},
            "max_abs_err": err, "max_row_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "device_ms": device_ms, "sync_free": True,
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention over pre-gathered contiguous K/V (excludes the gather)",
        })
    return rows


# s=16 is the smallest bucket; 32, 512, 2048 and 4096 are those the serve
# phase's prompts (20, 300, 1500 and 3000 tokens) fall in
PREFILL_SEQS = (16, 32, 512, 2048, 4096)


def check_prefill(torch, gen) -> list:
    from torch.nn.attention import SDPBackend, sdpa_kernel

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
        # key < seq_len) on GQA-expanded [b, h, s, d] inputs, on each
        # backend that takes a boolean mask (flash does not); the fastest
        # is the yardstick, and the row names it
        pos = torch.arange(s, device=dev)
        mask = ((pos[None, :] <= pos[:, None]) & (pos[None, :] < L))[None, None]
        lib_sets = [
            (qq.transpose(1, 2), kk.repeat_interleave(h // kvh, dim=2).transpose(1, 2),
             vv.repeat_interleave(h // kvh, dim=2).transpose(1, 2))
            for qq, kk, vv in sets
        ]
        backends = {}
        for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION):
            try:
                with sdpa_kernel([backend]):
                    backends[backend.name] = time_ms(
                        lambda: sdpa(*lib_sets[next(it) % n_sets], attn_mask=mask), iters)
            except RuntimeError:  # this backend refuses the call
                continue
        library_backend = min(backends, key=backends.get)
        # for reading only: flash SDPA with is_causal over the valid prefix
        # [0, seq_len) — the padded rows are not computed
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            library_causal_ms = time_ms(
                lambda: sdpa(*(x[:, :, :L] for x in lib_sets[next(it) % n_sets]), is_causal=True), iters)
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
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "tflops": flops / ms / 1e9, "bound_share": bnd / ms,
            "library_ms": backends[library_backend],
            "library": f"scaled_dot_product_attention with the same causal and seq_len mask, "
                       f"{library_backend} backend (the fastest that takes the mask)",
            "library_backends_ms": backends,
            "library_causal_ms": library_causal_ms,
            "library_causal": "scaled_dot_product_attention, FLASH_ATTENTION backend, is_causal "
                              "over the valid prefix [0, seq_len) only; for reading",
        })
    return rows


# the packed serve's two buffer shapes (packed_budget_shapes at max_batch 8)
# and what each carries in ragged_scenarios below
RAGGED_ROWS = (256, 72)


def ragged_scenarios():
    """(rows, segments): each segment is (slot, first position, tokens), in
    the engine's packing order — one decode row per running sequence, then
    the prompt segment — at the two buffer shapes the packed serve uses."""
    decode = [(1, 20, 1), (2, 300, 1), (3, 1500, 1)]
    return [
        (256, decode + [(0, 2768, 232)]),  # a long prompt's last segment
        (72, decode + [(0, 0, 44)]),  # a short prompt's only segment
    ]


def pack(torch, segments, rows, dev):
    """The engine's packing layout: each segment starts on an 8-row
    boundary; the rest are padding rows."""
    slot = torch.full((rows,), -1, dtype=torch.int32)
    pos = torch.zeros((rows,), dtype=torch.int32)
    r = 0
    for s, p0, n in segments:
        slot[r : r + n] = s
        pos[r : r + n] = torch.arange(p0, p0 + n, dtype=torch.int32)
        r += -(-n // 8) * 8
    if r > rows:
        raise ValueError("segments do not fit the buffer")
    return slot.to(dev), pos.to(dev)


def check_ragged_sharded(torch, mod, row3: dict, args, out, ref, layers: int, devices: list) -> dict:
    """The sharded ragged op on the inputs of ``check_ragged``'s case
    ``row3``, split over ``len(devices)`` ranks: the same kernel once per
    rank over the rank's query heads and KV-head slice of the pool. The
    heads joined, it is held to the unsharded plain version ``ref`` on
    every row (limit ``REL_TOL``) and to the unsharded kernel's ``out``
    (bit-equal is expected: a head's arithmetic does not depend on the
    rank that runs it; reported, and gated at the same limit).

    Timed: one rank's launch alone, and all ranks' launches (ranks that
    share a card run one after the other on its queue). The bound and the
    library time are ``row3``'s: the ranks together move the same unique
    bytes and do the same operations as the one launch."""
    from llm_d_fast_model_actuation_tpu_torch.parallel.mesh import serving_mesh

    tp = len(devices)
    mesh = serving_mesh(tp, devices)
    q, k_pool, v_pool, pt, slot, pos = args
    h, kvh = q.shape[2], k_pool.shape[3]
    hs, ks = h // tp, kvh // tp

    def split(x, dim, n):  # per rank: all layers' slice, contiguous, on the rank's device
        return [x.narrow(dim, r * n, n).to(mesh.devices[r]).contiguous() for r in range(tp)]

    qs, kps, vps = split(q, 2, hs), split(k_pool, 3, ks), split(v_pool, 3, ks)
    meta = [mesh.replicate(x) for x in (pt, slot, pos)]

    def run(i):
        outs = mod.ragged_paged_attention_sharded(
            mesh, [x[i] for x in qs], [x[i] for x in kps], [x[i] for x in vps], *meta
        )
        for d in mesh.distinct_devices()[1:]:  # the timing events sit on card 0's stream
            torch.cuda.current_stream(mesh.devices[0]).wait_stream(torch.cuda.current_stream(d))
        return outs

    before = mod.ragged_paged_attention_sharded.launches
    outs = run(0)
    torch.cuda.synchronize()
    if mod.ragged_paged_attention_sharded.launches - before != tp:
        raise AssertionError(f"the sharded ragged op did not launch the kernel once per rank (tp={tp})")
    if any(o.device != mesh.devices[r] or tuple(o.shape) != (q.shape[1], hs, q.shape[3]) for r, o in enumerate(outs)):
        raise AssertionError("a rank's output is not its head slice on its device")
    joined = torch.cat([o.to(out.device) for o in outs], dim=1)
    err, rel = errors(joined, ref)
    err_k, rel_k = errors(joined, out)
    if not (rel <= REL_TOL and rel_k <= REL_TOL):
        raise AssertionError(f"sharded ragged (tp={tp}) disagrees at {row3['rows']} rows: plain {rel}, kernel {rel_k}")
    it = iter(range(10**9))
    ms_all = time_ms(lambda: run(next(it) % layers), 50)

    def one_rank():
        i = next(it) % layers
        return mod.ragged_paged_attention(qs[0][i], kps[0][i], vps[0][i], meta[0][0], meta[1][0], meta[2][0])

    ms_rank = time_ms(one_rank, 50)
    two_cards = len(set(devices)) > 1
    device = {} if two_cards else {
        "device_ms": graph_ms(lambda: run(next(it) % layers), 40),
        "device_ms_one_rank": graph_ms(one_rank, 40),
    }
    sync_free(lambda: run(1))

    def plain(i):
        return mod.ragged_paged_attention_sharded_plain(
            mesh, [x[i] for x in qs], [x[i] for x in kps], [x[i] for x in vps], *meta
        )

    plain_ms = time_ms(lambda: plain(next(it) % layers), 5)
    return {
        "name": f"ragged_paged_attention_sharded[tp={tp},T={row3['rows']}]",
        "route": "cuda",
        "source": "llm_d_fast_model_actuation_tpu_torch/csrc/ragged.cu",
        "replaces": "llm_d_fast_model_actuation_tpu/ops/pallas/ragged.py:244",
        "rows": row3["rows"], "tp": tp, "devices": devices,
        "shape": dict(row3["shape"], heads_per_rank=hs, kv_heads_per_rank=ks,
                      blocks_per_launch=(row3["rows"] // 8) * ks),
        "max_abs_err": err, "max_row_rel_err": rel,
        "vs_unsharded_kernel": {"max_abs_err": err_k, "bit_equal": bool(torch.equal(joined, out))},
        "ms": ms_all, "ms_one_rank": ms_rank, **device, "unsharded_ms": row3["ms"],
        "unsharded_device_ms": row3["device_ms"], "plain_ms": plain_ms, "sync_free": True,
        "bound_ms": row3["bound_ms"], "bound_by": row3["bound_by"],
        "bound": "row 3's: the ranks together move the same unique bytes and do the same operations",
        "library_ms": row3["library_ms"], "library": row3["library"],
        "two_cards": "ran with the ranks on two cards" if two_cards else "not run",
    }


def check_ragged(torch, gen) -> tuple:
    """The ragged kernel's rows, and the sharded ragged op's on the same
    inputs (tp 2 and 4 on the one card; tp 2 across two cards where there
    are two)."""
    from llm_d_fast_model_actuation_tpu_torch.engine.engine import kv_pages_bucket
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import ragged as mod

    h, kvh, d, ps, max_batch, pps = 32, 8, 128, 16, 8, 8192 // 16
    g = h // kvh
    dev = "cuda"
    bf16 = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out_rows, sharded_rows = [], []
    for rows, segments in ragged_scenarios():
        # each sequence gets its own shuffled pages, as many as it needs
        need = {s: -(-(p0 + n) // ps) for s, p0, n in segments}
        num_pages = sum(need.values()) + 1
        perm = (torch.randperm(num_pages - 1, generator=torch.Generator().manual_seed(rows)) + 1).tolist()
        table = torch.zeros((max_batch, pps), dtype=torch.int32)
        for s, n in need.items():
            table[s, :n] = torch.tensor(perm[:n], dtype=torch.int32)
            perm = perm[n:]
        max_kv = max(p0 + n for _, p0, n in segments)
        kvp = kv_pages_bucket(max_kv, ps, pps)
        pt = table.to(dev)[:, :kvp]  # the engine's column slice: a strided view
        slot, pos = pack(torch, segments, rows, dev)
        layers = 8  # rotate, so each timed launch finds its pages cold in L2

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(bf16)

        k_pool, v_pool, q = rnd(layers, num_pages, ps, kvh, d), rnd(layers, num_pages, ps, kvh, d), rnd(layers, rows, h, d)

        def args(i):
            return (q[i], k_pool[i], v_pool[i], pt, slot, pos)

        out = mod.ragged_paged_attention(*args(0))
        ref = mod.ragged_paged_attention_plain(*args(0))
        torch.cuda.synchronize()
        err, rel = errors(out, ref)  # padding rows too: zeros in both
        if not rel <= REL_TOL:
            raise AssertionError(f"ragged kernel disagrees with its plain version at {rows} rows: {rel}")
        it = iter(range(10**9))
        ms = time_ms(lambda: mod.ragged_paged_attention(*args(next(it) % layers)), 50)
        device_ms = graph_ms(lambda: mod.ragged_paged_attention(*args(next(it) % layers)), 40)
        sync_free(lambda: mod.ragged_paged_attention(*args(1)))
        plain_ms = time_ms(lambda: mod.ragged_paged_attention_plain(*args(next(it) % layers)), 5)
        # library: one SDPA call over the sequences padded to one batch, K/V
        # pre-gathered, contiguous and GQA-expanded, with the same mask (a
        # row sees its sequence's positions <= its own); excludes the gather
        nseq, lq = len(segments), max(n for _, _, n in segments)
        qb = torch.zeros((nseq, h, lq, d), dtype=bf16, device=dev)
        kb = torch.zeros((nseq, h, max_kv, d), dtype=bf16, device=dev)
        vb = torch.zeros_like(kb)
        mask = torch.zeros((nseq, 1, lq, max_kv), dtype=torch.bool, device=dev)
        mask[..., 0] = True  # padded query rows see position 0 (no NaN)
        r = 0
        for i, (s, p0, n) in enumerate(segments):
            ctx = p0 + n
            pages = table[s, : -(-ctx // ps)].long().to(dev)
            kb[i, :, :ctx] = k_pool[0][pages].reshape(-1, kvh, d)[:ctx].repeat_interleave(g, dim=1).transpose(0, 1)
            vb[i, :, :ctx] = v_pool[0][pages].reshape(-1, kvh, d)[:ctx].repeat_interleave(g, dim=1).transpose(0, 1)
            qb[i, :, :n] = q[0][r : r + n].transpose(0, 1)
            qpos = torch.arange(p0, p0 + n, device=dev)
            mask[i, 0, :n, :ctx] = torch.arange(ctx, device=dev)[None, :] <= qpos[:, None]
            r += -(-n // 8) * 8
        library_ms = time_ms(lambda: sdpa(qb, kb, vb, attn_mask=mask), 50)
        # bound: each sequence's pages once, q in, out, the metadata
        unique_pages = sum(need.values())
        nbytes = (2 * unique_pages * ps * kvh * d * 2 + 2 * rows * h * d * 2
                  + unique_pages * 4 + 2 * rows * 4)
        flops = sum(4 * h * d * (p0 + j + 1) for _, p0, n in segments for j in range(n))
        bnd, by = bound_ms(nbytes, flops)
        # what the CTAs read, K and V for every KV head: each tile of one
        # run walks positions [0, its last valid position] of its sequence
        # (mod.work_items, the kernel's rule); beside it, the same for the
        # 8-row blocks of the design it replaced, one walk per block
        kv_pos_bytes = kvh * d * 2 * 2
        reread = sum(p0 + n for _, _, s, p0, n in mod.work_items(slot.cpu(), pos.cpu(), g) if s >= 0)
        reread_8row = sum(p0 + min(n, b0 + 8) for _, p0, n in segments for b0 in range(0, n, 8))
        out_rows.append({
            "name": f"ragged_paged_attention[T={rows}]",
            "route": "cuda",
            "source": "llm_d_fast_model_actuation_tpu_torch/csrc/ragged.cu",
            "replaces": "llm_d_fast_model_actuation_tpu/ops/pallas/ragged.py:54",
            "rows": rows,
            "shape": {"rows": rows, "heads": h, "kv_heads": kvh, "head_dim": d, "page_size": ps,
                      "table_cols": kvp, "segments": [list(x) for x in segments]},
            "max_abs_err": err, "max_row_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "bound_bytes": nbytes, "bound_flops": flops,
            "device_ms": device_ms, "sync_free": True,
            "reread_bytes": reread * kv_pos_bytes, "reread_bytes_8_row_blocks": reread_8row * kv_pos_bytes,
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention over the sequences padded to one batch, pre-gathered contiguous K/V (excludes the gather)",
        })
        meshes = [["cuda:0"] * 2, ["cuda:0"] * 4]
        if torch.cuda.device_count() >= 2:
            meshes.append(["cuda:0", "cuda:1"])
        for devices in meshes:
            sharded_rows.append(check_ragged_sharded(
                torch, mod, out_rows[-1], (q, k_pool, v_pool, pt, slot, pos), out, ref, layers, devices
            ))
    return out_rows, sharded_rows


# ragged_case's layouts: (segments, rows, table pages per sequence; None:
# as many as the longest sequence needs)
RAGGED_LAYOUTS = {
    # the reference tests' layout: a cold segment across a page, a decode
    # row, a suffix from position 7, a padded tail
    "reference": (lambda ps: [(0, 0, 11), (1, min(13, ps * 4 - 1), 1), (2, 7, 5)], 40, 4),
    # one CTA's 32-token window holding six sequences' decode rows, then a
    # run over several CTAs that ends mid-block, then padding
    "several_sequences": (lambda ps: [(s, 7 * s + 3, 1) for s in range(6)] + [(6, 50, 70)], 160, None),
    # a long context: a 512-token segment at position 7680 of an
    # 8192-position table
    "long_context": (lambda ps: [(0, 7680, 512)], 512, None),
}


def ragged_case(torch, gen, h, kvh, d, ps, layout="reference"):
    """A packed buffer in one of RAGGED_LAYOUTS through the ragged kernel
    and its plain version."""
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import ragged

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(torch.bfloat16)

    segments, rows, pps = RAGGED_LAYOUTS[layout]
    segments = segments(ps)
    pps = pps or -(-max(p0 + n for _, p0, n in segments) // ps)
    nseq = len(segments)
    num_pages = nseq * pps + 1
    pt = (torch.randperm(num_pages - 1, generator=torch.Generator().manual_seed(3)) + 1)
    pt = pt.reshape(nseq, pps).to(torch.int32).cuda()
    slot, pos = pack(torch, segments, rows, "cuda")
    args = (rnd(rows, h, d), rnd(num_pages, ps, kvh, d), rnd(num_pages, ps, kvh, d), pt, slot, pos)
    return errors(ragged.ragged_paged_attention(*args), ragged.ragged_paged_attention_plain(*args))


def check_variants(torch, gen) -> list:
    """Correctness only, at small shapes: the head dims, GQA groups and
    page sizes the main path does not use (other supported models), and
    the per-rank head counts of Llama-3-8B on a tensor-parallel mesh
    (16/4 at tp 2, 8/2 at tp 4), which the model hands the decode and
    prefill kernels rank by rank."""
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import decode, prefill

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(torch.bfloat16)

    out = []
    # decode: head dims 64 and 256; GQA groups 8, 2, 7, 1, 4 and 5 (clusters
    # of 2, 8, 2, 8 with two splits a CTA, 4 and 3 CTAs); page sizes 8, 12
    # and 64; positions 0, a partial page and ~1280 (40 tiles: several ring
    # steps a CTA), then batch 1 at position 4095
    for d, h, kvh, ps, positions in ((64, 32, 4, 16, None), (256, 8, 4, 16, None), (128, 28, 4, 8, None),
                                     (128, 8, 8, 16, None), (128, 16, 4, 16, None), (128, 8, 2, 16, None),
                                     (128, 20, 4, 16, None), (128, 32, 8, 12, None), (128, 32, 8, 64, None),
                                     (128, 32, 8, 16, [4095])):
        pps = -(-1280 // ps) if positions is None else -(-(max(positions) + 1) // ps)
        positions = positions or [0, ps + 3, pps * ps - 1]
        b = len(positions)
        num_pages = b * pps + 1
        pt = (torch.randperm(num_pages - 1, generator=torch.Generator().manual_seed(2)) + 1)
        args = (rnd(b, h, d), rnd(num_pages, ps, kvh, d), rnd(num_pages, ps, kvh, d),
                rnd(b, kvh, d), rnd(b, kvh, d), pt.reshape(b, pps).to(torch.int32).cuda(),
                torch.tensor(positions, dtype=torch.int32, device="cuda"))
        err, rel = errors(decode.paged_decode_attention_inline(*args),
                          decode.paged_decode_attention_inline_plain(*args))
        out.append({"kernel": "decode", "head_dim": d, "heads": h, "kv_heads": kvh,
                    "page_size": ps, "positions": positions, "max_abs_err": err, "max_row_rel_err": rel})
        sf = (*args[:3], args[5], args[6] + 1)  # scatter-first: seq_lens = pos + 1
        err, rel = errors(decode.paged_decode_attention(*sf), decode.paged_decode_attention_plain(*sf))
        out.append({"kernel": "decode_scatter_first", "head_dim": d, "heads": h, "kv_heads": kvh,
                    "page_size": ps, "positions": positions, "max_abs_err": err, "max_row_rel_err": rel})
    # prefill: Gemma-3-4B's head_dim 256 with 8/4 heads, one short and one
    # long seq_len; the per-rank 16/4 and 8/2; GQA group 1 (8/8); a bucket
    # clamped to a --max-model-len that is not a power of two (s 3000); a
    # one-token prompt beside a partial last tile (s 200)
    for d, h, kvh, s, lens in ((64, 32, 4, 128, [128, 70]), (128, 28, 4, 64, [1, 50]),
                               (256, 8, 4, 64, [5, 64]), (256, 8, 4, 1024, [9, 1000]),
                               (128, 16, 4, 512, [509, 33]), (128, 8, 2, 512, [509, 33]),
                               (128, 8, 8, 256, [256, 100]), (128, 32, 8, 3000, [3000, 2999]),
                               (128, 32, 8, 200, [1, 130])):
        args = (rnd(len(lens), s, h, d), rnd(len(lens), s, kvh, d), rnd(len(lens), s, kvh, d),
                torch.tensor(lens, dtype=torch.int32, device="cuda"))
        err, rel = errors(prefill.causal_prefill_attention(*args),
                          prefill.causal_prefill_attention_plain(*args))
        out.append({"kernel": "prefill", "head_dim": d, "heads": h, "kv_heads": kvh,
                    "seq": s, "seq_lens": lens, "max_abs_err": err, "max_row_rel_err": rel})
    # ragged: head dims 64 and 256, GQA groups 1, 2, 7 and 8, page size 8;
    # then several sequences in one CTA's window at groups 4, 1 and 8, and
    # the long context
    for d, h, kvh, ps, layout in ((64, 32, 4, 16, "reference"), (256, 8, 4, 16, "reference"),
                                  (128, 28, 4, 8, "reference"), (128, 8, 8, 16, "reference"),
                                  (128, 32, 4, 8, "reference"), (128, 16, 4, 16, "reference"),
                                  (128, 8, 2, 16, "reference"), (128, 32, 8, 16, "several_sequences"),
                                  (128, 8, 8, 8, "several_sequences"), (128, 64, 8, 16, "several_sequences"),
                                  (128, 32, 8, 16, "long_context")):
        err, rel = ragged_case(torch, gen, h, kvh, d, ps, layout)
        out.append({"kernel": "ragged", "layout": layout, "head_dim": d, "heads": h, "kv_heads": kvh,
                    "page_size": ps, "max_abs_err": err, "max_row_rel_err": rel})
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


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import build, decode, prefill, ragged

    return {
        "probe": build.launch_probe,
        "decode_inline": decode.paged_decode_attention_inline,
        "decode_scatter_first": decode.paged_decode_attention,
        "prefill": prefill.causal_prefill_attention,
        "ragged": ragged.ragged_paged_attention,
        "ragged_sharded": ragged.ragged_paged_attention_sharded,
    }


def reset_counts() -> None:
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    wrappers["prefill"].launches_by_seq.clear()
    wrappers["ragged"].launches_by_rows.clear()
    wrappers["ragged_sharded"].launches_by_rows.clear()


def read_counts() -> dict:
    wrappers = kernel_wrappers()
    counts = {k: fn.launches for k, fn in wrappers.items()}
    counts["prefill_by_seq"] = dict(wrappers["prefill"].launches_by_seq)
    counts["ragged_by_rows"] = dict(wrappers["ragged"].launches_by_rows)
    counts["ragged_sharded_by_rows"] = dict(wrappers["ragged_sharded"].launches_by_rows)
    return counts


def start_service(torch, opts: str):
    """An EngineService and its HTTP server on a free port, and the card's
    free bytes just before it started (after the previous phase's memory
    was given back). The kernel counts are set to 0 just before, so the
    engine's probe launch and the warm-up runs before its graph captures
    count."""
    from llm_d_fast_model_actuation_tpu_torch.engine import server as srv

    free_memory(torch)
    free_before = torch.cuda.mem_get_info()[0]
    reset_counts()
    t0 = time.monotonic()
    service = srv.EngineService(srv.parse_engine_options(opts))
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    server = srv.serve(service, "127.0.0.1", 0)
    return service, server, init_s, free_before


def mapped_bytes(eng) -> int:
    return sum(a.mapped_bytes for a in eng.arenas.values())


def state_ptrs(eng) -> list:
    """(object, address) of every tensor of the engine's device state: the
    weights, the RoPE tables, the page pool, the scheduler and noise
    buffers."""
    tensors = list(eng.model.parameters()) + list(eng.model.buffers()) + eng.pool.tensors() + eng.sched_tensors()
    return [(id(t), t.data_ptr()) for t in tensors]


def graph_stats(eng) -> dict:
    """The engine's chunk graphs: captures, replays against the chunks the
    serving path ran, capture seconds, and what its arenas map."""
    return {"graph_captures": eng.graph_captures, "graph_replays": eng.graph_replays,
            "decode_chunks": eng.decode_chunks, "eager_chunks": eng.decode_chunks - eng.graph_replays,
            "capture_s": eng.capture_s, "mapped_bytes": mapped_bytes(eng),
            "reserved_va_bytes": sum(a.reserved_va_bytes for a in eng.arenas.values())}


# the ported kernels a captured chunk holds, by the mangled name the CUDA
# driver gives a graph's kernel node (decode_kernel<HEAD_DIM, INLINE>)
GRAPH_KERNELS = {"decode_inline": ("decode_kernel", "ELb1E"), "decode_scatter_first": ("decode_kernel", "ELb0E")}


def graph_kernels(by_name: dict) -> dict:
    """Kernel nodes or launches by kernel name, summed per ported kernel
    of the captured chunk, keyed as ``kernel_wrappers()``."""
    return {key: sum(n for name, n in by_name.items() if all(m in name for m in marks))
            for key, marks in GRAPH_KERNELS.items()}


def path_counts(eng) -> dict:
    """A serve phase's kernel launches: the wrappers' counts, which are
    eager launches, plus what the engine's graph replays launched, read
    from each captured graph's kernel nodes (``engine/graphs.py``) times
    its replays; the two parts of each decode count under ``eager`` and
    ``replayed``."""
    counts = read_counts()
    replayed = graph_kernels(eng.graphs.replayed_launches() if eng.graphs else {})
    counts["eager"] = {k: counts[k] for k in GRAPH_KERNELS}
    counts["replayed"] = replayed
    for k, n in replayed.items():
        counts[k] += n
    return counts


def check_replays(eng, counts: dict, key: str) -> None:
    """Every decode chunk the serving path ran was a graph replay; each
    captured graph holds L x T nodes of the path's decode kernel
    (``key``) and none of the other's; the replays launched it L x their
    decode steps and the eager runs (the warm-ups before the captures) L
    x theirs."""
    if eng.graph_captures != 4 or eng.decode_chunks == 0 or eng.graph_replays != eng.decode_chunks:
        raise AssertionError(f"not every decode chunk replayed a captured graph: {graph_stats(eng)}")
    L = eng.cfg.model.num_layers
    for (T, sampled), program in eng.graphs.programs.items():
        nodes = graph_kernels(program.kernels)
        if nodes[key] != L * T or sum(nodes.values()) != L * T:
            raise AssertionError(f"the captured T={T} chunk (sampled={sampled}) holds decode kernel nodes {nodes}, "
                                 f"want {L} x {T} of {key}")
    replay_steps = sum(p.steps * p.replays for p in eng.graphs.programs.values())
    eager_steps = eng.decode_steps - replay_steps
    if replay_steps == 0 or counts["replayed"][key] != L * replay_steps or counts["eager"][key] != L * eager_steps:
        raise AssertionError(f"{key} launches {counts['eager'][key]} eager and {counts['replayed'][key]} replayed, "
                             f"want {L} x {eager_steps} and {L} x {replay_steps} (> 0) decode steps")


def check_asleep(torch, eng, free_before: int) -> dict:
    """While asleep: nothing of the engine's arenas is mapped, and the
    card's free memory is within 1 GiB of what it was before the server
    started (memory the arenas map is invisible to ``memory_reserved``)."""
    free = torch.cuda.mem_get_info()[0]
    if mapped_bytes(eng) != 0:
        raise AssertionError(f"{mapped_bytes(eng)} bytes of the arena are still mapped while asleep")
    if free < free_before - GIB:
        raise AssertionError(f"{(free_before - free) / GIB:.2f} GiB less free while asleep than before the server started")
    return {"mapped_while_asleep_bytes": mapped_bytes(eng), "free_while_asleep_bytes": free,
            "free_before_server_bytes": free_before}


def stop_service(torch, service, server) -> None:
    server.shutdown()
    server.server_close()
    service.shutdown()


def free_memory(torch) -> float:
    """Collect the previous phase's objects and give their blocks back;
    returns the bytes still allocated, in GiB."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / GIB


def run_traffic(torch, port: int, vocab: int) -> dict:
    """The serve phases' traffic: four concurrent greedy completions
    (prompts of 20, 300, 1500 and 3000 token ids, 64 tokens each), then a
    fifth request sharing a 512-token prefix with the third."""
    import numpy as np

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n).tolist() for n in (20, 300, 1500, 3000)]
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
    # 200 fresh ids -> a prefix-cache hit
    shared = prompts[2][:512] + rng.integers(0, vocab, 200).tolist()
    t2 = time.monotonic()
    fifth = post(port, "/v1/completions", {"prompt": shared, "max_tokens": 64})
    fifth_s = time.monotonic() - t2
    torch.cuda.synchronize()
    for r in results + [fifth]:
        ids = r["choices"][0]["token_ids"]
        if len(ids) != 64 or not all(0 <= t < vocab for t in ids):
            raise AssertionError(f"bad completion {ids[:8]}...")
    completion = sum(r["usage"]["completion_tokens"] for r in results)
    return {
        "prompts": prompts,
        "request_prompts": prompts + [shared],  # one per completion in "tokens"
        "tokens": [r["choices"][0]["token_ids"] for r in results + [fifth]],
        "summary": {
            "ttft_s": {str(len(p)): r["usage"]["time_to_first_token_s"] for p, r in zip(prompts, results)},
            "decode_tpot_s": {str(len(p)): r["usage"]["decode_tpot_s"] for p, r in zip(prompts, results)},
            "batch_wall_s": batch_s,
            "batch_tok_per_s": completion / batch_s,
            "decode_tok_per_s_per_seq": {
                str(len(p)): 1.0 / r["usage"]["decode_tpot_s"] for p, r in zip(prompts, results)
            },
            "prefix_hit_request_s": fifth_s,
            "prefix_hit_ttft_s": fifth["usage"]["time_to_first_token_s"],
        },
    }


def first_differences(tokens: list, bucketed: list) -> list:
    """For each completion, the first position where its tokens differ
    from the bucketed run's, or None where they are equal."""
    return [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), None) for x, y in zip(tokens, bucketed)]


def check_probe_launch(counts: dict) -> None:
    if counts["probe"] != 1:
        raise AssertionError(f"the engine launched the probe kernel {counts['probe']} times at start, want 1")


def serve_and_sleep(torch, smi: str) -> dict:
    # the reference EngineConfig's default pool: 2048 pages x 16 tokens
    opts = "--model llama3-8b --num-pages 2048 --seed 0 --max-batch 8 --device cuda"
    service, server, init_s, free_before = start_service(torch, opts)
    port = server.server_address[1]
    try:
        eng = service.engine
        L = eng.cfg.model.num_layers
        vocab = eng.cfg.model.vocab_size
        torch.cuda.reset_peak_memory_stats()
        warmup_steps, cold0 = eng.decode_steps, eng.cold_prefills
        traffic = run_traffic(torch, port, vocab)
        counts = path_counts(eng)
        # the counts were set to 0 before the engine started: its warm-up
        # runs before the graph captures launched kernels too
        steps = eng.decode_steps
        colds = eng.cold_prefills - cold0
        check_probe_launch(counts)
        check_replays(eng, counts, "decode_inline")
        if counts["decode_inline"] != L * steps or steps == warmup_steps:
            raise AssertionError(f"decode kernel launches {counts['decode_inline']} != {L} x {steps} decode steps")
        if counts["prefill"] != L * colds or colds != 4:
            raise AssertionError(f"prefill kernel launches {counts['prefill']} != {L} x {colds} cold prefills (want 4)")
        if counts["ragged"] or counts["ragged_sharded"] or counts["decode_scatter_first"]:
            raise AssertionError(f"the bucketed path launched kernels off its path: {counts}")
        hits = eng.prefix_cache.stats()["hits"] if eng.prefix_cache else 0
        if hits < 1:
            raise AssertionError("the fifth request did not hit the prefix cache")
        emit({
            "phase": "serve", "model": "llama3-8b", "layers": L,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "init_s": init_s, **traffic["summary"],
            "decode_steps": steps, "warmup_decode_steps": warmup_steps,
            "decode_launches": counts["decode_inline"], **graph_stats(eng),
            "cold_prefills": colds, "prefill_launches": counts["prefill"],
            "prefill_launches_by_seq": counts["prefill_by_seq"],
            "launches": counts,
            "prefix_cache": eng.prefix_cache.stats(),
            "peak_allocated_gib": torch.cuda.max_memory_allocated() / GIB,
        })

        # -- sleep / wake, three cycles (the spread of one transfer per call
        #    is too wide to read): the reference output is a repeat of
        #    request 1 (a prefix-cache hit, the path every repeat takes)
        probe = {"prompt": traffic["prompts"][0], "max_tokens": 64}
        before = post(port, "/v1/completions", probe)["choices"][0]["token_ids"]
        ptrs, captures = state_ptrs(eng), eng.graph_captures
        cycles = []
        for _ in range(3):
            info = post(port, "/sleep?level=1")
            if not get(port, "/is_sleeping")["is_sleeping"]:
                raise AssertionError("/is_sleeping is false after /sleep")
            asleep = check_asleep(torch, eng, free_before)
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
            if eng.graph_captures != captures or state_ptrs(eng) != ptrs:
                raise AssertionError("a sleep/wake cycle re-captured a graph or moved a state tensor")
            nbytes = info["bytes_offloaded"]
            cycles.append({
                "sleep_s": info["last_sleep_seconds"], "sleep_pin_s": pin_s,
                "wake_s": woke["last_wake_seconds"],
                "wake_alloc_s": service.sleeper.stats.last_alloc_seconds,
                "wake_map_s": service.sleeper.stats.wake_map_s,
                "wake_gib_per_s": nbytes / GIB / woke["last_wake_seconds"],
                "reserved_while_asleep_bytes": reserved,
                "allocated_while_asleep_bytes": allocated, **asleep,
            })
        level2 = level2_cycle(torch, service, port, eng, free_before, probe, before, ptrs, captures)
        check_replays(eng, path_counts(eng), "decode_inline")
        emit({
            "phase": "sleep_wake", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "bytes_offloaded": nbytes, "cycles": cycles, "tokens_identical": True,
            "graph_captures_unchanged": True, "state_addresses_unchanged": len(ptrs),
            "wake_bar_s": WAKE_BAR_S, "wake_within_bar": all(c["wake_s"] <= WAKE_BAR_S for c in cycles),
            "level2": level2, **graph_stats(eng),
        })
        if get(port, "/health")["status"] != "OK":
            raise AssertionError("server is not healthy")
        return {"counts": counts, "summary": traffic["summary"], "tokens": traffic["tokens"],
                "prompts": traffic["request_prompts"], "bytes_offloaded": nbytes}
    finally:
        stop_service(torch, service, server)


# a level-2 wake draws the weights into the live tensors one fp32 draw at a
# time; the largest, the embedding's [128256, 4096], is 1.96 GiB, where a
# second copy of the state would be 18.96 GiB
LEVEL2_WAKE_PEAK = 3 * GIB


def weight_sums(torch, eng) -> list:
    """A float64 sum of every parameter, layer by layer for stacked ones."""
    return [[x.sum(dtype=torch.float64).item() for x in (p if p.dim() == 3 else [p])] for p in eng.model.parameters()]


def level2_cycle(torch, service, port, eng, free_before, probe, before, ptrs, captures) -> dict:
    """One level-2 sleep and wake through the server: nothing mapped while
    asleep; the wake draws the weights anew from the seed into the same
    tensors (the same numbers: :func:`weight_sums` is unchanged), zeroes
    the pool, allocates under ``LEVEL2_WAKE_PEAK`` of ordinary memory at
    its peak, and moves and re-captures nothing; a
    completion after it is 64 valid tokens (whether they equal the
    level-1 repeat's is printed: the repeat hit the prefix cache, which
    the level-2 wake emptied)."""
    sums = weight_sums(torch, eng)
    info = post(port, "/sleep?level=2")
    asleep = check_asleep(torch, eng, free_before)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    woke = post(port, "/wake_up")
    peak = torch.cuda.max_memory_allocated() - allocated
    if peak >= LEVEL2_WAKE_PEAK:
        raise AssertionError(f"the level-2 wake allocated {peak / GIB:.2f} GiB at its peak (limit {LEVEL2_WAKE_PEAK / GIB} GiB)")
    if weight_sums(torch, eng) != sums:
        raise AssertionError("the level-2 wake drew other weights than the engine's seed gives")
    if any(t.view(torch.int16).any().item() for t in eng.pool.tensors()):
        raise AssertionError("the level-2 wake left a non-zero page in the pool")
    if eng.graph_captures != captures or state_ptrs(eng) != ptrs:
        raise AssertionError("the level-2 wake re-captured a graph or moved a state tensor")
    after = post(port, "/v1/completions", probe)["choices"][0]["token_ids"]
    if len(after) != 64 or not all(0 <= t < eng.cfg.model.vocab_size for t in after):
        raise AssertionError(f"bad completion after the level-2 wake {after[:8]}...")
    return {"sleep_s": info["last_sleep_seconds"], "wake_s": woke["last_wake_seconds"],
            "wake_map_s": service.sleeper.stats.wake_map_s, "wake_peak_allocated_bytes": peak,
            "weights_redrawn_equal": True, "pool_zero": True,
            "tokens_equal_to_level1_repeat": after == before, **asleep}


# -- phase graphs: the captured chunk against the eager one -----------------

GRAPH_PROMPT_LENS = (20, 300, 1500, 3000) * 2  # the serve traffic's lengths, 8 slots
GRAPH_SAMPLED = (1, 6)  # requests that sample (seeded), beside six greedy ones


def pool_reserved_bytes(torch, pool) -> int:
    """Bytes of the caching allocator's segments that belong to the graph
    memory pool ``pool``."""
    return sum(g["total_size"] for g in torch.cuda.memory_snapshot() if tuple(g.get("segment_pool_id", ())) == tuple(pool))


def graph_parity(torch, eng, T: int, sampled: bool) -> dict:
    """One chunk of ``T`` steps replayed from its graph, then — on a copy
    of the state as it was before — run eagerly: tokens, logprobs, top-k
    alternatives, the KV pool and the scheduler state must be bit-equal."""
    slots = [s for s, r in eng._running().items() if r.temperature > 0]
    if eng._dirty:
        eng._upload_sched()
    if sampled:
        eng._draw_chunk_noise(slots, T)
    state = eng.pool.tensors() + eng.sched_tensors()
    saved = [t.clone() for t in state]
    captures, eager0 = eng.graph_captures, read_counts()["decode_inline"]
    replayed0 = graph_kernels(eng.graphs.replayed_launches())["decode_inline"]
    replay = [x.clone() for x in flat_outputs(eng.graphs.replay(T, sampled))]
    after_graph = [t.clone() for t in state]
    eager_launches = read_counts()["decode_inline"] - eager0
    replay_launches = graph_kernels(eng.graphs.replayed_launches())["decode_inline"] - replayed0
    for t, s in zip(state, saved):
        t.copy_(s)
    eager = flat_outputs(eng.chunk_eager(T, sampled))
    torch.cuda.synchronize()
    equal = {
        "tokens": torch.equal(replay[0], eager[0]), "logprobs": torch.equal(replay[1], eager[1]),
        "alternatives": all(torch.equal(a, b) for a, b in zip(replay[2:], eager[2:])),
        "kv_pages": all(torch.equal(a, b) for a, b in zip(after_graph[:2], state[:2])),
        "sched_state": all(torch.equal(a, b) for a, b in zip(after_graph[2:], state[2:])),
    }
    if not all(equal.values()) or eng.graph_captures != captures:
        raise AssertionError(f"the replayed T={T} chunk (sampled={sampled}) differs from the eager one: {equal}")
    if replay_launches != eng.cfg.model.num_layers * T or eager_launches:
        raise AssertionError(f"the replay ran {replay_launches} decode kernel nodes (want {eng.cfg.model.num_layers} x {T}) "
                             f"and {eager_launches} eager decode launches (want 0)")
    del saved, after_graph
    return {"T": T, "sampled": sampled, "sampled_slots": slots if sampled else [], "bit_equal": equal,
            "decode_launches_replayed": replay_launches}


KERNEL_KINDS = (
    ("decode attention", ("decode_kernel",)),
    ("weight products", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas", "Kernel2")),
    ("top-k and sort", ("topk", "sort", "Sort", "radix", "select")),
)


def chunk_device_profile(torch, eng, T: int) -> dict:
    """The device time of one replayed greedy chunk of ``T`` steps with
    eight sequences running: its mean over three replays from CUDA events,
    and its kernels from ``torch.profiler`` (one replay), summed by kind
    and the largest by name. Each replay advances the running state."""
    from torch.profiler import ProfilerActivity, profile

    chunk_ms = time_ms(lambda: eng.graphs.replay(T, False), 3, warmup=1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.graphs.replay(T, False)
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if us > 0:
            kernels.append((e.key, us / 1e3, e.count))
    # the profiler's count of the decode kernel's runs in that replay, held
    # against the kernel nodes read from the captured graph
    ran = sum(c for name, _, c in kernels if "decode_kernel" in name)
    nodes = graph_kernels(eng.graphs.programs[(T, False)].kernels)["decode_inline"]
    if ran != nodes or ran != eng.cfg.model.num_layers * T:
        raise AssertionError(f"the profiled replay ran the decode kernel {ran} times; its graph holds {nodes} "
                             f"nodes, want {eng.cfg.model.num_layers} x {T}")
    by_kind = {}
    for name, ms, _ in kernels:
        kind = next((k for k, marks in KERNEL_KINDS if any(m in name for m in marks)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms / T
    traced = sum(ms for _, ms, _ in kernels)
    return {
        "chunk_steps": T, "chunk_device_ms": chunk_ms, "step_device_ms": chunk_ms / T,
        "decode_kernel_runs_profiled": ran, "decode_kernel_nodes": nodes,
        "profiled_step_ms": traced / T if kernels else "not measured",
        "profiled_step_ms_by_kind": by_kind or "not measured",
        "largest_kernels": [{"name": n[:90], "ms_per_step": ms / T, "launches_per_step": c / T}
                            for n, ms, c in sorted(kernels, key=lambda k: -k[1])[:12]],
    }


def flat_outputs(out) -> list:
    toks, lps, alts = out
    return [toks, lps, *(alts or ())]


def timed_run(torch, eng, prompts) -> dict:
    """Eight requests through ``step()`` to 64 tokens each: batch tokens/s
    over the whole run, TPOT per request (first token to last), and the
    mean wall time of a decode step after the first engine step."""
    reqs = [
        eng.add_request(p, max_new_tokens=64, **({"temperature": 0.8, "seed": 7 + i} if i in GRAPH_SAMPLED else {}))
        for i, p in enumerate(prompts)
    ]
    done, steps_wall, steps0 = {}, 0.0, None
    t0 = time.monotonic()
    while eng.has_work():
        t_step = time.monotonic()
        finished = eng.step()
        torch.cuda.synchronize()
        now = time.monotonic()
        if steps0 is None:
            steps0 = eng.decode_steps  # the first step prefilled all eight
        else:
            steps_wall += now - t_step
        for r in finished:
            done[r.seq_id] = (r, now)
    wall = time.monotonic() - t0
    if sorted(done) != sorted(reqs) or any(len(r.out_tokens) != 64 for r, _ in done.values()):
        raise AssertionError("a timed request did not finish with 64 tokens")
    tpot = [(now - r.first_token_time) / 63 for r, now in done.values()]
    return {"batch_tok_per_s": 8 * 64 / wall, "wall_s": wall, "tpot_s_mean": sum(tpot) / len(tpot),
            "tpot_s": tpot, "decode_step_ms": 1e3 * steps_wall / max(1, eng.decode_steps - steps0),
            "tokens": [done[i][0].out_tokens for i in reqs]}


def graphs_phase(torch, smi: str) -> dict:
    """A llama3-8b engine at full width and depth built directly: the
    captured T = 8 and T = 1 chunks held bit for bit against the eager
    chunk on the same state, then TPOT and tokens/s with the graphs and
    without them (on, off, off, on, in this one call)."""
    import numpy as np

    from llm_d_fast_model_actuation_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from llm_d_fast_model_actuation_tpu_torch.models import llama

    free_memory(torch)
    reset_counts()
    cfg = EngineConfig(model=llama.LlamaConfig.llama3_8b(), max_batch=8, num_pages=2048, prefix_caching=False)
    t0 = time.monotonic()
    eng = InferenceEngine(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    arena = eng.arenas[eng.device]
    pool_bytes = pool_reserved_bytes(torch, eng.graphs.pool)
    vocab = cfg.model.vocab_size
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, n).tolist() for n in GRAPH_PROMPT_LENS]
    for i, p in enumerate(prompts):  # room for the parity chunks and the profile's
        eng.add_request(p, max_new_tokens=200, **({"temperature": 0.8, "seed": 7 + i} if i in GRAPH_SAMPLED else {}))
    eng.step()  # eight cold prefills and the first chunk
    if len(eng._running()) != 8:
        raise AssertionError("the eight requests are not all running")
    parity = [graph_parity(torch, eng, T, sampled) for T in (8, 1) for sampled in (True, False)]
    device = chunk_device_profile(torch, eng, 8)
    eng.abort_all("parity check done")
    runs, graphs = {}, eng.graphs
    for name in ("graphs_on", "graphs_off", "graphs_off_2", "graphs_on_2"):
        eng.graphs = None if name.startswith("graphs_off") else graphs  # off: the eager chunk
        runs[name] = timed_run(torch, eng, prompts)
    eng.graphs = graphs
    tokens = {k: r.pop("tokens") for k, r in runs.items()}
    if any(t != tokens["graphs_off"] for t in tokens.values()):
        raise AssertionError("the requests' tokens with the graphs differ from those without them")

    def mean(key, on):
        vals = [r[key] for k, r in runs.items() if k.startswith("graphs_on") == on]
        return sum(vals) / len(vals)

    out = {
        "phase": "graphs", "model": "llama3-8b", "layers": cfg.model.num_layers, "batch": 8,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "init_s": init_s,
        "capture_s": eng.capture_s, "graph_captures": eng.graph_captures,
        "graph_pool_reserved_bytes": pool_bytes, "arena_granularity": arena.granularity,
        "arena_reserved_va_bytes": arena.reserved_va_bytes, "arena_mapped_bytes": arena.mapped_bytes,
        "arena_blocks": len(arena.blocks), "parity": parity, "device": device, "runs": runs,
        "tpot_s": {"graphs_on": mean("tpot_s_mean", True), "graphs_off": mean("tpot_s_mean", False)},
        "batch_tok_per_s": {"graphs_on": mean("batch_tok_per_s", True), "graphs_off": mean("batch_tok_per_s", False)},
        "decode_step_ms": {"graphs_on": mean("decode_step_ms", True), "graphs_off": mean("decode_step_ms", False)},
        "tokens_equal_graphs_on_and_off": True,
    }
    emit(out)
    return out


def serve_packed(torch, smi: str, bucketed: dict) -> dict:
    """The serve phase's traffic through a packed server: prompts stream
    into mixed steps beside the running decode rows."""
    left_gib = free_memory(torch)
    opts = ("--model llama3-8b --num-pages 2048 --seed 0 --max-batch 8 --device cuda "
            "--packed-serving on")
    service, server, init_s, _ = start_service(torch, opts)
    try:
        eng = service.engine
        L = eng.cfg.model.num_layers
        torch.cuda.reset_peak_memory_stats()
        traffic = run_traffic(torch, server.server_address[1], eng.cfg.model.vocab_size)
        counts = path_counts(eng)
        check_probe_launch(counts)
        check_replays(eng, counts, "decode_inline")
        if eng.packed_steps == 0 or counts["ragged"] != L * eng.packed_steps:
            raise AssertionError(f"ragged kernel launches {counts['ragged']} != {L} x {eng.packed_steps} packed steps (> 0)")
        if counts["prefill"] or counts["ragged_sharded"]:
            raise AssertionError(f"the one-rank packed path launched kernels off its path: {counts}")
        if counts["decode_inline"] != L * eng.decode_steps or eng.decode_steps == 0:
            raise AssertionError(f"decode kernel launches {counts['decode_inline']} != {L} x {eng.decode_steps} decode steps")
        if eng.prefix_cache.stats()["hits"] < 1:
            raise AssertionError("the fifth request did not hit the prefix cache")
        untimed = sorted(set(counts["ragged_by_rows"]) - set(RAGGED_ROWS))
        if untimed:
            raise AssertionError(f"the packed run launched ragged at untimed buffer sizes {untimed}")
        same = sum(a == b for a, b in zip(traffic["tokens"], bucketed["tokens"]))
        emit({
            "phase": "serve_packed", "model": "llama3-8b", "layers": L,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "allocated_before_gib": left_gib, "init_s": init_s, **traffic["summary"],
            "bucketed": bucketed["summary"],
            "packed_steps": eng.packed_steps, "packed_tokens_total": eng.packed_tokens_total,
            "decode_steps": eng.decode_steps, "launches": counts, **graph_stats(eng),
            "pad_waste_bytes": eng.pad_waste_bytes, "dispatch_tokens": eng.dispatch_tokens,
            "step_h2d_bytes": eng.step_h2d_bytes,
            "completions_equal_to_bucketed": f"{same}/{len(traffic['tokens'])} (bf16; not gated)",
            "first_difference_from_bucketed": first_differences(traffic["tokens"], bucketed["tokens"]),
            "prefix_cache": eng.prefix_cache.stats(),
            "peak_allocated_gib": torch.cuda.max_memory_allocated() / GIB,
        })
        return {"counts": counts, "summary": traffic["summary"], "tokens": traffic["tokens"]}
    finally:
        stop_service(torch, service, server)


def serve_tp2_packed(torch, smi: str, bucketed: dict, packed: dict) -> tuple:
    """The serve phases' traffic through a tensor-parallel packed server:
    two ranks, both on card 0. Then one level-1 sleep and wake. Returns
    the phase's numbers and its (stopped) engine, whose two-rank model
    the model-parity phase holds against the one-rank model."""
    from llm_d_fast_model_actuation_tpu_torch.engine.graphs import graphs_alive

    left_gib = free_memory(torch)
    tp = 2
    opts = ("--model llama3-8b --num-pages 2048 --seed 0 --max-batch 8 --tensor-parallel-size 2 "
            "--device cuda:0,cuda:0 --packed-serving on")
    service, server, init_s, free_before = start_service(torch, opts)
    port = server.server_address[1]
    try:
        eng = service.engine
        L = eng.cfg.model.num_layers
        if eng.mesh is None or eng.mesh.tp != tp or eng.mixed_impl != "ragged_sharded":
            raise AssertionError("the server did not build a two-rank engine")
        shard_shapes = [tuple(k.shape) for k, _ in eng.pool.shards]
        wq = [tuple(m.layers["wq"].shape) for m in eng.model.ranks]
        torch.cuda.reset_peak_memory_stats()
        traffic = run_traffic(torch, port, eng.cfg.model.vocab_size)
        counts = path_counts(eng)  # all eager: the mesh captures no graph
        check_probe_launch(counts)  # two ranks, one distinct device: one probe
        # read now: the sleep/wake probes below add steps of their own
        steps, decode_steps, packed_tokens = eng.packed_steps, eng.decode_steps, eng.packed_tokens_total
        h2d = dict(eng.step_h2d_bytes)
        if steps == 0 or counts["ragged_sharded"] != tp * L * steps:
            raise AssertionError(f"sharded ragged launches {counts['ragged_sharded']} != {tp} x {L} x {steps} packed steps (> 0)")
        if counts["ragged"] or counts["prefill"] or counts["decode_scatter_first"]:
            raise AssertionError(f"the two-rank packed path launched kernels off its path: {counts}")
        if counts["decode_inline"] != tp * L * decode_steps or decode_steps == 0:
            raise AssertionError(f"decode kernel launches {counts['decode_inline']} != {tp} x {L} x {decode_steps} decode steps")
        if eng.prefix_cache.stats()["hits"] < 1:
            raise AssertionError("the fifth request did not hit the prefix cache")
        untimed = sorted(set(counts["ragged_sharded_by_rows"]) - set(RAGGED_ROWS))
        if untimed:
            raise AssertionError(f"the two-rank packed run launched ragged at untimed buffer sizes {untimed}")
        same = sum(a == b for a, b in zip(traffic["tokens"], bucketed["tokens"]))
        peak = torch.cuda.max_memory_allocated() / GIB
        # one level-1 sleep and wake; the reference output is a repeat of
        # request 1 on this same engine (a prefix-cache hit)
        probe = {"prompt": traffic["prompts"][0], "max_tokens": 64}
        before = post(port, "/v1/completions", probe)["choices"][0]["token_ids"]
        ptrs = state_ptrs(eng)
        info = post(port, "/sleep?level=1")
        asleep = check_asleep(torch, eng, free_before)
        reserved, allocated = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
        if reserved != 0:
            raise AssertionError(
                f"{reserved} bytes still reserved while the two-rank engine sleeps ({allocated} allocated; "
                f"an engine of this process holds captured graphs: {graphs_alive()})"
            )
        if info["bytes_offloaded"] != bucketed["bytes_offloaded"]:
            raise AssertionError(
                f"bytes_offloaded {info['bytes_offloaded']} at tp={tp} != {bucketed['bytes_offloaded']} at tp=1"
            )
        woke = post(port, "/wake_up")
        after = post(port, "/v1/completions", probe)["choices"][0]["token_ids"]
        if after != before:
            raise AssertionError(f"tokens changed across the two-rank sleep/wake: {before[:8]} vs {after[:8]}")
        if [tuple(k.shape) for k, _ in eng.pool.shards] != shard_shapes or any(
            k.device != d or v.device != d for (k, v), d in zip(eng.pool.shards, eng.mesh.devices)
        ) or state_ptrs(eng) != ptrs:
            raise AssertionError("a pool shard did not come back to its rank and its addresses")
        if eng.graph_captures or eng.graph_replays:
            raise AssertionError("the two-rank engine captured or replayed a graph (its chunk is eager)")
        host_bytes = info["bytes_offloaded"] + sum(t.numel() * t.element_size() for t in eng.model.replicas())
        emit({
            "phase": "serve_tp2_packed", "model": "llama3-8b", "layers": L, "tp": tp,
            "mesh": [str(d) for d in eng.mesh.devices], "mixed_impl": eng.mixed_impl,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "pool_shard_shapes": shard_shapes, "wq_shard_shapes": wq,
            "allocated_before_gib": left_gib, "init_s": init_s, **traffic["summary"],
            "tp1_packed": packed["summary"],
            "packed_steps": steps, "packed_tokens_total": packed_tokens,
            "decode_steps": decode_steps, "launches": counts,
            "step_h2d_bytes": h2d,
            "completions_equal_to_bucketed": f"{same}/{len(traffic['tokens'])} (bf16; not gated)",
            "first_difference_from_bucketed": first_differences(traffic["tokens"], bucketed["tokens"]),
            "prefix_cache": eng.prefix_cache.stats(), "peak_allocated_gib": peak,
            "sleep_wake": {
                "bytes_offloaded": info["bytes_offloaded"], "bytes_offloaded_tp1": bucketed["bytes_offloaded"],
                "host_bytes_with_replicas": host_bytes,
                "sleep_s": info["last_sleep_seconds"], "sleep_pin_s": service.sleeper.stats.last_pin_seconds,
                "wake_s": woke["last_wake_seconds"],
                "wake_gib_per_s": host_bytes / GIB / woke["last_wake_seconds"],
                "reserved_while_asleep_bytes": reserved, "allocated_while_asleep_bytes": allocated,
                **asleep, "tokens_identical": True, "state_addresses_unchanged": len(ptrs),
            },
            **graph_stats(eng),
            "note": "two ranks on one card add launches and remove none: times are for reading, not a claim",
        })
        if get(port, "/health")["status"] != "OK":
            raise AssertionError("server is not healthy")
        return {"counts": counts, "summary": traffic["summary"], "tokens": traffic["tokens"]}, eng
    finally:
        stop_service(torch, service, server)


def serve_reference(torch, smi: str, bucketed: dict) -> tuple:
    """The serve phase's traffic with ``--attention-impl reference``: the
    scatter-first decode branch. Returns the phase's numbers and its
    (stopped) engine, whose weights the model-parity phase uses."""
    left_gib = free_memory(torch)
    opts = ("--model llama3-8b --num-pages 2048 --seed 0 --max-batch 8 --device cuda "
            "--attention-impl reference")
    service, server, init_s, _ = start_service(torch, opts)
    try:
        eng = service.engine
        L = eng.cfg.model.num_layers
        traffic = run_traffic(torch, server.server_address[1], eng.cfg.model.vocab_size)
        counts = path_counts(eng)
        check_probe_launch(counts)
        check_replays(eng, counts, "decode_scatter_first")
        if counts["decode_scatter_first"] != L * eng.decode_steps or eng.decode_steps == 0:
            raise AssertionError(
                f"scatter-first decode launches {counts['decode_scatter_first']} != {L} x {eng.decode_steps} decode steps"
            )
        if counts["decode_inline"] or counts["ragged"] or counts["ragged_sharded"]:
            raise AssertionError(f"the scatter-first path launched kernels off its path: {counts}")
        if counts["prefill"] != L * eng.cold_prefills or eng.cold_prefills != 4:
            raise AssertionError(f"prefill kernel launches {counts['prefill']} != {L} x {eng.cold_prefills} cold prefills (want 4)")
        same = sum(a == b for a, b in zip(traffic["tokens"], bucketed["tokens"]))
        emit({
            "phase": "serve_reference", "model": "llama3-8b", "layers": L,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "allocated_before_gib": left_gib, "init_s": init_s, **traffic["summary"],
            "decode_steps": eng.decode_steps, "launches": counts, **graph_stats(eng),
            "completions_equal_to_bucketed": f"{same}/{len(traffic['tokens'])} (bf16; not gated)",
            "first_difference_from_bucketed": first_differences(traffic["tokens"], bucketed["tokens"]),
        })
        return {"counts": counts, "summary": traffic["summary"], "tokens": traffic["tokens"]}, eng
    finally:
        stop_service(torch, service, server)


# Model parity at full width, bf16 on both sides. Stated before the first
# run, from bf16 rounding: two paths that compute the same function round
# differently (another product shape picks another cuBLAS tiling; another
# attention kernel sums in another order), each rounding to bf16 moves a
# value by at most u = 2**-8 relative, and a layer rounds its hidden state
# some ten times. If every rounding of 32 layers differed, independently,
# the hidden state and so the logits would drift by u * sqrt(320) = 0.07 of
# their norm; far fewer differ, so the limit on ||a - b|| / ||b|| over the
# vocabulary is 5e-2 for mixed_step against prefill. The two decode
# branches differ only in the attention's order of summation, one bf16
# rounding per layer: u * sqrt(32) = 2.2e-2, so the limit is 2e-2. Argmax
# agreement is reported, not gated (bf16 near-ties can flip it).
#
# Two ranks against one, on the same weights: every row-parallel product
# (wo, w_down) is summed as two bf16 halves instead of one fp32
# accumulation, one more bf16 rounding at each of the 64 reduces, so
# u * sqrt(64) = 3.1e-2 if every one moved every value; the sum rounds the
# way the single product does for most values, so the limit is 2e-2 for
# mixed_step and for decode_step, and the argmax must agree.
PARITY_TOL = {"mixed_vs_prefill": 5e-2, "scatter_first_vs_inline": 2e-2, "tp2_vs_tp1": 2e-2}


def greedy_divergence(torch, model, max_len: int, bucketed: dict, paths: dict) -> dict:
    """Where a path's greedy tokens first leave the bucketed run's: one
    prefill of the one-rank model over the request's prompt plus the
    tokens both runs agree on, and the top-2 logit margin at the next
    position, with the logits of the token each run chose there. For
    reading: a margin of a few bf16 ulps of the top logit is a near-tie."""
    from llm_d_fast_model_actuation_tpu_torch.engine.engine import prefill_bucket
    from llm_d_fast_model_actuation_tpu_torch.models import llama

    cfg = model.cfg
    dev = "cuda"
    ps = 16
    pps = -(-max_len // ps)
    shape = (cfg.num_layers, pps + 1, ps, cfg.num_kv_heads, cfg.head_dim)
    pool = tuple(torch.zeros(shape, dtype=cfg.dtype, device=dev) for _ in range(2))
    pt = torch.arange(1, pps + 1, dtype=torch.int32, device=dev)[None]
    margins = {}
    for name, tokens in paths.items():
        for i, j in enumerate(first_differences(tokens, bucketed["tokens"])):
            if j is None:
                continue
            if (i, j) not in margins:
                ids = bucketed["prompts"][i] + bucketed["tokens"][i][:j]
                n = len(ids)
                x = torch.zeros((1, prefill_bucket(n, max_len)), dtype=torch.int32, device=dev)
                x[0, :n] = torch.tensor(ids, dtype=torch.int32, device=dev)
                lg = llama.prefill(model, x, torch.tensor([n], dtype=torch.int32, device=dev), pool, pt)[0, n - 1].clone()
                top = lg.topk(2).values
                chose = bucketed["tokens"][i][j]
                margins[(i, j)] = {
                    "completion": i, "position": j, "top2_margin": (top[0] - top[1]).item(),
                    "top1": top[0].item(), "bucketed_token": chose, "bucketed_token_logit": lg[chose].item(),
                    "paths": {}, "logits": lg,
                }
            at = margins[(i, j)]
            at["paths"][name] = {"token": tokens[i][j], "logit": at["logits"][tokens[i][j]].item()}
    for at in margins.values():
        del at["logits"]
    del pool
    return {"phase": "greedy_divergence", "model": "llama3-8b",
            "first_difference_from_bucketed": {k: first_differences(v, bucketed["tokens"]) for k, v in paths.items()},
            "at": list(margins.values()),
            "note": "prefill of the one-rank model over prompt + agreed tokens; not gated"}


def model_parity(torch, eng, eng_tp2, bucketed: dict, paths: dict) -> dict:
    from llm_d_fast_model_actuation_tpu_torch.engine.engine import kv_pages_bucket, prefill_bucket
    from llm_d_fast_model_actuation_tpu_torch.models import llama

    model = eng.model
    cfg = model.cfg
    ps, n = 16, 300
    pages = kv_pages_bucket(n + 1, ps, eng.cfg.pages_per_seq)
    shape = (cfg.num_layers, pages + 1, ps, cfg.num_kv_heads, cfg.head_dim)
    pools = [tuple(torch.zeros(shape, dtype=cfg.dtype, device="cuda") for _ in range(2)) for _ in range(2)]
    pt = torch.arange(1, pages + 1, dtype=torch.int32, device="cuda")[None]
    gen = torch.Generator(device="cuda").manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (n,), generator=gen, device="cuda", dtype=torch.int32)

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item(), (a - b).abs().max().item(), bool(a.argmax() == b.argmax())

    # prefill over the prompt at its bucket, as the bucketed engine runs it
    bucket = prefill_bucket(n, eng.cfg.seq_len)
    tokens = torch.zeros((1, bucket), dtype=torch.int32, device="cuda")
    tokens[0, :n] = prompt
    lp = llama.prefill(model, tokens, torch.tensor([n], dtype=torch.int32, device="cuda"), pools[0], pt)[0, n - 1]
    # mixed_step over the same prompt, packed as the engine packs it
    rows = -(-n // 8) * 8
    slot = torch.full((rows,), -1, dtype=torch.int32, device="cuda")
    slot[:n] = 0
    pos = torch.zeros((rows,), dtype=torch.int32, device="cuda")
    pos[:n] = torch.arange(n, dtype=torch.int32, device="cuda")
    toks = torch.zeros((rows,), dtype=torch.int32, device="cuda")
    toks[:n] = prompt
    lm = llama.mixed_step(model, toks, slot, pos, pools[1], pt)[n - 1]
    mixed = rel(lm, lp)
    # one decode step at position n on the mixed step's cache: inline, then
    # scatter-first on the same state (it writes the same K/V again)
    nxt = lm.argmax().to(torch.int32)[None]
    at = torch.tensor([n], dtype=torch.int32, device="cuda")
    try:
        model.cfg = dataclasses.replace(cfg, attention_impl="grouped")
        li = llama.decode_step(model, nxt, at, pools[1], pt)[0]
        model.cfg = dataclasses.replace(cfg, attention_impl="reference")
        lr = llama.decode_step(model, nxt, at, pools[1], pt)[0]
    finally:
        model.cfg = cfg
    torch.cuda.synchronize()
    dec = rel(lr, li)
    # the two-rank model (same seed: its shards joined are these weights)
    # on the same prompt and then the same decode step, with a pool split
    # on its kv_heads axis
    two = eng_tp2.model
    tp = two.mesh.tp
    wq2 = torch.cat([m.layers["wq"] for m in two.ranks], dim=-1)
    head2 = torch.cat([m.lm_head for m in two.ranks], dim=-1)
    if not (torch.equal(wq2, model.layers["wq"]) and torch.equal(head2, model.lm_head)):
        raise AssertionError("the two-rank model's shards do not join to the one-rank model's weights")
    del wq2, head2
    shard_shape = shape[:3] + (cfg.num_kv_heads // tp,) + shape[4:]
    pool2 = [tuple(torch.zeros(shard_shape, dtype=cfg.dtype, device=d) for _ in range(2)) for d in two.mesh.devices]
    lm2 = llama.mixed_step(two, toks, slot, pos, pool2, pt)[n - 1]
    try:
        two.cfg = dataclasses.replace(two.cfg, attention_impl="grouped")
        li2 = llama.decode_step(two, nxt, at, pool2, pt)[0]
    finally:
        two.cfg = eng_tp2.model_cfg
    torch.cuda.synchronize()
    tp_mixed, tp_dec = rel(lm2, lm), rel(li2, li)
    out = {
        "phase": "model_parity", "model": "llama3-8b", "prompt_tokens": n, "prefill_bucket": bucket,
        "tolerance_rel_l2": PARITY_TOL,
        "mixed_vs_prefill": {"rel_l2": mixed[0], "max_abs": mixed[1], "argmax_equal": mixed[2]},
        "scatter_first_vs_inline": {"rel_l2": dec[0], "max_abs": dec[1], "argmax_equal": dec[2]},
        "tp2_vs_tp1_mixed_step": {"rel_l2": tp_mixed[0], "max_abs": tp_mixed[1], "argmax_equal": tp_mixed[2]},
        "tp2_vs_tp1_decode_step": {"rel_l2": tp_dec[0], "max_abs": tp_dec[1], "argmax_equal": tp_dec[2]},
    }
    emit(out)
    del pools, pool2
    emit(greedy_divergence(torch, model, eng.cfg.seq_len, bucketed, paths))
    if not mixed[0] <= PARITY_TOL["mixed_vs_prefill"]:
        raise AssertionError(f"mixed_step disagrees with prefill at full width: {mixed}")
    if not dec[0] <= PARITY_TOL["scatter_first_vs_inline"]:
        raise AssertionError(f"the scatter-first decode disagrees with the inline one: {dec}")
    for what, got in (("mixed_step", tp_mixed), ("decode_step", tp_dec)):
        if not (got[0] <= PARITY_TOL["tp2_vs_tp1"] and got[2]):
            raise AssertionError(f"two ranks disagree with one rank in {what} at full width: {got}")
    return out


def check_build_probe(torch) -> dict:
    """The probe kernel against its plain version, and its numbers."""
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import build

    x = torch.randn(build.PROBE_SHAPE, device="cuda")
    out = build.launch_probe(x)
    torch.cuda.synchronize()
    if not torch.equal(out, build.launch_probe_plain(x)):
        raise AssertionError("the probe kernel's copy differs from its plain version")
    dst = torch.empty_like(x)
    bnd, by = bound_ms(2 * x.numel() * 4, 0)
    return {
        "name": "launch_probe",
        "route": "cuda",
        "source": "llm_d_fast_model_actuation_tpu_torch/csrc/probe.cu",
        "replaces": "llm_d_fast_model_actuation_tpu/utils/compat.py:53",
        "shape": {"rows": build.PROBE_SHAPE[0], "cols": build.PROBE_SHAPE[1], "dtype": "float32"},
        "max_abs_err": (out - x).abs().max().item(),
        "ms": time_ms(lambda: build.launch_probe(x), 200),
        "plain_ms": time_ms(lambda: build.launch_probe_plain(x), 200),
        "bound_ms": bnd, "bound_by": by,
        "device_ms": graph_ms(lambda: build.launch_probe(x), 100),
        "library_ms": time_ms(lambda: dst.copy_(x), 200),
        "library_device_ms": graph_ms(lambda: dst.copy_(x), 100),
        "library": "Tensor.copy_ into a preallocated tensor",
    }


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
    probe = check_build_probe(torch)
    emit({"phase": "build", "seconds": time.monotonic() - t0, "nvcc": build.find_nvcc(),
          "probe": {k: probe[k] for k in ("max_abs_err", "ms", "device_ms")},
          "nvcc_seconds": {n: b.seconds for n, b in built.items()},
          "ptxas": {n: [ln.strip() for ln in b.log.splitlines() if "registers" in ln or "spill" in ln or "warning" in ln]
                    for n, b in built.items()}})
    gen = torch.Generator(device="cuda").manual_seed(0)
    dec = check_decode(torch, gen)
    pre = check_prefill(torch, gen)
    rag, rag_sharded = check_ragged(torch, gen)
    for k in dec + pre + rag + rag_sharded + [probe]:
        emit({"phase": "kernel", **k, "nvidia_smi": smi})
    emit({"phase": "kernel_variants", "checks": check_variants(torch, gen)})
    bucketed = serve_and_sleep(torch, smi)
    graphs_phase(torch, smi)
    packed = serve_packed(torch, smi, bucketed)
    tp2, eng_tp2 = serve_tp2_packed(torch, smi, bucketed, packed)
    reference, eng = serve_reference(torch, smi, bucketed)
    model_parity(torch, eng, eng_tp2, bucketed,
                 {"serve_packed": packed["tokens"], "serve_tp2_packed": tp2["tokens"],
                  "serve_reference": reference["tokens"]})
    del eng, eng_tp2
    runs = (bucketed["counts"], packed["counts"], tp2["counts"], reference["counts"])

    def total(key):
        return sum(c[key] for c in runs)

    untimed = sorted({s for c in runs for s in c["prefill_by_seq"]} - set(PREFILL_SEQS))
    if untimed:
        raise AssertionError(f"the serve run launched prefill at untimed lengths {untimed}")
    by_rows = packed["counts"]["ragged_by_rows"]
    kernels = [dict(dec[0], launches=total("decode_inline")),
               dict(dec[1], launches=total("decode_scatter_first"))]
    for k in pre:  # one entry per bucket the serve runs launched
        n = sum(c["prefill_by_seq"].get(k["seq"], 0) for c in runs)
        if n:
            kernels.append(dict(k, launches=n))
    for k in rag:  # one entry per buffer size the packed run launched
        if by_rows.get(k["rows"]):
            kernels.append(dict(k, launches=by_rows[k["rows"]]))
    # the sharded ragged op: one entry per buffer size the two-rank run
    # launched it at, at that run's mesh (two ranks on card 0)
    sharded_by_rows = tp2["counts"]["ragged_sharded_by_rows"]
    for k in rag_sharded:
        if k["devices"] == ["cuda:0"] * 2 and sharded_by_rows.get(k["rows"]):
            kernels.append(dict(k, launches=sharded_by_rows[k["rows"]]))
    kernels.append(dict(probe, launches=total("probe")))
    unused = [k["name"] for k in kernels if not k["launches"] > 0]
    if unused or not by_rows or not sharded_by_rows:
        raise AssertionError(f"kernels the serve runs never launched: {unused or 'ragged'}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    # device_ms beside ms where the row has it: decode, ragged and the probe,
    # whose ms is its wrapper's
    emit({"kernels": [{**{k: row.get(k) for k in keys}, **({"device_ms": row["device_ms"]} if "device_ms" in row else {})}
                      for row in kernels]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
