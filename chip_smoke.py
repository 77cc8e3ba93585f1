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
     over several CTAs, and a 512-token segment at position 7680; and
     (``kernel_check``) ragged at 256 rows with two whole segments masked
     between live runs, as a multi-variant pass has them: within the
     limit, the masked rows zero, and the packed step's K/V write of the
     masked rows going to the null page only;
  4. serve   — the port's HTTP server in process, full-width full-depth
     llama3-8b with seeded random weights; four greedy completions
     (prompts of 20, 300, 1500 and 3000 token ids, 64 tokens each), then
     a fifth sharing a 512-token prefix (the prefix-cache suffix path);
     the launch counts must show every decode step and cold prefill went
     through the kernels, and every decode chunk must be a replay of one
     of the four CUDA graphs the engine captured when it started
     (``graph_replays`` equal to the chunks run). Then on the same
     engine (``serve_metrics``, ``profile`` and ``echo`` lines):
     ``/metrics`` parsed by a small parser here (no ``prometheus_client``
     on the card's machine), one TTFT observation per request and the
     prompt and generation totals the responses' usage, the exposition
     rendered in process under CUDA's sync debug mode set to error; a
     ``/v1/profile`` window (``torch.profiler``) over a fresh 300- and
     3000-token greedy request of 64 tokens, whose Chrome file holds the
     engine thread's operators, L x the window's decode steps of
     decode-kernel events (inside the replayed graphs) and L x its cold
     prefills of prefill-kernel events (both read from ``/v1/stats``), a
     second start refused (409), and a small graph captured and replayed
     while it ran (reported), the traffic between two pads of spins as in
     ``graphs``; the 300-token prompt with its own 64 greedy
     tokens sent back with ``echo`` and ``logprobs``: one entry per
     prompt token, the first None, the 64 completion positions within
     ``ECHO_LOGPROB_TOL`` of the decode's logprobs on average, one cold prefill
     through the prefill kernel. A wrapper's counter
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
     bar scaled to this state (``WAKE_BAR_S``, reported). Each cycle is
     one trace (a client ``traceparent``): ``engine.wake`` lasts within 5%
     (or 5 ms) of ``last_wake_seconds`` and its ``wake.h2d`` buckets, like
     the sleep's ``sleep.d2h`` ones, sum to ``bytes_offloaded``; a fourth
     cycle runs with tracing off (its wake reported beside the traced
     ones), and ``fma_engine_actuation_bytes`` is then four times
     ``bytes_offloaded`` each way. Then one
     level-2 sleep and wake: nothing mapped while asleep, the weights
     drawn anew from the seed into the same tensors (the same per-layer
     sums), the pool zero, under 3 GiB of ordinary memory at the wake's
     peak (``LEVEL2_WAKE_PEAK``), no state moved and no graph captured
     again;
  serve_hf — the phase-4 engine's seeded weights, still on the card,
     written as a Hugging Face checkpoint in Llama-3-8B's published layout
     (four safetensors shards, their index, ``config.json`` and a
     ``generation_config.json`` with eos [128001, 128009]; 16.06 GB, one
     tensor at a time through the host) into a temporary directory on
     local disk (refused loudly when no disk has room; deleted at the
     end), then the port's server on ``--model hf:<dir>`` with phase 4's
     options: the weights loaded into the arena before the captures
     (``LoadStats`` printed with its GB/s); the phase-4 traffic with
     ``ignore_eos`` bit-equal to phase 4's tokens; a string prompt with a
     string stop, the same request streamed, a chat completion streamed
     and not, one request with ``logprobs: 2``; a level-1 sleep and wake
     and a level-2 sleep and wake that reads the directory again, each
     with identical tokens, no capture and no state moved;
  swap — model hot-swap on one service (``--model-pool-mib`` sized from
     the host's MemAvailable): a sibling checkpoint A' of serve_hf's A
     (every shard a link but the one holding lm_head, rewritten with
     lm_head's rows reversed), then ``POST /v1/swap`` A -> A' (cold) -> A (pool
     hit, by digest only KV and lm_head move) -> A' (the same) ->
     ``tinyllama-1.1b`` (cold) -> A (pool hit, full transfer); each pool
     hit's bytes equal to ``plan_swap``'s prediction made just before it,
     the sibling deltas to 2 x (KV + lm_head); each model's greedy tokens
     bit-equal to its own before; in every engine no graph captured again
     and no state tensor moved; pooled engines map nothing (each one's
     graph pool bytes printed); the two pooled siblings hold less host
     memory than their nominal sizes; a ``swap.h2d=fail:1`` drill armed
     over ``/v1/faults`` (503, /health DEGRADED, the outgoing model's
     tokens, the retry a pool hit, OK again). Then ``swap_states`` A <-> A'
     called directly with the digests withheld (20.4 GB each way),
     overlapped and sequential, the states bit-equal (fingerprints on the
     card) and the times printed (``swap_total_s``, ``overlap_frac``,
     ``peak_bytes_in_flight``, ``pin_s``); the digests' ``digest_s``. The
     service runs ``--exec-pool-mib 120``, one Llama-3-8B graph set: the
     pooled engines' graph bytes stay under it after every swap, and
     pooling A beside A' releases A's graphs, which it captures again
     (exactly its four) at its swap-in, with its tokens; no other engine
     captures again. Then the prefetch, with A serving: a third sibling
     A'' (lm_head's rows rolled by half) prefetched and aborted by
     ``DELETE /v1/prefetch`` while the ``coldload.read`` fault point holds
     its readers (aborted, nothing pooled); then prefetched while A serves
     the traffic (TPOT against the same traffic just before), the card's
     free memory sampled as it stages (not below its value before, less
     64 MiB of slack), the staged leaves' fingerprints equal to A's with
     lm_head rolled and their digests equal to A's but lm_head's; the swap
     to it answers ``tier: "prefetched"``, reads no checkpoint (``loads``
     0), builds weights with those fingerprints and an lm_head whose
     digest, hashed from the card, is the staged one (``build_s``,
     ``h2d_s``, ``capture_s`` printed); then back to A, a pool hit. Every
     cold build prints its readers, ``read_s``, its load and the captures
     after it, and how long its digests, hashed beside the captures and
     serving, still ran once it served. Before each pool hit, ``GET
     /v1/costs`` prices it: its ``predicted_bytes`` must equal the
     swap's ``bytes_moved`` (``predicted_s`` printed beside the swap's
     seconds);
  launcher — the port's launcher as its own process (``python -m
     llm_d_fast_model_actuation_tpu_torch.launcher.main``, real mode:
     the card by NVML, preload on, ``--restart-budget 1``), driven only
     through its REST API and its children's HTTP: no CUDA context of its
     own (nvidia-smi lists as many compute processes as before it
     started; on a machine whose nvidia-smi cannot map a container's pids
     it lists each as pid 1 with the card's whole use, so rows are
     counted and memory is read off the card's total); instance ``a``
     with phase 4's options on card 0's UUID (``CUDA_VISIBLE_DEVICES``
     its index, one more compute process on that UUID, and the child's
     own device UUID the same), ``spawn_to_healthy_s`` from the PUT to
     its ``/health``, phase 4's traffic with greedy tokens bit-equal to
     phase 4's, its kernel launches read from its ``/v1/device``; ``b``
     (``--seed 1``) on the same UUID refused with 409 naming ``a`` while
     ``a`` is awake; ``a`` asleep at level 1 holding under a limit made
     of its parts (``asleep_limit``: a fresh process's context, cuBLAS
     and graph memory read rung by rung before ``a`` starts, and bounds
     on what stays reserved and on the kernels loaded), its own reserved
     and mapped bytes read from its ``/v1/device``; ``b``
     admitted (201), serving and asleep; ``a`` awake with identical
     tokens; ``a`` swapped to the swap phase's A' and back through
     ``POST /v2/vllm/instances/a/swap`` (its tokens on A' the swap phase's,
     the stored ``--model`` rewritten, two SWAPPED events, its own tokens
     after); A'' prefetched through ``POST
     /v2/vllm/instances/a/prefetch`` (``a`` runs ``--prefetch-mib-s
     1024``) while ``a`` serves the traffic, the ledger's ``prefetched``
     block naming it, its state polled to ``completed`` and TPOT beside
     the same traffic before; a SIGKILL to ``a``'s child gives STOPPED (exit code -9),
     RESTARTING and RESTARTED on the watch stream, and the restarted
     child phase 4's tokens again; DELETE of both gives ``terminated``,
     the compute processes and the card's free memory (within 1 GiB) as
     before. The detailed instance list after ``a``'s two swaps holds
     ``a``'s cost-oracle summary under ``ledger.costs`` (its two swaps
     recorded, every priced one byte-exact). The PUT of ``a`` carries a
     client ``traceparent``: the launcher's ``/v2/vllm/traces`` holds
     ``launcher.create_instance`` under it and the child's ``/v1/traces``
     its ``engine.start`` under that (through the fork server) with
     ``engine.build_runtime`` below; ``b`` runs ``--slo-ttft-ms 1``, so
     its probe violates, and ``/v2/vllm/exemplars`` lists exactly it,
     its ``trace_id`` resolving in ``b``'s ``/v1/traces``; the launcher's
     ``fma_launcher_rpc_seconds_count`` equals its ``launcher.rpc`` spans
     verb by verb, and the phase's swaps and prefetch calls; a fault armed
     and reset through ``/v2/vllm/faults``. Then a launcher with
     ``--no-preload`` spawns one instance, for its
     ``spawn_to_healthy_s`` (not gated);
  quant — ``--sleep-quant int8`` on one service over the swap phase's
     checkpoints A, A' and A'' (``quant_phase``): layer 0 of ``w_gate``
     and ``wq`` quantized on the card and by the host twin at int8 and
     fp8, payload, scale and dequantized weights bit-equal, one slice's
     seconds each way; three level-1 cycles, each after serve's traffic:
     ``bytes_offloaded`` exactly ``QUANT_WAKE_BYTES`` (13,381,672,960)
     against ``QUANT_FULL_BYTES`` (20,355,489,792), memory while asleep
     within serve's gates, no capture and no state moved, and from cycle
     2 on the probe's greedy tokens and a fingerprint of every quantized
     stack equal to cycle 1's, and after cycle 1 a few layer slices
     (``QUANT_SAMPLES``) bit-equal to the host twin's int8 round trip of
     the weights before the first sleep; the wake's seconds and GiB/s
     beside serve's full-precision wake, the first sleep's ``pin_s``, the
     first cycle's logprob drift against the full-precision weights (not
     gated). Then A -> A' (cold), A' -> A (pool, the delta), A -> A' ->
     A with the content hash off (full, both ways quantized; A then
     serves cycle 1's tokens and quantized stacks again) and A''
     prefetched with int8 staging (exactly ``QUANT_PREFETCH_BYTES`` of
     host memory) and swapped to (``prefetched``; its ``QUANT_SAMPLES``
     equal to the same round trip): each swap's bytes
     equal to ``/v1/costs``' prediction read just before it and, for a
     pool hit, to ``plan_swap``'s; ``bytes_saved_quant``, seconds and
     the pool's bytes printed. Then each ``/v1/actuations`` record's
     errors, every priced one byte-exact;
  zero_drain — ``--zero-drain on --content-hash on`` on one service of
     the checkpoint (``zero_drain_phase``): eight streamed completions
     (four greedy, four seeded; prompts of 300 to 3000 token ids, 128
     tokens each) run uninterrupted, then again through a swap to the
     sibling A' and back, and again through a level-1 sleep and wake, each
     taken once every stream is mid-decode: every stream's tokens
     bit-equal to the uninterrupted run's, each delivered once; no
     ``swap`` abort and ``preempted`` equal to ``resumed``; the page-out's
     bytes the parked pages times a page's bytes, and each actuation's
     recorded price (the ``/v1/costs`` arithmetic) equal to its bytes; the
     sleep offloads the weights alone; no graph captured, no state tensor
     moved. Then a ``kvrestore.h2d`` drill (the parked streams end with
     ``state_loss``, a fresh request is served) and a ``kvsave.d2h`` drill
     (the swap falls back to the abort path). The pin, page-out, page-in
     and resume seconds and bytes are printed;
  migrate — the port's launcher runs two instances of the checkpoint
     with ``--zero-drain on`` (``b`` created while ``a`` sleeps, then
     ``a`` woken through its own ``/wake_up``): four streams (prompts of
     260 to 500 token ids, two greedy, two seeded) run uninterrupted on
     ``b``, then on ``a``, which ``POST /v2/vllm/instances/a/migrate``
     hands to ``b`` mid-decode: every token delivered once through
     ``a``'s streams and bit-equal to ``b``'s uninterrupted run; one
     migration per role in ``fma_engine_migrations_total``; the KV ``b``
     paged in equal to the KV ``a`` exported. Then new arrivals on ``a``
     and ``POST /v2/vllm/instances/a/drain``: ``a``'s queue depth 0, the
     arrivals finished through its proxies. The export, import and
     release seconds, the wire's KV bytes and the peak host memory of
     the launcher and both children are printed;
  coresident — co-resident sibling variants on one launcher child of the
     checkpoint (``--packed-serving on --token-budget 72
     --resident-variants 3 --variant-hbm-mib 2048 --prefix-caching off``):
     A' and A'' prefetched through the launcher, priced by ``/v1/costs``
     and attached through its residents verb, each moving and mapping
     exactly lm_head's 1,050,673,152 bytes; the resident ledger (device
     bytes, duplicated bytes, saved) and the launcher's fleet gauges; a
     non-sibling and an over-cap attach refused (409); each sibling's own
     lm_head served (a greedy request alone on each model: A' 's first
     token is the base's mirrored in the vocabulary, A'' 's rolled by half,
     at the base's logprob); nine concurrent
     streams over the three models (the passes and the kernels' launches
     counted per pass), base-only traffic on the captured graphs; detach
     refused while its variant streams, a sleep, a swap and an export
     refused while one is attached; the detaches give the card back its
     bytes, and a level-1 sleep and wake after them hold serve's gates.
     Then ``coresident_engine``: an engine of the checkpoint built in
     process with A' and A'' attached, the same nine requests added at
     once, interleaved and then routed to one model at a time: each
     request's tokens and logprobs bit-equal to its model's run, and each
     greedy request's first token on A' and A'' the base's mapped through
     the sibling's permutation of the vocabulary;
  dualpods — two Llama-3-8B engines time-sharing the card through the
     port's control plane: the dual-pods controller and the launcher
     populator in this process over an ``InMemoryStore`` (no apiserver
     here), with real HTTP to requester stubs (``requester.main --backend
     real``: the card by NVML UUID, its memory in use from NVML), to one
     launcher (real mode, preload; started by the controller's launcher
     hook for the populator's launcher Pod, every launcher Pod of the one
     node given its address, as the kubelet would) and to its children.
     The sleeping budget is the reference's one sleeper, 4096 MiB, and
     the LauncherConfig holds two instances. ISC ``isc-a`` runs serve's
     options and seed, ``isc-b`` the same with ``--seed 1``. Step 1:
     requester r1 (A) is actuated cold (``cold_actuation_s``, its Pod's
     creation to its ``/ready`` 200) and serves serve's traffic with
     serve's tokens; 2: r1 deleted, A sleeps, and a requester's memory
     reading of the card is nvidia-smi's ``memory.used`` within 64 MiB;
     3: r2 (B) is admitted beside the sleeping A and answers the launcher
     phase's probe with its seed-1 tokens; r2 is deleted (B's first
     sleep, which pins 20 GB of host buffers, its seconds printed) and
     r2b wakes B with the same tokens (``b_warm_actuation_s``); 4: r1b
     (A) while r2b is bound: the controller does not wake A, r1b's status
     carries the budget's "above sleeping budget" while B is awake
     (watched for 3 s), then r2b is deleted, B sleeps and A wakes
     (``warm_actuation_s``, r2b's deletion to r1b's ``/ready`` 200, beside
     ``WAKE_BAR_S``, reported), A's tokens bit-equal to step 1's second
     run (from its prefix cache, as after the wake), no graph captured
     again, warm faster than cold, one instance per ISC on the launcher;
     its trace: the controller's ``/debug/traces`` (its observability
     port), the launcher's and both children's exports merged, A's wake
     one trace whose only root is r1b's ``controller.reconcile_bound``,
     through ``controller.http`` to A's ``engine.wake`` and its ``wake.h2d``
     buckets (A's ``bytes_offloaded``), and B's sleep, which r2b's
     deletion starts, a trace of its own from the unbind's
     ``controller.http`` to B's ``engine.sleep`` and ``sleep.d2h`` (B's
     bytes); the hops printed in seconds beside ``warm_actuation_s``;
     5: r1b and
     both ISCs deleted, the controller's GC deletes both instances, and
     the card's compute processes and free memory (within 1 GiB) are as
     before. Both children's kernel launches are read from their
     ``/v1/device``;
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
     reserved bytes. Its profiled replay runs between two pads of 5000
     uncounted spin kernels of about 50 us each, which take the device
     records that a later profiler window loses at its edges (876 first
     records at most so far); the same profiled replay runs again at the
     end of the
     script on a fresh engine (``graphs_profile_again``), after every other
     profiler window, under the same gate;
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
  9. model_parity — on phase 8's weights at full width, every bf16 path
     on one 300-token prompt — ``prefill``, ``mixed_step`` at tp 1 and at
     tp 2 (phase 7's two-rank model, the same seed), the inline decode at
     tp 1 and 2 and the scatter-first decode of the next token — against
     an fp32 oracle of the same bf16 weights (the plain forward, a layer
     upcast at a time), each within a limit derived beside
     ``ROUNDING_RMS`` from bf16 rounding, the tp 2 figures within 1.40x
     of tp 1's, the argmax the oracle's but at a near-tie; the old pairwise
     figures printed beside, ungated; two planted faults (layer 0's
     ``w_down`` reduce dropping rank 1's share, and two KV heads swapped
     in layer 0's cache) must be refused by the same gate; then
     (``greedy_divergence``, not gated) one prefill of the one-rank
     model over each diverging request's prompt and agreed tokens, and
     the top-2 logit margin where the tokens part;
  10. kernels line — every ported kernel with its TPU source and numbers,
     one entry for each shape the serve runs launched it at (prefill by
     sequence bucket, ragged by buffer rows), with that shape's launches.
     Each serve phase sets every count to 0 just before it starts its
     server and reads them just after its traffic; the launcher's and
     the dualpods phase's children count from 0 in their own processes
     (forked from one that launched nothing) and are read through their
     ``/v1/device`` after the traffic.

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
import math
import os
import shlex
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
# bf16 I/O, fp32 math: two bf16 ulps (2 x 2**-7) of each row's largest
# value. A row-relative limit holds short rows (outputs of order 1) and
# long rows (outputs of order 1/sqrt(context)) to the same precision.
REL_TOL = 1.6e-2
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
MIB = 1 << 20
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


def check_ragged_masked(torch, gen) -> dict:
    """The ragged kernel over a multi-variant pass's buffer: the packed
    serve's 256-row layout with two whole segments masked (their rows'
    slot -1) between live runs, slot 2's decode row and slot 0's 120-row
    prompt segment, against the plain version within ``REL_TOL``, the
    masked rows zero in both; the live rows beside the same buffer
    unmasked (bit-equal expected: a row's arithmetic reads its own
    sequence only; reported). Then the packed step's K/V write
    (``llama._row_targets``, ``_scatter_rows``) with the same rows: a
    masked row writes nothing but the null page."""
    from llm_d_fast_model_actuation_tpu_torch.engine.engine import kv_pages_bucket
    from llm_d_fast_model_actuation_tpu_torch.models import llama
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import ragged as mod

    h, kvh, d, ps, max_batch, pps = 32, 8, 128, 16, 8, 8192 // 16
    dev, bf16, rows = "cuda", torch.bfloat16, 256
    segments = [(1, 20, 1), (2, 300, 1), (3, 1500, 1), (0, 2768, 120), (4, 0, 64)]
    masked = (2, 0)
    need = {s: -(-(p0 + n) // ps) for s, p0, n in segments}
    num_pages = sum(need.values()) + 1
    perm = (torch.randperm(num_pages - 1, generator=torch.Generator().manual_seed(7)) + 1).tolist()
    table = torch.zeros((max_batch, pps), dtype=torch.int32)
    for s_, n in need.items():
        table[s_, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    kvp = kv_pages_bucket(max(p0 + n for _, p0, n in segments), ps, pps)
    pt = table.to(dev)[:, :kvp]
    slot, pos = pack(torch, segments, rows, dev)
    live = slot.clone()
    for m in masked:
        live[slot == m] = -1

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(bf16)

    k_pool, v_pool, q = rnd(num_pages, ps, kvh, d), rnd(num_pages, ps, kvh, d), rnd(rows, h, d)
    out = mod.ragged_paged_attention(q, k_pool, v_pool, pt, live, pos)
    ref = mod.ragged_paged_attention_plain(q, k_pool, v_pool, pt, live, pos)
    full = mod.ragged_paged_attention(q, k_pool, v_pool, pt, slot, pos)
    torch.cuda.synchronize()
    err, rel = errors(out, ref)
    gone = (slot >= 0) & (live < 0)
    if not rel <= REL_TOL:
        raise AssertionError(f"ragged kernel disagrees with its plain version with masked segments: {rel}")
    if out[gone].abs().max().item() != 0 or ref[gone].abs().max().item() != 0:
        raise AssertionError("a masked row of the ragged kernel's output is not zero")
    kept = live >= 0
    # the K/V write: only the live rows' (page, offset) and the null page change
    new = rnd(rows, kvh, d)
    pool = k_pool.clone()
    llama._scatter_rows(pool, new, llama._row_targets(pt, live, pos, ps))
    changed = (pool != k_pool).flatten(2).any(-1)  # [pages, page_size]
    want = torch.zeros_like(changed)
    phys, off = llama._row_targets(pt, live, pos, ps)
    want[phys[kept], off[kept]] = True
    if not torch.equal(changed[1:], want[1:]):
        raise AssertionError("a masked row of the packed step wrote K/V outside the null page")
    return {
        "check": "ragged_masked_segments", "rows": rows, "segments": [list(x) for x in segments],
        "masked_slots": list(masked), "masked_rows": int(gone.sum()), "live_rows": int(kept.sum()),
        "max_abs_err": err, "max_row_rel_err": rel, "masked_rows_zero": True,
        "live_rows_bit_equal_unmasked": bool(torch.equal(out[kept], full[kept])),
        "kv_written_only_by_live_rows": True,
    }


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


def costs_row(port: int, model: str) -> dict:
    """``GET /v1/costs?model=`` and the candidate row pricing a swap to
    ``model``."""
    view = get(port, f"/v1/costs?model={urllib.parse.quote(model, safe='')}")
    return next(c for c in view["candidates"] if c["model"] == model)


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from llm_d_fast_model_actuation_tpu_torch.ops import cuda

    return cuda.kernel_wrappers()


def reset_counts() -> None:
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    wrappers["prefill"].launches_by_seq.clear()
    wrappers["ragged"].launches_by_rows.clear()
    wrappers["ragged_sharded"].launches_by_rows.clear()


def read_counts() -> dict:
    from llm_d_fast_model_actuation_tpu_torch.ops import cuda

    return cuda.kernel_launches()


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


def add_replayed(counts: dict, by_name: dict) -> dict:
    """Eager launch counts (the wrappers') plus what graph replays
    launched (``by_name``: kernel nodes by kernel name times replays);
    the two parts of each decode count under ``eager`` and ``replayed``."""
    replayed = graph_kernels(by_name)
    counts["eager"] = {k: counts[k] for k in GRAPH_KERNELS}
    counts["replayed"] = replayed
    for k, n in replayed.items():
        counts[k] += n
    return counts


def path_counts(eng) -> dict:
    """A serve phase's kernel launches: the wrappers' counts plus what the
    engine's graph replays launched, read from each captured graph's
    kernel nodes (``engine/graphs.py``)."""
    return add_replayed(read_counts(), eng.graphs.replayed_launches() if eng.graphs else {})


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


def run_traffic(torch, port: int, vocab: int, ignore_eos: bool = False) -> dict:
    """The serve phases' traffic: four concurrent greedy completions
    (prompts of 20, 300, 1500 and 3000 token ids, 64 tokens each), then a
    fifth request sharing a 512-token prefix with the third; with
    ``ignore_eos`` each request asks to decode past eos."""
    import numpy as np

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n).tolist() for n in (20, 300, 1500, 3000)]
    results = [None] * len(prompts)
    extra = {"ignore_eos": True} if ignore_eos else {}

    def one(i):
        results[i] = post(port, "/v1/completions", {"prompt": prompts[i], "max_tokens": 64, **extra})

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
    fifth = post(port, "/v1/completions", {"prompt": shared, "max_tokens": 64, **extra})
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
        "usages": [r["usage"] for r in results + [fifth]],
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


# -- observability: /metrics, traces, the profile and prompt logprobs ------

#: the tolerance on prompt logprobs against the decode's own, on their
#: mean over the 64 completion positions: the echo request's bucketed
#: prefill and the decode chunk compute the same logprob by two bf16
#: paths. At fp32 on the CPU the two agree within 2e-5 at every position
#: (tests/test_torch_echo.py, ``ECHO_FP32_TOL``), so what is left on the
#: card is bf16 rounding, and 0.05 is the reference's tolerance between
#: its packed and bucketed paths. It holds the mean, not each position:
#: both packages round the logits to bf16 before widening them, and a
#: logit in [4, 16) has an ulp of 0.03125 to 0.0625, so two paths whose
#: hidden states differ by bf16 noise part by one or two ulps at some
#: positions (up to 0.063, two of 64 over 0.05 on an H100: PERF.md §6). A shifted
#: target or a wrong normalization is off by nats at every position
ECHO_LOGPROB_TOL = 0.05
#: a span that ends with its copies: ``engine.wake`` within 5% (or 5 ms)
#: of the sleeper's ``last_wake_seconds``
SPAN_REL_TOL, SPAN_ABS_TOL_S = 0.05, 0.005


def parse_exposition(text: str) -> list:
    """The samples of a Prometheus text exposition (format 0.0.4), as
    ``(name, labels, value)``: this machine has no ``prometheus_client``."""
    import re

    label_re = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            body, value = rest.rsplit("}", 1)
            labels = {k: v.replace('\\"', '"').replace("\\n", "\n").replace("\\\\", "\\")
                      for k, v in label_re.findall(body)}
        else:
            name, value = line.split(" ", 1)
            labels = {}
        out.append((name, labels, float(value)))
    return out


def metric(samples: list, name: str, **labels) -> float:
    """The sum of ``name``'s samples whose labels include ``labels``."""
    return sum(v for n, lab, v in samples if n == name and all(lab.get(k) == w for k, w in labels.items()))


def scrape(url: str) -> list:
    with urllib.request.urlopen(url, timeout=120) as r:
        return parse_exposition(r.read().decode())


def new_traceparent() -> tuple:
    """(traceparent header, trace id) of a fresh client span."""
    trace_id = os.urandom(16).hex()
    return f"00-{trace_id}-{os.urandom(8).hex()}-01", trace_id


def spans(url: str) -> list:
    """A Chrome trace export (``/v1/traces``, ``/v2/vllm/traces``,
    ``/debug/traces``) as span dicts: name, ids, wall start and seconds,
    attributes."""
    with urllib.request.urlopen(url, timeout=60) as r:
        events = json.loads(r.read())["traceEvents"]
    out = []
    for e in events:
        args = dict(e["args"])
        out.append({"name": e["name"], "trace_id": args.pop("trace_id"), "span_id": args.pop("span_id"),
                    "parent_id": args.pop("parent_id"), "start": e["ts"] / 1e6, "seconds": e["dur"] / 1e6,
                    "pid": e["pid"], "attrs": args})
    return out


def traced_post(port: int, path: str, traceparent: str, body=None):
    status, out = request(f"http://127.0.0.1:{port}{path}", "POST", body or {}, headers={"traceparent": traceparent})
    if status != 200:
        raise AssertionError(f"POST {path}: {status} {out}")
    return out


def check_serve_metrics(torch, service, port: int, usages: list) -> dict:
    """``/metrics`` after serve's traffic: it parses, its counters equal
    the traffic (one TTFT observation per request, the prompt and
    generation token totals the responses' usage), and the exposition
    renders in process, with the engine idle, under the sync debug mode
    set to error (a scrape never waits for the device)."""
    samples = scrape(f"http://127.0.0.1:{port}/metrics")
    model = service.model
    got = {
        "ttft_count": metric(samples, "fma_engine_time_to_first_token_seconds_count", model=model),
        "prompt_tokens": metric(samples, "fma_engine_prompt_tokens_total", model=model),
        "generation_tokens": metric(samples, "fma_engine_generation_tokens_total", model=model),
        "queue_wait_count": metric(samples, "fma_engine_queue_wait_seconds_count", model=model),
    }
    want = {"ttft_count": len(usages), "prompt_tokens": sum(u["prompt_tokens"] for u in usages),
            "generation_tokens": sum(u["completion_tokens"] for u in usages), "queue_wait_count": len(usages)}
    if got != want:
        raise AssertionError(f"/metrics after serve's traffic: {got}, want {want}")
    sync_free(service.metrics_text)
    return {"samples": len(samples), "counters": got, "render_sync_free": True}


def profile_window(torch, service, port: int, vocab: int) -> dict:
    """``POST /v1/profile`` on serve's engine, a fresh 300-token and a
    fresh 3000-token greedy request of 64 tokens, ``DELETE``: the Chrome
    file holds the engine thread's operators, and the decode kernel's runs
    (inside the replayed chunk graphs) equal L x the decode steps and the
    prefill kernel's L x the cold prefills of the window (both read from
    ``/v1/stats`` before and after); a second start while one runs is a
    409. A small CUDA graph is captured and replayed while the capture
    runs (what a build does), its output checked: whether a capture works
    under an active profile. The traffic runs between two pads of spins
    launched here (``profile_pad``), which take the records a later
    window loses at its edges."""
    import numpy as np

    eng = service.engine
    L = eng.cfg.model.num_layers
    rng = np.random.default_rng(7)  # prompts no earlier request sent: cold prefills
    prompts = [rng.integers(0, vocab, n).tolist() for n in (300, 3000)]
    log_dir = os.path.join(ROOT, "build", "profile")
    shutil.rmtree(log_dir, ignore_errors=True)
    before = get(port, "/v1/stats")["engine"]
    started = post(port, "/v1/profile", {"log_dir": log_dir})
    conflict = request(f"http://127.0.0.1:{port}/v1/profile", "POST", {})[0]
    profile_pad(torch)
    torch.cuda.synchronize()
    for p in prompts:
        post(port, "/v1/completions", {"prompt": p, "max_tokens": 64})
    x = torch.randn(256, 256, device="cuda")
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            y = x @ x
        graph.replay()
        torch.cuda.synchronize()
        capture = "ok" if torch.equal(y, x @ x) else "wrong output"
    except Exception as e:  # noqa: BLE001 — the finding, reported
        capture = f"{type(e).__name__}: {e}"
    profile_pad(torch)
    torch.cuda.synchronize()
    after = get(port, "/v1/stats")["engine"]
    status = get(port, "/v1/profile")
    stopped = request(f"http://127.0.0.1:{port}/v1/profile", "DELETE")[1]
    path = os.path.join(log_dir, "trace.json")
    size = os.path.getsize(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    shutil.rmtree(log_dir, ignore_errors=True)
    kernels = [e for e in events if e.get("ph") == "X" and str(e.get("cat", "")).lower() == "kernel"]
    decode = [e for e in kernels if "decode_kernel" in e["name"]]
    prefill = sorted((e for e in kernels if "prefill_kernel" in e["name"]), key=lambda e: e["ts"])
    pads = pad_spins_lost(sorted((e["ts"], e["name"]) for e in kernels), PROFILE_PAD_KERNELS)
    engine_tid = service._thread.native_id
    engine_ops = sum(1 for e in events if e.get("cat") == "cpu_op" and e.get("tid") == engine_tid)
    steps = after["decode_steps"] - before["decode_steps"]
    colds = after["cold_prefills"] - before["cold_prefills"]
    out = {
        "started": started, "second_start_status": conflict, "status_while_running": status, "stopped": stopped,
        "trace_bytes": size, "events": len(events), "engine_thread_cpu_ops": engine_ops,
        "decode_steps": steps, "cold_prefills": colds, "decode_kernel_events": len(decode),
        "prefill_kernel_events": len(prefill), "layers": L,
        "decode_kernel_device_ms": sum(e["dur"] for e in decode) / 1e3 / max(1, len(decode)),
        "prefill_kernel_device_ms": {str(n): sum(e["dur"] for e in prefill[i * L:(i + 1) * L]) / 1e3 / L
                                     for i, n in enumerate((300, 3000)) if len(prefill) >= (i + 1) * L},
        "capture_under_profile": capture, **pads,
    }
    if (conflict != 409 or not status["profiling"] or stopped.get("profiling") is not False or engine_ops == 0
            or colds != 2 or len(decode) != L * steps or len(prefill) != L * colds or not steps):
        raise AssertionError(f"{pad_loss_note(pads)}the profile window: {out}")
    return out


def echo_logprobs(torch, service, port: int, prompt: list) -> dict:
    """``serve``'s 300-token prompt and its own 64 greedy tokens (with
    their logprobs from the decode) sent back with ``echo`` and
    ``logprobs``: one entry per prompt token, the first None, and at the
    64 completion positions the decode's logprobs within
    ``ECHO_LOGPROB_TOL`` on average (the largest error and the positions
    over it printed). The echo request bypasses the prefix cache: a cold
    prefill, through the prefill kernel."""
    L = service.engine.cfg.model.num_layers
    own = post(port, "/v1/completions", {"prompt": prompt, "max_tokens": 64, "logprobs": 1})["choices"][0]
    toks, lps = own["logprobs"]["tokens"], own["logprobs"]["token_logprobs"]
    full = prompt + toks
    before, launches = get(port, "/v1/stats")["engine"], read_counts()["prefill"]
    out = post(port, "/v1/completions", {"prompt": full, "max_tokens": 1, "echo": True, "logprobs": 1})
    after, launched = get(port, "/v1/stats")["engine"], read_counts()["prefill"] - launches
    lp = out["choices"][0]["logprobs"]
    plp = lp["token_logprobs"][: len(full)]
    errs = [abs(a - b) for a, b in zip(plp[len(prompt):], lps)]
    res = {"prompt_tokens": len(full), "entries": len(plp), "first": plp[0],
           "max_abs_err": max(errs), "mean_abs_err": sum(errs) / len(errs), "tol": ECHO_LOGPROB_TOL,
           "positions_over_tol": sum(e > ECHO_LOGPROB_TOL for e in errs),
           "cold_prefills": after["cold_prefills"] - before["cold_prefills"], "prefill_launches": launched,
           "decode_logprobs_first": lps[:4], "echo_logprobs_first": plp[len(prompt):len(prompt) + 4]}
    if (len(toks) != 64 or lp["tokens"][: len(full)] != full or plp[0] is not None
            or any(v is None for v in plp[1:]) or res["mean_abs_err"] > ECHO_LOGPROB_TOL
            or res["cold_prefills"] != 1 or launched != L):
        raise AssertionError(f"echo with logprobs: {res}")
    return res


def wake_spans(port: int, trace_id: str, woke: dict, nbytes: int) -> dict:
    """A traced sleep/wake cycle's spans: ``engine.wake`` lasts within
    ``SPAN_REL_TOL`` (or ``SPAN_ABS_TOL_S``) of the sleeper's
    ``last_wake_seconds`` (its bucket spans end with their copies, not at
    enqueue), and the ``wake.h2d`` and ``sleep.d2h`` buckets' bytes sum to
    ``bytes_offloaded``, each bucket under its verb's span."""
    got = spans(f"http://127.0.0.1:{port}/v1/traces?trace_id={trace_id}")
    wake = [s for s in got if s["name"] == "engine.wake"]
    sleep = [s for s in got if s["name"] == "engine.sleep"]
    if len(wake) != 1 or len(sleep) != 1:
        raise AssertionError(f"trace {trace_id}: {[s['name'] for s in got]}")
    h2d = [s for s in got if s["name"] == "wake.h2d" and s["parent_id"] == wake[0]["span_id"]]
    d2h = [s for s in got if s["name"] == "sleep.d2h" and s["parent_id"] == sleep[0]["span_id"]]
    want = woke["last_wake_seconds"]
    out = {"engine_wake_s": wake[0]["seconds"], "last_wake_seconds": want,
           "wake_h2d_bytes": sum(s["attrs"]["bytes"] for s in h2d), "wake_buckets": len(h2d),
           "sleep_d2h_bytes": sum(s["attrs"]["bytes"] for s in d2h), "sleep_buckets": len(d2h),
           "bucket_h2d_s": sum(s["seconds"] for s in h2d)}
    if (abs(out["engine_wake_s"] - want) > max(SPAN_ABS_TOL_S, SPAN_REL_TOL * want)
            or out["wake_h2d_bytes"] != nbytes or out["sleep_d2h_bytes"] != nbytes):
        raise AssertionError(f"the wake's spans: {out}, bytes_offloaded {nbytes}")
    return out


# serve's engine options (the reference EngineConfig's default pool: 2048
# pages x 16 tokens), which the launcher's children run too
SERVE_OPTS = "--model llama3-8b --num-pages 2048 --seed 0 --max-batch 8 --device cuda"


def serve_and_sleep(torch, smi: str, ckpt: str) -> dict:
    """The ``serve`` and ``sleep_wake`` phases; at the end, with the
    seeded weights still on the card, they are written to ``ckpt`` as a
    Hugging Face checkpoint for ``serve_hf``."""
    service, server, init_s, free_before = start_service(torch, SERVE_OPTS)
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
        emit({"phase": "serve_metrics", **check_serve_metrics(torch, service, port, traffic["usages"])})
        emit({"phase": "profile", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              **profile_window(torch, service, port, vocab)})
        emit({"phase": "echo", "nvidia_smi": smi, **echo_logprobs(torch, service, port, traffic["prompts"][1])})

        # -- sleep / wake, three cycles (the spread of one transfer per call
        #    is too wide to read): the reference output is a repeat of
        #    request 1 (a prefix-cache hit, the path every repeat takes)
        probe = {"prompt": traffic["prompts"][0], "max_tokens": 64}
        before = post(port, "/v1/completions", probe)["choices"][0]["token_ids"]
        ptrs, captures = state_ptrs(eng), eng.graph_captures
        cycles = []
        for _ in range(3):
            # each cycle one trace: its sleep and wake under a client span
            traceparent, trace_id = new_traceparent()
            info = traced_post(port, "/sleep?level=1", traceparent)
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
            woke = traced_post(port, "/wake_up", traceparent)
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
                "spans": wake_spans(port, trace_id, woke, nbytes),
            })
        # tracing's cost on a wake: one more cycle with tracing off (the
        # process's switch), beside the traced ones; reported, not gated
        from llm_d_fast_model_actuation_tpu_torch.utils import tracing

        tracing.disable()
        try:
            post(port, "/sleep?level=1")
            untraced_wake_s = post(port, "/wake_up")["last_wake_seconds"]
        finally:
            tracing.enable()
        if post(port, "/v1/completions", probe)["choices"][0]["token_ids"] != before:
            raise AssertionError("tokens changed across the untraced sleep/wake cycle")
        # the actuation byte counters: four level-1 cycles so far
        samples = scrape(f"http://127.0.0.1:{port}/metrics")
        moved = {d: metric(samples, "fma_engine_actuation_bytes", mode="off", dir=d) for d in ("d2h", "h2d")}
        if moved != {"d2h": 4 * nbytes, "h2d": 4 * nbytes}:
            raise AssertionError(f"fma_engine_actuation_bytes after four cycles of {nbytes} bytes: {moved}")
        level2 = level2_cycle(torch, service, port, eng, free_before, probe, before, ptrs, captures)
        check_replays(eng, path_counts(eng), "decode_inline")
        emit({
            "phase": "sleep_wake", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "bytes_offloaded": nbytes, "cycles": cycles, "tokens_identical": True,
            "graph_captures_unchanged": True, "state_addresses_unchanged": len(ptrs),
            "wake_bar_s": WAKE_BAR_S, "wake_within_bar": all(c["wake_s"] <= WAKE_BAR_S for c in cycles),
            "tracing_cost": {"traced_wake_s": [c["wake_s"] for c in cycles], "untraced_wake_s": untraced_wake_s},
            "actuation_bytes_metric": moved,
            "level2": level2, **graph_stats(eng),
        })
        if get(port, "/health")["status"] != "OK":
            raise AssertionError("server is not healthy")
        written = write_hf_checkpoint(torch, eng.model, ckpt)
        return {"counts": counts, "summary": traffic["summary"], "tokens": traffic["tokens"],
                "prompts": traffic["request_prompts"], "bytes_offloaded": nbytes, "checkpoint": written,
                "wake_cycles": cycles}
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


# -- phase serve_hf: a Hugging Face checkpoint directory -------------------

#: the published Llama-3-8B checkpoint's largest shard: four shards
HF_SHARD_BYTES = 5_000_000_000
#: Llama-3-8B's published config.json and generation_config.json (the
#: fields the loader reads, and their neighbours)
HF_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama", "hidden_act": "silu",
    "hidden_size": 4096, "intermediate_size": 14336, "num_attention_heads": 32, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "vocab_size": 128256, "max_position_embeddings": 8192, "rms_norm_eps": 1e-05,
    "rope_theta": 500000.0, "rope_scaling": None, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "bos_token_id": 128000, "eos_token_id": 128001, "attention_bias": False,
}
HF_GENERATION = {"bos_token_id": 128000, "eos_token_id": [128001, 128009]}
#: names of the layer tensors in the HF layout -> (the port's parameter,
#: transposed): HF keeps (out, in), the port (in, out)
HF_LAYER = {
    "input_layernorm.weight": ("attn_norm", False), "mlp.down_proj.weight": ("w_down", True),
    "mlp.gate_proj.weight": ("w_gate", True), "mlp.up_proj.weight": ("w_up", True),
    "post_attention_layernorm.weight": ("mlp_norm", False), "self_attn.k_proj.weight": ("wk", True),
    "self_attn.o_proj.weight": ("wo", True), "self_attn.q_proj.weight": ("wq", True),
    "self_attn.v_proj.weight": ("wv", True),
}


def hf_tensors(model) -> list:
    """(HF name, a function giving the tensor on the card in the HF
    layout) for every weight of a one-rank Llama-3 ``model``, in the
    published checkpoint's order."""
    out = [("model.embed_tokens.weight", lambda: model.embed)]
    for i in range(model.cfg.num_layers):
        for suffix, (name, transposed) in HF_LAYER.items():
            out.append((f"model.layers.{i}.{suffix}",
                        lambda i=i, name=name, t=transposed: model.layers[name][i].t() if t else model.layers[name][i]))
    out += [("model.norm.weight", lambda: model.final_norm), ("lm_head.weight", lambda: model.lm_head.t())]
    return out


def checkpoint_dir(need: int) -> str:
    """A new directory on local disk with ``need`` bytes free (and 1 GiB
    more) in its parent: under the checkout's ``build/``, else under the temporary
    directory; raises, naming what is free, when neither has room."""
    import tempfile

    free = {}
    for base in (os.path.join(ROOT, "build"), tempfile.gettempdir()):
        os.makedirs(base, exist_ok=True)
        free[base] = shutil.disk_usage(base).free
        if free[base] >= need + GIB:
            return tempfile.mkdtemp(prefix="hf-checkpoint-", dir=base)
    raise RuntimeError(f"no local disk has room for the {need}-byte checkpoint: free bytes {free}")


def write_hf_checkpoint(torch, model, path: str) -> dict:
    """``model``'s weights as a Hugging Face Llama checkpoint in ``path``,
    in Llama-3-8B's published layout: shards of at most
    ``HF_SHARD_BYTES`` named ``model-0000k-of-0000n.safetensors``, their
    index, ``config.json`` and ``generation_config.json``; no tokenizer.
    One tensor at a time passes through the host."""
    from llm_d_fast_model_actuation_tpu_torch.models import safetensors

    t0 = time.monotonic()
    tensors = hf_tensors(model)
    specs = {name: fn() for name, fn in tensors}  # views on the card, no copy
    shards, cur, size = [], [], 0
    for name, _ in tensors:
        nbytes = specs[name].numel() * specs[name].element_size()
        if cur and size + nbytes > HF_SHARD_BYTES:
            shards.append(cur)
            cur, size = [], 0
        cur.append(name)
        size += nbytes
    shards.append(cur)
    weight_map, total = {}, 0
    for k, names in enumerate(shards):
        fname = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        entries = [(n, specs[n].dtype, tuple(specs[n].shape)) for n in names]
        total += safetensors.write_file(os.path.join(path, fname), entries, lambda n: specs[n].contiguous(),
                                        metadata={"format": "pt"})
        weight_map.update({n: fname for n in names})
    data_bytes = sum(specs[n].numel() * specs[n].element_size() for n in weight_map)
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": data_bytes}, "weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(HF_CONFIG, f)
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump(HF_GENERATION, f)
    del specs
    return {"shards": len(shards), "tensors": len(weight_map), "data_bytes": data_bytes, "file_bytes": total,
            "write_s": time.monotonic() - t0}


def sse(port: int, path: str, body) -> list:
    """POST a streamed request; its events (JSON objects), checked to end
    with ``[DONE]``."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(dict(body, stream=True)).encode(),
        method="POST", headers={"Content-Type": "application/json"},
    )
    events = []
    with urllib.request.urlopen(req, timeout=600) as r:
        if not r.headers["Content-Type"].startswith("text/event-stream"):
            raise AssertionError(f"a streamed request answered {r.headers['Content-Type']}")
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                return events
            events.append(json.loads(line[6:]))
    raise AssertionError(f"the stream ended without [DONE] after {len(events)} events")


def text_traffic(port: int) -> dict:
    """The string and chat requests of serve_hf, each gated: a string
    prompt with a string stop (taken from the unstopped text, so it
    matches), the same request streamed, a chat completion streamed and
    not, and one request with ``logprobs: 2``."""
    body = {"prompt": "The quick brown fox", "max_tokens": 24, "ignore_eos": True}
    # every request below but the first finds the prompt's first page in
    # the prefix cache, whose path rounds differently from a cold prefill:
    # the first one fills the cache, the rest compare like with like
    post(port, "/v1/completions", body)
    full = post(port, "/v1/completions", body)["choices"][0]
    text = full["text"]
    # random weights give random bytes: the stop is the first character
    # past the second that is not U+FFFD and occurs there first
    cut = next((k for k in range(2, len(text)) if text[k] != "\ufffd" and text.find(text[k]) == k), None)
    if cut is None:
        raise AssertionError(f"no stop string to take from the completion {text!r}")
    stop = text[cut]
    stopped = post(port, "/v1/completions", dict(body, stop=stop))["choices"][0]
    if stopped["finish_reason"] != "stop" or stopped["text"] != text[:cut]:
        raise AssertionError(f"the string stop {stop!r} gave {stopped} against the text {text!r}")
    events = sse(port, "/v1/completions", dict(body, stop=stop))
    chunks = [e for e in events if e.get("choices")]
    streamed = "".join(e["choices"][0]["text"] for e in chunks)
    ids = [t for e in chunks for t in e["choices"][0]["token_ids"]]
    if streamed != stopped["text"] or ids != stopped["token_ids"]:
        raise AssertionError(f"the streamed completion {streamed!r} {ids} differs from {stopped}")
    chat = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 16, "ignore_eos": True}
    post(port, "/v1/chat/completions", chat)
    message = post(port, "/v1/chat/completions", chat)["choices"][0]["message"]
    events = sse(port, "/v1/chat/completions", chat)
    deltas = [e["choices"][0]["delta"] for e in events if e.get("choices")]
    if (deltas[0].get("role") != "assistant" or "".join(d["content"] for d in deltas) != message["content"]
            or events[-1].get("usage", {}).get("completion_tokens") != len(message["token_ids"])):
        raise AssertionError(f"the streamed chat {deltas[:2]}... differs from {message}")
    lp = post(port, "/v1/completions", {"prompt": [1, 2, 3], "max_tokens": 8, "logprobs": 2, "ignore_eos": True})
    lps = lp["choices"][0]["logprobs"]
    if (len(lps["tokens"]) != 8 or len(lps["top_logprobs"]) != 8 or any(len(d) not in (1, 2) for d in lps["top_logprobs"])
            or not all(x <= 0.0 for x in lps["token_logprobs"])):
        raise AssertionError(f"bad logprobs {lps}")
    return {"string_stop": stop, "stopped_text_chars": len(stopped["text"]), "streamed_equal": True,
            "chat_tokens": len(message["token_ids"]), "chat_streamed_equal": True, "logprobs_2": True}


def build_figures(service) -> dict:
    """The serving engine's build: its load (``load_s``) and the warm-up
    after it (the chunk graphs' captures, ``capture_s``), and its digests,
    hashed after the load off the build's path (``digest_s``) and how long
    joining them waited here (``digest_join_wait_s``)."""
    t0 = time.monotonic()
    service._digests(service._runtime)
    wait = time.monotonic() - t0
    ls = service.load_stats
    return {"warmup": service.engine.warmup_stats, "digest_s": ls.digest_s if ls else None,
            "digest_join_wait_s": wait, "read_s": ls.read_s if ls else None, "workers": ls.workers if ls else None}


def serve_hf(torch, smi: str, ckpt: str, written: dict, bucketed: dict) -> dict:
    """The port's server on ``--model hf:<ckpt>``: the checkpoint written
    from ``serve``'s weights, loaded into the arena before the captures;
    the serve traffic's token-id completions (with ``ignore_eos``) must be
    bit-equal to ``serve``'s; string, chat, streamed and logprobs requests;
    a level-1 and a level-2 sleep and wake, the level-2 wake reading the
    directory again."""
    from llm_d_fast_model_actuation_tpu_torch.models import llama

    t0 = time.monotonic()
    opts = f"--model hf:{ckpt} --num-pages 2048 --seed 0 --max-batch 8 --device cuda"
    service, server, init_s, free_before = start_service(torch, opts)
    port = server.server_address[1]
    try:
        eng = service.engine
        L = eng.cfg.model.num_layers
        if eng.cfg.model != llama.LlamaConfig.llama3_8b() or eng.cfg.eos_token_id != 128001 or eng.cfg.extra_eos_ids != (128009,):
            raise AssertionError(f"the checkpoint's config resolved to {eng.cfg}")
        build = build_figures(service)
        load = service.load_stats.summary()
        captures = eng.graph_captures
        traffic = run_traffic(torch, port, eng.cfg.model.vocab_size, ignore_eos=True)
        if traffic["tokens"] != bucketed["tokens"]:
            raise AssertionError(f"the checkpoint's completions differ from serve's at "
                                 f"{first_differences(traffic['tokens'], bucketed['tokens'])}")
        text = text_traffic(port)
        counts = path_counts(eng)
        check_probe_launch(counts)
        check_replays(eng, counts, "decode_inline")
        if counts["decode_inline"] != L * eng.decode_steps or counts["prefill"] != L * eng.cold_prefills or eng.cold_prefills < 4:
            raise AssertionError(f"launches {counts} against {eng.decode_steps} decode steps and {eng.cold_prefills} cold prefills")
        if counts["ragged"] or counts["ragged_sharded"] or counts["decode_scatter_first"]:
            raise AssertionError(f"the checkpoint's bucketed path launched kernels off its path: {counts}")
        # level 1: a repeat of request 1 before and after
        probe = {"prompt": traffic["prompts"][0], "max_tokens": 64, "ignore_eos": True}
        before = post(port, "/v1/completions", probe)["choices"][0]["token_ids"]
        ptrs = state_ptrs(eng)
        info = post(port, "/sleep?level=1")
        asleep1 = check_asleep(torch, eng, free_before)
        woke = post(port, "/wake_up")
        if post(port, "/v1/completions", probe)["choices"][0]["token_ids"] != before:
            raise AssertionError("the checkpoint's tokens changed across a level-1 sleep")
        if eng.graph_captures != captures or state_ptrs(eng) != ptrs:
            raise AssertionError("a level-1 cycle re-captured a graph or moved a state tensor")
        level1 = {"sleep_s": info["last_sleep_seconds"], "wake_s": woke["last_wake_seconds"],
                  "bytes_offloaded": info["bytes_offloaded"], **asleep1}
        # level 2: the wake reads the directory again into the same tensors
        post(port, "/sleep?level=2")
        asleep2 = check_asleep(torch, eng, free_before)
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loads = service.loads
        woke = post(port, "/wake_up")
        peak = torch.cuda.max_memory_allocated() - allocated
        if service.loads != loads + 1:
            raise AssertionError("the level-2 wake did not read the checkpoint again")
        reload = service.load_stats.summary()
        after = post(port, "/v1/completions", probe)["choices"][0]["token_ids"]
        if after != bucketed["tokens"][0]:  # the prefix cache is empty again: a cold prefill, as serve's first
            raise AssertionError("the checkpoint's tokens changed across a level-2 sleep")
        if eng.graph_captures != captures or state_ptrs(eng) != ptrs:
            raise AssertionError("the level-2 wake re-captured a graph or moved a state tensor")
        if peak >= LEVEL2_WAKE_PEAK:
            raise AssertionError(f"the level-2 reload allocated {peak / GIB:.2f} GiB at its peak")
        stats = get(port, "/v1/stats")
        if stats["load"]["loads"] != 2 or stats["actuations"] != {"sleep": 2, "wake": 2}:
            raise AssertionError(f"/v1/stats: {stats}")
        out = {
            "phase": "serve_hf", "model": "hf:<checkpoint of serve's weights>", "layers": L,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "checkpoint": written,
            "init_s": init_s, "load": load, "build": build, "graph_captures_after_start": captures,
            "tokens_equal_to_serve": True, **traffic["summary"], "text": text,
            "launches": counts, **graph_stats(eng),
            "level1": dict(level1, tokens_identical=True, state_addresses_unchanged=len(ptrs),
                           graph_captures_unchanged=True),
            "level2": {"wake_s": woke["last_wake_seconds"], "reload": reload, "wake_peak_allocated_bytes": peak,
                       "graph_captures_before_reload": captures, "graph_captures_after_reload": eng.graph_captures,
                       "tokens_identical": True, **asleep2},
            "stats": stats, "seconds": time.monotonic() - t0,
        }
        emit(out)
        return {"counts": counts}
    finally:
        stop_service(torch, service, server)


# -- phase swap: model hot-swap between engines on one card ----------------

#: the issue's byte prediction for a delta swap between two Llama-3-8B
#: siblings that differ in lm_head only: both directions move the KV pool
#: (2048 pages: 4 GiB) and lm_head (4096 x 128256 bf16), nothing else
SIBLING_DELTA_BYTES = 2 * (4 * GIB + 4096 * 128256 * 2)
#: the greedy request each swap phase's model answers before and after
#: its swaps (the first 20 token ids of the serve traffic's first prompt)
SWAP_PROBE_MAX_TOKENS = 32


def mem_available() -> int:
    """The host's MemAvailable, in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def reverse_rows(t):
    return t.flip(0)


def roll_rows(t):
    """lm_head's rows (the vocabulary) rolled by half their number."""
    return t.roll(t.shape[0] // 2, 0)


def write_sibling(torch, src: str, dst: str, permute=reverse_rows) -> dict:
    """A sibling checkpoint of ``src`` in ``dst``: every shard a link to
    ``src``'s but the one holding ``lm_head.weight``, which is written
    anew with lm_head's rows (the vocabulary) permuted by ``permute``
    (reversed by default); the config and index files copied."""
    from llm_d_fast_model_actuation_tpu_torch.models import safetensors

    t0 = time.monotonic()
    os.makedirs(dst, exist_ok=True)
    with open(os.path.join(src, "model.safetensors.index.json")) as f:
        target = json.load(f)["weight_map"]["lm_head.weight"]
    for name in os.listdir(src):
        if name.endswith(".safetensors") and name != target:
            os.symlink(os.path.join(src, name), os.path.join(dst, name))
        elif name.endswith(".json"):
            shutil.copy(os.path.join(src, name), os.path.join(dst, name))
    shard = safetensors.SafetensorsFile(os.path.join(src, target))
    entries = [(n, safetensors.DTYPES[i.dtype], i.shape) for n, i in sorted(shard.tensors.items(), key=lambda kv: kv[1].begin)]

    def tensor_of(name):
        t = shard.get(name)
        return permute(t) if name == "lm_head.weight" else t

    nbytes = safetensors.write_file(os.path.join(dst, target), entries, tensor_of, metadata={"format": "pt"})
    return {"rewritten_shard": target, "shard_bytes": nbytes, "tensors_in_shard": len(entries), "write_s": time.monotonic() - t0}


def fingerprint(torch, tensors) -> list:
    """Per tensor, three int64 sums of its bytes seen as int32 words (the
    words, the words mixed, and the words weighted by position mod 251),
    computed on the card in slices (a host tensor's slices are copied
    there first): equal contents give equal sums, and a moved, flipped or
    swapped word changes them."""
    out = []
    step = 1 << 26
    weights = (torch.arange(step, device="cuda", dtype=torch.int64) % 251) + 1
    for t in tensors:
        words = t.reshape(-1).view(torch.uint8).view(torch.int32)
        s = torch.zeros(3, dtype=torch.int64, device="cuda")
        for k in range(0, words.numel(), step):
            w = words[k : k + step].to("cuda").to(torch.int64)
            s[0] += w.sum()
            s[1] += (w ^ (w >> 7)).sum()
            s[2] += (w * weights[: w.numel()]).sum()
        out.append(s)
    return torch.stack(out).tolist()


def engine_state(eng) -> list:
    """Every tensor a swap moves: the weights and the KV pool."""
    return list(eng.model.parameters()) + eng.pool.tensors()


#: the swap phase's card budget for pooled engines' graphs: one Llama-3-8B
#: set (79,691,776 B, PERF.md) and tinyllama's fit, two Llama-3-8B sets do
#: not, so the sequence releases one pooled engine's graphs once
EXEC_POOL_MIB = 120
#: what the card's free memory may lose while a prefetch stages beside
#: serving traffic (the traffic's allocator cache was warmed just before)
PREFETCH_FREE_SLACK_BYTES = 64 * MIB


def progress(what: str, **figures) -> None:
    """One line on stderr as a long phase goes (with the host's free
    memory), so a run that is cut shows how far it came."""
    print(json.dumps({"progress": what, "host_mem_available_bytes": mem_available(), **figures}), file=sys.stderr,
          flush=True)


def staged_leaf(tree: dict, flat: str):
    node = tree
    for part in flat.split("."):
        node = node[part]
    return node


def prefetch_until_done(port: int, timeout: float = 300.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        body = get(port, "/v1/prefetch")
        if body["state"] != "running":
            return body
        time.sleep(0.1)
    raise AssertionError("the prefetch did not end in time")


def swap_phase(torch, smi: str, ckpt: str, bucketed: dict) -> dict:
    """Hot-swap through ``POST /v1/swap`` on one service: ``hf:A`` (the
    serve_hf checkpoint) -> ``hf:A'`` (a sibling that differs in lm_head:
    cold) -> A (pool hit, delta) -> A' (pool hit, delta) ->
    ``tinyllama-1.1b`` (cold, another architecture) -> A (pool hit, full
    transfer: a named config has no digests). Gates: each model's greedy
    tokens bit-equal to its own earlier ones; each pool hit's bytes equal
    to ``plan_swap``'s prediction, made just before it; no engine moves a
    state tensor, and none captures a graph again but the one whose graphs
    the exec pool released (``--exec-pool-mib`` EXEC_POOL_MIB holds one
    Llama-3-8B set: pooling A beside A' releases A's), which captures its
    four again at its swap-in, with its tokens; the pooled engines' graph
    bytes under the budget; pooled engines map nothing; the two pooled
    siblings hold less host memory than their nominal sizes; a
    ``swap.h2d=fail:1`` drill rolls back (503, DEGRADED, both models'
    tokens, the retry a pool hit, then OK). Then direct ``swap_states``
    calls between A and A' with the digests withheld (full 20.4 GB each
    way), overlapped and sequential, bit-equal to each other. Then the
    prefetch: a third sibling A'' (lm_head's rows rolled) prefetched while
    A serves the traffic, after a ``DELETE /v1/prefetch`` drill (aborted,
    nothing pooled): the card's free memory does not fall while it
    stages, the staged leaves equal A's with lm_head rolled, and the swap
    to it is ``prefetched``, reads no checkpoint and builds weights equal
    to the checkpoint. Returns the siblings' directories and the probe
    tokens the launcher phase holds its swaps to, and the phase's kernel
    launches."""
    from llm_d_fast_model_actuation_tpu_torch.engine import sleep as sleep_mod
    from llm_d_fast_model_actuation_tpu_torch.engine.chunk_store import leaf_digest

    t_phase = time.monotonic()
    sibling, sibling2 = ckpt.rstrip("/") + "-sibling", ckpt.rstrip("/") + "-sibling2"
    written = write_sibling(torch, ckpt, sibling)
    written2 = write_sibling(torch, ckpt, sibling2, roll_rows)
    avail = mem_available()
    pool_mib = int(min(48 * GIB, avail * 0.6)) >> 20
    if pool_mib << 20 < 32 * GIB:
        raise RuntimeError(f"MemAvailable {avail} bytes leaves no room for a 32 GiB pool of two 20.4 GB siblings")
    model_a, model_b, other, model_c = f"hf:{ckpt}", f"hf:{sibling}", "tinyllama-1.1b", f"hf:{sibling2}"
    opts = (f"--model {model_a} --num-pages 2048 --seed 0 --max-batch 8 --device cuda --model-pool-mib {pool_mib} "
            f"--content-hash on --swap-bucket-mib 256 --exec-pool-mib {EXEC_POOL_MIB}")
    service, server, init_s, _ = start_service(torch, opts)
    port = server.server_address[1]
    probe = {"prompt": bucketed["prompts"][0], "max_tokens": SWAP_PROBE_MAX_TOKENS, "ignore_eos": True}
    budget = EXEC_POOL_MIB * MIB
    engines = {}  # id -> [engine, graph captures it should have, state addresses]
    gold, steps, recaptured = {}, [], []

    def tokens():
        return post(port, "/v1/completions", probe)["choices"][0]["token_ids"]

    def note_engine():
        eng = service.engine
        if id(eng) not in engines:
            engines[id(eng)] = [eng, eng.graph_captures, state_ptrs(eng)]

    def check_engines(where: str):
        for eng, captures, ptrs in engines.values():
            if eng.graph_captures != captures or state_ptrs(eng) != ptrs:
                raise AssertionError(f"{where}: an engine captured {eng.graph_captures} graphs, want {captures}, "
                                     f"or moved a state tensor")
        pooled = service.pooled_engines()
        if any(p["mapped_bytes"] for p in pooled):
            raise AssertionError(f"{where}: a pooled engine maps card memory: {pooled}")
        if sum(p["graph_pool_bytes"] for p in pooled) > budget or service.exec_pool.bytes_used > budget:
            raise AssertionError(f"{where}: pooled engines' graphs hold more than {budget} bytes: {pooled}")
        return pooled

    def first_tokens(model: str):
        # a cold prefill, then the same prompt again through the prefix
        # cache: the later swaps find the cache warm, so they are held to
        # the second
        cold, hit = tokens(), tokens()
        gold[model] = {"cold": cold, "hit": hit}

    def swap(model: str, tier: str, plan_key: str = ""):
        plan = priced = None
        if tier == "pool":
            entry = service.model_pool.peek(model)
            rt = service._runtime
            plan = sleep_mod.plan_swap(rt.sleeper, entry.runtime.sleeper, bucket_bytes=256 * MIB,
                                       out_digests=service._digests(rt), in_digests=service._digests(entry.runtime))
            # the cost oracle's price of the same swap, read just before it
            priced = costs_row(port, model)
        previous = service.model
        out = post(port, "/v1/swap", {"model": model, "request_id": f"swap-{len(steps)}"})
        if not out.get("swapped") or out["tier"] != tier or out["model"] != model:
            raise AssertionError(f"swap {previous} -> {model}: want tier {tier}, got {out}")
        if plan is not None and any(out[k] != plan[k] for k in ("bytes_out", "bytes_in", "bytes_moved", "bytes_deduped",
                                                               "deduped_leaves", "buckets_out", "buckets_in")):
            raise AssertionError(f"swap {previous} -> {model} moved other bytes than planned: {out} vs {plan}")
        if priced is not None and (priced["tier"] != "pool" or priced["predicted_bytes"] != out["bytes_moved"]):
            raise AssertionError(f"swap {previous} -> {model} moved {out['bytes_moved']} bytes, /v1/costs "
                                 f"predicted {priced}")
        note_engine()
        if tier == "pool" and not out["graphs_kept"]:
            # the exec pool released its graphs: captured again, all four
            engines[id(service.engine)][1] += 4
            recaptured.append({"model": model, "at_step": len(steps), "recapture_s": out["recapture_s"]})
        pooled = check_engines(f"after the swap to {model}")
        if model in gold:
            got = tokens()
            if got != gold[model]["hit"]:
                raise AssertionError(f"{model}'s tokens changed across its swaps: {got[:8]} vs {gold[model]['hit'][:8]}")
        else:
            first_tokens(model)
        step = {"from": previous, "to": model, **{k: out.get(k) for k in (
            "tier", "swap_total_s", "transfer_s", "d2h_s", "h2d_s", "overlap_frac", "peak_bytes_in_flight", "pin_s",
            "handover_s", "build_s", "load_s", "read_s", "workers", "capture_s", "warmup", "graphs_kept",
            "recapture_s", "bytes_out", "bytes_in", "bytes_moved", "bytes_deduped", "deduped_leaves",
            "buckets_out", "buckets_in")}, "planned_bytes_moved": plan and plan["bytes_moved"],
            "predicted_bytes": priced and priced["predicted_bytes"], "predicted_s": priced and priced["predicted_s"],
            "pool_bytes_used": out["pool"]["bytes_used"], "pooled_engines": pooled,
            "exec_pool": {k: out["exec_pool"][k] for k in ("entries", "bytes_used", "budget_bytes", "evictions")},
            "host_mem_available_bytes": mem_available(), "tokens_equal": model in gold and len(steps) > 0}
        steps.append(step)
        progress(f"swap {previous} -> {model}", tier=out["tier"], swap_total_s=out["swap_total_s"])
        return out, step

    try:
        note_engine()
        first_tokens(model_a)
        build = build_figures(service)
        # each parameter's [copy to the host, sha256] seconds, on 8 threads
        digest_times = service.load_stats.digest_times
        # a digest streamed from the card equals the host copy's (the
        # host path is the one the CPU tests hold to the reference's strings)
        model = service.engine.model
        for key, t in (("embed", model.embed), ("final_norm", model.final_norm)):
            if leaf_digest(t.cpu()) != service._runtime.digests[key]:
                raise AssertionError(f"the digest of {key} streamed from the card differs from its host copy's")
        swap(model_b, "cold")
        _, delta1 = swap(model_a, "pool")
        _, delta2 = swap(model_b, "pool")
        for d in (delta1, delta2):
            if d["bytes_moved"] != SIBLING_DELTA_BYTES:
                raise AssertionError(f"a sibling delta swap moved {d['bytes_moved']} bytes, want {SIBLING_DELTA_BYTES}")
        swap(other, "cold")
        pool = service.model_pool.describe()
        nominal = {e["model_id"]: e["nbytes"] for e in pool["entries"]}
        siblings = nominal[model_a] + nominal[model_b]
        a_model = service.model_pool.peek(model_a).runtime.engine.model
        shared = sum(p.numel() * p.element_size() for n, p in a_model.named_parameters() if n != "lm_head")
        if not pool["bytes_used"] <= siblings - shared or pool["chunks"]["dedup_saved_bytes"] < shared:
            raise AssertionError(f"two pooled siblings hold {pool['bytes_used']} bytes, nominal {siblings}, "
                                 f"sharing {shared}: {pool}")
        dedup = {"pool_bytes_used": pool["bytes_used"], "siblings_nominal_bytes": siblings, "shared_weight_bytes": shared,
                 "dedup_saved_bytes": pool["chunks"]["dedup_saved_bytes"]}
        swap(model_a, "pool")
        # the budget drill: pooling A beside A' released A's graphs, and A
        # captured its four again when it came back, with its tokens
        if [r["model"] for r in recaptured] != [model_a] or steps[-1]["graphs_kept"]:
            raise AssertionError(f"the exec pool released and recaptured {recaptured}, want A's graphs once, at the swap "
                                 f"back from {other}")

        # the rollback drill: swap.h2d fails once, over HTTP
        armed = post(port, "/v1/faults", {"spec": "swap.h2d=fail:1"})
        if "swap.h2d" not in armed["armed"]:
            raise AssertionError(f"/v1/faults did not arm swap.h2d: {armed}")
        status, body = request(f"http://127.0.0.1:{port}/v1/swap", "POST", {"model": model_b})
        health = get(port, "/health")
        if status != 503 or not body.get("rolled_back") or body.get("model") != model_a or health["status"] != "DEGRADED":
            raise AssertionError(f"the swap.h2d drill answered {status} {body}, /health {health}")
        if tokens() != gold[model_a]["hit"]:
            raise AssertionError("the rolled-back swap changed the outgoing model's tokens")
        check_engines("after the rolled-back swap")
        retry, _ = swap(model_b, "pool")
        if get(port, "/health")["status"] != "OK":
            raise AssertionError("a committed swap did not clear DEGRADED")
        drill = {"status": status, "health": health, "retry_tier": retry["tier"], "tokens_equal": True}
        swap(model_a, "pool")

        # full transfers: A <-> A' with the digests withheld, overlapped and
        # sequential, on the engine thread
        a_rt = service._runtime
        b_entry = service.model_pool.take(model_b)
        b_rt = b_entry.runtime
        fp_a = fingerprint(torch, engine_state(a_rt.engine))

        def direct(src, dst, overlapped):
            return service._on_loop(lambda: sleep_mod.swap_states(src.sleeper, dst.sleeper, bucket_bytes=256 * MIB,
                                                                  overlapped=overlapped))

        full = {}
        full["a_to_b_overlapped"] = direct(a_rt, b_rt, True)
        fp_b1 = fingerprint(torch, engine_state(b_rt.engine))
        full["b_to_a_sequential"] = direct(b_rt, a_rt, False)
        fp_a1 = fingerprint(torch, engine_state(a_rt.engine))
        full["a_to_b_sequential"] = direct(a_rt, b_rt, False)
        fp_b2 = fingerprint(torch, engine_state(b_rt.engine))
        full["b_to_a_overlapped"] = direct(b_rt, a_rt, True)
        fp_a2 = fingerprint(torch, engine_state(a_rt.engine))
        service._pool_park(b_entry.model_id, b_rt, b_entry.nbytes)  # A' back in the pool
        if fp_b1 != fp_b2 or fp_a1 != fp_a or fp_a2 != fp_a:
            raise AssertionError("the full transfers overlapped and sequential are not bit-equal")
        for name, m in full.items():
            if m["bytes_moved"] != bucketed["bytes_offloaded"] * 2 or m["bytes_deduped"]:
                raise AssertionError(f"{name} moved {m['bytes_moved']} bytes, want 2 x {bucketed['state_bytes']}")
        if tokens() != gold[model_a]["hit"]:
            raise AssertionError("A's tokens changed across the full transfers")
        check_engines("after the full transfers")

        prefetch = prefetch_drill(torch, service, port, model_a, model_c, swap)
        replayed: dict = {}
        for eng, _, _ in engines.values():
            for name, n in (eng.graphs.replayed_launches() if eng.graphs else {}).items():
                replayed[name] = replayed.get(name, 0) + n
        counts = add_replayed(read_counts(), replayed)
        # every build launched the probe once; every decode step and cold
        # prefill of every engine went through the kernels
        decode = sum(eng.cfg.model.num_layers * eng.decode_steps for eng, _, _ in engines.values())
        prefill = sum(eng.cfg.model.num_layers * eng.cold_prefills for eng, _, _ in engines.values())
        if (counts["probe"] != service.builds_total or counts["decode_inline"] != decode or counts["prefill"] != prefill
                or not counts["replayed"]["decode_inline"]):
            raise AssertionError(f"the swap phase's launches {counts} against {service.builds_total} builds, "
                                 f"{decode} decode and {prefill} prefill layer-steps")
        keys = ("swap_total_s", "d2h_s", "h2d_s", "overlap_s", "overlap_frac", "peak_bytes_in_flight", "pin_s",
                "bytes_out", "bytes_in", "bytes_moved", "buckets_out", "buckets_in")
        emit({
            "phase": "swap", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "init_s": init_s,
            "sibling": written, "sibling2": written2, "model_pool_mib": pool_mib, "exec_pool_mib": EXEC_POOL_MIB,
            "host_mem_available_at_start_bytes": avail, "build": build, "digest_times": digest_times, "steps": steps,
            "sibling_delta_bytes_predicted": SIBLING_DELTA_BYTES, "pooled_siblings": dedup, "rollback_drill": drill,
            "exec_pool_drill": {"recaptured": recaptured, "exec_pool": service.exec_pool.describe()},
            "full_transfer": {k: {f: m[f] for f in keys} for k, m in full.items()}, "full_transfer_bit_equal": True,
            "prefetch": prefetch, "engines": len(engines), "graph_captures_as_expected": True,
            "state_addresses_unchanged": True, "launches": counts, "seconds": time.monotonic() - t_phase,
        })
        return {"counts": counts, "sibling": sibling, "sibling2": sibling2, "gold": gold, "probe": probe,
                "pool_mib": pool_mib}
    finally:
        stop_service(torch, service, server)
        service._free_pooled(service.model_pool.drain())


def prefetch_drill(torch, service, port: int, model_a: str, model_c: str, swap) -> dict:
    """With A serving: a ``DELETE /v1/prefetch`` of A'' held at the
    ``coldload.read`` fault point (aborted, nothing pooled); then A''
    prefetched while A serves the traffic (TPOT against the same traffic
    before it), the card's free memory sampled as it stages; the staged
    leaves' fingerprints against A's weights with lm_head rolled, their
    digests against A's; the swap to it ``prefetched``, with no checkpoint
    read, its weights those fingerprints and its lm_head's digest, hashed
    from the card, the staged one; then back to A (a pool hit)."""
    from llm_d_fast_model_actuation_tpu_torch.engine.chunk_store import leaf_digest
    from llm_d_fast_model_actuation_tpu_torch.models.hf import _param
    from llm_d_fast_model_actuation_tpu_torch.models.llama import param_shapes

    eng_a = service.engine
    a_digests = service._digests(service._runtime)
    vocab = eng_a.cfg.model.vocab_size
    # the first run fills the prefix cache and the traffic's allocator
    # cache, so the two measured runs take the same path (a prefix hit
    # and a miss may round differently: ROADMAP queue 3 item 4)
    run_traffic(torch, port, vocab, ignore_eos=True)
    before = run_traffic(torch, port, vocab, ignore_eos=True)
    torch.cuda.synchronize()
    free_before = torch.cuda.mem_get_info()[0]

    # the abort drill
    post(port, "/v1/faults", {"spec": "coldload.read=delay:2"})
    started = post(port, "/v1/prefetch", {"model": model_c})
    time.sleep(0.5)
    status, aborted = request(f"http://127.0.0.1:{port}/v1/prefetch", "DELETE")
    request(f"http://127.0.0.1:{port}/v1/faults", "DELETE")
    if (status != 200 or not started["started"] or not aborted.get("aborted") or aborted.get("state") != "aborted"
            or get(port, "/v1/prefetch")["state"] != "aborted" or service.model_pool.contains_match(model_c)):
        raise AssertionError(f"the prefetch abort drill: {started} then {status} {aborted}, pool {service.model_pool.models()}")

    samples, host, stop = [], [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(torch.cuda.mem_get_info()[0])
            host.append(mem_available())
            time.sleep(0.05)

    progress("prefetch abort drill done", answer=aborted)
    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.monotonic()
    try:
        started = post(port, "/v1/prefetch", {"model": model_c})
        during = run_traffic(torch, port, vocab, ignore_eos=True)
        traffic_end_s = time.monotonic() - t0
        done = prefetch_until_done(port)
        prefetch_s = time.monotonic() - t0
    finally:
        stop.set()
        sampler.join()
    progress("prefetch staged", state=done["state"], prefetch_s=prefetch_s)
    if done["state"] != "completed" or not started["started"]:
        raise AssertionError(f"the prefetch of {model_c}: {started} then {done}")
    if min(samples) < free_before - PREFETCH_FREE_SLACK_BYTES:
        raise AssertionError(f"the card's free memory fell by {free_before - min(samples)} bytes while the prefetch staged")
    if during["tokens"] != before["tokens"]:
        raise AssertionError("A's tokens changed while the prefetch staged")
    pw = service.model_pool.peek(model_c).runtime
    flats = list(param_shapes(eng_a.cfg.model))
    a_model = eng_a.model

    def expected(flat):
        t = _param(a_model, flat)
        return t.roll(vocab // 2, 1) if flat == "lm_head" else t  # the checkpoint's rows are lm_head's columns

    want = fingerprint(torch, [expected(f) for f in flats])
    if fingerprint(torch, [staged_leaf(pw.params_host, f) for f in flats]) != want:
        raise AssertionError("the staged leaves differ from the checkpoint's")
    staged_digests = dict(pw.digests)
    if {k: v for k, v in staged_digests.items() if k != "lm_head"} != {k: v for k, v in a_digests.items() if k != "lm_head"}:
        raise AssertionError("the staged digests differ from a cold load's")

    out, step = swap(model_c, "prefetched")
    eng_c = service.engine
    if not out["prefetched"] or service.loads != 0:
        raise AssertionError(f"the prefetched swap read the checkpoint ({service.loads} loads): {out}")
    if fingerprint(torch, [_param(eng_c.model, f) for f in flats]) != want:
        raise AssertionError("the prefetched engine's weights differ from the checkpoint's")
    if leaf_digest(eng_c.model.lm_head) != staged_digests["lm_head"] or service._digests(service._runtime) != staged_digests:
        raise AssertionError("the prefetched engine's digests differ from its staged ones")
    back, _ = swap(model_a, "pool")
    return {
        "tpot_before_s": before["summary"]["decode_tpot_s"], "tpot_during_s": during["summary"]["decode_tpot_s"],
        "batch_tok_per_s_before": before["summary"]["batch_tok_per_s"],
        "batch_tok_per_s_during": during["summary"]["batch_tok_per_s"],
        "prefetch_s": prefetch_s, "traffic_during_s": traffic_end_s, "staged": {k: done.get(k) for k in (
            "bytes", "read_s", "digest_s", "total_s", "shards", "workers")},
        "free_before_bytes": free_before, "free_min_while_staging_bytes": min(samples), "free_samples": len(samples),
        "host_mem_available_min_while_staging_bytes": min(host),
        "abort": {"started": started["started"], "answer": aborted},
        "swap": {k: out.get(k) for k in ("tier", "prefetched", "swap_total_s", "build_s", "load_s", "h2d_s", "capture_s",
                                         "warmup", "pin_s", "bytes_in")},
        "loads_after_swap": 0, "weights_equal_checkpoint": True, "back_to_a_tier": back["tier"],
    }
# -- phase graphs: the captured chunk against the eager one -----------------

# -- launcher: the port's launcher forks, pins, supervises, time-shares ------

# A sleeping child's share of the card is held to a limit made of its
# parts, each measured or bounded before the reading:
#  - a CUDA context, cuBLAS's handles and kernels, and a graph's memory
#    per kernel node, read rung by rung from a fresh process
#    (``context_ladder``) in this run;
#  - the child's captured graphs (kernel nodes from its ``/v1/device``)
#    at the ladder's bytes per node;
#  - what its caching allocator keeps reserved while asleep, which the
#    child reports: at most ASLEEP_RESERVED_LIMIT_BYTES, 1.29x the largest
#    reading of the in-process sleep phase (149-182 MB: the graph pool
#    and cuBLAS's workspaces; a child read 149 MB);
#  - the kernels a serving engine loads beyond the ladder's (the port's
#    and PyTorch's, lazily): at most ASLEEP_MODULES_LIMIT_BYTES, 2.3x
#    the 43 MB that one child's share left once the parts above were
#    taken off (NVIDIA H100 80GB HBM3, 700 W).
ASLEEP_RESERVED_LIMIT_BYTES = 224 * MIB
#: the launcher's child stages its prefetch at this rate (--prefetch-mib-s),
#: beside the swap phase's unthrottled one: 16 GB in about 15 s
LAUNCHER_PREFETCH_MIB_S = 1024
ASLEEP_MODULES_LIMIT_BYTES = 96 * MIB
#: kernel nodes of the ladder's graph
LADDER_NODES = 16384
#: the ladder's process: each rung is read after it prints, and the next
#: one starts once a line comes on its standard input
LADDER = r"""
import json, sys, torch
def rung(name):
    torch.cuda.synchronize()
    print(json.dumps({"rung": name, "reserved": torch.cuda.memory_reserved()}), flush=True)
    sys.stdin.readline()
x = torch.zeros(1, device="cuda")
rung("context")
a = torch.randn(8, 4096, device="cuda", dtype=torch.bfloat16)
w = torch.randn(4096, 14336, device="cuda", dtype=torch.bfloat16)
y = a @ w
rung("cublas")
x.add_(1)
g = torch.cuda.CUDAGraph()
with torch.cuda.graph(g):
    for _ in range(int(sys.argv[1])):
        x.add_(1)
g.replay()
rung("graph")
"""


def context_ladder(index: int) -> dict:
    """A fresh process's share of card ``index``, rung by rung (``LADDER``):
    for each rung, the card's ``memory.used`` it added and how much of
    that its caching allocator reserved. Run while nothing else on the
    card changes."""
    base = card_used_bytes(index)
    proc = subprocess.Popen([sys.executable, "-c", LADDER, str(LADDER_NODES)], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True)
    rungs, used, reserved = {}, base, 0
    try:
        for _ in range(3):
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError(f"the context ladder exited with {proc.wait()} after {rungs}")
            r = json.loads(line)
            now = card_used_bytes(index)
            rungs[r["rung"]] = {"card_bytes": now - used, "reserved_bytes": r["reserved"] - reserved}
            used, reserved = now, r["reserved"]
            proc.stdin.write("\n")
            proc.stdin.flush()
        if proc.wait(60) != 0:
            raise RuntimeError(f"the context ladder exited with {proc.returncode}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rungs


def asleep_limit(ladder: dict, graph_nodes: int) -> dict:
    """The parts of a sleeping child's limit (see ASLEEP_RESERVED_LIMIT_BYTES)
    and their sum, ``limit_bytes``."""
    graph = ladder["graph"]
    per_node = (graph["card_bytes"] - graph["reserved_bytes"]) / LADDER_NODES
    parts = {
        "context_bytes": ladder["context"]["card_bytes"],
        "cublas_bytes": ladder["cublas"]["card_bytes"] - ladder["cublas"]["reserved_bytes"],
        "graph_bytes_per_node": per_node, "graph_kernel_nodes": graph_nodes,
        "graphs_bytes": round(per_node * graph_nodes),
        "reserved_limit_bytes": ASLEEP_RESERVED_LIMIT_BYTES, "modules_limit_bytes": ASLEEP_MODULES_LIMIT_BYTES,
    }
    parts["limit_bytes"] = (parts["context_bytes"] + parts["cublas_bytes"] + parts["graphs_bytes"]
                            + ASLEEP_RESERVED_LIMIT_BYTES + ASLEEP_MODULES_LIMIT_BYTES)
    return parts


def smi_rows(*args) -> list:
    out = subprocess.run(["nvidia-smi", *args, "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True, timeout=30).stdout
    return [[f.strip() for f in line.split(",")] for line in out.strip().splitlines() if line.strip()]


def compute_apps() -> list:
    """The card's compute processes as nvidia-smi lists them: (pid,
    gpu_uuid, used MiB). Inside a container whose processes nvidia-smi
    cannot map (each listed as pid 1 beside the card's whole use), a
    process still adds a row."""
    return [(int(p), u, int(m)) for p, u, m in smi_rows("--query-compute-apps=pid,gpu_uuid,used_memory")]


def card_used_bytes(index: int) -> int:
    return int(smi_rows("--query-gpu=memory.used", "-i", str(index))[0][0]) << 20


def request(url: str, method: str = "GET", body=None, timeout: float = 600.0, headers=None) -> tuple:
    """(status, parsed JSON or text) of one HTTP request; an error status
    is returned, not raised."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw.decode(errors="replace")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Launcher:
    """The port's launcher as its own process (real mode: NVML ids), its
    REST API at ``self.url``; stopped with SIGTERM, which stops its
    children."""

    def __init__(self, *flags: str) -> None:
        self.log_dir = os.path.join(ROOT, "build", "launcher-logs")
        os.makedirs(self.log_dir, exist_ok=True)
        port = free_port()
        self.url = f"http://127.0.0.1:{port}"
        self.log = open(os.path.join(self.log_dir, f"launcher-{port}.log"), "wb")
        t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "llm_d_fast_model_actuation_tpu_torch.launcher.main", "--host", "127.0.0.1",
             "--port", str(port), "--log-dir", self.log_dir, *flags],
            cwd=ROOT, stdout=self.log, stderr=subprocess.STDOUT,
        )
        self.wait(lambda: request(self.url + "/health", timeout=5)[0] == 200, 600, "the launcher's /health")
        self.ready_s = time.monotonic() - t0

    def wait(self, ok, timeout: float, what: str) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(f"the launcher exited with {self.proc.returncode} waiting for {what}: {self.tail()}")
            try:
                if ok():
                    return
            except OSError:
                pass
            time.sleep(0.2)
        raise TimeoutError(f"{what} within {timeout} s: {self.tail()}")

    def tail(self) -> str:
        self.log.flush()
        with open(self.log.name, "rb") as f:
            return f.read()[-3000:].decode(errors="replace")

    def instance(self, iid: str) -> dict:
        status, body = request(f"{self.url}/v2/vllm/instances/{iid}")
        if status != 200:
            raise AssertionError(f"GET instance {iid}: {status} {body}")
        return body

    def child_log(self, iid: str) -> str:
        return str(request(f"{self.url}/v2/vllm/instances/{iid}/log", headers={"Range": "bytes=0-"})[1])[-3000:]

    def create(self, iid: str, options: str, uuid: str, headers=None) -> tuple:
        return request(f"{self.url}/v2/vllm/instances/{iid}", "PUT", {"options": options, "gpu_uuids": [uuid]},
                       headers=headers)

    def spawn(self, iid: str, options: str, uuid: str, port: int, headers=None) -> tuple:
        """PUT the instance and wait for its child's /health; (create
        answer, seconds from the PUT to healthy)."""
        t0 = time.monotonic()
        status, body = self.create(iid, options, uuid, headers=headers)
        if status != 201:
            raise AssertionError(f"PUT {iid}: {status} {body}")
        self.wait_child(iid, port)
        return body, time.monotonic() - t0

    def wait_child(self, iid: str, port: int) -> None:
        def healthy():
            if self.instance(iid)["status"] != "running":
                raise AssertionError(f"instance {iid} stopped while starting: {self.child_log(iid)}")
            return request(f"http://127.0.0.1:{port}/health", timeout=5)[0] == 200

        self.wait(healthy, 600, f"instance {iid}'s /health")

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.log.close()


def child_counts(port: int) -> tuple:
    """A launcher child's kernel launches (its own process counts them
    from 0: it was forked from a process that launched none), eager ones
    plus those its graph replays ran, keyed as ``path_counts``; and its
    device answer."""
    dev = get(port, "/v1/device")
    counts = dev["launches"]
    for key in ("prefill_by_seq", "ragged_by_rows", "ragged_sharded_by_rows"):
        counts[key] = {int(k): v for k, v in counts[key].items()}
    return add_replayed(counts, dev["replayed"]), dev


def await_events(url: str, want: list, timeout: float) -> list:
    """Read the launcher's watch stream from ``url`` until the event types
    ``want`` have come in that order (other events between them are kept
    too)."""
    events, i = [], 0
    with urllib.request.urlopen(url, timeout=timeout) as r:
        while i < len(want):
            line = r.readline()
            if not line:
                raise AssertionError(f"the watch stream ended after {events}")
            events.append(json.loads(line))
            if events[-1]["type"] == want[i]:
                i += 1
    return events


def launcher_create_trace(url: str, port: int, trace_id: str, traceparent: str) -> dict:
    """The create's trace across the fork server: the launcher holds
    ``launcher.create_instance`` under the client's span, and the child
    ``engine.start`` under it (propagated as the child body's argument),
    with ``engine.build_runtime`` under that."""
    client_span = traceparent.split("-")[2]
    mine = spans(f"{url}/v2/vllm/traces?trace_id={trace_id}")
    child = spans(f"http://127.0.0.1:{port}/v1/traces?trace_id={trace_id}")
    create = [s for s in mine if s["name"] == "launcher.create_instance"]
    start = [s for s in child if s["name"] == "engine.start"]
    build = [s for s in child if s["name"] == "engine.build_runtime"]
    if (len(create) != 1 or create[0]["parent_id"] != client_span or len(start) != 1
            or start[0]["parent_id"] != create[0]["span_id"] or len(build) != 1
            or build[0]["parent_id"] != start[0]["span_id"]):
        raise AssertionError(f"the create's trace: launcher {[(s['name'], s['parent_id']) for s in mine]}, "
                             f"child {[(s['name'], s['parent_id']) for s in child]}")
    return {"launcher.create_instance_s": create[0]["seconds"], "engine.start_s": start[0]["seconds"],
            "engine.build_runtime_s": build[0]["seconds"], "child_spans": len(child),
            "child_pid": start[0]["pid"], "launcher_pid": create[0]["pid"]}


def launcher_exemplars(url: str, port: int, requests: int) -> dict:
    """``/v2/vllm/exemplars`` lists each request of the child judged
    against ``--slo-ttft-ms 1``, and each exemplar's trace is in that
    child's ``/v1/traces``."""
    status, body = request(f"{url}/v2/vllm/exemplars")
    mine = [e for e in body.get("slo_exemplars", []) if e.get("instance") == "b"] if status == 200 else []
    resolved = [bool(spans(f"http://127.0.0.1:{port}/v1/traces?trace_id={e['trace_id']}")) for e in mine]
    if status != 200 or len(mine) != requests or not all(resolved) or body.get("slo_requests_violated") != requests:
        raise AssertionError(f"/v2/vllm/exemplars: {status} {body}")
    return {"exemplars": len(mine), "violated": body["slo_requests_violated"], "attainment": body["slo_attainment"],
            "legs": mine[0]["legs"], "trace_resolved": True}


def launcher_rpcs(url: str, calls: dict) -> dict:
    """``fma_launcher_rpc_seconds_count`` on the launcher's ``/metrics``:
    by verb, one observation per ``launcher.rpc`` span the launcher
    recorded (each ended once), and for the verbs the phase sent through
    the launcher (``calls``) the number it sent."""
    samples = scrape(f"{url}/metrics")
    counted: dict = {}
    for n, lab, v in samples:
        if n == "fma_launcher_rpc_seconds_count" and lab.get("outcome") != "refused":
            counted[lab["verb"]] = counted.get(lab["verb"], 0) + int(v)
    recorded: dict = {}
    for s in spans(f"{url}/v2/vllm/traces"):
        if s["name"] == "launcher.rpc":
            recorded[s["attrs"]["verb"]] = recorded.get(s["attrs"]["verb"], 0) + 1
    if counted != recorded or any(counted.get(verb) != n for verb, n in calls.items()):
        raise AssertionError(f"launcher rpc counts {counted}, spans {recorded}, the phase's calls {calls}")
    return counted


def launcher_faults(url: str) -> dict:
    """``/v2/vllm/faults``: a point armed and described, then reset."""
    armed = request(f"{url}/v2/vllm/faults", "POST", {"spec": "instance.spawn=fail:1"})
    reset = request(f"{url}/v2/vllm/faults", "DELETE")
    if (armed[0] != 200 or "instance.spawn" not in armed[1]["armed"] or reset[0] != 200 or reset[1]["armed"]
            or request(f"{url}/v2/vllm/faults")[1]["armed"]):
        raise AssertionError(f"the launcher's faults: armed {armed}, reset {reset}")
    return {"armed": armed[1]["armed"], "after_reset": reset[1]["armed"]}


def launcher_phase(torch, smi: str, bucketed: dict, swapped: dict) -> dict:
    """The port's launcher started as its own process (real mode, preload
    on, ``--restart-budget 1``) and driven only through its REST API and
    its children's HTTP: it holds no CUDA context; instance ``a`` on card
    0's UUID serves ``serve``'s traffic with ``serve``'s tokens; ``b`` on
    the same card is refused while ``a`` is awake and admitted once it
    sleeps; ``a`` wakes with its tokens, swaps to the swap phase's sibling
    checkpoint (its tokens the swap phase's) and back through
    ``POST /v2/vllm/instances/a/swap`` (the stored ``--model`` rewritten
    each time, a ``SWAPPED`` event each); a SIGKILL to ``a``'s child gives
    STOPPED (-9), RESTARTING, RESTARTED and the same tokens again; DELETE
    leaves no child on the card and its memory back. Then a launcher with
    ``--no-preload`` spawns once, for its ``spawn_to_healthy_s``."""
    from llm_d_fast_model_actuation_tpu_torch.models.llama import LlamaConfig

    model = LlamaConfig.llama3_8b()
    free_memory(torch)
    index, uuid = smi_rows("--query-gpu=index,uuid")[0]
    index = int(index)
    apps0 = compute_apps()
    free_before = torch.cuda.mem_get_info()[0]
    launcher = Launcher("--restart-budget", "1", "--restart-backoff", "0.5")
    try:
        apps1 = compute_apps()
        if len(apps1) != len(apps0) or launcher.proc.pid in [p for p, _, _ in apps1]:
            raise AssertionError(f"the launcher (pid {launcher.proc.pid}) holds a CUDA context: {apps0} -> {apps1}")
        ladder = context_ladder(index)
        used_base = card_used_bytes(index)
        port_a = free_port()
        # serve's options, with a pool that holds the model a swap parks,
        # and a prefetch throttled to LAUNCHER_PREFETCH_MIB_S; the PUT
        # carries a client span, which the fork server's child joins
        traceparent, create_trace = new_traceparent()
        created, spawn_s = launcher.spawn(
            "a", f"{SERVE_OPTS} --model-pool-mib {swapped['pool_mib']} --prefetch-mib-s {LAUNCHER_PREFETCH_MIB_S} "
                 f"--port {port_a}", uuid, port_a, headers={"traceparent": traceparent})
        create_spans = launcher_create_trace(launcher.url, port_a, create_trace, traceparent)
        if created["env_vars"]["CUDA_VISIBLE_DEVICES"] != str(index) or created["gpu_uuids"] != [uuid]:
            raise AssertionError(f"card {index} ({uuid}) pinned as {created['env_vars']}")
        apps2 = compute_apps()
        if len(apps2) != len(apps0) + 1 or [u for _, u, _ in apps2].count(uuid) != [u for _, u, _ in apps0].count(uuid) + 1:
            raise AssertionError(f"instance a added no process on {uuid}: {apps0} -> {apps2}")
        traffic = run_traffic(torch, port_a, model.vocab_size)
        if traffic["tokens"] != bucketed["tokens"]:
            raise AssertionError(f"the launcher's child gave other tokens than serve: "
                                 f"{first_differences(traffic['tokens'], bucketed['tokens'])}")
        counts, dev = child_counts(port_a)
        if dev["uuid"].lower() != uuid.lower() or dev["device"] not in ("cuda", "cuda:0"):
            raise AssertionError(f"instance a runs on {dev['device']} {dev['uuid']}, asked for {uuid}")
        L = model.num_layers
        check_probe_launch(counts)
        if counts["prefill"] != 4 * L or not counts["replayed"]["decode_inline"] or counts["decode_inline"] % L:
            raise AssertionError(f"instance a's launches are not serve's path: {counts}")
        if counts["ragged"] or counts["ragged_sharded"] or counts["decode_scatter_first"]:
            raise AssertionError(f"instance a launched kernels off the bucketed path: {counts}")
        probe = {"prompt": traffic["prompts"][0], "max_tokens": 64}
        before = post(port_a, "/v1/completions", probe)["choices"][0]["token_ids"]

        # the GPU exclusivity rule: refused while a is awake, admitted once
        # it sleeps
        port_b = free_port()
        # b judges every request against a 1 ms TTFT target: each violates
        # and leaves an exemplar
        opts_b = f"{SERVE_OPTS.replace('--seed 0', '--seed 1')} --slo-ttft-ms 1 --port {port_b}"
        status, body = launcher.create("b", opts_b, uuid)
        if status != 409 or "['a']" not in body:
            raise AssertionError(f"PUT b on a's card while a is awake: {status} {body}")
        refused = body
        limit = asleep_limit(ladder, dev["memory"]["graph_kernel_nodes"])
        post(port_a, "/sleep?level=1")
        time.sleep(1)
        asleep_bytes = card_used_bytes(index) - used_base
        asleep_apps = compute_apps()
        asleep_memory = get(port_a, "/v1/device")["memory"]
        # what the child accounts for itself, and the rest: its context
        rest = asleep_bytes - asleep_memory["reserved_bytes"] - asleep_memory["mapped_bytes"]
        split = {"card_bytes": asleep_bytes, "child": asleep_memory, "context_bytes": rest,
                 "context_beyond_ladder_bytes": rest - limit["context_bytes"] - limit["cublas_bytes"] - limit["graphs_bytes"]}
        emit({"phase": "launcher_asleep", "split": split, "limit": limit, "ladder": ladder})
        if asleep_memory["mapped_bytes"] or asleep_memory["reserved_bytes"] > ASLEEP_RESERVED_LIMIT_BYTES:
            raise AssertionError(f"sleeping instance a keeps {asleep_memory} (reserved limit {ASLEEP_RESERVED_LIMIT_BYTES})")
        if asleep_bytes >= limit["limit_bytes"]:
            raise AssertionError(f"sleeping instance a holds {asleep_bytes} bytes of the card, limit {limit}")
        _, spawn_b_s = launcher.spawn("b", opts_b, uuid, port_b)
        b_tokens = post(port_b, "/v1/completions", probe)["choices"][0]["token_ids"]
        post(port_b, "/sleep?level=1")
        exemplars = launcher_exemplars(launcher.url, port_b, 1)
        woke = post(port_a, "/wake_up")
        after = post(port_a, "/v1/completions", probe)["choices"][0]["token_ids"]
        if after != before:
            raise AssertionError(f"instance a's tokens changed across b's turn: {before[:8]} vs {after[:8]}")

        # the swap verb: a to the swap phase's sibling checkpoint and back
        rev = request(f"{launcher.url}/v2/vllm/instances?detail=false")[1]["revision"]
        sibling = f"hf:{swapped['sibling']}"
        verbs = {}
        for target, tier in ((sibling, "cold"), ("llama3-8b", "pool")):
            status, body = request(f"{launcher.url}/v2/vllm/instances/a/swap", "POST", {"model": target})
            options = launcher.instance("a")["options"]
            if (status != 200 or body["swap"]["tier"] != tier or body["model"] != target
                    or shlex.split(options)[shlex.split(options).index("--model") + 1] != target):
                raise AssertionError(f"swapping a to {target}: {status} {body}, options {options!r}")
            verbs[target] = {k: body["swap"][k] for k in ("tier", "swap_total_s", "bytes_moved", "pin_s")}
            if target == sibling:
                got = post(port_a, "/v1/completions", swapped["probe"])["choices"][0]["token_ids"]
                if got != swapped["gold"][sibling]["cold"]:
                    raise AssertionError(f"a serves the sibling with other tokens than the swap phase: {got[:8]}")
        swap_events = await_events(f"{launcher.url}/v2/vllm/instances/watch?since={rev}", ["SWAPPED", "SWAPPED"], 60)
        # the detailed list lifts the reporting child's cost-oracle summary
        # into ledger.costs: its swaps are recorded, priced, byte-exact
        ledger_costs = request(f"{launcher.url}/v2/vllm/instances")[1]["ledger"].get("costs") or {}
        a_costs = ledger_costs.get("a") or {}
        prediction = a_costs.get("prediction") or {}
        if (set(a_costs) != {"bandwidth_gibps", "prediction"} or prediction.get("by_kind", {}).get("swap") != 2
                or prediction.get("byte_exact_frac") != 1.0):
            raise AssertionError(f"the launcher's ledger.costs for a: {ledger_costs}")
        if post(port_a, "/v1/completions", probe)["choices"][0]["token_ids"] != before:
            raise AssertionError("instance a's tokens changed across its swaps")

        # the prefetch verb: A'' staged on a's host, throttled, while a
        # serves the traffic; the ledger's prefetched block names it
        target = f"hf:{swapped['sibling2']}"
        plain = run_traffic(torch, port_a, model.vocab_size)  # a's prefix cache holds it all: as the next run
        t0 = time.monotonic()
        status, body = request(f"{launcher.url}/v2/vllm/instances/a/prefetch", "POST", {"model": target})
        if status != 200 or body["prefetch"].get("state") not in ("running", "completed"):
            raise AssertionError(f"the launcher's prefetch verb answered {status} {body}")
        hinted = request(f"{launcher.url}/v2/vllm/instances")[1]["ledger"]["prefetched"]
        throttled = run_traffic(torch, port_a, model.vocab_size)
        deadline = time.monotonic() + 300
        prefetch_gets = 1
        while (done := request(f"{launcher.url}/v2/vllm/instances/a/prefetch")[1]["prefetch"])["state"] == "running":
            prefetch_gets += 1
            if time.monotonic() > deadline:
                raise AssertionError("the launcher's prefetch did not end in time")
            time.sleep(0.2)
        prefetch_s = time.monotonic() - t0
        ledger = request(f"{launcher.url}/v2/vllm/instances")[1]["ledger"]
        if done["state"] != "completed" or hinted != {"a": target} or ledger["prefetched"] != {"a": target}:
            raise AssertionError(f"the launcher's prefetch: {done}, ledger {hinted} then {ledger['prefetched']}")
        if throttled["tokens"] != plain["tokens"]:
            raise AssertionError("instance a's tokens changed while it staged a prefetch")
        prefetch_verb = {"model": "hf:<A''>", "state": done["state"], "prefetch_s": prefetch_s,
                         "prefetch_mib_s": LAUNCHER_PREFETCH_MIB_S, "staged": {k: done.get(k) for k in (
                             "bytes", "read_s", "digest_s", "total_s", "workers")},
                         "tpot_before_s": plain["summary"]["decode_tpot_s"],
                         "tpot_during_s": throttled["summary"]["decode_tpot_s"],
                         "ledger_prefetched": {"a": "hf:<A''>"}, "pool_models": ledger["pools"].get("a", {}).get("models")}

        # supervision: SIGKILL a's child
        rev = request(f"{launcher.url}/v2/vllm/instances?detail=false")[1]["revision"]
        pid = launcher.instance("a")["pid"]
        t0 = time.monotonic()
        os.kill(pid, signal.SIGKILL)
        events = await_events(f"{launcher.url}/v2/vllm/instances/watch?since={rev}",
                              ["STOPPED", "RESTARTING", "RESTARTED"], 120)
        stopped = next(e for e in events if e["type"] == "STOPPED")["object"]
        if stopped["exit_code"] != -9 or stopped["instance_id"] != "a":
            raise AssertionError(f"the SIGKILL gave {stopped}")
        launcher.wait_child("a", port_a)
        restart_s = time.monotonic() - t0
        new_pid = launcher.instance("a")["pid"]
        again = run_traffic(torch, port_a, model.vocab_size)
        if again["tokens"] != bucketed["tokens"] or new_pid == pid:
            raise AssertionError(f"the restarted child (pid {new_pid}) gave other tokens: "
                                 f"{first_differences(again['tokens'], bucketed['tokens'])}")

        rpcs = launcher_rpcs(launcher.url, {"POST /v1/swap": 2, "POST /v1/prefetch": 1,
                                            "GET /v1/prefetch": prefetch_gets})
        faults_round_trip = launcher_faults(launcher.url)

        # teardown
        deleted = {iid: request(f"{launcher.url}/v2/vllm/instances/{iid}", "DELETE")[1]["status"] for iid in ("a", "b")}
        if set(deleted.values()) != {"terminated"}:
            raise AssertionError(f"DELETE gave {deleted}")
        launcher.wait(lambda: len(compute_apps()) == len(apps0), 30, "the children's contexts to leave the card")
        free_after = torch.cuda.mem_get_info()[0]
        if free_after < free_before - GIB:
            raise AssertionError(f"{(free_before - free_after) / GIB:.2f} GiB less free after DELETE than before the phase")
    finally:
        launcher.stop()

    # preload's effect: a launcher without it, one spawn
    plain = Launcher("--no-preload")
    try:
        port_c = free_port()
        _, spawn_plain_s = plain.spawn("c", f"{SERVE_OPTS} --port {port_c}", uuid, port_c)
        request(f"{plain.url}/v2/vllm/instances/c", "DELETE")
    finally:
        plain.stop()
    emit({
        "phase": "launcher", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "gpu": {"index": index, "uuid": uuid}, "launcher_ready_s": launcher.ready_s,
        "launcher_holds_context": False, "compute_apps": {"before": apps0, "launcher": apps1, "a": apps2,
                                                          "a_asleep": asleep_apps},
        "spawn_to_healthy_s": spawn_s, "child_device": {k: dev[k] for k in ("device", "name", "uuid")},
        "tokens_equal_serve": True, **traffic["summary"], "launches": counts,
        "refused_while_awake": refused, "a_asleep_card_bytes": asleep_bytes,
        "asleep_limit_bytes": limit["limit_bytes"], "asleep_limit": limit, "asleep_split": split, "ladder": ladder, "b_spawn_to_healthy_s": spawn_b_s, "b_tokens": b_tokens[:8],
        "a_wake_s": woke["last_wake_seconds"], "a_tokens_identical_after_b": True,
        "swap_verb": verbs, "swap_events": [e["type"] for e in swap_events], "prefetch_verb": prefetch_verb,
        "ledger_costs_a": a_costs,
        "restart_events": [{k: e["object"].get(k) for k in ("revision", "pid", "exit_code", "restart_attempt")} | {"type": e["type"]}
                           for e in events],
        "restart_to_healthy_s": restart_s, "restarted_tokens_equal_serve": True,
        "deleted": deleted, "free_before_bytes": free_before, "free_after_bytes": free_after,
        "no_preload_spawn_to_healthy_s": spawn_plain_s, "no_preload_launcher_ready_s": plain.ready_s,
        "create_trace": create_spans, "exemplars": exemplars, "rpc_seconds": rpcs, "faults": faults_round_trip,
    })
    return {"counts": counts, "probe": probe, "b_tokens": b_tokens}


# -- phase quant: compressed actuation and the cost oracle ---------------------

#: Llama-3-8B at 2048 pages under --sleep-quant int8 with the hot head, from
#: the shapes: the seven layer stacks cross as 6,979,321,856 B of int8
#: payload and 5,505,024 B of f32 scales; embed, lm_head, the norms and the
#: KV pool at full precision
QUANT_WAKE_BYTES = 13_381_672_960
#: the same state at full precision (serve's bytes_offloaded)
QUANT_FULL_BYTES = 20_355_489_792
#: a prefetch staged at int8: the parameters only, the stacks as payloads
QUANT_PREFETCH_BYTES = 9_086_705_664
#: the leaves a quantized transfer compresses (the hot head kept)
QUANT_LEAVES = tuple(f"layers.{w}" for w in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
#: layer slices whose weights after a first quantized offload's wake, and
#: after a prefetch staged at int8, must equal the host twin's int8 round
#: trip of the full-precision checkpoint's
QUANT_SAMPLES = (("layers.w_gate", 0), ("layers.wq", 31), ("layers.w_down", 17), ("layers.wv", 5))


def quant_reference(torch, params) -> dict:
    """``QUANT_SAMPLES``' slices of the full-precision weights, rounded as
    a first int8 offload rounds them, by the host twin."""
    from llm_d_fast_model_actuation_tpu_torch.models import quant as tq

    return {(n, l): tq.dequantize_leaf_host(*tq.quantize_leaf_host(params[n][l].detach().cpu(), "int8"))
            for n, l in QUANT_SAMPLES}


def check_quant_samples(torch, engine, reference: dict, where: str) -> None:
    """The card's weights at ``QUANT_SAMPLES`` bit-equal to ``reference``
    (what the dequantization on the card must have written)."""
    params = dict(engine.model.named_parameters())
    for (n, l), want in reference.items():
        got = params[n][l].detach().cpu()
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise AssertionError(f"{where}: {n}[{l}] on the card is not the host twin's int8 round trip of the "
                                 f"checkpoint's weights")


def quant_twin(torch, eng) -> dict:
    """Layer 0 of ``w_gate`` and of ``wq`` quantized on the card and by the
    host twin, at int8 and at fp8: payload, scale and dequantized weights
    bit-equal, and one layer slice's seconds each way (the second call,
    synchronized)."""
    from llm_d_fast_model_actuation_tpu_torch.models import quant as tq

    params = dict(eng.model.named_parameters())
    out = {}
    for name in ("layers.w_gate", "layers.wq"):
        piece = params[name][0:1].detach()
        host = piece.cpu()
        for mode in ("int8", "fp8"):
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p, m = tq.quantize_leaf(piece, mode)
                torch.cuda.synchronize()
                quantize_s = time.perf_counter() - t0
                back = torch.empty_like(piece)
                t0 = time.perf_counter()
                tq.dequantize_leaf(p, m, out=back)
                torch.cuda.synchronize()
                dequantize_s = time.perf_counter() - t0
            hp, hm = tq.quantize_leaf_host(host, mode)
            hback = tq.dequantize_leaf_host(hp, hm)
            same = torch.equal(p.cpu().view(torch.uint8), hp.view(torch.uint8))
            if mode == "int8":
                same = same and torch.equal(m.scale.cpu().view(torch.int32), hm.scale.view(torch.int32))
            same_back = torch.equal(back.cpu().view(torch.int16), hback.view(torch.int16))
            if not (same and same_back):
                raise AssertionError(f"{name}[0] at {mode}: the card's payload/scale equal to the host twin's: {same}, "
                                     f"dequantized: {same_back}")
            out[f"{name}[0]:{mode}"] = {"elements": piece.numel(), "bit_equal": True,
                                        "quantize_s": quantize_s, "dequantize_s": dequantize_s}
            del p, m, back
    return out


def quant_phase(torch, smi: str, ckpt: str, bucketed: dict, swapped: dict) -> dict:
    """Compressed actuation (``--sleep-quant int8``) and the cost oracle on
    one service over the swap phase's checkpoints A, A' and A''
    (Llama-3-8B, full width and depth). The card's quantization against
    the host twin (``quant_twin``); three level-1 cycles, each after
    serve's traffic: ``bytes_offloaded`` exactly ``QUANT_WAKE_BYTES``
    against ``QUANT_FULL_BYTES``, the memory while asleep within serve's
    gates, no capture and no state tensor moved, and from cycle 2 on the
    greedy tokens of a short probe (a cold prefill: no full page to hit
    the prefix cache) and a fingerprint of every quantized leaf equal to
    cycle 1's, and after cycle 1 ``QUANT_SAMPLES`` equal to the host
    twin's round trip (``check_quant_samples``); the wake's seconds and
    GiB/s beside serve's full-precision wake, the first sleep's
    ``pin_s``, and the first cycle's logprob
    drift against the full-precision weights (random weights: reported,
    not gated). Then swaps, each gated to move what ``/v1/costs``
    predicted just before it (and, for a pool hit, what ``plan_swap``
    plans): A -> A' (cold), A' -> A (pool, by digest: the delta), A ->
    A' -> A with the content hash off (full, both directions quantized
    with A's cached scales: A's tokens and quantized stacks then equal
    cycle 1's), then A'' prefetched with int8 staging (its pooled host
    bytes exactly ``QUANT_PREFETCH_BYTES``) and swapped to
    (``prefetched``, dequantized on the card; ``QUANT_SAMPLES`` equal to
    the host twin's round trip, since A'' shares A's layer stacks). Then
    every ``/v1/actuations`` record's errors."""
    from llm_d_fast_model_actuation_tpu_torch.engine import sleep as sleep_mod

    t_phase = time.monotonic()
    model_a, model_b, model_c = f"hf:{ckpt}", f"hf:{swapped['sibling']}", f"hf:{swapped['sibling2']}"
    opts = (f"--model {model_a} --num-pages 2048 --seed 0 --max-batch 8 --device cuda "
            f"--model-pool-mib {swapped['pool_mib']} --content-hash on --swap-bucket-mib 256 "
            f"--exec-pool-mib {EXEC_POOL_MIB} --sleep-quant int8")
    service, server, init_s, free_before = start_service(torch, opts)
    port = server.server_address[1]
    engines = {}

    def note_engine():
        engines.setdefault(id(service.engine), service.engine)

    try:
        note_engine()
        eng = service.engine
        twin = quant_twin(torch, eng)
        free_memory(torch)
        vocab = eng.cfg.model.vocab_size
        probe = {"prompt": bucketed["prompts"][0][:12], "max_tokens": 32, "logprobs": True, "ignore_eos": True}

        def probed():
            c = post(port, "/v1/completions", probe)["choices"][0]
            return c["token_ids"], c["logprobs"]["token_logprobs"]

        fp_tokens, fp_logprobs = probed()
        params = dict(eng.model.named_parameters())
        reference = quant_reference(torch, params)
        ptrs, captures = state_ptrs(eng), eng.graph_captures
        cycles, first = [], None
        for c in range(3):
            traffic = run_traffic(torch, port, vocab)
            info = post(port, "/sleep?level=1")
            asleep = check_asleep(torch, eng, free_before)
            reserved = torch.cuda.memory_reserved()
            if reserved >= GIB:
                raise AssertionError(f"{reserved / GIB:.2f} GiB still reserved while asleep after a quantized sleep")
            if (info["quant"] != "int8" or info["bytes_offloaded"] != QUANT_WAKE_BYTES
                    or info["bytes_offloaded_full"] != QUANT_FULL_BYTES):
                raise AssertionError(f"a quantized sleep offloaded {info}, want {QUANT_WAKE_BYTES} of {QUANT_FULL_BYTES}")
            st = service.sleeper.stats
            pin_s, sleep_transfer_s = st.last_pin_seconds, st.last_sleep_transfer_s
            woke = post(port, "/wake_up")
            tokens, logprobs = probed()
            prints = fingerprint(torch, [params[n] for n in QUANT_LEAVES])
            if eng.graph_captures != captures or state_ptrs(eng) != ptrs:
                raise AssertionError("a quantized sleep/wake cycle re-captured a graph or moved a state tensor")
            if first is None:
                # the first offload's rounding and the wake's
                # dequantization on the card, against the host twin
                check_quant_samples(torch, eng, reference, "after the first quantized wake")
                first = (tokens, prints)
                same = [i for i, (a, b) in enumerate(zip(tokens, fp_tokens)) if a == b]
                drift = {"tokens_equal_fp": tokens == fp_tokens, "first_difference": next(
                    (i for i, (a, b) in enumerate(zip(tokens, fp_tokens)) if a != b), None),
                    "max_abs_logprob_drift": max((abs(logprobs[i] - fp_logprobs[i]) for i in same), default=None)}
            elif (tokens, prints) != first:
                raise AssertionError(f"quantized cycle {c + 1} changed the tokens or the quantized leaves: lossy more "
                                     f"than once")
            cycles.append({"sleep_s": info["last_sleep_seconds"], "sleep_transfer_s": sleep_transfer_s,
                           "sleep_pin_s": pin_s, "wake_s": woke["last_wake_seconds"],
                           "wake_gib_per_s": info["bytes_offloaded"] / GIB / woke["last_wake_seconds"],
                           "wake_map_s": service.sleeper.stats.wake_map_s,
                           "reserved_while_asleep_bytes": reserved, **asleep,
                           "traffic_batch_tok_per_s": traffic["summary"]["batch_tok_per_s"]})
        fp_wakes = [w["wake_s"] for w in bucketed["wake_cycles"]]

        # swaps, each priced by /v1/costs just before it
        steps = []

        def qswap(model: str, tier: str, with_plan: bool = False):
            plan = None
            if with_plan:
                entry = service.model_pool.peek(model)
                rt = service._runtime
                digests = service._content_hash
                plan = service._on_loop(lambda: sleep_mod.plan_swap(
                    rt.sleeper, entry.runtime.sleeper, bucket_bytes=256 * MIB,
                    out_digests=service._digests(rt) if digests else None,
                    in_digests=service._digests(entry.runtime) if digests else None, quant="int8"))
            priced = costs_row(port, model)
            previous = service.model
            out = post(port, "/v1/swap", {"model": model, "request_id": f"quant-{len(steps)}"})
            note_engine()
            if not out.get("swapped") or out["tier"] != tier or priced["tier"] != tier:
                raise AssertionError(f"quantized swap {previous} -> {model}: want tier {tier}, got {out} (priced {priced})")
            if out["bytes_moved"] != priced["predicted_bytes"] or (plan and out["bytes_moved"] != plan["bytes_moved"]):
                raise AssertionError(f"quantized swap {previous} -> {model} moved {out['bytes_moved']} bytes, /v1/costs "
                                     f"predicted {priced['predicted_bytes']}, the plan {plan and plan['bytes_moved']}")
            if out["quant"] != "int8":
                raise AssertionError(f"swap {previous} -> {model} under --sleep-quant int8 reports quant {out['quant']}")
            step = {"from": previous, "to": model, "tier": tier, **{k: out.get(k) for k in (
                "bytes_moved", "bytes_out", "bytes_in", "bytes_full", "bytes_saved_quant", "quant_leaves",
                "bytes_deduped", "swap_total_s", "transfer_s", "d2h_s", "h2d_s", "pin_s", "build_s", "capture_s")},
                "planned_bytes_moved": plan and plan["bytes_moved"], "predicted_bytes": priced["predicted_bytes"],
                "predicted_s": priced["predicted_s"], "measured": priced["measured"],
                "pool_bytes_used": out["pool"]["bytes_used"], "tokens": probed()[0][:8]}
            steps.append(step)
            progress(f"quantized swap {previous} -> {model}", tier=tier, bytes_moved=out["bytes_moved"])
            return out

        qswap(model_b, "cold")
        delta = qswap(model_a, "pool", with_plan=True)
        # the full transfers: the digests off, both directions quantized.
        # A leaves and comes back quantized with the scales its first
        # offload cached, so it must serve cycle 1's weights again
        service._on_loop(lambda: setattr(service, "_content_hash", False))
        try:
            qswap(model_b, "pool", with_plan=True)
            qswap(model_a, "pool", with_plan=True)
        finally:
            service._on_loop(lambda: setattr(service, "_content_hash", True))
        round_trip = (probed()[0], fingerprint(torch, [dict(service.engine.model.named_parameters())[n]
                                                       for n in QUANT_LEAVES]))
        if round_trip != first:
            raise AssertionError("A after a quantized A -> A' -> A round trip does not serve its first quantized "
                                 "wake's tokens and weights")
        started = post(port, "/v1/prefetch", {"model": model_c})
        staged = prefetch_until_done(port, timeout=600)
        entry = service.model_pool.peek(model_c)
        if (staged["state"] != "completed" or staged.get("quant") != "int8" or staged["bytes"] != QUANT_PREFETCH_BYTES
                or entry is None or entry.nbytes != QUANT_PREFETCH_BYTES):
            raise AssertionError(f"the int8 prefetch of A'' staged {staged}, want {QUANT_PREFETCH_BYTES} host bytes")
        prefetched = qswap(model_c, "prefetched")
        if prefetched["bytes_in"] != QUANT_FULL_BYTES or not prefetched.get("prefetched"):
            raise AssertionError(f"the swap to the prefetched A'' built {prefetched['bytes_in']} bytes of state")
        # A'' shares A's layer stacks: staged at int8 on the host and
        # dequantized on the card, they are A's first rounding
        check_quant_samples(torch, service.engine, reference, "after the swap to the int8-prefetched A''")
        actuations = get(port, "/v1/actuations")
        records = [{k: r.get(k) for k in ("seq", "kind", "tier", "outcome", "actual_bytes", "predicted_bytes",
                                          "actual_s", "predicted_s", "measured", "bytes_error_ratio",
                                          "seconds_error_ratio")} for r in actuations["records"]]
        if actuations["summary"]["byte_exact_frac"] != 1.0:
            raise AssertionError(f"the oracle's bytes missed: {actuations['summary']}")
        replayed: dict = {}
        for e in engines.values():
            for name, n in (e.graphs.replayed_launches() if e.graphs else {}).items():
                replayed[name] = replayed.get(name, 0) + n
        counts = add_replayed(read_counts(), replayed)
        decode = sum(e.cfg.model.num_layers * e.decode_steps for e in engines.values())
        prefill = sum(e.cfg.model.num_layers * e.cold_prefills for e in engines.values())
        if (counts["probe"] != service.builds_total or counts["decode_inline"] != decode or counts["prefill"] != prefill
                or not counts["replayed"]["decode_inline"]):
            raise AssertionError(f"the quant phase's launches {counts} against {service.builds_total} builds, "
                                 f"{decode} decode and {prefill} prefill layer-steps")
        emit({
            "phase": "quant", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "init_s": init_s,
            "mode": "int8", "hot_head": True, "twin": twin,
            "bytes_offloaded": QUANT_WAKE_BYTES, "bytes_offloaded_full": QUANT_FULL_BYTES,
            "bytes_offloaded_share": QUANT_WAKE_BYTES / QUANT_FULL_BYTES, "cycles": cycles,
            "fp_wake_s": fp_wakes, "fp_wake_gib_per_s": [QUANT_FULL_BYTES / GIB / w for w in fp_wakes],
            "lossy_once": True, "round_trip_equals_cycle_1": True,
            "samples_equal_host_twin": [f"{n}[{l}]" for n, l in QUANT_SAMPLES],
            "graph_captures_unchanged": True, "state_addresses_unchanged": len(ptrs),
            "first_cycle_drift": drift, "swaps": steps,
            "delta_bytes_moved": delta["bytes_moved"], "fp_sibling_delta_bytes": SIBLING_DELTA_BYTES,
            "prefetch": {k: staged.get(k) for k in ("state", "bytes", "quant", "quant_s", "read_s", "total_s")},
            "prefetch_started": started.get("state"), "actuations": records, "oracle": actuations["summary"],
            "launches": counts, "seconds": time.monotonic() - t_phase,
        })
        return {"counts": counts}
    finally:
        stop_service(torch, service, server)
        service._free_pooled(service.model_pool.drain())


#: the zero_drain phase's streams: prompt lengths (each in a timed prefill
#: bucket, 512, 2048 or 4096), the first four greedy, the last four seeded
ZD_PROMPT_LENS = (300, 1100, 2100, 3000, 400, 1500, 2600, 2000)
ZD_SAMPLED = 4
#: tokens each stream of the zero_drain and migrate phases decodes
ZD_NEW_TOKENS = 128
#: the migrate phase's streams (each prompt in the 512 bucket), two greedy
#: and two seeded
MIG_PROMPT_LENS = (260, 350, 420, 500)
MIG_SAMPLED = 2
#: the arrivals the drain moves (one greedy, one seeded)
MIG_ARRIVAL_LENS = (300, 450)


def stream_bodies(vocab: int, lens: tuple, sampled: int, seed: int) -> list:
    """Completion bodies of random token ids: the first ``len(lens) -
    sampled`` greedy, the rest seeded, each decoding ZD_NEW_TOKENS past
    eos."""
    import numpy as np

    rng = np.random.default_rng(seed)
    greedy = len(lens) - sampled
    return [{"prompt": rng.integers(0, vocab, n).tolist(), "max_tokens": ZD_NEW_TOKENS, "ignore_eos": True,
             **({} if i < greedy else {"temperature": 0.8, "top_p": 0.95, "seed": 1000 + i})}
            for i, n in enumerate(lens)]


class Streams:
    """Concurrent streamed completions, each read on a thread of its own:
    the token ids its events carried, in order, and its error event."""

    def __init__(self, port: int, bodies: list) -> None:
        self.tokens = [[] for _ in bodies]
        self.errors = [None] * len(bodies)
        self.usage = [None] * len(bodies)
        self.threads = [threading.Thread(target=self._read, args=(i, port, b), daemon=True)
                        for i, b in enumerate(bodies)]
        for t in self.threads:
            t.start()

    def _read(self, i: int, port: int, body: dict) -> None:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                     data=json.dumps(dict(body, stream=True)).encode(), method="POST",
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=900) as r:
                for line in r:
                    line = line.decode().strip()
                    if line == "data: [DONE]":
                        return
                    if line.startswith("data: "):
                        ev = json.loads(line[6:])
                        if "error" in ev:
                            self.errors[i] = ev["error"]
                        if ev.get("usage"):
                            self.usage[i] = ev["usage"]
                        for ch in ev.get("choices") or ():
                            self.tokens[i].extend(ch.get("token_ids") or ())
        except Exception as e:  # noqa: BLE001 — reported by the caller's gate
            self.errors[i] = f"{type(e).__name__}: {e}"

    def wait_tokens(self, n: int, timeout: float = 300.0) -> None:
        """Until every stream delivered ``n`` tokens: all are mid-decode."""
        deadline = time.monotonic() + timeout
        while min(len(t) for t in self.tokens) < n:
            if time.monotonic() > deadline or any(self.errors):
                raise AssertionError(f"the streams never reached {n} tokens each: "
                                     f"{[len(t) for t in self.tokens]}, {self.errors}")
            time.sleep(0.002)

    def join(self, timeout: float = 900.0) -> "Streams":
        for t in self.threads:
            t.join(timeout)
        return self


def check_streams(streams: Streams, gold: list, where: str) -> None:
    """Every stream ended without an error, each token delivered once, and
    bit-equal to the uninterrupted run's."""
    if any(streams.errors):
        raise AssertionError(f"{where}: a stream failed: {streams.errors}")
    for i, (got, want) in enumerate(zip(streams.tokens, gold)):
        if got != want:
            at = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
            raise AssertionError(f"{where}: stream {i} ({len(got)} tokens) leaves the uninterrupted run's "
                                 f"({len(want)}) at token {at}")


def last_record(port: int, kind: str) -> dict:
    return get(port, f"/v1/actuations?kind={kind}&n=1")["records"][-1]


def priced_exactly(rec: dict, where: str) -> None:
    if rec["predicted_bytes"] is None or rec["predicted_bytes"] != rec["actual_bytes"]:
        raise AssertionError(f"{where}: the oracle predicted {rec['predicted_bytes']} bytes, "
                             f"{rec['actual_bytes']} moved: {rec}")


#: the coresident phase's streams, the base's, A' 's and A'' 's in turn
#: (each model's third one seeded), 64 new tokens each
CO_PROMPT_LENS = (20, 1500, 3000, 300, 2000, 700, 60, 2500, 1100)
CO_NEW_TOKENS = 64
#: coresident_engine's: its four runs each prefill the nine prompts
CO_ENGINE_NEW_TOKENS = 16
#: the delta of each sibling: lm_head, 4096 x 128256 bf16
CO_DELTA_BYTES = 4096 * 128256 * 2
#: the card's free memory after a detach, against before it, less the delta
CO_FREE_SLACK_BYTES = 64 * MIB
#: a sibling's first logprob against the base's on the same steps: its
#: logits are the base's permuted, so only the log-sum-exp's order differs
CO_HEAD_LP_TOL = 1e-4
#: the prompts of the coresident phase's head check, each request alone
CO_HEAD_PROMPT_LENS = (20, 60, 300)


def base_token(m: int, token: int, vocab: int) -> int:
    """The base's vocabulary index of model ``m``'s token: A' (1) has
    lm_head's vocabulary reversed, A'' (2) rolled by half."""
    return (token, vocab - 1 - token, (token - vocab // 2) % vocab)[m]


def check_sibling_heads(rows: list, vocab: int, where: str) -> list:
    """Each sibling served its own lm_head, a check apart from the passes
    and the arena copies that the bit-equal gates share. Per greedy prompt
    on the same steps, ``rows`` hold each model's first (token, logprob)
    and ``ties``, the base's tokens at its best logprob (more than one
    where the best logits tie): each sibling's token maps back to one of
    them, at the base's logprob."""
    for i, r in enumerate(rows):
        t0, lp0 = r["first"][0]
        for m in (1, 2):
            t, lp = r["first"][m]
            if base_token(m, t, vocab) not in r["ties"] or abs(lp - lp0) > CO_HEAD_LP_TOL:
                raise AssertionError(f"{where}: prompt {i} on model {m} gave token {t} (the base's "
                                     f"{base_token(m, t, vocab)}) at logprob {lp}; the base's best are "
                                     f"{sorted(r['ties'])} at {lp0}")
    return [{"first": r["first"], "ties": sorted(r["ties"])} for r in rows]


def http_heads(port: int, models: tuple, vocab: int) -> list:
    """``check_sibling_heads``' rows over HTTP: one greedy token of each
    prompt on each model, each request alone (the same steps); the base's
    ties are its token and its best with that token banned
    (``logit_bias``)."""
    import numpy as np

    rng = np.random.default_rng(19)
    rows = []
    for n in CO_HEAD_PROMPT_LENS:
        prompt = rng.integers(0, vocab, n).tolist()

        def first(model, bias=None):
            body = {"prompt": prompt, "max_tokens": 1, "model": model, "logprobs": 1, "ignore_eos": True}
            if bias:
                body["logit_bias"] = bias
            ch = post(port, "/v1/completions", body)["choices"][0]
            return ch["token_ids"][0], ch["logprobs"]["token_logprobs"][0]

        got = [first(m) for m in models]
        banned = first(models[0], {str(got[0][0]): -100.0})[0]
        rows.append({"first": got, "ties": {got[0][0], banned}})
    return rows


def coresident_bodies(vocab: int, models: tuple) -> list:
    import numpy as np

    rng = np.random.default_rng(18)
    out = []
    for i, n in enumerate(CO_PROMPT_LENS):
        body = {"prompt": rng.integers(0, vocab, n).tolist(), "max_tokens": CO_NEW_TOKENS, "ignore_eos": True,
                "model": models[i % 3]}
        if i // 3 == 2:
            body.update(temperature=0.8, top_p=0.95, seed=2000 + i)
        out.append(body)
    return out


def timing(streams: "Streams", which: list) -> dict:
    """Mean TTFT and decode TPOT of the listed streams (their usage)."""
    use = [streams.usage[i] for i in which]
    return {"ttft_s": sum(u["time_to_first_token_s"] for u in use) / len(use),
            "tpot_s": sum(u["decode_tpot_s"] for u in use) / len(use), "requests": len(use)}


def engine_figures(port: int) -> dict:
    """The child's step counters and its kernel launches (eager, and what
    its graph replays ran)."""
    counts, dev = child_counts(port)
    eng = get(port, "/v1/stats")["engine"]
    return {**eng, "ragged": counts["ragged"], "decode_eager": counts["eager"]["decode_inline"],
            "decode_replayed": counts["replayed"]["decode_inline"], "mapped_bytes": dev["memory"]["mapped_bytes"],
            "counts": counts}


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after if isinstance(after[k], (int, float)) and k in before}


def coresident_phase(torch, smi: str, ckpt: str, swapped: dict) -> dict:
    """Co-resident sibling variants on one launcher child of the checkpoint
    A (``--packed-serving on --token-budget 72 --resident-variants 3
    --variant-hbm-mib 2048 --prefix-caching off``: one packed buffer shape,
    and no prefix-cache hit between the runs compared): A' and A''
    prefetched into its pool, then attached through the launcher's
    residents verb. Gates: each attach moves and maps exactly its price
    (lm_head, 1,050,673,152 bytes); the ledger's device bytes twice that
    and its duplicated bytes twice the weights; the launcher's fleet
    gauges the same; ``tinyllama-1.1b`` (no digests the tiers hold: no
    sibling) and then a third attach (the cap) refused with a 409; each
    sibling's own lm_head served (``http_heads``). Nine
    concurrent streams (three per model, each model's third seeded): the
    routed steps and chunks run one pass per resident with rows in them,
    the ragged and decode kernels launched L x passes (their tokens are
    held bit for bit in ``coresident_engine``); base-only traffic replays
    the captured graphs and captures none; TTFT and TPOT of both. A detach while its
    variant streams is a 409, and a sleep, a swap and an export are
    refused; after the drain both detaches free exactly what was mapped
    (the card's free memory within 64 MiB); then a level-1 sleep maps
    nothing and a wake serves the same tokens."""
    from llm_d_fast_model_actuation_tpu_torch.models.llama import LlamaConfig, param_shapes

    t_phase = time.monotonic()
    cfg = LlamaConfig.llama3_8b()
    L, vocab = cfg.num_layers, cfg.vocab_size
    weights = 2 * sum(math.prod(v) for v in param_shapes(cfg).values())
    free_memory(torch)
    _, uuid = smi_rows("--query-gpu=index,uuid")[0]
    base, sib1, sib2 = f"hf:{ckpt}", f"hf:{swapped['sibling']}", f"hf:{swapped['sibling2']}"
    port = free_port()
    opts = (f"--model {base} --num-pages 2048 --seed 0 --max-batch 8 --device cuda --packed-serving on "
            f"--token-budget 72 --resident-variants 3 --variant-hbm-mib 2048 --zero-drain off --content-hash on "
            f"--prefix-caching off --model-pool-mib {swapped['pool_mib']} --port {port}")
    launcher = Launcher()
    url = f"{launcher.url}/v2/vllm/instances/r"
    try:
        _, spawn_s = launcher.spawn("r", opts, uuid, port)
        t0 = time.monotonic()
        for m in (sib1, sib2):
            status, body = request(f"{url}/prefetch", "POST", {"model": m})
            done = prefetch_until_done(port)
            if status != 200 or done["state"] != "completed":
                raise AssertionError(f"prefetch {m} through the launcher: {status} {body} {done}")
        prefetch_s = time.monotonic() - t0
        rows = {r["model"]: r for r in get(port, "/v1/costs")["coresident"]}
        priced = {m: rows[m].get("predicted_bytes") for m in (sib1, sib2)}
        if priced != {sib1: CO_DELTA_BYTES, sib2: CO_DELTA_BYTES}:
            raise AssertionError(f"the coresident prices are {priced}, want {CO_DELTA_BYTES} each: {rows}")
        attached, free0 = [], torch.cuda.mem_get_info()[0]
        for i, m in enumerate((sib1, sib2)):
            before = get(port, "/v1/device")["memory"]["mapped_bytes"]
            status, body = request(f"{url}/residents", "POST", {"model": m})
            if status != 200 or not body["residents"]["attached"]:
                raise AssertionError(f"attach {m}: {status} {body}")
            res = body["residents"]
            grew = get(port, "/v1/device")["memory"]["mapped_bytes"] - before
            rec = res["costs"]
            if not rec["predicted_bytes"] == rec["actual_bytes"] == res["wire_bytes"] == grew == CO_DELTA_BYTES:
                raise AssertionError(f"attach {m}: priced {rec['predicted_bytes']}, moved {rec['actual_bytes']}, "
                                     f"mapped {grew}, want {CO_DELTA_BYTES}")
            attached.append({"model": m, "handle": res["handle"], "attach_s": res["attach_s"],
                             "predicted_s": rec["predicted_s"], "source_tier": res["source_tier"], "mapped": grew})
            if i == 0:
                # a model the tiers hold no digests of is no sibling
                status, body = request(f"{url}/residents", "POST", {"model": "tinyllama-1.1b"})
                if status != 409:
                    raise AssertionError(f"attach tinyllama-1.1b: {status} {body}")
                not_sibling = str(body)[:300]
        free1 = torch.cuda.mem_get_info()[0]
        ledger = res["ledger"]
        if not (ledger["bytes_device"] == 2 * CO_DELTA_BYTES and ledger["bytes_if_duplicated"] == 2 * weights
                and ledger["bytes_saved"] == 2 * weights - 2 * CO_DELTA_BYTES):
            raise AssertionError(f"the resident ledger: {ledger}, want device {2 * CO_DELTA_BYTES}, duplicated "
                                 f"{2 * weights}")
        status, capped = request(f"{url}/residents", "POST", {"model": f"hf:{ckpt}-sibling3"})
        if status != 409 or "cap" not in str(capped):
            raise AssertionError(f"a third attach: {status} {capped}")
        samples = scrape(f"{launcher.url}/metrics")
        gauges = {"resident_variants": metric(samples, "fma_launcher_fleet_resident_variants"),
                  "coresident_saved_bytes": metric(samples, "fma_launcher_fleet_coresident_saved_bytes")}
        if gauges != {"resident_variants": 3, "coresident_saved_bytes": ledger["bytes_saved"]}:
            raise AssertionError(f"the launcher's fleet gauges {gauges}, the ledger {ledger}")
        listed = request(launcher.url + "/v2/vllm/instances")[1]["ledger"]["residents"].get("r", {})
        if listed.get("residents") != sorted([sib1, sib2]):
            raise AssertionError(f"the launcher's ledger block: {listed}")
        heads = check_sibling_heads(http_heads(port, (base, sib1, sib2), vocab), vocab, "coresident")

        # all nine at once; their tokens are gated bit for bit on a fixed
        # schedule in coresident_engine: over HTTP the arrivals' order and
        # the steps they share vary, and a decode row in a packed step
        # rounds apart from one in a chunk
        bodies = coresident_bodies(vocab, (base, sib1, sib2))
        before = engine_figures(port)
        t0 = time.monotonic()
        mixed = Streams(port, bodies).join()
        mixed_s = time.monotonic() - t0
        if any(mixed.errors) or any(len(t) != CO_NEW_TOKENS for t in mixed.tokens):
            raise AssertionError(f"the interleaved streams failed: {mixed.errors}")
        d = delta(engine_figures(port), before)
        if not (d["variant_steps"] > 0 and d["variant_chunks"] > 0 and d["ragged"] == L * d["packed_passes"]
                and d["packed_passes"] > d["packed_steps"]
                and d["decode_eager"] == L * d["variant_decode_forwards"]
                and d["decode_replayed"] == L * (d["decode_steps"] - d["variant_chunk_steps"])
                and d["graph_replays"] + d["variant_chunks"] == d["decode_chunks"] and d["graph_captures"] == 0):
            raise AssertionError(f"the interleaved run's passes and launches: {d}")
        routed_ix = [i for i, b in enumerate(bodies) if b["model"] != base]
        # base-only traffic with the variants attached: the plain path
        base_bodies = [dict(b, model=base) for b in bodies]
        before = engine_figures(port)
        base_run = Streams(port, base_bodies).join()
        if any(base_run.errors):
            raise AssertionError(f"base-only traffic failed: {base_run.errors}")
        b = delta(engine_figures(port), before)
        if not (b["decode_chunks"] > 0 and b["graph_replays"] == b["decode_chunks"] and b["variant_chunks"] == 0
                and b["variant_steps"] == 0 and b["packed_passes"] == b["packed_steps"] and b["graph_captures"] == 0
                and b["decode_eager"] == 0 and b["ragged"] == L * b["packed_steps"]):
            raise AssertionError(f"base-only traffic left the plain path: {b}")

        # detach-first
        s = Streams(port, [bodies[1]])  # A' 's 1500-id prompt
        s.wait_tokens(2)
        refused = {"detach_live": request(f"{url}/residents", "DELETE", {"model": sib1}),
                   "sleep": request(f"http://127.0.0.1:{port}/sleep?level=1", "POST", {}),
                   "swap": request(f"http://127.0.0.1:{port}/v1/swap", "POST", {"model": sib2}),
                   "export": request(f"http://127.0.0.1:{port}/v1/parked/{urllib.parse.quote(base, safe='')}")}
        s.join()
        if (refused["detach_live"][0] != 409 or refused["sleep"][0] != 400 or refused["swap"][0] != 400
                or refused["export"][0] != 409 or not all("detach" in str(v[1]) for v in refused.values())):
            raise AssertionError(f"the detach-first refusals: {refused}")
        if s.errors[0] or len(s.tokens[0]) != CO_NEW_TOKENS:
            raise AssertionError(f"the stream beside the refusals: {s.errors}")
        mapped0, free2 = get(port, "/v1/device")["memory"]["mapped_bytes"], torch.cuda.mem_get_info()[0]
        detached = []
        for m in (sib1, sib2):
            status, body = request(f"{url}/residents", "DELETE", {"model": m})
            if status != 200 or body["residents"]["freed_bytes"] != CO_DELTA_BYTES:
                raise AssertionError(f"detach {m}: {status} {body}")
            detached.append(body["residents"]["detach_s"])
        mapped1, free3 = get(port, "/v1/device")["memory"]["mapped_bytes"], torch.cuda.mem_get_info()[0]
        if mapped0 - mapped1 != 2 * CO_DELTA_BYTES or abs(free3 - free2 - 2 * CO_DELTA_BYTES) > CO_FREE_SLACK_BYTES \
                or abs(free0 - free1 - 2 * CO_DELTA_BYTES) > CO_FREE_SLACK_BYTES:
            raise AssertionError(f"the detaches unmapped {mapped0 - mapped1} bytes and freed {free3 - free2} of the "
                                 f"card, the attaches took {free0 - free1}; want {2 * CO_DELTA_BYTES}")
        # serve's sleep gates with no variant left
        captures = get(port, "/v1/stats")["engine"]["graph_captures"]
        gold = Streams(port, [bodies[0]]).join()
        post(port, "/sleep?level=1")
        asleep = get(port, "/v1/device")["memory"]
        if asleep["mapped_bytes"] or asleep["reserved_bytes"] > ASLEEP_RESERVED_LIMIT_BYTES:
            raise AssertionError(f"asleep after the detaches the child keeps {asleep}")
        woke = post(port, "/wake_up")
        probe = Streams(port, [bodies[0]]).join()
        if probe.tokens[0] != gold.tokens[0] or get(port, "/v1/stats")["engine"]["graph_captures"] != captures:
            raise AssertionError("the wake after the detaches serves other tokens or captured graphs again")
        counts, _ = child_counts(port)
        emit({
            "phase": "coresident", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "spawn_s": spawn_s,
            "prefetch_s": prefetch_s, "attach": attached, "ledger": ledger, "fleet_gauges": gauges,
            "refused": {"cap": str(capped)[:200], "not_sibling": not_sibling,
                        **{k: str(v[1])[:160] for k, v in refused.items()}},
            "streams": {"prompt_tokens": list(CO_PROMPT_LENS), "new_tokens": CO_NEW_TOKENS, "interleaved_s": mixed_s},
            "routed": timing(mixed, routed_ix), "base_in_interleaved": timing(mixed, [0, 3, 6]),
            "base_only": timing(base_run, list(range(len(bodies)))),
            "interleaved_run": {k: v for k, v in d.items() if k != "counts"},
            "base_only_run": {k: v for k, v in b.items() if k != "counts"},
            "sibling_heads": heads, "detach_s": detached, "freed_card_bytes": free3 - free2, "attached_card_bytes": free0 - free1,
            "sleep_wake": {"asleep": asleep, "wake_s": woke.get("last_wake_seconds")},
            "seconds": time.monotonic() - t_phase,
        })
        return {"counts": counts}
    finally:
        launcher.stop()


def coresident_engine(torch, smi: str, ckpt: str) -> dict:
    """The co-resident passes bit for bit, on an engine of the checkpoint
    built here (``--token-budget 72``: one packed buffer shape; no prefix
    cache) with two siblings attached, A' (lm_head's vocabulary reversed)
    and A'' (rolled by half). The coresident phase's nine requests (three
    per model, each model's third seeded) are added at once, so the steps
    are the same in every run: interleaved, then the same nine routed to
    one model at a time. Each request's tokens and logprobs must equal the
    run where its model is the only one routed (one pass a step, the same
    steps and buffer shapes). Each greedy request's first token on A' and
    A'' maps back to the base's in the single-model runs, at its logprob
    (``check_sibling_heads``; the base's top logprobs give its ties). The
    interleaved run's launches: the ragged
    kernel L x the packed passes, the decode kernel eagerly L x the
    multi-variant chunks' decode forwards, replayed for the rest."""
    from llm_d_fast_model_actuation_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from llm_d_fast_model_actuation_tpu_torch.models import hf as hf_models

    t_phase = time.monotonic()
    free_memory(torch)
    model = hf_models.config_from_hf(ckpt)
    cfg = EngineConfig(model=model, max_batch=8, num_pages=2048, packed_serving=True, token_budget=72,
                       prefix_caching=False)
    eng = InferenceEngine(cfg, params=lambda m: hf_models.load_params(ckpt, m), device="cuda")
    try:
        head = eng.model.lm_head
        handles = [0, eng.attach_variant({"lm_head": head.flip(1).contiguous()}, "a1"),
                   eng.attach_variant({"lm_head": head.roll(head.shape[1] // 2, 1).contiguous()}, "a2")]
        bodies = coresident_bodies(model.vocab_size, (0, 1, 2))
        L = model.num_layers

        def run(route) -> tuple:
            ids = [eng.add_request(b["prompt"], max_new_tokens=CO_ENGINE_NEW_TOKENS, ignore_eos=True,
                                   temperature=b.get("temperature", 0.0), top_p=b.get("top_p", 1.0),
                                   seed=b.get("seed"), want_top_logprobs=True, variant=handles[route(b)])
                   for b in bodies]
            done, t0 = {}, time.monotonic()
            while eng.has_work():
                for r in eng.step():
                    done[r.seq_id] = r
            reqs = [done[i] for i in ids]
            return ([(r.out_tokens, r.out_logprobs) for r in reqs], time.monotonic() - t0,
                    [r.out_top_logprobs[0] for r in reqs])

        solo = {m: run(lambda b, m=m: m) for m in range(3)}
        before = {k: getattr(eng, k) for k in ("packed_passes", "packed_steps", "variant_steps", "variant_chunks",
                                                 "variant_decode_forwards", "graph_replays", "decode_chunks")}
        reset_counts()
        mixed, mixed_s, _ = run(lambda b: b["model"])
        counts = path_counts(eng)
        d = {k: getattr(eng, k) - v for k, v in before.items()}
        for i, b in enumerate(bodies):
            if mixed[i] != solo[b["model"]][0][i]:
                got, want = mixed[i][0], solo[b["model"]][0][i][0]
                at = next((k for k, (x, y) in enumerate(zip(got, want)) if x != y), None)
                raise AssertionError(f"request {i} (model {b['model']}) interleaved leaves its model's run at "
                                     f"token {at} (logprobs equal: {mixed[i][1] == solo[b['model']][0][i][1]})")
        if not (d["variant_steps"] > 0 and d["variant_chunks"] > 0
                and counts["ragged"] == L * d["packed_passes"] and d["packed_passes"] > d["packed_steps"]
                and counts["eager"]["decode_inline"] == L * d["variant_decode_forwards"]
                and d["graph_replays"] + d["variant_chunks"] == d["decode_chunks"]):
            raise AssertionError(f"the interleaved run's passes {d} and launches {counts}")
        heads = check_sibling_heads(
            [{"first": [(solo[m][0][i][0][0], solo[m][0][i][1][0]) for m in range(3)],
              "ties": {t for t, lp in solo[0][2][i] if lp >= solo[0][0][i][1][0] - CO_HEAD_LP_TOL}}
             for i, b in enumerate(bodies) if "temperature" not in b], model.vocab_size, "coresident_engine")
        for h in handles[1:]:
            eng.detach_variant(h)
        out = {"phase": "coresident_engine", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
               "tokens_and_logprobs_bit_equal": True, "sibling_heads": heads, "requests": len(bodies), "interleaved_s": mixed_s,
               "single_model_s": [solo[m][1] for m in range(3)], "passes": d,
               "launches": {k: counts[k] for k in ("ragged", "eager", "replayed")},
               "seconds": time.monotonic() - t_phase}
        emit(out)
        return {"counts": counts}
    finally:
        del eng
        free_memory(torch)


def profile_again(torch, smi: str) -> dict:
    """The graphs phase's profiled replay once more, now after the serve
    phases' profiler windows and the coresident phase, in this process:
    a fresh engine as ``graphs_phase`` builds it, eight requests running,
    the gate of ``chunk_device_profile`` unchanged."""
    import numpy as np

    from llm_d_fast_model_actuation_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from llm_d_fast_model_actuation_tpu_torch.models import llama

    free_memory(torch)
    cfg = EngineConfig(model=llama.LlamaConfig.llama3_8b(), max_batch=8, num_pages=2048, prefix_caching=False)
    eng = InferenceEngine(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(1)
    for n in GRAPH_PROMPT_LENS:
        eng.add_request(rng.integers(0, cfg.model.vocab_size, n).tolist(), max_new_tokens=200)
    eng.step()
    out = {"phase": "graphs_profile_again", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           **chunk_device_profile(torch, eng, 8)}
    eng.abort_all("profile done")
    del eng
    free_memory(torch)
    emit(out)
    return out


def zero_drain_phase(torch, smi: str, ckpt: str, swapped: dict) -> dict:
    """Zero-drain actuation on one service of the checkpoint (``--zero-drain
    on --content-hash on``): eight streams (four greedy, four seeded;
    prompts of 300 to 3000 tokens, 128 new tokens each) run once
    uninterrupted, then again through (a) a swap to the swap phase's
    sibling and back and (b) a level-1 sleep and wake, each taken while
    every stream is mid-decode. Gates: every stream's tokens bit-equal to
    the uninterrupted run's, each delivered once; no ``swap`` abort, and
    preempted == resumed; the page-out's bytes equal the parked pages
    (``parked_page_ids``) times a page's bytes, and each actuation's price
    (the ``/v1/costs`` arithmetic, made on the engine thread just before
    it) equals its bytes; the sleep moves the weights alone; the engine
    captures no graph and moves no state tensor. Then two drills: a
    ``kvrestore.h2d`` failure ends the parked streams with ``state_loss``
    and the engine serves a fresh request; a ``kvsave.d2h`` failure falls
    back to the abort path. Prints the pin, page-out, page-in and resume
    seconds and bytes."""
    from llm_d_fast_model_actuation_tpu_torch.engine.kv_cache import PagePool

    t_phase = time.monotonic()
    model_a, model_b = f"hf:{ckpt}", f"hf:{swapped['sibling']}"
    opts = (f"--model {model_a} --num-pages 2048 --seed 0 --max-batch 8 --device cuda "
            f"--model-pool-mib {swapped['pool_mib']} --content-hash on --swap-bucket-mib 256 --exec-pool-mib 512 "
            "--zero-drain on")
    service, server, init_s, _ = start_service(torch, opts)
    port = server.server_address[1]
    engines = {}
    try:
        eng = service.engine
        engines[id(eng)] = eng
        m = eng.cfg.model
        page_nbytes = PagePool.page_nbytes(m.num_layers, eng.cfg.page_size, m.num_kv_heads, m.head_dim, dtype=m.dtype)
        weights = sum(t.numel() * t.element_size() for t in eng.model.parameters())
        bodies = stream_bodies(m.vocab_size, ZD_PROMPT_LENS, ZD_SAMPLED, seed=15)
        t0 = time.monotonic()
        gold = Streams(port, bodies).join()
        gold_s = time.monotonic() - t0
        if any(gold.errors) or any(len(t) != ZD_NEW_TOKENS for t in gold.tokens):
            raise AssertionError(f"the uninterrupted run failed: {gold.errors}")
        gold = gold.tokens
        # pool both models (the first pinning) and empty A's prefix cache
        # (a park clears it), so the streams prefill cold, as the gold did
        warm = [post(port, "/v1/swap", {"model": model_b}), post(port, "/v1/swap", {"model": model_a})]
        engines[id(service.engine)] = service.engine
        captures, ptrs = eng.graph_captures, state_ptrs(eng)
        if service.engine is not eng:
            raise AssertionError("the swap back installed another engine")

        # (a) a swap to the sibling and back under the eight live streams
        s = Streams(port, bodies)
        s.wait_tokens(2)
        out = post(port, "/v1/swap", {"model": model_b})
        zd = out["zero_drain"]
        bundle = service.model_pool.peek(model_a).runtime.parked
        used = sum(-(-pr.req.pos // eng.cfg.page_size) for pr in bundle.live)
        if zd["parked"] != len(bodies) or len(bundle.live) != len(bodies):
            raise AssertionError(f"the swap parked {zd['parked']} requests ({len(bundle.live)} live), "
                                 f"want all {len(bodies)} live")
        if not zd["kv_pageout_bytes"] == len(bundle.page_ids) * page_nbytes == used * page_nbytes:
            raise AssertionError(f"the page-out moved {zd['kv_pageout_bytes']} bytes, want {used} pages x "
                                 f"{page_nbytes}")
        priced_exactly(out["costs"], "the preempting swap")
        delivered = [len(t) for t in s.tokens]
        engines[id(service.engine)] = service.engine
        back = post(port, "/v1/swap", {"model": model_a})
        if back["zero_drain"]["resumed"] != len(bodies) or back["kv_pagein_bytes"] != zd["kv_pageout_bytes"]:
            raise AssertionError(f"the swap back resumed {back['zero_drain']}, want {len(bodies)} streams and "
                                 f"{zd['kv_pageout_bytes']} bytes")
        priced_exactly(back["costs"], "the resuming swap")
        s.join()
        check_streams(s, gold, "swap cycle")
        swap_cycle = {
            "parked": zd["parked"], "kv_pageout_bytes": zd["kv_pageout_bytes"], "pages": len(bundle.page_ids),
            "kv_pin_s": zd["kv_pin_s"], "kv_pageout_s": zd["kv_pageout_s"],
            "kv_pagein_bytes": back["kv_pagein_bytes"], "kv_pagein_s": back["zero_drain"]["kv_pagein_s"],
            "swap_out_s": out["swap_total_s"], "swap_back_s": back["swap_total_s"],
            "bytes_moved": [out["bytes_moved"], back["bytes_moved"]],
            "tokens_at_park": delivered, "predicted_bytes": [out["costs"]["predicted_bytes"],
                                                             back["costs"]["predicted_bytes"]],
        }
        del bundle

        # (b) a level-1 sleep and a wake under the eight live streams
        s = Streams(port, bodies)
        s.wait_tokens(2)
        slept = post(port, "/sleep?level=1")
        if slept["bytes_offloaded"] != weights or slept["zero_drain"]["parked"] != len(bodies):
            raise AssertionError(f"the sleep offloaded {slept['bytes_offloaded']} bytes (the weights are {weights}) "
                                 f"and parked {slept.get('zero_drain')}")
        priced_exactly(last_record(port, "sleep"), "the parking sleep")
        woke = post(port, "/wake_up")
        if woke["zero_drain"]["resumed"] != len(bodies) or woke["zero_drain"]["kv_pagein_bytes"] != \
                slept["zero_drain"]["kv_pageout_bytes"]:
            raise AssertionError(f"the wake resumed {woke.get('zero_drain')}, the sleep parked {slept['zero_drain']}")
        priced_exactly(last_record(port, "wake"), "the resuming wake")
        s.join()
        check_streams(s, gold, "sleep cycle")
        sleep_cycle = {**slept["zero_drain"], **woke["zero_drain"], "bytes_offloaded": slept["bytes_offloaded"],
                       "sleep_s": slept["last_sleep_seconds"], "wake_s": woke["last_wake_seconds"]}
        if eng.graph_captures != captures or state_ptrs(eng) != ptrs:
            raise AssertionError(f"the engine captured {eng.graph_captures - captures} graphs or moved a state "
                                 "tensor over the two cycles")
        stats = get(port, "/v1/stats")
        zds = stats["zero_drain"]
        if stats["aborted"].get("swap", 0) or zds["preempted"] != zds["resumed"] or zds["aborted"]:
            raise AssertionError(f"the cycles aborted requests: {stats['aborted']}, {zds}")

        # drill: a page-in that fails ends the parked streams (state_loss)
        s = Streams(port, bodies[:2])
        s.wait_tokens(2)
        post(port, "/sleep?level=1")
        post(port, "/v1/faults", {"spec": "kvrestore.h2d=fail:1"})
        woke_drill = post(port, "/wake_up")
        s.join()
        if not all(e and "zero-drain KV restore" in e for e in s.errors):
            raise AssertionError(f"the kvrestore.h2d drill left streams {s.errors}")
        fresh = post(port, "/v1/completions", {"prompt": bodies[0]["prompt"][:20], "max_tokens": 16})
        if len(fresh["choices"][0]["token_ids"]) != 16:
            raise AssertionError("the engine did not serve after the kvrestore.h2d drill")
        # drill: a page-out that fails falls back to the abort path
        s = Streams(port, bodies[:2])
        s.wait_tokens(2)
        post(port, "/v1/faults", {"spec": "kvsave.d2h=fail:1"})
        out_drill = post(port, "/v1/swap", {"model": model_b})
        s.join()
        if "fallback" not in out_drill["zero_drain"] or not all(e and "aborted by model swap" in e for e in s.errors):
            raise AssertionError(f"the kvsave.d2h drill: {out_drill['zero_drain']}, streams {s.errors}")
        request(f"http://127.0.0.1:{port}/v1/faults", "DELETE")
        post(port, "/v1/swap", {"model": model_a})
        drills = {"kvrestore_h2d": {"aborted": len(s.errors), "wake": woke_drill.get("zero_drain"),
                                    "stats": get(port, "/v1/stats")["zero_drain"]},
                  "kvsave_d2h": out_drill["zero_drain"]}

        replayed: dict = {}
        for e in engines.values():
            for name, n in (e.graphs.replayed_launches() if e.graphs else {}).items():
                replayed[name] = replayed.get(name, 0) + n
        counts = add_replayed(read_counts(), replayed)
        if not counts["replayed"]["decode_inline"] or not counts["prefill"]:
            raise AssertionError(f"the zero_drain phase launched no decode or prefill kernel: {counts}")
        emit({
            "phase": "zero_drain", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "init_s": init_s,
            "streams": {"prompt_tokens": list(ZD_PROMPT_LENS), "new_tokens": ZD_NEW_TOKENS, "sampled": ZD_SAMPLED},
            "uninterrupted_s": gold_s, "warm_swaps_s": [w["swap_total_s"] for w in warm],
            "page_nbytes": page_nbytes, "weights_bytes": weights,
            "swap_cycle": swap_cycle, "sleep_cycle": sleep_cycle, "drills": drills,
            "tokens_bit_equal": True, "graph_captures_unchanged": True, "state_addresses_unchanged": len(ptrs),
            "stats": get(port, "/v1/stats")["zero_drain"], "launches": counts,
            "seconds": time.monotonic() - t_phase,
        })
        return {"counts": counts}
    finally:
        stop_service(torch, service, server)
        service._free_pooled(service.model_pool.drain())


def migrate_phase(torch, smi: str, ckpt: str) -> dict:
    """Live migration through the port's launcher (its own process): two
    instances of the checkpoint on card 0 (``--zero-drain on --content-hash
    on``), ``b`` admitted while ``a`` sleeps, then ``a`` woken through its
    own ``POST /wake_up`` (the exclusivity rule is applied at create, as
    ever). Four streams (prompts of 260 to 500 tokens, 128 new tokens, two
    greedy, two seeded) run once uninterrupted on ``b``, then on ``a``,
    where ``POST /v2/vllm/instances/a/migrate`` hands them to ``b``
    mid-decode. Gates: every token delivered once through ``a``'s
    streams, bit-equal to the uninterrupted run's; one migration per role
    in ``fma_engine_migrations_total``; the KV ``b`` paged in equals the
    KV ``a`` exported. Then new arrivals on ``a`` and ``POST
    /v2/vllm/instances/a/drain``: ``a``'s queue depth is 0 after it and
    the arrivals finish through its proxies. Prints the export, import and
    release seconds, the wire's bytes and the peak host memory."""
    from llm_d_fast_model_actuation_tpu_torch.models.llama import LlamaConfig

    t_phase = time.monotonic()
    free_memory(torch)
    _, uuid = smi_rows("--query-gpu=index,uuid")[0]
    opts = (f"--model hf:{ckpt} --num-pages 2048 --seed 0 --max-batch 8 --content-hash on --zero-drain on "
            "--swap-bucket-mib 256")
    port_a, port_b = free_port(), free_port()
    launcher = Launcher()
    try:
        _, spawn_a = launcher.spawn("a", f"{opts} --port {port_a}", uuid, port_a)
        post(port_a, "/sleep?level=1")
        _, spawn_b = launcher.spawn("b", f"{opts} --port {port_b}", uuid, port_b)
        post(port_a, "/wake_up")
        vocab = LlamaConfig.llama3_8b().vocab_size
        bodies = stream_bodies(vocab, MIG_PROMPT_LENS, MIG_SAMPLED, seed=16)
        gold = Streams(port_b, bodies).join()
        if any(gold.errors) or any(len(t) != ZD_NEW_TOKENS for t in gold.tokens):
            raise AssertionError(f"the uninterrupted run on b failed: {gold.errors}")
        s = Streams(port_a, bodies)
        s.wait_tokens(2)
        status, mig = request(f"{launcher.url}/v2/vllm/instances/a/migrate", "POST", {})
        if status != 200 or mig["dest_id"] != "b" or mig["migrated"] != len(bodies):
            raise AssertionError(f"migrate a: {status} {mig}")
        if not 0 < mig["kv_bytes"] == mig["import"]["kv_bytes"]:
            raise AssertionError(f"b paged in {mig['import']['kv_bytes']} bytes, a exported {mig['kv_bytes']}")
        s.join()
        check_streams(s, gold.tokens, "migrate")
        # each leg's seconds as the two engines saw them (the drain's pass
        # overwrites them)
        legs = {"a_export": get(port_a, "/v1/stats")["migration_legs"]["export"],
                "b_import": get(port_b, "/v1/stats")["migration_legs"]["import"]}
        roles = {"source": metric(scrape(f"http://127.0.0.1:{port_a}/metrics"), "fma_engine_migrations_total",
                                  role="source", outcome="committed"),
                 "destination": metric(scrape(f"http://127.0.0.1:{port_b}/metrics"), "fma_engine_migrations_total",
                                       role="destination", outcome="imported")}
        if roles != {"source": 1, "destination": 1}:
            raise AssertionError(f"fma_engine_migrations_total per role: {roles}")
        # drain: new arrivals on a, then passes until a is idle
        arrivals = Streams(port_a, stream_bodies(vocab, MIG_ARRIVAL_LENS, 1, seed=17))
        arrivals.wait_tokens(1)
        status, drained = request(f"{launcher.url}/v2/vllm/instances/a/drain", "POST", {})
        depth = get(port_a, "/v1/stats")["queue_depth"]
        if status != 200 or not drained.get("drained") or depth != 0:
            raise AssertionError(f"drain a: {status} {drained}, queue_depth {depth}")
        arrivals.join()
        if any(arrivals.errors) or any(len(t) != ZD_NEW_TOKENS for t in arrivals.tokens):
            raise AssertionError(f"the arrivals drained away failed: {arrivals.errors}")
        counts_a, dev_a = child_counts(port_a)
        counts_b, dev_b = child_counts(port_b)
        stats_a, stats_b = get(port_a, "/v1/stats"), get(port_b, "/v1/stats")
        emit({
            "phase": "migrate", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "spawn_s": {"a": spawn_a, "b": spawn_b},
            "streams": {"prompt_tokens": list(MIG_PROMPT_LENS), "new_tokens": ZD_NEW_TOKENS, "sampled": MIG_SAMPLED},
            "migrate": {k: mig[k] for k in ("requests", "migrated", "proxied", "bytes", "kv_bytes", "wire_kv_bytes",
                                            "seconds")},
            "legs": legs,
            "tokens_bit_equal": True, "migrations_per_role": roles,
            "drain": {k: drained[k] for k in ("passes", "migrated", "bytes")}, "queue_depth_after_drain": depth,
            "peak_rss_bytes": {"launcher": mig["launcher_peak_rss_bytes"], "a": dev_a["peak_rss_bytes"],
                               "b": dev_b["peak_rss_bytes"]},
            "zero_drain": {"a": stats_a["zero_drain"], "b": stats_b["zero_drain"]},
            "migration": {"a": stats_a["migration"], "b": stats_b["migration"]},
            "launches": {"a": counts_a, "b": counts_b}, "seconds": time.monotonic() - t_phase,
        })
        return {"counts": [counts_a, counts_b]}
    finally:
        launcher.stop()


#: the controller's sleeping budget: the reference's sleeperLimit (1) x 4096 MiB
DUALPODS_BUDGET_BYTES = 4096 * MIB
#: how far the requester's NVML reading may be from nvidia-smi's memory.used
NVML_SMI_LIMIT_BYTES = 64 * MIB
#: how long step 4 watches A stay asleep behind the awake B
BUDGET_HOLD_S = 3.0
BUDGET_MESSAGE = "above sleeping budget"


class RequesterStub:
    """``requester.main --backend real`` as its own process: the SPI and
    probes servers of one requester Pod."""

    def __init__(self, name: str, log_dir: str) -> None:
        self.spi, self.probes = free_port(), free_port()
        self.log = open(os.path.join(log_dir, f"requester-{name}.log"), "wb")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "llm_d_fast_model_actuation_tpu_torch.requester.main", "--backend", "real",
             "--host", "127.0.0.1", "--spi-port", str(self.spi), "--probes-port", str(self.probes)],
            cwd=ROOT, stdout=self.log, stderr=subprocess.STDOUT)
        deadline = time.monotonic() + 120
        while True:
            try:
                self.cards = request(f"http://127.0.0.1:{self.spi}/v1/dual-pods/accelerators", timeout=5)[1]
                break
            except OSError:
                if self.proc.poll() is not None or time.monotonic() > deadline:
                    raise RuntimeError(f"requester stub {name} did not serve: {self.tail()}")
                time.sleep(0.1)

    def tail(self) -> str:
        self.log.flush()
        with open(self.log.name, "rb") as f:
            return f.read()[-2000:].decode(errors="replace")

    def memory(self) -> dict:
        status, body = request(f"http://127.0.0.1:{self.spi}/v1/dual-pods/accelerator-memory-usage")
        if status != 200:
            raise AssertionError(f"the requester's memory query answered {status} {body}")
        return body

    def ready(self) -> bool:
        try:
            return request(f"http://127.0.0.1:{self.probes}/ready", timeout=5)[0] == 200
        except OSError:
            return False

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.log.close()


class ControlPlane:
    """The port's dual-pods controller and launcher populator over an
    ``InMemoryStore`` (this machine has no apiserver), on an event loop of
    their own in a thread, speaking real HTTP to the requester stubs, the
    launcher and its children (``HttpTransports``). Its launcher hook
    stands in for the kubelet of the one node: the first launcher Pod
    starts the launcher process (real mode, preload on), and every
    launcher Pod of the node is given that process's address, as
    hostNetwork launcher Pods of one node share the host."""

    NS, NODE = "fma", "node-0"

    def __init__(self, budget: int) -> None:
        import asyncio

        from llm_d_fast_model_actuation_tpu_torch.api import constants as C
        from llm_d_fast_model_actuation_tpu_torch.controller.clients import HttpTransports
        from llm_d_fast_model_actuation_tpu_torch.controller.dualpods import DualPodsConfig, DualPodsController
        from llm_d_fast_model_actuation_tpu_torch.controller.populator import Populator, PopulatorConfig
        from llm_d_fast_model_actuation_tpu_torch.controller.store import InMemoryStore

        self.C = C
        self.asyncio = asyncio
        self.store = InMemoryStore()
        self.launcher = None
        self.launcher_lock = threading.Lock()
        self.log_dir = os.path.join(ROOT, "build", "launcher-logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self.controller = DualPodsController(self.store, HttpTransports(), DualPodsConfig(
            namespace=self.NS, accelerator_sleeping_memory_limit_bytes=budget, launcher_runtime=self.runtime))
        self.populator = Populator(self.store, PopulatorConfig(namespace=self.NS, launcher_runtime=self.runtime))
        self.store.create({"kind": "Node", "metadata": {"name": self.NODE, "labels": {"pool": "h100"}}})
        self.store.create({"kind": "LauncherConfig", "metadata": {"name": "lc", "namespace": self.NS},
                           "spec": {"podTemplate": {"spec": {"containers": [{"name": "launcher"}]}},
                                    "maxInstances": 2}})
        self.store.create({"kind": "LauncherPopulationPolicy", "metadata": {"name": "lpp", "namespace": self.NS},
                           "spec": {"enhancedNodeSelector": {"labelSelector": {"matchLabels": {"pool": "h100"}}},
                                    "countForLauncher": [{"launcherConfigName": "lc", "launcherCount": 1}]}})
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, name="control-plane", daemon=True)
        self.thread.start()
        # the controllers' observability port: /metrics and /debug/traces
        from llm_d_fast_model_actuation_tpu_torch.controller.metrics import serve_metrics

        self.obs = serve_metrics(0, "127.0.0.1")
        self.obs_url = f"http://127.0.0.1:{self.obs.server_address[1]}"

    def run(self, coro, timeout: float = 120.0):
        return self.asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def start(self) -> None:
        self.run(self.populator.start())
        self.run(self.controller.start())

    async def runtime(self, pod: dict) -> None:
        def up() -> int:
            with self.launcher_lock:
                if self.launcher is None:
                    self.launcher = Launcher()
                return int(self.launcher.url.rsplit(":", 1)[1])

        port = await self.asyncio.to_thread(up)

        def run(p):
            p["metadata"].setdefault("annotations", {})[self.C.LAUNCHER_PORT_ANNOTATION] = str(port)
            p.setdefault("status", {})["podIP"] = "127.0.0.1"
            p["status"]["conditions"] = [{"type": "Ready", "status": "True"}]
            return p

        await self.asyncio.to_thread(self.store.mutate, "Pod", self.NS, pod["metadata"]["name"], run)

    def add_isc(self, name: str, options: str, port: int) -> None:
        self.store.create({"kind": "InferenceServerConfig", "metadata": {"name": name, "namespace": self.NS},
                           "spec": {"modelServerConfig": {"port": port, "options": options},
                                    "launcherConfigName": "lc"}})

    def add_requester(self, name: str, isc: str, stub: RequesterStub) -> None:
        C = self.C
        self.store.create({"kind": "Pod", "metadata": {"name": name, "namespace": self.NS, "annotations": {
            C.INFERENCE_SERVER_CONFIG_ANNOTATION: isc, C.ADMIN_PORT_ANNOTATION: str(stub.spi)}},
            "spec": {"nodeName": self.NODE, "containers": [{"name": C.INFERENCE_SERVER_CONTAINER_NAME}]},
            "status": {"podIP": "127.0.0.1"}})

    def status(self, name: str) -> list:
        pod = self.store.try_get("Pod", self.NS, name) or {"metadata": {}}
        raw = (pod["metadata"].get("annotations") or {}).get(self.C.STATUS_ANNOTATION)
        return json.loads(raw)["Errors"] if raw else []

    def launcher_pods(self) -> list:
        return self.store.list("Pod", self.NS, selector={self.C.COMPONENT_LABEL: self.C.LAUNCHER_COMPONENT})

    def instances(self) -> dict:
        status, body = request(f"{self.launcher.url}/v2/vllm/instances")
        if status != 200:
            raise AssertionError(f"the launcher's list answered {status} {body}")
        return {s["instance_id"]: s for s in body["instances"]}

    def by_isc(self) -> dict:
        out = {}
        for iid, s in self.instances().items():
            out.setdefault((s.get("annotations") or {}).get("isc-name"), []).append(iid)
        return out

    def stop(self) -> None:
        try:
            self.run(self.controller.stop())
            self.run(self.populator.stop())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=30)
            self.obs.shutdown()
            self.obs.server_close()
            if self.launcher is not None:
                self.launcher.stop()


def wait_for(ok, timeout: float, what: str, *procs) -> float:
    """Poll ``ok`` until it holds; the seconds it took. Fails at the
    timeout, or when one of ``procs`` (the phase's own processes) exits."""
    t0 = time.monotonic()
    while not ok():
        for p in procs:
            if p is not None and p.poll() is not None:
                raise RuntimeError(f"{p.args[2] if len(p.args) > 2 else p.args} exited with {p.returncode} "
                                   f"waiting for {what}")
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{what} within {timeout} s")
        time.sleep(0.05)
    return time.monotonic() - t0


def sleeping(port: int) -> bool:
    return get(port, "/is_sleeping")["is_sleeping"]


def sleep_seconds(port: int) -> dict:
    """A child's last sleep and wake seconds and its last offload's bytes
    (a wake leaves them), read from the answer of a
    ``/sleep`` to a child already asleep or a ``/wake_up`` to one awake
    (each answers the sleeper's state and changes nothing)."""
    out = post(port, "/sleep?level=1" if sleeping(port) else "/wake_up")
    return {k: out[k] for k in ("last_sleep_seconds", "last_wake_seconds", "bytes_offloaded")}


def merged_trace(plane: "ControlPlane", ports: tuple, trace_id: str) -> list:
    """One trace's spans from every process that records them: the
    controller's ``/debug/traces``, the launcher's ``/v2/vllm/traces`` and
    each child's ``/v1/traces``."""
    urls = [f"{plane.obs_url}/debug/traces", f"{plane.launcher.url}/v2/vllm/traces",
            *(f"http://127.0.0.1:{p}/v1/traces" for p in ports)]
    return [s for url in urls for s in spans(f"{url}?trace_id={trace_id}")]


def trace_path(got: list, names: tuple) -> list:
    """The spans of one parent-to-child chain through ``names``, or []."""
    by_id = {s["span_id"]: s for s in got}
    for leaf in (s for s in got if s["name"] == names[-1]):
        chain = [leaf]
        while len(chain) < len(names) and chain[-1]["parent_id"] in by_id:
            chain.append(by_id[chain[-1]["parent_id"]])
        if [s["name"] for s in reversed(chain)] == list(names):
            return list(reversed(chain))
    return []


def warm_actuation_trace(plane, port_a: int, port_b: int, a_wake: dict, b_sleep: dict,
                         t_del: float, t_ready: float) -> dict:
    """Step 4's warm actuation, read from the spans of every process. A's
    wake is one trace from r1b's ``controller.reconcile_bound`` (its only
    root; every other span's parent in it) through ``controller.http`` to
    A's ``engine.wake`` and its ``wake.h2d`` buckets, whose bytes are A's
    ``bytes_offloaded``. B's sleep, which r2b's deletion starts, is the
    unbind's call to B's admin port (``controller.http`` to B's
    ``engine.sleep`` and its ``sleep.d2h`` buckets, B's
    ``bytes_offloaded``): a trace of its own, as in the reference, whose
    controller opens no span around the unbind and sleeps B without the
    launcher. The hops, in seconds on the wall clock the exports share,
    from r2b's deletion to r1b's readiness."""
    wake = max((s for s in spans(f"http://127.0.0.1:{port_a}/v1/traces") if s["name"] == "engine.wake"),
               key=lambda s: s["start"])
    # B's last sleep that moved its state (a /sleep to a child already
    # asleep records an engine.sleep with no bucket under it)
    b_spans = spans(f"http://127.0.0.1:{port_b}/v1/traces")
    moved = {s["parent_id"] for s in b_spans if s["name"] == "sleep.d2h"}
    sleep = max((s for s in b_spans if s["name"] == "engine.sleep" and s["span_id"] in moved), key=lambda s: s["start"])
    w = merged_trace(plane, (port_a, port_b), wake["trace_id"])
    b = merged_trace(plane, (port_a, port_b), sleep["trace_id"])
    ids = {s["span_id"] for s in w}
    roots = [s["name"] for s in w if s["parent_id"] not in ids]
    wake_path = trace_path(w, ("controller.reconcile_bound", "controller.http", "engine.wake"))
    h2d = [s for s in w if s["name"] == "wake.h2d" and s["parent_id"] == wake["span_id"]]
    sleep_path = trace_path(b, ("controller.http", "engine.sleep"))
    d2h = [s for s in b if s["name"] == "sleep.d2h" and s["parent_id"] == sleep["span_id"]]
    problems = []
    if {s["trace_id"] for s in w} != {wake["trace_id"]} or roots != ["controller.reconcile_bound"]:
        problems.append(f"A's wake trace has roots {roots}")
    if not wake_path or not h2d or sum(s["attrs"]["bytes"] for s in h2d) != a_wake["bytes_offloaded"]:
        problems.append(f"A's wake path {[s['name'] for s in wake_path]}, h2d bytes "
                        f"{sum(s['attrs']['bytes'] for s in h2d)} of {a_wake['bytes_offloaded']}")
    if not sleep_path or sum(s["attrs"]["bytes"] for s in d2h) != b_sleep["bytes_offloaded"]:
        problems.append(f"B's sleep path {[s['name'] for s in sleep_path]}, d2h bytes "
                        f"{sum(s['attrs']['bytes'] for s in d2h)} of {b_sleep['bytes_offloaded']}")
    if problems:
        raise AssertionError("; ".join(problems) + f": {[(s['name'], s['pid']) for s in w + b]}")
    reconcile, wake_http = wake_path[0], wake_path[1]
    sleep_http = sleep_path[0]
    end = lambda s: s["start"] + s["seconds"]  # noqa: E731
    return {
        "trace_id": wake["trace_id"], "spans": len(w), "processes": len({s["pid"] for s in w}),
        "b_sleep_trace_id": sleep["trace_id"],
        "deleted_to_b_sleep_call_s": sleep_http["start"] - t_del,
        "b_controller_http_sleep_s": sleep_http["seconds"], "b_engine_sleep_s": sleep["seconds"],
        "b_sleep_d2h_s": sum(s["seconds"] for s in d2h), "b_sleep_buckets": len(d2h),
        "b_sleep_end_to_a_reconcile_s": reconcile["start"] - end(sleep_http),
        "a_reconcile_bound_s": reconcile["seconds"], "a_controller_http_wake_s": wake_http["seconds"],
        "a_engine_wake_s": wake["seconds"], "a_wake_h2d_s": sum(s["seconds"] for s in h2d),
        "a_wake_buckets": len(h2d), "a_wake_bytes": sum(s["attrs"]["bytes"] for s in h2d),
        "a_reconcile_end_to_ready_s": t_ready - end(reconcile),
        "deleted_to_ready_s": t_ready - t_del,
    }


def dualpods_phase(torch, smi: str, bucketed: dict, launched: dict) -> dict:
    """Two Llama-3-8B engines time-sharing the card through the port's
    control plane: requester stubs (NVML) -> dual-pods controller and
    populator -> launcher -> engine children. ISC ``isc-a`` runs serve's
    options and seed, ``isc-b`` the same with ``--seed 1``. r1 (A) is
    actuated cold and serves serve's tokens; deleted, A sleeps, and a
    requester's NVML reading of the card agrees with nvidia-smi; r2 (B)
    is admitted beside the sleeping A with the launcher phase's B tokens,
    then deleted (B's first sleep, which pins its host buffers) and B
    woken for r2b; r1b (A) while r2b is bound is held back by the
    sleeping budget (the requester's status says so) until r2b is
    deleted, then A wakes with its tokens, no graph captured again,
    faster than cold; the ISCs' deletion lets the controller's GC delete
    both instances, and the card is back as before the phase."""
    from llm_d_fast_model_actuation_tpu_torch.models.llama import LlamaConfig

    model = LlamaConfig.llama3_8b()
    free_memory(torch)
    index, uuid = smi_rows("--query-gpu=index,uuid")[0]
    index = int(index)
    apps0, used0 = compute_apps(), card_used_bytes(index)
    free_before = torch.cuda.mem_get_info()[0]
    port_a, port_b = free_port(), free_port()
    plane = ControlPlane(DUALPODS_BUDGET_BYTES)
    plane.add_isc("isc-a", f"{SERVE_OPTS} --port {port_a}", port_a)
    plane.add_isc("isc-b", f"{SERVE_OPTS.replace('--seed 0', '--seed 1')} --port {port_b}", port_b)
    stubs, steps = {}, {}
    try:
        plane.start()
        wait_for(lambda: any((p.get("status") or {}).get("podIP") for p in plane.launcher_pods()), 600,
                 "the populator's launcher Pod to run")
        launcher_proc = plane.launcher.proc

        # 1. r1 for A: bound, created, ready (cold)
        stubs["r1"] = RequesterStub("r1", plane.log_dir)
        if stubs["r1"].cards != [uuid]:
            raise AssertionError(f"the real backend names {stubs['r1'].cards}, NVML's card is {uuid}")
        plane.add_requester("r1", "isc-a", stubs["r1"])
        cold = wait_for(stubs["r1"].ready, 600, "r1's /ready", launcher_proc, stubs["r1"].proc)
        traffic = run_traffic(torch, port_a, model.vocab_size)
        if traffic["tokens"] != bucketed["tokens"]:
            raise AssertionError(f"A gave other tokens than serve: "
                                 f"{first_differences(traffic['tokens'], bucketed['tokens'])}")
        # the same traffic again, now from A's prefix cache, as it will
        # find the cache after its wake: a hit and a miss round apart in
        # bf16 (ROADMAP queue 3 item 4), so step 4 compares with this run
        cached = run_traffic(torch, port_a, model.vocab_size)
        (iid_a,) = plane.by_isc()["isc-a"]
        captures_a = get(port_a, "/v1/device")["graph_captures"]
        steps["1_cold"] = {"cold_actuation_s": cold, "instance": iid_a, "graph_captures": captures_a,
                           "tokens_equal_serve": True, **traffic["summary"]}
        emit({"phase": "dualpods_step", "step": 1, **steps["1_cold"]})

        # 2. r1 deleted: A sleeps; a requester's NVML reading against nvidia-smi
        plane.store.delete("Pod", plane.NS, "r1")
        stubs.pop("r1").stop()
        wait_for(lambda: sleeping(port_a) and plane.store.try_get("Pod", plane.NS, "r1") is None, 120,
                 "A asleep and r1 gone")
        stubs["r2"] = RequesterStub("r2", plane.log_dir)
        readings = []
        for _ in range(3):
            spi_used = stubs["r2"].memory()[uuid]
            readings.append({"spi_bytes": spi_used, "nvidia_smi_bytes": card_used_bytes(index)})
        nearest = min(readings, key=lambda r: abs(r["spi_bytes"] - r["nvidia_smi_bytes"]))
        if abs(nearest["spi_bytes"] - nearest["nvidia_smi_bytes"]) > NVML_SMI_LIMIT_BYTES:
            raise AssertionError(f"the requester's NVML reading is not nvidia-smi's within "
                                 f"{NVML_SMI_LIMIT_BYTES} bytes: {readings}")
        steps["2_asleep"] = {"readings": readings, "limit_bytes": NVML_SMI_LIMIT_BYTES,
                             "card_used_before_phase_bytes": used0, "a_asleep_bytes": nearest["nvidia_smi_bytes"] - used0,
                             "a_first_sleep": sleep_seconds(port_a)}
        emit({"phase": "dualpods_step", "step": 2, **steps["2_asleep"]})

        # 3. r2 for B: admitted beside the sleeping A
        plane.add_requester("r2", "isc-b", stubs["r2"])
        b_cold = wait_for(stubs["r2"].ready, 600, "r2's /ready", launcher_proc, stubs["r2"].proc)
        b_tokens = post(port_b, "/v1/completions", launched["probe"])["choices"][0]["token_ids"]
        if b_tokens != launched["b_tokens"] or not sleeping(port_a):
            raise AssertionError(f"B gave {b_tokens[:8]}, the launcher phase's seed 1 {launched['b_tokens'][:8]}; "
                                 f"A asleep {sleeping(port_a)}")
        # B's first sleep pins its host buffers (20 GB; PERF.md §5,
        # bottleneck 8): r2 goes and r2b wakes B, so that the time-share
        # below meets a B that has slept before, as it will every time
        # after the first; the first sleep's seconds are printed
        t_del = time.monotonic()
        plane.store.delete("Pod", plane.NS, "r2")
        stubs.pop("r2").stop()
        b_unbound = wait_for(lambda: sleeping(port_b) and plane.store.try_get("Pod", plane.NS, "r2") is None, 120,
                             "B asleep and r2 gone")
        b_first_sleep = sleep_seconds(port_b)
        stubs["r2b"] = RequesterStub("r2b", plane.log_dir)
        plane.add_requester("r2b", "isc-b", stubs["r2b"])
        b_warm = wait_for(stubs["r2b"].ready, 300, "r2b's /ready", launcher_proc, stubs["r2b"].proc)
        if post(port_b, "/v1/completions", launched["probe"])["choices"][0]["token_ids"] != b_tokens:
            raise AssertionError("B's tokens changed across its sleep")
        steps["3_b"] = {"b_cold_actuation_s": b_cold, "b_tokens_equal_launcher_phase": True,
                        "b_first_unbind_s": b_unbound, "b_first_sleep": b_first_sleep, "b_warm_actuation_s": b_warm,
                        "r2_deleted_to_r2b_ready_s": time.monotonic() - t_del, "instances": plane.by_isc()}
        emit({"phase": "dualpods_step", "step": 3, **steps["3_b"]})

        # 4. r1b for A while r2b is bound: held by the budget until B sleeps
        stubs["r1b"] = RequesterStub("r1b", plane.log_dir)
        t_r1b = time.monotonic()
        plane.add_requester("r1b", "isc-a", stubs["r1b"])
        try:
            wait_for(lambda: any(BUDGET_MESSAGE in e for e in plane.status("r1b")), 120, "the budget's status on r1b")
        except TimeoutError:
            raise AssertionError(f"r1b's status {plane.status('r1b')}, A asleep {sleeping(port_a)}, "
                                 f"card memory {stubs['r1b'].memory()}")
        held = []
        t_hold = time.monotonic()
        while time.monotonic() - t_hold < BUDGET_HOLD_S:
            held.append({"a_asleep": sleeping(port_a), "b_awake": not sleeping(port_b),
                         "r1b_ready": stubs["r1b"].ready(), "status": plane.status("r1b")})
            time.sleep(0.25)
        if not all(h["a_asleep"] and h["b_awake"] and not h["r1b_ready"] and any(BUDGET_MESSAGE in e for e in h["status"])
                   for h in held):
            raise AssertionError(f"A was not held asleep behind the awake B: {held}")
        budget_status = held[-1]["status"]
        t_del, t_del_wall = time.monotonic(), time.time()
        plane.store.delete("Pod", plane.NS, "r2b")
        stubs.pop("r2b").stop()
        warm = wait_for(stubs["r1b"].ready, 300, "r1b's /ready after r2b's deletion", launcher_proc,
                        stubs["r1b"].proc)
        t_ready_wall = time.time()
        budget_held_s = t_del - t_r1b
        again = run_traffic(torch, port_a, model.vocab_size)
        dev_a = get(port_a, "/v1/device")
        instances = plane.by_isc()
        problems = []
        if again["tokens"] != cached["tokens"]:
            problems.append(f"A's tokens changed: {first_differences(again['tokens'], cached['tokens'])}")
        if dev_a["graph_captures"] != captures_a:
            problems.append(f"A captured graphs again: {captures_a} -> {dev_a['graph_captures']}")
        if not sleeping(port_b) or sleeping(port_a):
            problems.append(f"B asleep {sleeping(port_b)}, A asleep {sleeping(port_a)}")
        if not warm < cold:
            problems.append(f"warm actuation {warm} s is not faster than cold {cold} s")
        if sorted(instances) != ["isc-a", "isc-b"] or any(len(v) != 1 for v in instances.values()):
            problems.append(f"the launcher holds {instances}, want one instance per ISC")
        if plane.status("r1b"):
            problems.append(f"r1b's status still says {plane.status('r1b')}")
        if problems:
            raise AssertionError("; ".join(problems))
        a_wake, b_sleep = sleep_seconds(port_a), sleep_seconds(port_b)
        hops = warm_actuation_trace(plane, port_a, port_b, a_wake, b_sleep, t_del_wall, t_ready_wall)
        steps["4_warm"] = {"warm_actuation_s": warm, "wake_bar_s": WAKE_BAR_S, "budget_held_s": budget_held_s,
                           "a_wake": a_wake, "b_sleep": b_sleep, "hops": hops,
                           "budget_bytes": DUALPODS_BUDGET_BYTES, "budget_status": budget_status,
                           "held_samples": len(held), "tokens_equal_step_1": True,
                           "graph_captures": dev_a["graph_captures"], "instances": instances}
        emit({"phase": "dualpods_step", "step": 4, **steps["4_warm"]})
        counts_a, _ = child_counts(port_a)
        counts_b, _ = child_counts(port_b)
        for name, counts in (("A", counts_a), ("B", counts_b)):
            check_probe_launch(counts)
            if not (counts["prefill"] and counts["replayed"]["decode_inline"]):
                raise AssertionError(f"child {name} did not run the bucketed path's kernels: {counts}")

        # 5. clean up: r1b deleted, the ISCs deleted, their instances GC'd
        plane.store.delete("Pod", plane.NS, "r1b")
        stubs.pop("r1b").stop()
        wait_for(lambda: sleeping(port_a), 120, "A asleep after r1b")
        for isc in ("isc-a", "isc-b"):
            plane.store.delete("InferenceServerConfig", plane.NS, isc)
        gc_s = wait_for(lambda: not plane.instances(), 120, "the controller's GC of both instances")
    finally:
        for stub in stubs.values():
            stub.stop()
        plane.stop()
    wait_for(lambda: len(compute_apps()) == len(apps0), 60, "the children's contexts to leave the card")
    free_after = torch.cuda.mem_get_info()[0]
    if free_after < free_before - GIB:
        raise AssertionError(f"{(free_before - free_after) / GIB:.2f} GiB less free after the phase than before")
    emit({
        "phase": "dualpods", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "gpu": {"index": index, "uuid": uuid}, "cold_actuation_s": cold, "warm_actuation_s": warm,
        "wake_bar_s": WAKE_BAR_S, "b_cold_actuation_s": b_cold, "b_warm_actuation_s": b_warm,
        "b_first_sleep": b_first_sleep, "budget_held_s": budget_held_s,
        "gc_s": gc_s, "nvml_vs_smi": steps["2_asleep"], "launches": {"a": counts_a, "b": counts_b},
        "warm_actuation_hops": steps["4_warm"]["hops"],
        "compute_apps": {"before": apps0, "after": compute_apps()},
        "free_before_bytes": free_before, "free_after_bytes": free_after,
    })
    return {"counts": (counts_a, counts_b)}


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


#: spin kernels launched at each edge of a profiler window whose kernels
#: are counted, and each one's cycles (about 50 us at the H100's 1.98 GHz:
#: about 0.25 s a pad)
PROFILE_PAD_KERNELS = 5000
PROFILE_PAD_CYCLES = 100_000
#: the most device records a later profiler window has lost so far: its
#: first 876 (a late window of ``profile_windows.py``, about 44 ms of
#: spins) and, at its end, the last 17 decode kernels of serve's window
#: with the kernels after them; each pad is sized above both
PROFILE_LOSS_SEEN = 876


def profile_pad(torch, n: int = PROFILE_PAD_KERNELS) -> None:
    """``n`` uncounted spin kernels at an edge of a profiler window. A
    window after the process's first loses device records at an edge (its
    first ones, or its last ones), and these are what it loses."""
    for _ in range(n):
        torch.cuda._sleep(PROFILE_PAD_CYCLES)


def pad_spins_lost(records: list, n: int) -> dict:
    """Of a window's device records ``(start, name)`` in time order, the
    pad spins that were not recorded at each edge: those before the first
    other record belong to the lead pad, those after the last to the
    trailing one."""
    spin = [i for i, (_, name) in enumerate(records) if "spin_kernel" in name]
    other = [i for i, (_, name) in enumerate(records) if "spin_kernel" not in name]
    lead = sum(1 for i in spin if other and i < other[0])
    trail = sum(1 for i in spin if other and i > other[-1])
    return {"pad_spins": n, "lead_spins_lost": n - lead, "trail_spins_lost": n - trail,
            "largest_loss_seen": PROFILE_LOSS_SEEN}


def pad_loss_note(pads: dict) -> str:
    """What a failed count says when a whole pad was lost: the known loss
    at a window's edge, now past the pad."""
    n = pads["pad_spins"]
    edges = [e for e in ("lead", "trail") if n and pads[f"{e}_spins_lost"] == n]
    return (f"the window lost every spin of its {' and '.join(edges)} pad: the known loss at a later window's "
            f"edge (at most {PROFILE_LOSS_SEEN} first records before), now past the pad; " if edges else "")

KERNEL_KINDS = (
    ("decode attention", ("decode_kernel",)),
    ("weight products", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas", "Kernel2")),
    ("top-k and sort", ("topk", "sort", "Sort", "radix", "select")),
)


def chunk_device_profile(torch, eng, T: int, pad: int = PROFILE_PAD_KERNELS) -> dict:
    """The device time of one replayed greedy chunk of ``T`` steps with
    eight sequences running: its mean over three replays from CUDA events,
    and its kernels from ``torch.profiler`` (one replay between two pads of
    ``pad`` spins), summed by kind and the largest by name. Each replay
    advances the running state."""
    from torch.profiler import ProfilerActivity, profile

    chunk_ms = time_ms(lambda: eng.graphs.replay(T, False), 3, warmup=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profile_pad(torch, pad)
        eng.graphs.replay(T, False)
        profile_pad(torch, pad)
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if "spin" not in e.key and us > 0:
            kernels.append((e.key, us / 1e3, e.count))
    # the device records in time order: the first ones name what a window
    # that starts late would lose
    device = sorted((ev for ev in prof.events() if getattr(ev, "device_type", None) is not None
                     and "CUDA" in str(ev.device_type) and ev.time_range.elapsed_us() >= 0),
                    key=lambda ev: ev.time_range.start)
    first = [ev.name[:60] for ev in device[:4]]
    pads = pad_spins_lost([(ev.time_range.start, ev.name) for ev in device], pad)
    # the profiler's count of the decode kernel's runs in that replay, held
    # against the kernel nodes read from the captured graph
    ran = sum(c for name, _, c in kernels if "decode_kernel" in name)
    program = eng.graphs.programs[(T, False)]
    nodes = graph_kernels(program.kernels)["decode_inline"]
    records = {"kernel_records": sum(c for _, _, c in kernels), "kernel_nodes": sum(program.kernels.values()),
               "first_device_records": first, **pads}
    if ran != nodes or ran != eng.cfg.model.num_layers * T:
        raise AssertionError(f"{pad_loss_note(pads)}the profiled replay ran the decode kernel {ran} times; its graph "
                             f"holds {nodes} nodes, want {eng.cfg.model.num_layers} x {T}; {records}")
    by_kind = {}
    for name, ms, _ in kernels:
        kind = next((k for k, marks in KERNEL_KINDS if any(m in name for m in marks)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms / T
    traced = sum(ms for _, ms, _ in kernels)
    return {
        "chunk_steps": T, "chunk_device_ms": chunk_ms, "step_device_ms": chunk_ms / T,
        "decode_kernel_runs_profiled": ran, "decode_kernel_nodes": nodes, **records,
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


# Model parity at full width: each bf16 path against an fp32 oracle of the
# same bf16 weights. Stated before the first run, from bf16 rounding.
#
# The oracle (oracle_logits) is the plain forward in fp32: the bf16 weights
# upcast one layer at a time, fp32 norms, products, RoPE and attention. Each
# time a bf16 path rounds a vector to bf16 it moves it by a relative error
# of RMS s = 1.66e-3: bf16 keeps 8 significant bits, so the spacing is
# 2**-7 of a value at the bottom of its binade and 2**-8 at the top, the
# error is uniform within half a spacing (variance spacing**2 / 12), and
# over values spread evenly in log across a binade the mean of
# (spacing / value)**2 is 0.541 * 2**-14: s = 2**-7 * sqrt(0.541 / 12).
# Independent roundings add in quadrature. At least 2 L + 2 of them move
# the whole hidden state and reach the logits in full: the residual stream
# is rounded after each of a layer's two residual adds, then the final
# norm's output and the logits themselves. At most all of a path's
# roundings do, some R = 10 a layer (the norm outputs, q/k/v, the attention
# output, the MLP's products, the residual adds) plus those two:
# s * sqrt(2 L + 2) <= e_p <= s * sqrt(10 L + 2), 1.35e-2 .. 2.98e-2 at
# L = 32. (The ROADMAP's figure, 2.0e-2 / sqrt(2) = 1.4e-2, read off two
# paths that decorrelate every rounding, is the bottom of that band: paths
# that share some roundings differ by less than their distance to the
# oracle.) The limit is the top of the band, with no factor on it:
# parity_limit(L) = s * sqrt(10 L + 2), 2.98e-2 at 32 layers, 1.08e-2 at
# 4. The top counts every rounding at full weight, layer 0's too, where
# the residual stream is mostly the branches' output (an embedding row is
# small). Later, a rounding of a branch's output moves the residual stream
# only by the branch's share of it, so a path sits below the top. The
# softmax and the stack of random weights can carry an early error
# further; the quadrature leaves that out, and the gate does not allow for
# it: a path it pushes past the top is refused.
#
# Two ranks add one bf16 rounding at each of the 2 L row-parallel reduces
# (wo and w_down summed as two bf16 halves). Those are roundings of a
# branch's output too, so each counts at a weight between 0 and 1: the
# square of a tp 2 figure is, in expectation, its tp 1 figure's plus
# between 0 and 2 L s**2. With tp 1 at the band's bottom (2 L + 2
# roundings), the ratio's expectation lies between 1 and
# sqrt((4 L + 2) / (2 L + 2)), 1.40 at 32 layers, 1.34 at 4; the ratio
# limit is that top, tp_ratio_limit(L). One reading is one draw of the
# roundings, and the tp 2 path draws its own from the first reduce on, so
# a ratio can fall below 1 (the reduces' weights near 0, the two draws
# apart); the gate is one-sided and only the top matters.
#
# Each path's argmax must equal the oracle's, unless the oracle's own top-2
# margin is smaller than the path's expected error there: a logit difference
# moves by about sqrt(2) * e_p * rms(oracle logits), and the margin is
# exempt under four times that (ARGMAX_TIE_SIGMAS).
#
# The pairwise figures of the earlier gate (mixed_step against prefill, the
# scatter-first decode against the inline one, two ranks against one) are
# printed beside these, ungated: two bf16 programs against each other sat
# at the mean of their own spread (parity_spread.py), which is why the gate
# moved to the oracle.
ROUNDING_RMS = 2**-7 * (0.541 / 12) ** 0.5
ROUNDINGS_PER_LAYER = 10
ARGMAX_TIE_SIGMAS = 4.0
#: the bf16 paths held to the oracle, and the tp 2 ones' tp 1 partners
PARITY_PATHS = ("prefill", "mixed_step", "mixed_step_tp2", "decode_inline", "decode_inline_tp2",
                "decode_scatter_first")
TP_PAIRS = {"mixed_step_tp2": "mixed_step", "decode_inline_tp2": "decode_inline"}
#: the old pairwise figures (path, against), printed for reading
PAIRWISE = {"mixed_vs_prefill": ("mixed_step", "prefill"),
            "scatter_first_vs_inline": ("decode_scatter_first", "decode_inline"),
            "tp2_vs_tp1_mixed_step": ("mixed_step_tp2", "mixed_step"),
            "tp2_vs_tp1_decode_step": ("decode_inline_tp2", "decode_inline")}


def parity_band(layers: int) -> tuple:
    """The predicted band of one path's rel-L2 against the oracle."""
    return ROUNDING_RMS * (2 * layers + 2) ** 0.5, ROUNDING_RMS * (ROUNDINGS_PER_LAYER * layers + 2) ** 0.5


def parity_limit(layers: int) -> float:
    """The limit of one path's rel-L2: the top of its band."""
    return parity_band(layers)[1]


def tp_ratio_limit(layers: int) -> float:
    """The limit of a tp 2 figure over its tp 1 partner's: the top of
    the ratio's expectation, the 2 L reduce roundings at full weight
    against tp 1 at the band's bottom."""
    return ((4 * layers + 2) / (2 * layers + 2)) ** 0.5


def oracle_logits(torch, model, tokens, rows) -> "torch.Tensor":
    """The fp32 oracle: the plain forward of a one-rank Llama-family
    ``model`` over ``tokens`` [s] (causal, one sequence, no cache), each
    layer's bf16 weights upcast to fp32 when its turn comes, RoPE in
    float64 then fp32, attention written out; the fp32 logits at the
    positions ``rows``. The head is upcast a vocabulary slice at a time."""
    cfg = model.cfg
    if (cfg.post_norms or cfg.qk_norm or cfg.attn_bias or cfg.embed_scale or cfg.norm_offset
            or cfg.hidden_activation != "silu" or cfg.rope_scaling):
        raise ValueError("the oracle computes the plain Llama forward only")
    f32 = torch.float32
    dev = model.embed.device
    s = tokens.shape[0]
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def norm(x, w):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + cfg.rms_eps) * w.float()

    inv = cfg.rope_theta ** (-torch.arange(0, d, 2, dtype=torch.float64, device=dev) / d)
    ang = torch.arange(s, dtype=torch.float64, device=dev)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang).to(f32)[:, None, :], torch.sin(ang).to(f32)[:, None, :]

    def rope(x):
        x1, x2 = x[..., : d // 2], x[..., d // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    causal = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    x = model.embed[tokens.long()].float()
    with torch.no_grad():
        for i in range(cfg.num_layers):
            w = {k: v.float() for k, v in model.layer(i).items()}
            a = norm(x, w["attn_norm"])
            q = rope((a @ w["wq"]).view(s, h, d))
            k = rope((a @ w["wk"]).view(s, kvh, d)).repeat_interleave(h // kvh, dim=1)
            v = (a @ w["wv"]).view(s, kvh, d).repeat_interleave(h // kvh, dim=1)
            sc = torch.einsum("qhd,khd->hqk", q, k) / d ** 0.5
            p = torch.softmax(sc.masked_fill(~causal, float("-inf")), dim=-1)
            x = x + torch.einsum("hqk,khd->qhd", p, v).reshape(s, h * d) @ w["wo"]
            m = norm(x, w["mlp_norm"])
            x = x + (torch.nn.functional.silu(m @ w["w_gate"]) * (m @ w["w_up"])) @ w["w_down"]
            del w, a, q, k, v, sc, p, m
        y = norm(x[rows], model.final_norm)
        head = model.head()
        step = 32768
        return torch.cat([y @ head[:, j : j + step].float() for j in range(0, head.shape[1], step)], dim=-1)


def parity_figure(torch, logits, oracle) -> dict:
    """One path against the oracle: rel-L2 over the vocabulary, max abs,
    argmax agreement, and the oracle's top-2 margin and logit RMS."""
    top = oracle.topk(2).values
    return {"rel_l2": ((logits - oracle).norm() / oracle.norm()).item(),
            "max_abs": (logits - oracle).abs().max().item(),
            "argmax_equal": bool(logits.argmax() == oracle.argmax()),
            "oracle_top2_margin": (top[0] - top[1]).item(),
            "oracle_rms": oracle.pow(2).mean().sqrt().item()}


def parity_gate(figures: dict, layers: int) -> list:
    """The gate: what in ``figures`` (path -> :func:`parity_figure`) breaks
    the limits derived above for a stack of ``layers``; empty when it
    holds. A path's rel-L2 stays under :func:`parity_limit`; a tp 2 path
    within :func:`tp_ratio_limit` of its tp 1 partner; each argmax equals the
    oracle's unless the oracle's margin lies inside the path's expected
    error."""
    limit, ratio_limit = parity_limit(layers), tp_ratio_limit(layers)
    bad = []
    for path, f in figures.items():
        if not f["rel_l2"] <= limit:
            bad.append(f"{path}: rel_l2 {f['rel_l2']:.4e} > {limit:.4e}")
        tie = ARGMAX_TIE_SIGMAS * 2 ** 0.5 * f["rel_l2"] * f["oracle_rms"]
        if not f["argmax_equal"] and not f["oracle_top2_margin"] < tie:
            bad.append(f"{path}: argmax differs from the oracle's at a margin of {f['oracle_top2_margin']:.4e} "
                       f"(exempt under {tie:.4e})")
        partner = TP_PAIRS.get(path)
        if partner in figures:
            ratio = f["rel_l2"] / figures[partner]["rel_l2"]
            if not ratio <= ratio_limit:
                bad.append(f"{path}: {ratio:.3f} x {partner}'s rel_l2 > {ratio_limit:.3f}")
    return bad


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


def parity_logits(torch, one, two, seed: int, n: int = 300, page_size: int = 16) -> dict:
    """Every bf16 path's logits on one prompt of ``n`` token ids drawn
    from ``seed``, on the one-rank model ``one`` and the two-rank model
    ``two`` (the same weights, sliced): ``prefill`` and ``mixed_step``
    (tp 1 and 2) at position ``n - 1``; then, on the mixed step's cache,
    the inline decode (tp 1 and 2) and the scatter-first decode of the
    one-rank model's argmax token ``nxt`` at position ``n``. Returns the
    logits by path, and what the oracle and the planted faults need: the
    prompt, ``nxt``, the one-rank model's cache after its decodes, and a
    function that reruns the two-rank mixed step on a fresh cache."""
    from llm_d_fast_model_actuation_tpu_torch.engine.engine import kv_pages_bucket, prefill_bucket
    from llm_d_fast_model_actuation_tpu_torch.models import llama

    cfg = one.cfg
    dev = one.device
    pages = kv_pages_bucket(n + 1, page_size, -(-cfg.max_seq_len // page_size))
    shape = (cfg.num_layers, pages + 1, page_size, cfg.num_kv_heads, cfg.head_dim)
    tp = two.mesh.tp
    shard_shape = shape[:3] + (cfg.num_kv_heads // tp,) + shape[4:]

    def pool(shp=shape, d=dev):
        return tuple(torch.zeros(shp, dtype=cfg.dtype, device=d) for _ in range(2))

    pt = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)[None]
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=dev, dtype=torch.int32)
    # prefill over the prompt at its bucket, as the bucketed engine runs it
    tokens = torch.zeros((1, prefill_bucket(n, cfg.max_seq_len)), dtype=torch.int32, device=dev)
    tokens[0, :n] = prompt
    out = {"prefill": llama.prefill(one, tokens, torch.tensor([n], dtype=torch.int32, device=dev), pool(), pt)[0, n - 1]}
    # mixed_step over the same prompt, packed as the engine packs it
    rows = -(-n // 8) * 8
    slot = torch.full((rows,), -1, dtype=torch.int32, device=dev)
    slot[:n] = 0
    pos = torch.zeros((rows,), dtype=torch.int32, device=dev)
    pos[:n] = torch.arange(n, dtype=torch.int32, device=dev)
    toks = torch.zeros((rows,), dtype=torch.int32, device=dev)
    toks[:n] = prompt
    cache = pool()
    out["mixed_step"] = llama.mixed_step(one, toks, slot, pos, cache, pt)[n - 1]
    # one decode step at position n on the mixed step's cache: inline, then
    # scatter-first on the same state (it writes the same K/V again)
    nxt = out["mixed_step"].argmax().to(torch.int32)[None]
    at = torch.tensor([n], dtype=torch.int32, device=dev)

    def decode(model, impl, kv):
        base = model.cfg
        try:
            model.cfg = dataclasses.replace(base, attention_impl=impl)
            return llama.decode_step(model, nxt, at, kv, pt)[0]
        finally:
            model.cfg = base

    out["decode_inline"] = decode(one, "grouped", cache)
    out["decode_scatter_first"] = decode(one, "reference", cache)

    # the two-rank model on the same prompt and then the same decode step,
    # with a pool split on its kv_heads axis
    def mixed_tp2(kv=None):
        kv = kv or [pool(shard_shape, d) for d in two.mesh.devices]
        return llama.mixed_step(two, toks, slot, pos, kv, pt)[n - 1], kv

    out["mixed_step_tp2"], cache2 = mixed_tp2()
    out["decode_inline_tp2"] = decode(two, "grouped", cache2)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"logits": out, "prompt": prompt, "nxt": nxt, "cache": cache, "mixed_tp2": mixed_tp2,
            "decode": lambda kv: decode(one, "grouped", kv)}


def parity_figures(torch, one, run: dict) -> tuple:
    """The oracle's logits at ``n - 1`` and ``n`` (one forward over the
    prompt and ``nxt``), every path's :func:`parity_figure` against them
    and the old pairwise figures."""
    n = run["prompt"].shape[0]
    oracle = oracle_logits(torch, one, torch.cat([run["prompt"], run["nxt"]]), [n - 1, n])
    at = {p: oracle[1] if p.startswith("decode") else oracle[0] for p in PARITY_PATHS}
    figures = {p: parity_figure(torch, run["logits"][p], at[p]) for p in PARITY_PATHS}
    pairwise = {}
    for name, (a, b) in PAIRWISE.items():
        la, lb = run["logits"][a], run["logits"][b]
        pairwise[name] = {"rel_l2": ((la - lb).norm() / lb.norm()).item(), "max_abs": (la - lb).abs().max().item(),
                          "argmax_equal": bool(la.argmax() == lb.argmax())}
    return oracle, figures, pairwise


def planted_faults(torch, one, two, run: dict, oracle, figures: dict) -> dict:
    """Two faults run through :func:`parity_gate`, which must refuse each:
    the two-rank mixed step with layer 0's ``w_down`` reduce dropping rank
    1's share (``TpMesh.all_reduce_sum`` wrapped here, on this mesh only:
    the forward's reduces run embedding, then per layer ``wo`` and
    ``w_down``, so it is the third call), and the inline decode step on a
    cache whose layer 0 has KV heads 0 and 1 swapped. Returns each fault's
    figure and what the gate said; raises if the gate let one through."""
    mesh = two.mesh
    calls = [0]
    reduce = type(mesh).all_reduce_sum

    def dropping(parts):
        calls[0] += 1
        if calls[0] == 3:
            parts = [parts[0]] + [torch.zeros_like(p) for p in parts[1:]]
        return reduce(mesh, parts)

    mesh.all_reduce_sum = dropping
    try:
        dropped = run["mixed_tp2"]()[0]
    finally:
        del mesh.all_reduce_sum
    k, v = (t.clone() for t in run["cache"])
    for t in (k, v):
        t[0, :, :, [0, 1]] = t[0, :, :, [1, 0]]
    swapped = run["decode"]((k, v))
    del k, v
    out = {}
    layers = one.cfg.num_layers
    for name, path, logits in (("w_down_reduce_drops_rank1", "mixed_step_tp2", dropped),
                               ("kv_heads_swapped", "decode_inline", swapped)):
        f = parity_figure(torch, logits, oracle[1] if path.startswith("decode") else oracle[0])
        refused = parity_gate(dict(figures, **{path: f}), layers)
        if not refused:
            raise AssertionError(f"the parity gate let the planted fault {name} through: {f}")
        out[name] = {"path": path, **f, "refused": refused}
    return out


def model_parity(torch, eng, eng_tp2, bucketed: dict, paths: dict) -> dict:
    """Every bf16 path against the fp32 oracle of the same weights, gated
    by :func:`parity_gate`; the old pairwise figures printed beside them;
    the two planted faults refused."""
    one, two = eng.model, eng_tp2.model
    cfg = one.cfg
    wq2 = torch.cat([m.layers["wq"] for m in two.ranks], dim=-1)
    head2 = torch.cat([m.lm_head for m in two.ranks], dim=-1)
    if not (torch.equal(wq2, one.layers["wq"]) and torch.equal(head2, one.lm_head)):
        raise AssertionError("the two-rank model's shards do not join to the one-rank model's weights")
    del wq2, head2
    run = parity_logits(torch, one, two, seed=5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    oracle, figures, pairwise = parity_figures(torch, one, run)
    oracle_peak = torch.cuda.max_memory_allocated() - base
    faults = planted_faults(torch, one, two, run, oracle, figures)
    refused = parity_gate(figures, cfg.num_layers)
    out = {
        "phase": "model_parity", "model": "llama3-8b", "prompt_tokens": run["prompt"].shape[0],
        "limits": {"rel_l2": parity_limit(cfg.num_layers), "tp2_over_tp1": tp_ratio_limit(cfg.num_layers),
                   "argmax_tie_sigmas": ARGMAX_TIE_SIGMAS},
        "predicted_rel_l2": parity_band(cfg.num_layers),
        "against_fp32_oracle": figures,
        "tp2_over_tp1": {p: figures[p]["rel_l2"] / figures[q]["rel_l2"] for p, q in TP_PAIRS.items()},
        "pairwise_not_gated": pairwise,
        "planted_faults": faults,
        "oracle_peak_allocated_bytes": oracle_peak,
        "oracle": "plain fp32 forward, the bf16 weights upcast a layer at a time",
        "refused": refused,
    }
    emit(out)
    del run, oracle
    emit(greedy_divergence(torch, one, eng.cfg.seq_len, bucketed, paths))
    if refused:
        raise AssertionError(f"a bf16 path breaks the parity gate against the fp32 oracle: {refused}")
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

    t_run = time.monotonic()
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
    emit({"phase": "kernel_check", **check_ragged_masked(torch, gen), "nvidia_smi": smi})
    emit({"phase": "kernel_variants", "checks": check_variants(torch, gen)})
    # first of the model phases; its profiled replay runs again at the end
    # (profile_again), after every other profiler window
    graphs_phase(torch, smi)
    from llm_d_fast_model_actuation_tpu_torch.models.llama import LlamaConfig, param_shapes

    # room for the checkpoint and, beside it, the swap phase's two siblings:
    # each one rewritten shard (at most HF_SHARD_BYTES; the others are links)
    ckpt = checkpoint_dir(2 * sum(math.prod(s) for s in param_shapes(LlamaConfig.llama3_8b()).values())
                          + 2 * HF_SHARD_BYTES)
    try:
        bucketed = serve_and_sleep(torch, smi, ckpt)
        hf = serve_hf(torch, smi, ckpt, bucketed["checkpoint"], bucketed)
        swapped = swap_phase(torch, smi, ckpt, bucketed)
        launched = launcher_phase(torch, smi, bucketed, swapped)
        quant = quant_phase(torch, smi, ckpt, bucketed, swapped)
        zero_drain = zero_drain_phase(torch, smi, ckpt, swapped)
        migrated = migrate_phase(torch, smi, ckpt)
        coresident = coresident_phase(torch, smi, ckpt, swapped)
        co_engine = coresident_engine(torch, smi, ckpt)
    finally:
        shutil.rmtree(ckpt)
        for suffix in ("-sibling", "-sibling2"):
            shutil.rmtree(ckpt.rstrip("/") + suffix, ignore_errors=True)
    dual = dualpods_phase(torch, smi, bucketed, launched)
    packed = serve_packed(torch, smi, bucketed)
    tp2, eng_tp2 = serve_tp2_packed(torch, smi, bucketed, packed)
    reference, eng = serve_reference(torch, smi, bucketed)
    model_parity(torch, eng, eng_tp2, bucketed,
                 {"serve_packed": packed["tokens"], "serve_tp2_packed": tp2["tokens"],
                  "serve_reference": reference["tokens"]})
    del eng, eng_tp2
    profile_again(torch, smi)
    runs = (bucketed["counts"], hf["counts"], swapped["counts"], launched["counts"], quant["counts"],
            zero_drain["counts"], *migrated["counts"], coresident["counts"], co_engine["counts"], *dual["counts"],
            packed["counts"],
            tp2["counts"], reference["counts"])

    def total(key):
        return sum(c[key] for c in runs)

    untimed = sorted({s for c in runs for s in c["prefill_by_seq"]} - set(PREFILL_SEQS))
    if untimed:
        raise AssertionError(f"the serve run launched prefill at untimed lengths {untimed}")
    # the ragged kernel's launches by buffer size: the packed serve's and
    # the coresident child's (one shape, 72 rows)
    by_rows = dict(packed["counts"]["ragged_by_rows"])
    for run in (coresident, co_engine):
        for k, n in run["counts"]["ragged_by_rows"].items():
            by_rows[k] = by_rows.get(k, 0) + n
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
    emit({"phase": "total", "seconds": time.monotonic() - t_run})
    # device_ms beside ms where the row has it: decode, ragged and the probe,
    # whose ms is its wrapper's
    emit({"kernels": [{**{k: row.get(k) for k in keys}, **({"device_ms": row["device_ms"]} if "device_ms" in row else {})}
                      for row in kernels]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
