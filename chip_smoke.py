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
  5. sleep   — two level-1 sleep/wake cycles: ``memory_reserved``
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
     ``spawn_to_healthy_s`` (not gated): the ``release`` phase's child;
  quant — ``--sleep-quant int8`` on one service over the swap phase's
     checkpoints A, A' and A'' (``quant_phase``): layer 0 of ``w_gate``
     and ``wq`` quantized on the card and by the host twin at int8 and
     fp8, payload, scale and dequantized weights bit-equal, one slice's
     seconds each way; two level-1 cycles, each after serve's traffic:
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
  orbax — ``serve``'s seeded weights drawn again on the card and written
     by the port's ``save_params`` as an Orbax checkpoint (OCDBT, zarr v2,
     zstd; 16.06 GB, after the Hugging Face checkpoints are deleted), then
     served with ``--checkpoint-dir``: ``serve``'s traffic with
     ``serve``'s tokens, every byte restored, the manifest's digests those
     of the served weights (hashed from the card), the bucketed path's
     launches; a level-2 sleep whose wake restores the checkpoint again,
     ``serve``'s first tokens once more; the write's, the restore's (GB/s
     beside ``serve_hf``'s load) and the wake's seconds, and libzstd's
     version. The launcher phase also gates that its child (the default
     ``--sleep-release-devices auto``) reports ``devices_released`` false;
  release — a launcher child with ``--sleep-release-devices always`` (the
     launcher phase's spawn without preload, once its children are gone):
     asleep it reports its devices released, maps nothing, holds no graph
     node and at most 32 MiB in its allocator, and takes at most the
     launcher phase's unreleased child's share of the card less what its
     release gave back (64 MiB of slack); printed beside it, the ladder's
     context plus 96 MiB it was asked to stay under (the CUDA driver keeps most
     of a destroyed graph's memory: the ladder's ``graph_destroyed`` rung),
     and an earlier unreleased sleep's 1,159,725,056 B; its wake captures one set of
     graphs again (``last_reacquire_seconds`` against ``WAKE_BAR_S``,
     reported) and serves ``serve``'s tokens, every chunk replayed;
  graphs — a llama3-8b engine at full width and depth built directly,
     eight requests of the serve traffic's lengths (two of them sampled,
     seeded) prefilled; then for T = 8 and T = 1, sampled and greedy, one
     chunk replayed from its graph and, on a copy of the state as it was,
     the same chunk run eagerly: tokens, logprobs, alternatives, KV pages
     and scheduler state must be bit-equal. Then TPOT and tokens/s of the
     eight requests over 64 tokens with the graphs and without them (on,
     then off), with the same tokens each time; the device
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

Weight-only int8, n-gram speculation and pipelined decode:
``kernel_check`` (``w8a16``) holds the W8A16 kernel (tensor cores,
``mma.sync`` on bf16 fragments converted in registers from the int8
bytes) at Llama-3-8B's five products at 1, 8, 16 and 64 rows (64 is
``models/quant.py:W8A16_MAX_ROWS``, the largest product routed to it)
against its plain version (error over the largest plain value under
7.81e-3, the same bits on a second launch), with its device time from a
CUDA graph, bf16 ``torch.matmul``'s time, ``torch._weight_int8pack_mm``'s
on a transposed copy of the weight where this PyTorch has a CUDA kernel
for it (else null, said once) and the bound; ``serve_int8`` (after
``quant``) serves llama3-8b at ``--quantization int8`` (parameters exactly 8,561,882,112 B, every chunk
a replay whose graph holds (7 L + 1) x T W8A16 nodes, a level-1 cycle of
exactly 12,856,849,408 B with the same tokens and addresses, the prefill
and decode paths against an fp32 oracle of the quantized weights, a
swap to the sibling checkpoint and back each priced to the byte), and
reports the replayed step's kernels by kind; ``speculative`` runs one
greedy stream with ``--speculative-ngram 4`` and without (proposals
made, ``/metrics`` equal to ``/v1/stats``, every emitted token the
argmax of a teacher-forced cold prefill or a near-tie); ``pipeline``
runs eight streams with ``--pipeline-decode`` off and on (tokens
bit-equal, a level-1 sleep with a chunk in flight losing none); the
``launcher`` line's ``refusals`` are the three pairs of options that do
not compose, each a 422 in the reference's words. The ``kernels`` line
carries one W8A16 entry per product shape at 8 rows, with the
``serve_int8`` and ``serve_moe`` runs' launches of that shape.

The Mixtral MoE family, after ``pipeline``: ``kernel_check``
(``w8a16_experts``) holds the batched W8A16 kernel at Mixtral-8x7B's two
expert-stack shapes (E = 8; 4096 -> 14336 with one x for every expert,
14336 -> 4096 with an x per expert) at the same rows as the 2-D one is
held (``torch._weight_int8pack_mm`` once an expert); ``serve_moe``
serves ``mixtral-8x7b`` at ``--quantization int8``, full width and depth, random weights (parameters exactly
46,870,172,672 B, every chunk a replay whose graph holds L x T decode
and (7 L + 1) x T W8A16 nodes, the host's MemAvailable checked before
one level-1 cycle of exactly 51,165,139,968 B priced to the byte, with
the same tokens and addresses after the wake, the replayed step's
kernels by kind), then a 4-layer int8 model built in process whose
prefill and decode are held against an fp32 oracle of its quantized
weights routed as they routed (the share of routing decisions that fp32
routing would change printed beside); ``serve_moe_hf`` writes a 1-layer,
full-width Mixtral checkpoint in Mixtral's tensor names from an
in-process bf16 service (3.43 GB, deleted at the end) and serves it
with ``--model hf:<dir>`` in bf16 and in int8: tokens, parameter bytes
and weights equal to the in-process services', the int8 build's peak
beyond its arena under one layer's bf16 expert stacks. The ``kernels``
line carries one batched entry per expert-stack shape at 8 rows.

Expert parallelism and training, after ``serve_moe_hf``, every engine
before them stopped: ``serve_moe_ep`` builds the 4-layer int8 Mixtral on
``MeshPlan(tp=2, ep=2)``, four ranks on card 0 (each rank E/ep = 4
experts and its tp half of attention and of the pool), serves the serve
mix's four prompts 16 tokens each (the counts read right after: the W8A16
kernels at the ranks' shapes, the batched one at E = 4, which
``kernel_check`` also holds at those shapes), then the same model on one
rank; a prefill of 8 x 300 ids and one decode step of the 8 rows on both,
each block held to the fp32 oracle of the quantized weights routed as
that path routed (one rank under its band's top, the mesh under its own,
one ``wo`` rounding a layer more, and within ``moe_ep_ratio_limit`` of
one rank's), and where the two engines' greedy tokens part, the one-rank
logits' gap inside the tie exemption; then the same model on
``MeshPlan(pp=2, ep=2)`` (two stages of two layers, each stage's two
ranks E/ep experts), held to the same gates (its W8A16 kernels at the
tp 1 shapes, the batched one at E = 4 over the whole ``f``, which
``kernel_check`` also holds). ``train`` runs ``models/train.py``
at Llama-3-8B's full size: seeded bf16 weights drawn on the card,
``forward_train`` and the serving prefill (the prefill kernel) on 256
ids held to the fp32 oracle, three AdamW steps with remat on 2 x 1024
ids (one row padded after 777), the losses finite, each step's ms,
tokens/s, share of 989 TF/s and the peak allocated bytes; then the
optimizer state dropped and an engine built from the trained weights
serving four greedy completions through its captured chunks, every
token the oracle's argmax or a near-tie. ``train_mesh`` (Llama-3-8B
widths, 4 layers, ``MeshPlan(sp=2, tp=2)``, one row of 4096 ids) and
``train_moe`` (Mixtral widths, 2 layers, ``MeshPlan(dp=2, ep=2)``, 4 x
512 ids) each take one step on the mesh, four ranks on the card, and
the same step on one rank from the same seed: the loss, AdamW's first
moment and the update within ``MESH_*``; ``train_mesh`` also takes the
step on ``MeshPlan(pp=2, tp=2)`` (two stages of two layers) against the
same one-rank step, and holds layer 0's ring attention in f32 to the
dense function. Every phase line carries ``at_s``, its seconds since the
script started.

Pipeline stages, after ``train_moe``: ``serve_pp`` builds Llama-3-8B at
full size from seed 0 through ``InferenceEngine(cfg, mesh=...)`` (the
server has no ``pp`` flag, as the reference's has none) on
``MeshPlan(pp=2)`` and ``MeshPlan(pp=2, tp=2)``, every rank on card 0
(each stage 16 layers of the weights and of the pool), and on one rank
from the same seed. The four serve prompts, 16 new tokens each,
bucketed: greedy tokens identical to the one-rank engine's on both
meshes (on ``pp`` 2 x ``tp`` 2, to a ``tp`` 2 engine's where it parts
from one rank's, as ``tp`` 2 alone does at a bf16 near-tie); a prefill
of 8 x 300 ids and one decode step on each model, ``pp`` 2's logits
bit-equal to one rank's (every layer runs the same kernels at the same
shapes), the largest difference printed; L x tp decode launches a step
and L x tp prefill launches a cold prefill. Then one packed run on ``pp``
2 against a one-rank packed engine (tokens identical, L ragged launches
a packed step) and one level-1 sleep and wake on ``pp`` 2:
``bytes_offloaded`` the one-rank state's, nothing mapped asleep, the
same first tokens and state addresses after the wake. Each model's
eager decode step (8 rows, after a 300-id prefill) is timed, median of
``PP_TIMED_STEPS``.

Multi-node gangs, after ``model_parity``: ``gang`` first serves the
serve mix (8 new tokens a request) through a one-process tp 2 engine on
``cuda:0,cuda:0``, bucketed, in this process; then starts Llama-3-8B at
full size, tp 2, as a gang of TWO engine processes through ``python -m
llm_d_fast_model_actuation_tpu_torch.engine.server`` (``--num-processes 2
--process-id 0|1 --coordinator-address``, both with ``--device cuda:0``,
one rank and half the weights each, joined by a Gloo group:
``engine/multihost.py``), drives the same mix through the leader's
``/v1/completions`` (the follower refuses one) and holds the greedy
tokens bit-equal to the one-process engine's, the prefix-cache hit
included; each member's launches (``/v1/device``) are L per decode step
and per cold prefill and one probe, and equal between the members (they
run in lockstep). A lone 16-token request gives a gang decode step's
ms, the seconds inside the Gloo calls and the host-staged bytes per
step on each member. One level-1 ``/sleep`` and ``/wake_up`` through
the leader: both members unmap their arenas and map them back (their
bytes printed per process, the card's free memory read here) and the
first token is unchanged. Last, with ``FMA_GANG_HEARTBEAT_TIMEOUT=2``, a
SIGKILL of the follower must make the leader exit 13
(``EXIT_GANG_PEER_LOST``) within a minute; its seconds are printed. The
members' logs go to ``build/gang-logs``.

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


#: the script's start on the monotonic clock: every phase line carries
#: its seconds since then (``at_s``)
START = time.monotonic()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "at_s": time.monotonic() - START}
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

    from llm_d_fast_model_actuation_tpu_torch.engine.arena import capture_guard

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with capture_guard(), torch.cuda.graph(graph):
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
    wrappers["w8a16"].launches_by_shape.clear()
    wrappers["w8a16_experts"].launches_by_shape.clear()


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


def run_traffic(torch, port: int, vocab: int, ignore_eos: bool = False, max_tokens: int = 64) -> dict:
    """The serve phases' traffic: four concurrent greedy completions
    (prompts of 20, 300, 1500 and 3000 token ids, ``max_tokens`` (64)
    tokens each), then a fifth request sharing a 512-token prefix with
    the third; with ``ignore_eos`` each request asks to decode past eos."""
    import numpy as np

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n).tolist() for n in (20, 300, 1500, 3000)]
    results = [None] * len(prompts)
    extra = {"ignore_eos": True} if ignore_eos else {}

    def one(i):
        results[i] = post(port, "/v1/completions", {"prompt": prompts[i], "max_tokens": max_tokens, **extra})

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
    fifth = post(port, "/v1/completions", {"prompt": shared, "max_tokens": max_tokens, **extra})
    fifth_s = time.monotonic() - t2
    torch.cuda.synchronize()
    for r in results + [fifth]:
        ids = r["choices"][0]["token_ids"]
        if len(ids) != max_tokens or not all(0 <= t < vocab for t in ids):
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


#: new tokens of each request of the profile window (64 until the gang
#: phase joined the script, for its time limit)
PROFILE_MAX_TOKENS = 32


def profile_window(torch, service, port: int, vocab: int) -> dict:
    """``POST /v1/profile`` on serve's engine, a fresh 300-token and a
    fresh 3000-token greedy request of ``PROFILE_MAX_TOKENS``, ``DELETE``: the Chrome
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

    from llm_d_fast_model_actuation_tpu_torch.engine.arena import capture_guard

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
        post(port, "/v1/completions", {"prompt": p, "max_tokens": PROFILE_MAX_TOKENS})
    x = torch.randn(256, 256, device="cuda")
    graph = torch.cuda.CUDAGraph()
    try:
        with capture_guard(), torch.cuda.graph(graph):
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
#: serve's level-1 cycles (three until the gang phase joined the script,
#: for its time limit)
SERVE_CYCLES = 2


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

        # -- sleep / wake, SERVE_CYCLES cycles (the spread of one transfer per
        #    call is too wide to read): the reference output is a repeat of
        #    request 1 (a prefix-cache hit, the path every repeat takes)
        probe = {"prompt": traffic["prompts"][0], "max_tokens": 64}
        before = post(port, "/v1/completions", probe)["choices"][0]["token_ids"]
        ptrs, captures = state_ptrs(eng), eng.graph_captures
        cycles = []
        for _ in range(SERVE_CYCLES):
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
        # the actuation byte counters: SERVE_CYCLES and the untraced level-1
        # cycle so far
        samples = scrape(f"http://127.0.0.1:{port}/metrics")
        moved = {d: metric(samples, "fma_engine_actuation_bytes", mode="off", dir=d) for d in ("d2h", "h2d")}
        n = SERVE_CYCLES + 1
        if moved != {"d2h": n * nbytes, "h2d": n * nbytes}:
            raise AssertionError(f"fma_engine_actuation_bytes after {n} cycles of {nbytes} bytes: {moved}")
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


#: serve_moe_hf's depth: the full width at one of Mixtral-8x7B's 32
#: layers (two until the pipeline phase joined the script, for its time
#: limit)
MOE_HF_LAYERS = 1
#: Mixtral-8x7B's published config.json at ``MOE_HF_LAYERS`` of its 32
#: layers (the fields the loader reads, and their neighbours);
#: generation_config.json
MIXTRAL_HF_CONFIG = {
    "architectures": ["MixtralForCausalLM"], "model_type": "mixtral", "hidden_act": "silu",
    "hidden_size": 4096, "intermediate_size": 14336, "num_attention_heads": 32, "num_hidden_layers": MOE_HF_LAYERS,
    "num_key_value_heads": 8, "vocab_size": 32000, "max_position_embeddings": 32768, "rms_norm_eps": 1e-05,
    "rope_theta": 1000000.0, "sliding_window": None, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "bos_token_id": 1, "eos_token_id": 2, "num_local_experts": 8, "num_experts_per_tok": 2,
    "router_aux_loss_coef": 0.02, "output_router_logits": False,
}
MIXTRAL_HF_GENERATION = {"bos_token_id": 1, "eos_token_id": 2}
#: Mixtral's layer tensors in the HF layout: the attention trunk's as
#: Llama's, the router and each expert's w1/w3/w2 (gate, up, down)
MIXTRAL_HF_LAYER = {k: v for k, v in HF_LAYER.items() if not k.startswith("mlp.")}
MIXTRAL_HF_EXPERT = {"w1.weight": "w_gate", "w2.weight": "w_down", "w3.weight": "w_up"}


def hf_tensors(model) -> list:
    """(HF name, a function giving the tensor on the card in the HF
    layout) for every weight of a one-rank Llama-3 or Mixtral ``model``,
    in the published checkpoint's order."""
    from llm_d_fast_model_actuation_tpu_torch.models.llama import is_moe

    moe = is_moe(model.cfg)
    out = [("model.embed_tokens.weight", lambda: model.embed)]
    for i in range(model.cfg.num_layers):
        for suffix, (name, transposed) in (MIXTRAL_HF_LAYER if moe else HF_LAYER).items():
            out.append((f"model.layers.{i}.{suffix}",
                        lambda i=i, name=name, t=transposed: model.layers[name][i].t() if t else model.layers[name][i]))
        if moe:
            out.append((f"model.layers.{i}.block_sparse_moe.gate.weight", lambda i=i: model.layers["router"][i].t()))
            for e in range(model.cfg.num_experts):
                for suffix, name in MIXTRAL_HF_EXPERT.items():
                    out.append((f"model.layers.{i}.block_sparse_moe.experts.{e}.{suffix}",
                                lambda i=i, e=e, name=name: model.layers[name][i, e].t()))
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


def write_hf_checkpoint(torch, model, path: str, config: dict = HF_CONFIG, generation: dict = HF_GENERATION) -> dict:
    """``model``'s weights as a Hugging Face Llama checkpoint in ``path``,
    in Llama-3-8B's published layout (or, with Mixtral's ``config``, in
    Mixtral's tensor names): shards of at most ``HF_SHARD_BYTES`` named
    ``model-0000k-of-0000n.safetensors``, their index, ``config.json``
    and ``generation_config.json``; no tokenizer. One tensor at a time
    passes through the host."""
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
        json.dump(config, f)
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump(generation, f)
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
        return {"counts": counts, "load": load}
    finally:
        stop_service(torch, service, server)


# -- phase orbax: an Orbax checkpoint written and served by the port --------


def orbax_phase(torch, smi: str, bucketed: dict, hf: dict) -> dict:
    """``serve``'s seeded weights drawn again on the card and written by
    the port's ``save_params`` as an Orbax checkpoint (OCDBT, zarr v2,
    zstd), then served with ``--checkpoint-dir``: ``serve``'s traffic
    with ``serve``'s tokens, every byte of the model restored, the
    manifest's digests those of the served weights, the bucketed path's
    launches; then a level-2 sleep, whose wake restores the checkpoint
    again, and ``serve``'s first tokens once more."""
    from llm_d_fast_model_actuation_tpu_torch.models import checkpoint as ckpt_mod
    from llm_d_fast_model_actuation_tpu_torch.models import hf as hf_models
    from llm_d_fast_model_actuation_tpu_torch.models import llama
    from llm_d_fast_model_actuation_tpu_torch.native import zstd

    cfg = llama.LlamaConfig.llama3_8b()
    nbytes = sum(math.prod(s) * cfg.dtype.itemsize for s in llama.param_shapes(cfg).values())
    free_memory(torch)
    directory = checkpoint_dir(nbytes)
    try:
        t0 = time.monotonic()
        model = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")  # serve's --seed 0
        torch.cuda.synchronize()
        draw_s = time.monotonic() - t0
        written = ckpt_mod.save_params(directory, cfg, model)
        write_s = time.monotonic() - t0 - draw_s
        del model
        service, server, init_s, free_before = start_service(torch, f"{SERVE_OPTS} --checkpoint-dir {directory}")
        port = server.server_address[1]
        try:
            eng = service.engine
            L = eng.cfg.model.num_layers
            load = service.load_stats.summary()
            if load["bytes_h2d"] != nbytes or service.load_stats.digests != written["digests"]:
                raise AssertionError(f"the restore moved {load['bytes_h2d']} of {nbytes} bytes, or its manifest's "
                                     f"digests are not the written ones")
            captures, cold0 = eng.graph_captures, eng.cold_prefills
            traffic = run_traffic(torch, port, cfg.vocab_size)
            if traffic["tokens"] != bucketed["tokens"]:
                raise AssertionError(f"the Orbax checkpoint's completions differ from serve's at "
                                     f"{first_differences(traffic['tokens'], bucketed['tokens'])}")
            counts = path_counts(eng)
            colds = eng.cold_prefills - cold0
            check_probe_launch(counts)
            check_replays(eng, counts, "decode_inline")
            if counts["decode_inline"] != L * eng.decode_steps or counts["prefill"] != L * colds or colds != 4:
                raise AssertionError(f"launches {counts} against {eng.decode_steps} decode steps and {colds} cold prefills")
            if counts["ragged"] or counts["ragged_sharded"] or counts["decode_scatter_first"]:
                raise AssertionError(f"the Orbax checkpoint's bucketed path launched kernels off its path: {counts}")
            # the manifest against the served weights, hashed from the card
            t_dig = time.monotonic()
            served = hf_models.model_digests(eng.model)
            digest_s = time.monotonic() - t_dig
            if served != written["digests"] or service._digests(service._runtime) != served:
                raise AssertionError("the manifest's digests are not those of the served weights")
            # level 2: the wake restores the checkpoint again
            probe = {"prompt": traffic["prompts"][0], "max_tokens": 64}
            post(port, "/sleep?level=2")
            check_asleep(torch, eng, free_before)
            loads = service.loads
            woke = post(port, "/wake_up")
            if service.loads != loads + 1:
                raise AssertionError("the level-2 wake did not restore the checkpoint again")
            reload = service.load_stats.summary()
            if post(port, "/v1/completions", probe)["choices"][0]["token_ids"] != bucketed["tokens"][0]:
                raise AssertionError("the Orbax checkpoint's tokens changed across a level-2 sleep")
            if eng.graph_captures != captures:
                raise AssertionError("the level-2 wake re-captured a graph")
            stored = written["stored_bytes"]
            emit({
                "phase": "orbax", "model": "llama3-8b --checkpoint-dir <serve's weights>", "layers": L,
                "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "libzstd": zstd.version(),
                "bytes": nbytes, "stored_bytes": stored, "stored_frac": stored / nbytes,
                "draw_s": draw_s, "write_s": write_s, "write_gb_per_s": nbytes / 1e9 / write_s,
                "write": {k: written[k] for k in ("copy_s", "buffer_wait_s", "drain_wait_s")},
                "restore_s": load["total_s"], "restore_gb_per_s": nbytes / 1e9 / load["total_s"],
                "restore": load, "hf_load_gb_per_s": hf["load"]["gb_per_s"], "hf_load_s": hf["load"]["total_s"],
                "init_s": init_s, "tokens_equal_to_serve": True, **traffic["summary"],
                "launches": counts, **graph_stats(eng), "digests_equal": len(served), "digest_s": digest_s,
                "level2": {"wake_s": woke["last_wake_seconds"], "reload": reload, "tokens_identical": True},
            })
            return {"counts": counts}
        finally:
            stop_service(torch, service, server)
    finally:
        shutil.rmtree(directory, ignore_errors=True)


# -- phase release: a launcher child's device release on sleep --------------

#: a released sleep keeps at most this much in the caching allocator
RELEASED_RESERVED_LIMIT_BYTES = 32 * MIB
#: the share of the card a released child was asked to keep to at most:
#: a fresh process's context and this much; not reachable on this CUDA
#: driver, which keeps most of a destroyed graph's memory with the
#: context (the ladder's ``graph_destroyed`` rung reads how much), so it
#: is reported beside the gated limit (``released_limit``)
RELEASED_BEYOND_CONTEXT_BYTES = 96 * MIB
#: an unreleased level-1 sleep's share of the card in an earlier split
#: (context, graphs, allocator, cuBLAS, the rest; NVIDIA H100 80GB HBM3, 700 W)
UNRELEASED_ASLEEP_BYTES = 1_159_725_056


#: the released sleep's stream: fewer prompt ids than a page holds
RELEASE_STREAM_PROMPT = 12


def released_limit(ladder: dict, graph_nodes: int) -> dict:
    """The parts of a released child's limit, from this run's ladder and
    the child's kernel nodes before its sleep, and their sum,
    ``limit_bytes``: a fresh process's context; cuBLAS's handles and
    kernels; what the driver keeps of a destroyed graph per kernel node
    (the ``graph`` rung less what ``graph_destroyed`` gave back, beyond
    the allocator's) times those nodes; at most
    RELEASED_RESERVED_LIMIT_BYTES in the allocator; and the kernels a
    serving engine loads (ASLEEP_MODULES_LIMIT_BYTES)."""
    graph, gone = ladder["graph"], ladder["graph_destroyed"]
    per_node = ((graph["card_bytes"] - graph["reserved_bytes"])
                + (gone["card_bytes"] - gone["reserved_bytes"])) / LADDER_NODES
    parts = {
        "context_bytes": ladder["context"]["card_bytes"],
        "cublas_bytes": ladder["cublas"]["card_bytes"] - ladder["cublas"]["reserved_bytes"],
        "retained_graph_bytes_per_node": per_node, "graph_kernel_nodes": graph_nodes,
        "retained_graphs_bytes": round(per_node * graph_nodes),
        "reserved_limit_bytes": RELEASED_RESERVED_LIMIT_BYTES, "modules_limit_bytes": ASLEEP_MODULES_LIMIT_BYTES,
    }
    parts["limit_bytes"] = (parts["context_bytes"] + parts["cublas_bytes"] + parts["retained_graphs_bytes"]
                            + RELEASED_RESERVED_LIMIT_BYTES + ASLEEP_MODULES_LIMIT_BYTES)
    return parts


def release_phase(torch, smi: str, bucketed: dict, launcher: "Launcher", index: int, uuid: str, ladder: dict,
                  unreleased_bytes: int, unreleased_memory: dict) -> dict:
    """A launcher child started with ``serve``'s options and
    ``--sleep-release-devices always``, asleep while a greedy stream is
    mid-decode (its prompt, like the request before it, shares no page
    with ``serve``'s traffic): it reports its devices released, maps
    nothing, holds no graph node and at most
    ``RELEASED_RESERVED_LIMIT_BYTES`` in its allocator, and takes at most
    ``released_limit`` of the card, made of this run's ladder and the
    child's kernel nodes before the sleep; beside it, the ladder's context
    plus ``RELEASED_BEYOND_CONTEXT_BYTES``, reported. Its wake captures one
    set of graphs again on a blank scheduler state, the stream goes on
    bit-equal to its uninterrupted run, and the child serves ``serve``'s
    tokens through replays. The launcher phase runs it once its children
    are gone, on its launcher without preload, whose spawn it times
    (``unreleased_bytes`` and ``unreleased_memory``: its child ``a``'s
    share of the card and ``/v1/device`` memory asleep, reported)."""
    from llm_d_fast_model_actuation_tpu_torch.models.llama import LlamaConfig

    model = LlamaConfig.llama3_8b()
    used_base = card_used_bytes(index)
    port = free_port()
    try:
        _, spawn_s = launcher.spawn("r", f"{SERVE_OPTS} --sleep-release-devices always --port {port}", uuid, port)
        # one request before the sleep, which loads the serving kernels: its
        # prompt shares no page with the traffic's (a prefix-cache hit
        # rounds apart from a miss, and the traffic after the wake must
        # run as serve's did)
        post(port, "/v1/completions", {"prompt": [1] * 20, "max_tokens": 16})  # the 32 bucket, as serve's first
        # a stream shorter than a page (no prefix-cache hit), run whole
        # once: what it must give when a released sleep interrupts it
        body = stream_bodies(model.vocab_size, (RELEASE_STREAM_PROMPT,), 0, seed=21)
        gold = Streams(port, body).join()
        if any(gold.errors) or len(gold.tokens[0]) != ZD_NEW_TOKENS:
            raise AssertionError(f"the uninterrupted stream failed: {gold.errors}")
        counts0, dev0 = child_counts(port)
        captures, nodes = dev0["graph_captures"], dev0["memory"]["graph_kernel_nodes"]
        awake_bytes = card_used_bytes(index) - used_base
        stream = Streams(port, body)
        stream.wait_tokens(2)
        info = post(port, "/sleep?level=1")
        at_sleep = len(stream.tokens[0])
        if not at_sleep < ZD_NEW_TOKENS:
            raise AssertionError(f"the stream ended before the released sleep ({at_sleep} tokens)")
        time.sleep(1)
        asleep_bytes = card_used_bytes(index) - used_base
        dev = get(port, "/v1/device")
        memory = dev["memory"]
        flag = get(port, "/is_sleeping")
        if not (info["devices_released"] and dev["devices_released"] and flag == {"is_sleeping": True,
                                                                              "devices_released": True}):
            raise AssertionError(f"the child's sleep did not release its device: {info} {flag}")
        if memory["mapped_bytes"] or memory["graph_kernel_nodes"] or memory["reserved_bytes"] > RELEASED_RESERVED_LIMIT_BYTES:
            raise AssertionError(f"the released child keeps {memory}")
        released = dev["released"]
        limit = released_limit(ladder, nodes)
        if asleep_bytes > limit["limit_bytes"]:
            raise AssertionError(f"the released child holds {asleep_bytes} bytes of the card, more than {limit}")
        asked = ladder["context"]["card_bytes"] + RELEASED_BEYOND_CONTEXT_BYTES
        t0 = time.monotonic()
        woke = post(port, "/wake_up")
        wake_call_s = time.monotonic() - t0
        if woke["devices_released"] or get(port, "/v1/device")["graph_captures"] != captures + 4:
            raise AssertionError(f"the released wake did not capture one set of graphs again: {woke}")
        check_streams(stream.join(), gold.tokens, "released sleep mid-stream")
        stats0 = get(port, "/v1/stats")["engine"]
        traffic = run_traffic(torch, port, model.vocab_size)
        if traffic["tokens"] != bucketed["tokens"]:
            raise AssertionError(f"the released child's completions differ from serve's at "
                                 f"{first_differences(traffic['tokens'], bucketed['tokens'])}")
        stats1 = get(port, "/v1/stats")["engine"]
        counts, _ = child_counts(port)
        chunks = stats1["decode_chunks"] - stats0["decode_chunks"]
        replays = stats1["graph_replays"] - stats0["graph_replays"]
        # eager decode launches after the wake: the re-capture's warm-ups
        # alone, as many as the start's (every chunk replayed)
        eager0, eager = counts0["eager"]["decode_inline"], counts["eager"]["decode_inline"]
        if not chunks or replays != chunks or eager != 2 * eager0:
            raise AssertionError(f"after the released wake {chunks} chunks ran, {replays} replayed; eager decode "
                                 f"launches {eager0} -> {eager}")
        check_probe_launch(counts)
        emit({
            "phase": "release", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "spawn_to_healthy_s": spawn_s, "awake_card_bytes": awake_bytes,
            "released_card_bytes": asleep_bytes, "unreleased_card_bytes": unreleased_bytes,
            "unreleased_pr9_card_bytes": UNRELEASED_ASLEEP_BYTES, "limit": limit,
            "asked_limit_bytes": asked, "asked_limit_met": asleep_bytes <= asked,
            "ladder": ladder, "memory": memory, "released": released,
            "unreleased_memory": unreleased_memory,
            "sleep_s": info["last_sleep_seconds"], "wake_s": woke["last_wake_seconds"], "wake_call_s": wake_call_s,
            "last_reacquire_seconds": woke["last_reacquire_seconds"], "wake_bar_s": WAKE_BAR_S,
            "graph_captures": {"before": captures, "after": captures + 4},
            "chunks_after_wake": chunks, "replays_after_wake": replays, "tokens_equal_to_serve": True,
            "stream": {"prompt_tokens": RELEASE_STREAM_PROMPT, "new_tokens": ZD_NEW_TOKENS,
                       "delivered_at_sleep": at_sleep, "equal_to_uninterrupted": True},
            "eager_decode_launches": {"start": eager0, "after_wake": eager},
        })
        return {"counts": counts, "spawn_s": spawn_s}
    finally:
        request(f"{launcher.url}/v2/vllm/instances/r", "DELETE")


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
        t = a_model.get_parameter(flat)
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
    if fingerprint(torch, [eng_c.model.get_parameter(f) for f in flats]) != want:
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
#: beside the swap phase's unthrottled one (raised from 1024 to save time
#: within the 1200 s limit)
LAUNCHER_PREFETCH_MIB_S = 2048
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
del g
import gc
gc.collect()
torch.cuda.empty_cache()
rung("graph_destroyed")
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
        for _ in range(4):
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
    ``--no-preload`` spawns once, for its ``spawn_to_healthy_s``: the
    device-release child (``release_phase``)."""
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
        # the default --sleep-release-devices (auto) releases nothing on a GPU
        if post(port_a, "/sleep?level=1")["devices_released"] or get(port_a, "/is_sleeping")["devices_released"]:
            raise AssertionError("instance a (--sleep-release-devices auto) released its device on sleep")
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
        refusals = launcher_refusals(launcher, uuid)

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

    # preload's effect: a launcher without it, whose one spawn is the
    # device-release child
    plain = Launcher("--no-preload")
    try:
        released = release_phase(torch, smi, bucketed, plain, index, uuid, ladder, asleep_bytes, asleep_memory)
        spawn_plain_s = released["spawn_s"]
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
        "refusals": refusals,
    })
    return {"counts": counts, "probe": probe, "b_tokens": b_tokens, "release_counts": released["counts"]}


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


#: the quantized level-1 cycles: the second shows the first rounded once
#: (once three; cut for the 1200 s limit)
QUANT_CYCLES = 2
#: new tokens of each request of the serve mix before each quantized sleep
#: (64 until the gang phase joined the script, for its time limit)
QUANT_TRAFFIC_TOKENS = 32


def quant_phase(torch, smi: str, ckpt: str, bucketed: dict, swapped: dict) -> dict:
    """Compressed actuation (``--sleep-quant int8``) and the cost oracle on
    one service over the swap phase's checkpoints A, A' and A''
    (Llama-3-8B, full width and depth). The card's quantization against
    the host twin (``quant_twin``); ``QUANT_CYCLES`` level-1 cycles, each after
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
        for c in range(QUANT_CYCLES):
            traffic = run_traffic(torch, port, vocab, max_tokens=QUANT_TRAFFIC_TOKENS)
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
#: (each model's third one seeded), CO_NEW_TOKENS new tokens each; the prompts are
#: about a quarter of what they were before the MoE phases joined the
#: script (20-3000 ids, 11,180 in all), to keep it within its time limit:
#: both co-resident phases spend most of their time prefilling them in
#: 72-token packed steps, one pass per resident
CO_PROMPT_LENS = (20, 375, 750, 300, 500, 350, 60, 625, 275)
CO_NEW_TOKENS = 32  # 64 until the gang phase joined the script, for its time limit
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
    ("weight products", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas", "Kernel2", "w8a16")),
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
    without them (on, then off, in this one call: two turns, where there
    were four before the MoE phases joined the script, for its time
    limit)."""
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
    for name in ("graphs_on", "graphs_off"):
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


#: new tokens of each request of the two-rank serve's traffic (the other
#: serves' 64 cut to fit the script's time limit; its tokens are compared
#: with the bucketed serve's for reading only)
TP2_MAX_TOKENS = 16  # 32 until the gang phase joined the script, for its time limit


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
        # 16 tokens a request, where the other serves take 64: two ranks
        # on one card run their steps eagerly, and the time limit is shared
        traffic = run_traffic(torch, port, eng.cfg.model.vocab_size, max_tokens=TP2_MAX_TOKENS)
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
        probe = {"prompt": traffic["prompts"][0], "max_tokens": TP2_MAX_TOKENS}
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


#: the gang phase's traffic: the serve mix at 8 new tokens a request: both
#: engines run their chunks eagerly
GANG_MAX_TOKENS = 8  # 16 until the pipeline phase joined the script, for its time limit
#: the lone request that times a gang decode step
GANG_LONE_TOKENS = 16  # 32 until the pipeline phase joined the script
#: the gang's FMA_GANG_HEARTBEAT_TIMEOUT: how long the leader waits on a
#: silent follower before it exits 13
GANG_HB_TIMEOUT_S = 2
GANG_OPTS = "--model llama3-8b --num-pages 2048 --seed 0 --max-batch 8 --tensor-parallel-size 2"
#: each member's one device; the one-process engine's two ranks share it
GANG_DEVICE = "cuda:0"


def gang_coordinator_port() -> int:
    """A free port whose heartbeat port (+ HEARTBEAT_PORT_OFFSET) is free
    too."""
    import socket

    from llm_d_fast_model_actuation_tpu_torch.engine.multihost import HEARTBEAT_PORT_OFFSET

    for _ in range(64):
        port = free_port()
        if port + HEARTBEAT_PORT_OFFSET > 65535:
            continue
        with socket.socket() as s:
            try:
                s.bind(("0.0.0.0", port + HEARTBEAT_PORT_OFFSET))
            except OSError:
                continue
        return port
    raise RuntimeError("no coordinator port with a free heartbeat port")


class GangMember:
    """One engine process of a two-process gang on card 0, started through
    the server's module entry point; its log under ``build/gang-logs``."""

    def __init__(self, index: int, coordinator_port: int) -> None:
        log_dir = os.path.join(ROOT, "build", "gang-logs")
        os.makedirs(log_dir, exist_ok=True)
        self.index = index
        self.port = free_port()
        self.log = open(os.path.join(log_dir, f"member-{index}-{self.port}.log"), "wb")
        env = dict(os.environ, FMA_GANG_HEARTBEAT_TIMEOUT=str(GANG_HB_TIMEOUT_S))
        env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH", "")) if p)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "llm_d_fast_model_actuation_tpu_torch.engine.server", *GANG_OPTS.split(),
             "--device", GANG_DEVICE, "--num-processes", "2", "--process-id", str(index),
             "--coordinator-address", f"127.0.0.1:{coordinator_port}", "--host", "127.0.0.1",
             "--port", str(self.port)],
            cwd=ROOT, env=env, stdout=self.log, stderr=subprocess.STDOUT,
        )

    def tail(self) -> str:
        self.log.flush()
        with open(self.log.name, "rb") as f:
            return f.read()[-3000:].decode(errors="replace")

    def healthy(self) -> bool:
        try:
            return request(f"http://127.0.0.1:{self.port}/health", timeout=5)[0] == 200
        except OSError:
            return False

    def stats(self) -> dict:
        return get(self.port, "/v1/stats")

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self.log.close()


def sum_counts(a: dict, b: dict) -> dict:
    """Two processes' launch counts, key by key (dicts of counts summed
    within)."""
    out = {}
    for k in set(a) | set(b):
        x, y = a.get(k, 0), b.get(k, 0)
        out[k] = sum_counts(x or {}, y or {}) if isinstance(x, dict) or isinstance(y, dict) else x + y
    return out


def gang_exchange_figures(before: list, after: list, steps: int) -> list:
    """Each member's exchanges through host memory over a window of
    ``steps`` decode steps: per step, the ms inside the Gloo calls and in
    the staging, the exchanges and the bytes sent and received."""
    out = []
    for b, a in zip(before, after):
        d = {k: a[k] - b[k] for k in ("exchanges", "bytes", "gloo_s", "stage_s")}
        out.append({"gloo_ms_per_step": d["gloo_s"] * 1e3 / steps, "stage_ms_per_step": d["stage_s"] * 1e3 / steps,
                    "exchanges_per_step": d["exchanges"] / steps, "bytes_per_step": d["bytes"] / steps, **d})
    return out


def gang_phase(torch, smi: str) -> dict:
    """Llama-3-8B at full size served by a two-process tp 2 gang on card 0,
    held bit for bit to a one-process tp 2 engine on the same weights;
    its level-1 cycle; its teardown when the follower dies."""
    t_phase = time.monotonic()
    free_memory(torch)
    service, server, one_init_s, _ = start_service(torch, f"{GANG_OPTS} --device {GANG_DEVICE},{GANG_DEVICE}")
    try:
        eng = service.engine
        if eng.mesh is None or eng.mesh.tp != 2 or eng.mesh.spans_processes or eng.cfg.packed_serving:
            raise AssertionError("the reference is not a one-process two-rank bucketed engine")
        L, vocab = eng.cfg.model.num_layers, eng.cfg.model.vocab_size
        one = run_traffic(torch, server.server_address[1], vocab, max_tokens=GANG_MAX_TOKENS)
        lone_body = {"prompt": one["prompts"][0], "max_tokens": GANG_LONE_TOKENS, "ignore_eos": True}
        one_lone = post(server.server_address[1], "/v1/completions", lone_body)
    finally:
        stop_service(torch, service, server)
        del service, server, eng
    free_memory(torch)
    free_before = torch.cuda.mem_get_info()[0]
    coordinator = gang_coordinator_port()
    t0 = time.monotonic()
    follower, leader = members = [GangMember(1, coordinator), GangMember(0, coordinator)]
    try:
        try:
            wait_for(lambda: all(m.healthy() for m in members), 600, "the gang's /health", follower.proc, leader.proc)
        except RuntimeError as e:  # a member exited: its log says why
            raise RuntimeError(f"{e}: {[m.tail() for m in members]}") from e
        start_s = time.monotonic() - t0
        status, body = request(f"http://127.0.0.1:{follower.port}/v1/completions", "POST",
                               {"prompt": [1, 2, 3], "max_tokens": 1})
        if status == 200:
            raise AssertionError(f"the follower served a completion: {body}")
        traffic = run_traffic(torch, leader.port, vocab, max_tokens=GANG_MAX_TOKENS)
        if traffic["tokens"] != one["tokens"]:
            raise AssertionError(f"the gang's greedy tokens differ from the one-process tp 2 engine's: first "
                                 f"differences {first_differences(traffic['tokens'], one['tokens'])}")
        stats = [m.stats() for m in (leader, follower)]
        #: the traffic's exchanges through host memory, on each member
        traffic_exchanges = [st["gang"]["exchanges"] for st in stats]
        if stats[0]["gang"]["prefix_hits"] < 1:
            raise AssertionError("the fifth request did not hit the leader's prefix cache")
        counts = [child_counts(m.port)[0] for m in (leader, follower)]
        for m, c, st in zip((leader, follower), counts, stats):
            check_probe_launch(c)
            e = st["engine"]
            if e["decode_steps"] == 0 or c["decode_inline"] != L * e["decode_steps"] \
                    or c["prefill"] != L * e["cold_prefills"] or c["ragged"] or c["ragged_sharded"] \
                    or c["decode_scatter_first"] or e["graph_replays"]:
                raise AssertionError(f"gang member {m.index} launched {c} over {e}")
        if any(counts[0][k] != counts[1][k] for k in ("decode_inline", "prefill", "prefill_by_seq")):
            raise AssertionError(f"the members' launches differ: {counts}")
        # a lone request: a gang decode step and its exchanges
        before = [m.stats() for m in (leader, follower)]
        lone = post(leader.port, "/v1/completions", lone_body)
        if lone["choices"][0]["token_ids"] != one_lone["choices"][0]["token_ids"]:
            raise AssertionError("the gang's lone request's tokens differ from the one-process engine's")
        after = [m.stats() for m in (leader, follower)]
        steps = after[0]["engine"]["decode_steps"] - before[0]["engine"]["decode_steps"]
        if steps != GANG_LONE_TOKENS - 1 or after[1]["engine"]["decode_steps"] - before[1]["engine"]["decode_steps"] != steps:
            raise AssertionError(f"the lone request ran {steps} decode steps on the leader, want {GANG_LONE_TOKENS - 1} on both")
        tpot_ms = lone["usage"]["decode_tpot_s"] * 1e3
        exchanges = gang_exchange_figures([b["gang"]["exchanges"] for b in before],
                                          [a["gang"]["exchanges"] for a in after], steps)
        # one level-1 cycle through the leader
        probe = {"prompt": traffic["prompts"][0], "max_tokens": 1}
        first = post(leader.port, "/v1/completions", probe)["choices"][0]["token_ids"]
        mapped = [m.stats()["gang"]["mapped_bytes"] for m in (leader, follower)]
        free_awake = torch.cuda.mem_get_info()[0]
        slept = post(leader.port, "/sleep?level=1")
        asleep_s = wait_for(lambda: sleeping(follower.port), 120, "the follower's sleep", follower.proc, leader.proc)
        free_asleep = torch.cuda.mem_get_info()[0]
        asleep = [m.stats()["gang"] for m in (leader, follower)]
        if any(g["mapped_bytes"] for g in asleep) or any(not g["bytes_offloaded"] for g in asleep):
            raise AssertionError(f"a member kept its arenas mapped or offloaded nothing: {asleep}")
        woke = post(leader.port, "/wake_up")
        awake_s = wait_for(lambda: not sleeping(follower.port), 120, "the follower's wake", follower.proc,
                           leader.proc)
        again = post(leader.port, "/v1/completions", probe)["choices"][0]["token_ids"]
        woken = [m.stats()["gang"] for m in (leader, follower)]
        if again != first or [g["mapped_bytes"] for g in woken] != mapped:
            raise AssertionError(f"the gang's wake changed its first token ({first} -> {again}) or its mapping "
                                 f"({mapped} -> {[g['mapped_bytes'] for g in woken]})")
        frames = after[0]["gang"]["frames"]
        # the follower dies: the leader must exit EXIT_GANG_PEER_LOST
        from llm_d_fast_model_actuation_tpu_torch.engine.multihost import EXIT_GANG_PEER_LOST

        t_kill = time.monotonic()
        follower.proc.send_signal(signal.SIGKILL)
        try:
            rc = leader.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"the leader outlived its follower by 60 s: {leader.tail()}")
        death_s = time.monotonic() - t_kill
        if rc != EXIT_GANG_PEER_LOST:
            raise AssertionError(f"the leader exited {rc} when its follower died, want {EXIT_GANG_PEER_LOST}: "
                                 f"{leader.tail()}")
    finally:
        for m in members:
            m.stop()
    emit({
        "phase": "gang", "model": "llama3-8b", "layers": L, "tp": 2, "processes": 2, "device": f"{GANG_DEVICE} x 2",
        "card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "transport": "Gloo over TCP on 127.0.0.1, host-staged uint8 (NCCL refuses two ranks on one device)",
        "one_process_init_s": one_init_s, "one_process": one["summary"], "gang_start_s": start_s,
        **traffic["summary"], "tokens_equal_to_one_process": f"{len(traffic['tokens'])}/{len(one['tokens'])}",
        "launches": {"leader": counts[0], "follower": counts[1]},
        "engine": {"leader": stats[0]["engine"], "follower": stats[1]["engine"]},
        "decode_step": {"tpot_ms": tpot_ms, "one_process_tpot_ms": one_lone["usage"]["decode_tpot_s"] * 1e3,
                        "steps": steps, "window": "a lone 20-id request, 32 tokens, its prefill included in the "
                        "exchanges", "leader": exchanges[0], "follower": exchanges[1],
                        "gloo_share_of_step": exchanges[0]["gloo_ms_per_step"] / tpot_ms},
        "frames": frames, "traffic_exchanges": {"leader": traffic_exchanges[0], "follower": traffic_exchanges[1]},
        "sleep_wake": {"bytes_offloaded": {"leader": asleep[0]["bytes_offloaded"],
                                           "follower": asleep[1]["bytes_offloaded"]},
                       "wake_bytes": {"leader": woken[0]["last_wake_bytes"], "follower": woken[1]["last_wake_bytes"]},
                       "mapped_bytes_awake": mapped, "card_free_gib": {"before_gang": free_before / GIB,
                       "awake": free_awake / GIB, "asleep": free_asleep / GIB},
                       "leader_sleep_s": slept["last_sleep_seconds"], "follower_asleep_after_s": asleep_s,
                       "leader_wake_s": woke["last_wake_seconds"], "follower_awake_after_s": awake_s,
                       "first_token_unchanged": True},
        "death": {"heartbeat_timeout_s": GANG_HB_TIMEOUT_S, "leader_exit": rc, "seconds": death_s},
        "seconds": time.monotonic() - t_phase,
    })
    return {"counts": sum_counts(counts[0], counts[1]), "tokens": traffic["tokens"]}


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


def parity_gate(figures: dict, layers: int, limit: "float | None" = None) -> list:
    """The gate: what in ``figures`` (path -> :func:`parity_figure`) breaks
    the limits derived above for a stack of ``layers``; empty when it
    holds. A path's rel-L2 stays under :func:`parity_limit`; a tp 2 path
    within :func:`tp_ratio_limit` of its tp 1 partner; each argmax equals the
    oracle's unless the oracle's margin lies inside the path's expected
    error."""
    limit, ratio_limit = limit or parity_limit(layers), tp_ratio_limit(layers)
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
    1's share (``Mesh.all_reduce_sum`` wrapped here, on this mesh only:
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


# -- W8A16 serving, n-gram speculation and pipelined decode ------------------

#: Llama-3-8B's weight products (in, out), and how many of each one decode
#: step of the batch runs a layer (wq and wo, wk and wv, w_gate and w_up,
#: w_down); lm_head's once a step
W8A16_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256))
W8A16_PER_LAYER = {(4096, 4096): 2, (4096, 1024): 2, (4096, 14336): 2, (14336, 4096): 1}
#: a decode step's 1 and 8, a speculative verify window's 16, and
#: models/quant.py:W8A16_MAX_ROWS (64), the largest product routed to it
W8A16_ROWS = (1, 8, 16, 64)
#: the kernel's error over the largest plain value: two bf16 steps (2^-7),
#: as the plain version rounds its product and then the scaled product
W8A16_TOL = 7.81e-3
W8A16_SOURCE = "llm_d_fast_model_actuation_tpu_torch/csrc/w8a16.cu"
W8A16_REPLACES = "none: the JAX package's int8 product is XLA (llm_d_fast_model_actuation_tpu/models/quant.py:38)"


def int8pack_ms(torch, x, q, s):
    """The second yardstick: ``torch._weight_int8pack_mm``, the one PyTorch
    call that computes a W8A16 product (``x @ q.T * scales``, q [N, K]),
    timed on a transposed copy of q (one call an expert for a stack),
    outside any path of the port; None where the card's PyTorch has no
    CUDA kernel for it or the call refuses these inputs (``main`` says
    so once)."""
    if not torch._C._dispatch_has_kernel_for_dispatch_key("aten::_weight_int8pack_mm", "CUDA"):
        return None
    qt = q.transpose(-1, -2).contiguous()
    sc = s.reshape(q.shape[:-2] + (q.shape[-1],)).to(x.dtype)
    if q.ndim == 2:
        def call():
            return torch._weight_int8pack_mm(x, qt, sc)
    else:
        def call():
            return [torch._weight_int8pack_mm(x if x.ndim == 2 else x[e], qt[e], sc[e]) for e in range(q.shape[0])]
    try:
        return time_ms(call, 20)
    except RuntimeError:
        return None


def check_w8a16(torch, gen) -> list:
    """The W8A16 kernel at each of Llama-3-8B's five products at each of
    ``W8A16_ROWS``, against its plain version: the error over the largest plain
    value under ``W8A16_TOL``, the same bits from a second launch (no
    atomics), one launch under CUDA's sync debug mode; ``ms`` through the
    wrapper, ``device_ms`` from a CUDA graph, the plain version's and
    bf16 ``torch.matmul``'s (the library yardstick) times,
    :func:`int8pack_ms`, and the bound from the int8 weight, scale, x and
    y bytes or the flops."""
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import w8a16 as mod

    rows = []
    for K, N in W8A16_SHAPES + W8A16_EP_SHAPES:
        q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
        # a weight's scales: amax / 127 of a column of std K^-0.5
        s = (torch.rand((1, N), generator=gen, device="cuda") + 3.0) * (K**-0.5 / 127)
        w = q.to(torch.bfloat16)
        for M in W8A16_ROWS:
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)

            def kernel():
                return mod.w8a16_matmul(x, q, s)

            y, ref = kernel(), mod.w8a16_matmul_plain(x, q, s)
            max_abs, _ = errors(y, ref)
            rel = max_abs / ref.float().abs().max().item()
            same = torch.equal(y, kernel())
            if not rel < W8A16_TOL or not same:
                raise AssertionError(f"W8A16 at [{M}, {K}] @ [{K}, {N}]: error {rel:.3e} of the largest plain value "
                                     f"(limit {W8A16_TOL}), bit-stable {same}")
            if M == 8:
                sync_free(kernel)
            bound, by = bound_ms(K * N + 4 * N + 2 * M * K + 2 * M * N, 2 * M * K * N)
            rows.append({"name": f"w8a16[in={K},out={N}]", "route": "cuda", "source": W8A16_SOURCE, "replaces": W8A16_REPLACES,
                         "rows": M, "in": K, "out": N, "plan": list(mod.launch_plan(M, K, N)),
                         "max_abs_err": max_abs, "rel_err": rel, "bit_stable": same,
                         "ms": time_ms(kernel, 20), "device_ms": graph_ms(kernel, 20),
                         "plain_ms": time_ms(lambda: mod.w8a16_matmul_plain(x, q, s), 20),
                         "library_ms": time_ms(lambda: torch.matmul(x, w), 20), "library": "torch.matmul bf16",
                         "int8pack_ms": int8pack_ms(torch, x, q, s), "bound_ms": bound, "bound_by": by})
            del x, y, ref
        del q, s, w
    return rows


def w8a16_nodes(program) -> int:
    """The W8A16 product's kernel nodes in a captured chunk (its split
    reduction, ``w8a16_reduce``, is not counted)."""
    return sum(n for name, n in program.kernels.items() if "w8a16_kernel" in name)


def w8a16_launches(eng, counts: dict) -> dict:
    """The W8A16 kernel's launches in a serve run, by product shape
    ``"<in>x<out>"``: the wrapper's eager ones plus the replayed ones, each
    replayed decode step one launch of lm_head and ``W8A16_PER_LAYER`` of
    the others a layer; every captured chunk must hold ``(7 L + 1) x T``
    nodes."""
    L = eng.cfg.model.num_layers
    per_step = {f"{k}x{n}": c * L for (k, n), c in W8A16_PER_LAYER.items()}
    per_step["4096x128256"] = 1
    for (T, sampled), program in eng.graphs.programs.items():
        if w8a16_nodes(program) != sum(per_step.values()) * T:
            raise AssertionError(f"the captured T={T} chunk (sampled={sampled}) holds {w8a16_nodes(program)} W8A16 "
                                 f"nodes, want (7 x {L} + 1) x {T}")
    replay_steps = sum(p.steps * p.replays for p in eng.graphs.programs.values())
    eager = counts["w8a16_by_shape"]
    return {k: eager.get(k, 0) + n * replay_steps for k, n in per_step.items()}


#: Llama-3-8B's parameters under --quantization int8: the int8 stacks and
#: lm_head 7,504,658,432 B, their f32 scales 6,018,048 B, the bf16
#: embedding and norms 1,051,205,632 B
INT8_PARAM_BYTES = 8_561_882_112
#: a level-1 sleep of that engine: the parameters and the 2048 x 16-token
#: KV pool (4,294,967,296 B)
INT8_SLEEP_BYTES = 12_856_849_408
#: the roundings a layer of an int8 path adds to the bf16 path's ten,
#: against the oracle of its own quantized weights: each of the seven
#: products rounded before its scale, and the scale rounded to bf16
INT8_ROUNDINGS_PER_LAYER = ROUNDINGS_PER_LAYER + 2 * 7


def int8_parity_limit(layers: int) -> float:
    """The top of an int8 path's rel-L2 band against the fp32 oracle of
    its quantized weights: ``ROUNDING_RMS`` over the bf16 path's roundings
    and the products' and scales' (``INT8_ROUNDINGS_PER_LAYER``), the
    head's two more."""
    return ROUNDING_RMS * (INT8_ROUNDINGS_PER_LAYER * layers + 4) ** 0.5


class Dequantized:
    """A one-rank int8 model seen as the fp32 weights it holds (``q x s``,
    exact in fp32), a layer at a time: what :func:`oracle_logits` reads."""

    class Head:
        def __init__(self, leaf):
            self.q, self.s = leaf["q"], leaf["s"]
            self.shape = self.q.shape

        def __getitem__(self, idx):
            return self.q[idx].float() * self.s[idx]

    def __init__(self, model):
        self.model, self.cfg = model, model.cfg
        self.embed, self.final_norm = model.embed, model.final_norm

    def layer(self, i: int) -> dict:
        return {k: v["q"].float() * v["s"] if isinstance(v, dict) else v for k, v in self.model.layer(i).items()}

    def head(self):
        return self.Head(self.model.head())


def int8_parity(torch, model, seed: int = 5, n: int = 300) -> dict:
    """The int8 model's bucketed prefill at ``n - 1`` (its products the
    plain version: 512 rows) and the inline decode of its argmax at ``n``
    (the W8A16 kernel: one row) on one prompt, against the fp32 oracle of
    the same quantized weights, gated at :func:`int8_parity_limit`."""
    from llm_d_fast_model_actuation_tpu_torch.engine.engine import prefill_bucket
    from llm_d_fast_model_actuation_tpu_torch.models import llama

    cfg, dev = model.cfg, model.device
    ps = 16
    pages = -(-(n + 1) // ps)
    kv = tuple(torch.zeros((cfg.num_layers, pages + 1, ps, cfg.num_kv_heads, cfg.head_dim), dtype=cfg.dtype,
                           device=dev) for _ in range(2))
    pt = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)[None]
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=dev, dtype=torch.int32)
    tokens = torch.zeros((1, prefill_bucket(n, cfg.max_seq_len)), dtype=torch.int32, device=dev)
    tokens[0, :n] = prompt
    pre = llama.prefill(model, tokens, torch.tensor([n], dtype=torch.int32, device=dev), kv, pt)[0, n - 1]
    nxt = pre.argmax().to(torch.int32)[None]
    dec = llama.decode_step(model, nxt, torch.tensor([n], dtype=torch.int32, device=dev), kv, pt)[0]
    del kv
    oracle = oracle_logits(torch, Dequantized(model), torch.cat([prompt, nxt]), [n - 1, n])
    figures = {"prefill": parity_figure(torch, pre, oracle[0]), "decode_inline": parity_figure(torch, dec, oracle[1])}
    limit = int8_parity_limit(cfg.num_layers)
    refused = parity_gate(figures, cfg.num_layers, limit=limit)
    if refused:
        raise AssertionError(f"an int8 path breaks the parity gate against the oracle of its quantized weights: "
                             f"{refused}")
    return {"against_fp32_oracle": figures, "limit_rel_l2": limit,
            "predicted_rel_l2": [ROUNDING_RMS * (2 * cfg.num_layers + 4) ** 0.5, limit],
            "oracle": "plain fp32 forward of q x s, a layer dequantized at a time"}


def int8_profile(torch, eng, prompts) -> dict:
    """On the engine thread: eight greedy requests of the serve lengths
    prefilled, then :func:`chunk_device_profile` of a replayed T = 8
    chunk (the kernels by kind, the W8A16 products among the weight
    products), then the requests aborted."""
    for p in prompts:
        eng.add_request(p, max_new_tokens=200)
    eng.step()
    try:
        return chunk_device_profile(torch, eng, 8)
    finally:
        eng.abort_all("profile done")


def serve_int8(torch, smi: str, bucketed: dict, swapped: dict) -> dict:
    """Llama-3-8B at full width and depth under ``--quantization int8``,
    bucketed, seeded as ``serve`` (the same underlying weights, quantized):
    its parameter bytes exactly ``INT8_PARAM_BYTES``; the serve traffic,
    every decode chunk a replay whose graph holds the W8A16 kernel's
    (7 L + 1) x T nodes; the replayed step's device time by kernel kind;
    one level-1 cycle of exactly ``INT8_SLEEP_BYTES``, capturing nothing
    and moving no state tensor, the tokens after the wake those before;
    both paths against the fp32 oracle of the quantized weights; then a
    swap to the ``serve_hf`` checkpoint's sibling (cold: read, staged bf16,
    quantized on the card) and back (the pool), each moving the bytes
    ``/v1/costs`` priced just before it, with no delta (content hashing is
    off). Reports TTFT, TPOT, the wake's seconds and the first greedy
    divergence from the bf16 ``serve``."""
    import numpy as np

    t_phase = time.monotonic()
    sibling = f"hf:{swapped['sibling']}"
    opts = f"{SERVE_OPTS} --quantization int8 --model-pool-mib {swapped['pool_mib']}"
    service, server, init_s, free_before = start_service(torch, opts)
    port = server.server_address[1]
    try:
        eng = service.engine
        L, vocab = eng.cfg.model.num_layers, eng.cfg.model.vocab_size
        nbytes = sum(p.numel() * p.element_size() for p in eng.model.parameters())
        if nbytes != INT8_PARAM_BYTES or service._content_hash:
            raise AssertionError(f"the int8 engine holds {nbytes} parameter bytes, want {INT8_PARAM_BYTES} "
                                 f"(content hashing {service._content_hash})")
        traffic = run_traffic(torch, port, vocab)
        counts = path_counts(eng)
        check_probe_launch(counts)
        check_replays(eng, counts, "decode_inline")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, vocab, n).tolist() for n in GRAPH_PROMPT_LENS]
        # the probe repeats request 1: its first run registers the prompt
        # (the profile's abort cleared the prefix cache), every later one
        # is a prefix-cache hit, the path each repeat takes
        probe = {"prompt": traffic["prompts"][0], "max_tokens": 64}
        post(port, "/v1/completions", probe)
        before = post(port, "/v1/completions", probe)["choices"][0]["token_ids"]
        ptrs, captures = state_ptrs(eng), eng.graph_captures
        info = post(port, "/sleep?level=1")
        asleep = check_asleep(torch, eng, free_before)
        woke = post(port, "/wake_up")
        after = post(port, "/v1/completions", probe)["choices"][0]["token_ids"]
        if info["bytes_offloaded"] != INT8_SLEEP_BYTES or after != before:
            raise AssertionError(f"the int8 level-1 cycle moved {info['bytes_offloaded']} bytes (want "
                                 f"{INT8_SLEEP_BYTES}), tokens equal after the wake: {after == before}")
        if eng.graph_captures != captures or state_ptrs(eng) != ptrs:
            raise AssertionError("the int8 sleep/wake cycle re-captured a graph or moved a state tensor")
        counts = path_counts(eng)
        check_replays(eng, counts, "decode_inline")
        by_shape = w8a16_launches(eng, counts)
        # after the counts: the profile replays graphs outside the serving path
        device = service._on_loop(lambda: int8_profile(torch, eng, prompts))
        parity = int8_parity(torch, eng.model)
        # the swap to the sibling checkpoint and back, each priced first
        swaps = []
        for model in (sibling, "llama3-8b"):
            priced = costs_row(port, model)
            out = post(port, "/v1/swap", {"model": model, "request_id": f"int8-{model}"})
            if priced["predicted_bytes"] != out["bytes_moved"] or out["bytes_deduped"] or out["deduped_leaves"]:
                raise AssertionError(f"the int8 swap to {model} moved {out['bytes_moved']} bytes "
                                     f"({out['bytes_deduped']} deduped), /v1/costs priced {priced['predicted_bytes']}")
            swaps.append({"model": model, "tier": out["tier"], "bytes_moved": out["bytes_moved"],
                          "predicted_bytes": priced["predicted_bytes"], "swap_total_s": out.get("swap_total_s"),
                          "predicted_s": priced.get("predicted_s"),
                          "tokens": post(port, "/v1/completions", probe)["choices"][0]["token_ids"][:8]})
        back = post(port, "/v1/completions", probe)["choices"][0]["token_ids"]
        if [s["tier"] for s in swaps] != ["cold", "pool"] or back != before:
            raise AssertionError(f"the int8 swaps: tiers {[s['tier'] for s in swaps]}, tokens back equal {back == before}")
        out = {
            "phase": "serve_int8", "model": "llama3-8b", "quantization": "int8", "layers": L,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "init_s": init_s,
            "param_bytes": nbytes, **traffic["summary"], **graph_stats(eng),
            "w8a16_launches_by_shape": by_shape, "launches": counts,
            "replayed_step": device, "weight_products_ms_per_step": (device.get("profiled_step_ms_by_kind") or {}).get(
                "weight products") if isinstance(device.get("profiled_step_ms_by_kind"), dict) else "not measured",
            "sleep": {"bytes_offloaded": info["bytes_offloaded"], "sleep_s": info["last_sleep_seconds"],
                      "wake_s": woke["last_wake_seconds"],
                      "wake_gib_per_s": info["bytes_offloaded"] / GIB / woke["last_wake_seconds"], **asleep},
            "tokens_identical_after_wake": True, "graph_captures_unchanged": True,
            "parity": parity, "swaps": swaps,
            "first_difference_from_bf16_serve": first_differences(traffic["tokens"], bucketed["tokens"]),
            "seconds": time.monotonic() - t_phase,
        }
        emit(out)
        return {"counts": counts, "by_shape": by_shape}
    finally:
        stop_service(torch, service, server)
        service._free_pooled(service.model_pool.drain())
        # the serving engine's pinned host copies (its level-1 cycle's)
        # go back to the host now, not when a later phase empties the cache
        service._runtime = eng = None
        gc.collect()
        torch._C._host_emptyCache()


#: the refusals the launcher answers at create with 422, each in the
#: reference's words
REFUSED_PAIRS = {
    "--packed-serving on --pipeline-decode on": "--packed-serving is incompatible with --pipeline-decode",
    "--quantization int8 --resident-variants 2 --packed-serving on":
        "--resident-variants > 1 is incompatible with --quantization",
    "--quantization int8 --sleep-quant int8": "--sleep-quant composes with full-precision serving only",
}


def launcher_refusals(launcher, uuid: str) -> dict:
    """``PUT /v2/vllm/instances/<id>`` with each pair of options that do
    not compose: a 422 naming the reference's reason, and no instance."""
    out = {}
    for i, (pair, words) in enumerate(REFUSED_PAIRS.items()):
        status, body = launcher.create(f"refused-{i}", f"{SERVE_OPTS} --port {free_port()} {pair}", uuid)
        if status != 422 or words not in json.dumps(body):
            raise AssertionError(f"the launcher answered {status} {body} to {pair!r}, want 422 naming {words!r}")
        if request(f"{launcher.url}/v2/vllm/instances/refused-{i}")[0] != 404:
            raise AssertionError(f"a refused instance exists: {pair!r}")
        out[pair] = {"status": status, "body": body}
    return out


SPEC_K = 4
SPEC_NEW_TOKENS = 128  # 256 until the pipeline phase joined the script, for its time limit
#: the repeated pattern of the speculative stream's prompt, and its repeats
SPEC_PATTERN, SPEC_REPEATS = 24, 12


def cold_logits(torch, model, ids: list, max_len: int):
    """One cold bucketed prefill of the one-rank ``model`` over ``ids``:
    the fp32 logits at every position ``[len(ids), vocab]``."""
    from llm_d_fast_model_actuation_tpu_torch.engine.engine import prefill_bucket
    from llm_d_fast_model_actuation_tpu_torch.models import llama

    cfg, dev = model.cfg, model.device
    n, ps = len(ids), 16
    pages = -(-n // ps)
    kv = tuple(torch.zeros((cfg.num_layers, pages + 1, ps, cfg.num_kv_heads, cfg.head_dim), dtype=cfg.dtype,
                           device=dev) for _ in range(2))
    pt = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)[None]
    x = torch.zeros((1, prefill_bucket(n, max_len)), dtype=torch.int32, device=dev)
    x[0, :n] = torch.tensor(ids, dtype=torch.int32, device=dev)
    return llama.prefill(model, x, torch.tensor([n], dtype=torch.int32, device=dev), kv, pt)[0, :n]


def teacher_forced(torch, model, prompt: list, out: list, max_len: int) -> dict:
    """Every emitted token against a cold prefill over prompt + output: the
    argmax there, or a near-tie. A near-tie is a top-2 gap inside the
    bf16 rounding noise of a logit as ``parity_gate`` derives it
    (``ARGMAX_TIE_SIGMAS`` x sqrt 2 x the bf16 band's top x the row's
    logit RMS); raises on any other token."""
    L = model.cfg.num_layers
    logits = cold_logits(torch, model, prompt + out, max_len)[len(prompt) - 1 : len(prompt) - 1 + len(out)]
    chose = torch.tensor(out, dtype=torch.long, device=logits.device)
    top = logits.max(dim=-1)
    gap = top.values - logits.gather(-1, chose[:, None])[:, 0]
    tie = ARGMAX_TIE_SIGMAS * 2**0.5 * parity_limit(L) * logits.pow(2).mean(-1).sqrt()
    argmax = top.indices == chose
    bad = (~argmax & (gap > tie)).nonzero().flatten().tolist()
    if bad:
        raise AssertionError(f"emitted tokens at positions {bad[:8]} are not the cold prefill's argmax nor a near-tie: "
                             f"gaps {gap[bad[:8]].tolist()} against {tie[bad[:8]].tolist()}")
    return {"positions": len(out), "argmax": int(argmax.sum().item()), "near_ties": int((~argmax).sum().item()),
            "largest_tie_gap": float(gap[~argmax].max().item()) if (~argmax).any() else 0.0}


def speculative_phase(torch, smi: str) -> dict:
    """One greedy stream of ``SPEC_NEW_TOKENS`` on the bf16 llama3-8b
    server with ``--speculative-ngram SPEC_K``, its prompt a repeated
    pattern, then the same stream with speculation off on the same engine
    (its config between requests). Gated: proposals made, ``/metrics``'s
    two families equal to ``/v1/stats``, every emitted token the argmax of
    a teacher-forced cold prefill or a near-tie. Reported: the acceptance
    rate, forwards per emitted token, TPOT with and without, and the first
    divergence from the stream without speculation (the reference's own
    caveat: the verify and the chunk round apart at argmax ties)."""
    import numpy as np

    t_phase = time.monotonic()
    service, server, init_s, _ = start_service(torch, f"{SERVE_OPTS} --speculative-ngram {SPEC_K}")
    port = server.server_address[1]
    try:
        eng = service.engine
        vocab = eng.cfg.model.vocab_size
        pattern = np.random.default_rng(3).integers(0, vocab, SPEC_PATTERN).tolist()
        body = {"prompt": pattern * SPEC_REPEATS, "max_tokens": SPEC_NEW_TOKENS, "ignore_eos": True}
        steps0, chunks0 = eng.chunk_steps, eng.decode_chunks
        spec = post(port, "/v1/completions", body)
        stats = get(port, "/v1/stats")["engine"]
        samples = scrape(f"http://127.0.0.1:{port}/metrics")
        scraped = {k: metric(samples, f"fma_engine_spec_{k}_tokens", model="llama3-8b")
                   for k in ("proposed", "accepted")}
        if not stats["spec_proposed"] > 0 or scraped != {"proposed": stats["spec_proposed"],
                                                         "accepted": stats["spec_accepted"]}:
            raise AssertionError(f"speculation: /v1/stats {stats}, /metrics {scraped}")
        steps = eng.chunk_steps - steps0
        forwards = stats["spec_rounds"] + steps + 1  # verify rounds, chunk steps, the prefill
        service._on_loop(lambda: setattr(eng, "cfg", dataclasses.replace(eng.cfg, speculative_ngram=0)))
        plain = post(port, "/v1/completions", body)
        tokens = spec["choices"][0]["token_ids"]
        forced = teacher_forced(torch, eng.model, body["prompt"], tokens, eng.cfg.seq_len)
        out = {
            "phase": "speculative", "model": "llama3-8b", "k": SPEC_K, "new_tokens": SPEC_NEW_TOKENS,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "init_s": init_s,
            "spec_proposed": stats["spec_proposed"], "spec_accepted": stats["spec_accepted"],
            "spec_rounds": stats["spec_rounds"], "metrics": scraped,
            "acceptance_rate": stats["spec_accepted"] / stats["spec_proposed"],
            "chunk_steps": steps, "decode_chunks": eng.decode_chunks - chunks0,
            "forwards_per_token": forwards / len(tokens),
            "tpot_s": {"speculative": spec["usage"]["decode_tpot_s"], "off": plain["usage"]["decode_tpot_s"]},
            "ttft_s": {"speculative": spec["usage"]["time_to_first_token_s"],
                       "off": plain["usage"]["time_to_first_token_s"]},
            "first_difference_from_off": first_differences([tokens], [plain["choices"][0]["token_ids"]])[0],
            "teacher_forced": forced, "seconds": time.monotonic() - t_phase,
        }
        emit(out)
        return out
    finally:
        stop_service(torch, service, server)


#: the pipeline phase's streams: a greedy wave of the serve lengths, then
#: a seeded sampled wave admitted while a chunk is in flight
PIPE_WAVE1 = (20, 300, 1500, 3000)
PIPE_WAVE2 = (16, 400, 1800, 2500)


def pipeline_run(torch, eng, pipeline: bool, wave1: list, wave2: list) -> dict:
    """The two waves through ``step()`` with ``pipeline_decode`` set as
    asked (64 and 48 tokens): the tokens by request, TPOT per request
    (its first token to its last read), and the device's gap between
    consecutive replayed chunks from CUDA events around each replay."""
    eng.cfg = dataclasses.replace(eng.cfg, pipeline_decode=pipeline)
    real, marks = eng.graphs.replay, []

    def replay(T, sampled):
        a = torch.cuda.Event(enable_timing=True)
        a.record()
        out = real(T, sampled)
        b = torch.cuda.Event(enable_timing=True)
        b.record()
        marks.append((a, b))
        return out

    eng.graphs.replay = replay
    try:
        ids = [eng.add_request(p, max_new_tokens=64) for p in wave1]
        done = {}

        def step():
            for r in eng.step():
                done[r.seq_id] = (r, time.monotonic())

        step()
        step()
        if pipeline and eng._inflight is None:
            raise AssertionError("no chunk in flight when the second wave came")
        ids += [eng.add_request(p, max_new_tokens=48, temperature=0.8, seed=7 + i) for i, p in enumerate(wave2)]
        while eng.has_work():
            step()
        torch.cuda.synchronize()
    finally:
        del eng.graphs.replay
    gaps = sorted(b.elapsed_time(a2) for (_, b), (a2, _) in zip(marks, marks[1:]))
    tpot = [(t - r.first_token_time) / (len(r.out_tokens) - 1) for r, t in done.values()]
    return {"tokens": [done[i][0].out_tokens for i in ids], "chunks": len(marks),
            "tpot_s_mean": sum(tpot) / len(tpot), "chunk_gap_ms_median": gaps[len(gaps) // 2],
            "chunk_gap_ms_mean": sum(gaps) / len(gaps)}


def pipeline_phase(torch, smi: str) -> dict:
    """A llama3-8b engine at full width and depth built directly, every
    chunk a replay of its graphs: the two waves with ``pipeline_decode``
    off, on, on, off (one engine, its config between runs), the tokens
    bit-equal across the modes (a drain that read an output a later
    replay overwrote would emit another chunk's tokens); then a level-1
    sleep issued while a pipelined chunk is in flight, which reads it
    first: after the wake the stream finishes with the tokens of the same
    request run alone without pipelining. Reports TPOT and the device gap
    between chunks in both modes."""
    import numpy as np

    from llm_d_fast_model_actuation_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from llm_d_fast_model_actuation_tpu_torch.engine.sleep import attach_sleep
    from llm_d_fast_model_actuation_tpu_torch.models import llama

    t_phase = time.monotonic()
    free_memory(torch)
    cfg = EngineConfig(model=llama.LlamaConfig.llama3_8b(), max_batch=8, num_pages=2048, prefix_caching=False)
    eng = InferenceEngine(cfg, seed=0, device="cuda")
    vocab = cfg.model.vocab_size
    rng = np.random.default_rng(4)
    wave1 = [rng.integers(0, vocab, n).tolist() for n in PIPE_WAVE1]
    wave2 = [rng.integers(0, vocab, n).tolist() for n in PIPE_WAVE2]
    runs = {name: pipeline_run(torch, eng, name.startswith("on"), wave1, wave2)
            for name in ("off", "on", "on_2", "off_2")}
    tokens = {k: r.pop("tokens") for k, r in runs.items()}
    if any(t != tokens["off"] for t in tokens.values()):
        raise AssertionError("the pipelined streams' tokens differ from the sequential ones")
    # a level-1 sleep with a pipelined chunk in flight
    eng.cfg = dataclasses.replace(eng.cfg, pipeline_decode=False)
    gold = eng.generate([wave1[1]], max_new_tokens=40)[0]
    eng.cfg = dataclasses.replace(eng.cfg, pipeline_decode=True)
    sleeper = attach_sleep(eng)
    eng.add_request(wave1[1], max_new_tokens=40)
    eng.step()
    if eng._inflight is None:
        raise AssertionError("no chunk in flight before the sleep")
    slept = sleeper.sleep(1)
    if eng._inflight is not None:
        raise AssertionError("the sleep left a chunk in flight")
    sleeper.wake_up()
    done = []
    while eng.has_work():
        done.extend(eng.step())
    if not done or done[0].out_tokens != gold:
        raise AssertionError("the stream slept with a chunk in flight lost or changed tokens")

    def mean(key, on):
        vals = [r[key] for k, r in runs.items() if k.startswith("on") == on]
        return sum(vals) / len(vals)

    out = {
        "phase": "pipeline", "model": "llama3-8b", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "runs": runs, "tokens_bit_equal": True, "sleep_in_flight": {"bytes_offloaded": slept["bytes_offloaded"],
                                                                   "tokens_equal_alone": True},
        "tpot_s": {"on": mean("tpot_s_mean", True), "off": mean("tpot_s_mean", False)},
        "chunk_gap_ms_median": {"on": mean("chunk_gap_ms_median", True), "off": mean("chunk_gap_ms_median", False)},
        "seconds": time.monotonic() - t_phase,
    }
    emit(out)
    del eng, sleeper
    return out


#: the batched W8A16 product at Mixtral-8x7B's expert stacks: (experts,
#: in, out, one x shared by every expert): the gate and up products read
#: one x, the down product an x per expert
W8A16_EXPERT_SHAPES = ((8, 4096, 14336, True), (8, 14336, 4096, False))
W8A16_EXPERTS_REPLACES = ("none: the JAX package's expert product is XLA "
                          "(llm_d_fast_model_actuation_tpu/models/moe.py:153)")


def check_w8a16_experts(torch, gen) -> list:
    """The batched W8A16 kernel at Mixtral-8x7B's two expert-stack shapes
    (E = 8; 4096 -> 14336 with one shared x, 14336 -> 4096 with an x per
    expert) at each of ``W8A16_ROWS``, against its plain version, as
    :func:`check_w8a16` holds the 2-D product: the error over the largest
    plain value under ``W8A16_TOL``, the same bits from a second launch,
    one launch under CUDA's sync debug mode; ``ms``, ``device_ms``, the
    plain version's time, bf16 ``torch.matmul`` over the same experts
    (the library yardstick, a batched product), :func:`int8pack_ms`, and
    the bound from the int8 weights, scales, x and y bytes or the flops."""
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import w8a16 as mod

    rows = []
    for E, K, N, shared in W8A16_EXPERT_SHAPES + W8A16_EP_EXPERT_SHAPES + W8A16_PP_EP_EXPERT_SHAPES:
        q = torch.randint(-127, 128, (E, K, N), generator=gen, device="cuda", dtype=torch.int8)
        s = (torch.rand((E, 1, N), generator=gen, device="cuda") + 3.0) * (K**-0.5 / 127)
        w = q.to(torch.bfloat16)
        for M in W8A16_ROWS:
            x = torch.randn((M, K) if shared else (E, M, K), generator=gen, device="cuda").to(torch.bfloat16)

            def kernel():
                return mod.w8a16_matmul_experts(x, q, s)

            y, ref = kernel(), mod.w8a16_matmul_experts_plain(x, q, s)
            max_abs, _ = errors(y, ref)
            rel = max_abs / ref.float().abs().max().item()
            same = torch.equal(y, kernel())
            if not rel < W8A16_TOL or not same:
                raise AssertionError(f"batched W8A16 at E={E} [{M}, {K}] @ [{K}, {N}] (x shared {shared}): error "
                                     f"{rel:.3e} of the largest plain value (limit {W8A16_TOL}), bit-stable {same}")
            if M == 8:
                sync_free(kernel)
            bound, by = bound_ms(E * K * N + 4 * E * N + 2 * x.numel() + 2 * E * M * N, 2 * E * M * K * N)
            rows.append({"name": f"w8a16_experts[E={E},in={K},out={N}]", "route": "cuda", "source": W8A16_SOURCE,
                         "replaces": W8A16_EXPERTS_REPLACES, "rows": M, "experts": E, "in": K, "out": N,
                         "x_shared": shared, "plan": list(mod.launch_plan(M, K, N, E)),
                         "max_abs_err": max_abs, "rel_err": rel, "bit_stable": same,
                         "ms": time_ms(kernel, 20), "device_ms": graph_ms(kernel, 20),
                         "plain_ms": time_ms(lambda: mod.w8a16_matmul_experts_plain(x, q, s), 20),
                         "library_ms": time_ms(lambda: torch.matmul(x, w), 20),
                         "library": "torch.matmul bf16 over the experts", "int8pack_ms": int8pack_ms(torch, x, q, s),
                         "bound_ms": bound, "bound_by": by})
            del x, y, ref
        del q, s, w
    return rows


MOE_OPTS = "--model mixtral-8x7b --quantization int8 --num-pages 2048 --seed 0 --max-batch 8 --device cuda"
#: Mixtral-8x7B under --quantization int8: the int8 stacks and lm_head
#: 46,570,405,888 B, their f32 scales (a scale per expert and output
#: channel) 34,993,152 B, the bf16 embedding, routers and norms
#: 264,773,632 B
MOE_PARAM_BYTES = 46_870_172_672
#: a level-1 sleep of that engine: the parameters and the 2048 x 16-token
#: KV pool (4,294,967,296 B)
MOE_SLEEP_BYTES = 51_165_139_968
#: host memory the sleep needs beside its pinned copies
MOE_SLEEP_HOST_SLACK_BYTES = 2 * GIB
#: the W8A16 launches of one Mixtral decode step a layer, by product shape:
#: the attention trunk's four (2-D), the three expert stacks' (batched)
MOE_W8A16_PER_LAYER = {"4096x4096": 2, "4096x1024": 2}
MOE_W8A16_EXPERTS_PER_LAYER = {"8x4096x14336": 2, "8x14336x4096": 1}
#: the layers of the in-process MoE parity model and of the checkpoint
MOE_PARITY_LAYERS = 4
#: one layer's bf16 expert stacks (3 x 8 x 4096 x 14336 x 2 B): the most
#: an int8 load may hold on the card beyond the int8 parameters
MOE_LAYER_STACK_BYTES = 2_818_572_288
#: the roundings an MoE int8 layer adds to the dense int8 layer's: the
#: router's logits rounded to bf16, and the experts' weighted sum rounded
MOE_INT8_ROUNDINGS_PER_LAYER = INT8_ROUNDINGS_PER_LAYER + 2


def moe_w8a16_launches(eng, counts: dict) -> dict:
    """The W8A16 kernel's launches in an MoE serve run by product shape
    (the 2-D ones ``"<in>x<out>"``, the batched ones ``"<E>x<in>x<out>"``):
    the wrappers' eager ones plus the replayed ones. Every captured chunk
    must hold ``(7 L + 1) x T`` W8A16 nodes: four attention products and
    three expert products a layer, and lm_head."""
    L = eng.cfg.model.num_layers
    per_step = {k: c * L for k, c in MOE_W8A16_PER_LAYER.items()}
    per_step[f"4096x{eng.cfg.model.vocab_size}"] = 1
    per_step_experts = {k: c * L for k, c in MOE_W8A16_EXPERTS_PER_LAYER.items()}
    for (T, sampled), program in eng.graphs.programs.items():
        if w8a16_nodes(program) != (7 * L + 1) * T:
            raise AssertionError(f"the captured T={T} chunk (sampled={sampled}) holds {w8a16_nodes(program)} W8A16 "
                                 f"nodes, want (7 x {L} + 1) x {T}")
    replay_steps = sum(p.steps * p.replays for p in eng.graphs.programs.values())
    eager, eager_e = counts["w8a16_by_shape"], counts["w8a16_experts_by_shape"]
    return {"w8a16": {k: eager.get(k, 0) + n * replay_steps for k, n in per_step.items()},
            "w8a16_experts": {k: eager_e.get(k, 0) + n * replay_steps for k, n in per_step_experts.items()}}


def moe_parity_limit(layers: int) -> float:
    """The top of an MoE int8 path's rel-L2 band against the fp32 oracle
    of its quantized weights, routed as the path routed: as
    :func:`int8_parity_limit` with ``MOE_INT8_ROUNDINGS_PER_LAYER``."""
    return ROUNDING_RMS * (MOE_INT8_ROUNDINGS_PER_LAYER * layers + 4) ** 0.5


def moe_oracle_logits(torch, model, tokens, rows, routes) -> tuple:
    """The fp32 oracle of a one-rank MoE ``model`` (:func:`oracle_logits`'
    forward with the MoE FFN): each token's FFN the weighted sum of the
    experts ``routes[layer]`` [s, k] name (the bf16 path's choice), its
    weights the softmax of the oracle's own fp32 router logits at those
    experts. Returns the fp32 logits at ``rows`` and the share of the
    (token, layer) decisions whose expert set differs from the oracle's
    own fp32 top-k (ties to the lower index)."""
    cfg = model.cfg
    f32 = torch.float32
    dev = model.embed.device
    s = tokens.shape[0]
    h, kvh, d, k = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.experts_per_token

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
    differ = 0
    with torch.no_grad():
        for i in range(cfg.num_layers):
            w = {n: v.float() for n, v in model.layer(i).items()}
            a = norm(x, w["attn_norm"])
            q = rope((a @ w["wq"]).view(s, h, d))
            kk = rope((a @ w["wk"]).view(s, kvh, d)).repeat_interleave(h // kvh, dim=1)
            v = (a @ w["wv"]).view(s, kvh, d).repeat_interleave(h // kvh, dim=1)
            sc = torch.einsum("qhd,khd->hqk", q, kk) / d ** 0.5
            p = torch.softmax(sc.masked_fill(~causal, float("-inf")), dim=-1)
            x = x + torch.einsum("hqk,khd->qhd", p, v).reshape(s, h * d) @ w["wo"]
            m = norm(x, w["mlp_norm"])
            logits = m @ w["router"]
            own = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :k]
            idx = routes[i].to(dev)
            differ += int((own.sort(-1).values != idx.sort(-1).values).any(-1).sum())
            wts = torch.softmax(logits.gather(-1, idx), dim=-1)
            y = torch.zeros_like(x)
            for e in range(cfg.num_experts):
                hit = idx == e  # [s, k]
                sel = hit.any(-1).nonzero()[:, 0]
                if sel.numel():
                    me = m[sel]
                    out = (torch.nn.functional.silu(me @ w["w_gate"][e]) * (me @ w["w_up"][e])) @ w["w_down"][e]
                    y[sel] += (wts * hit).sum(-1)[sel, None] * out
            x = x + y
            del w, a, q, kk, v, sc, p, m
        yr = norm(x[rows], model.final_norm)
        head = model.head()
        step = 32768
        logits = torch.cat([yr @ head[:, j : j + step].float() for j in range(0, head.shape[1], step)], dim=-1)
    return logits, differ / (s * cfg.num_layers)


def moe_parity(torch, seed: int = 5, n: int = 300) -> dict:
    """Mixtral-8x7B at ``MOE_PARITY_LAYERS`` layers and full width under
    int8, drawn in process: its bucketed prefill at ``n - 1`` (the plain
    products) and the inline decode of its argmax at ``n`` (the W8A16
    kernels, one row) on one prompt, each layer's routing recorded, held
    against the fp32 oracle of the same quantized weights routed as they
    were routed, gated at :func:`moe_parity_limit`; beside it the share of
    (token, layer) routing decisions that fp32 routing would change."""
    from llm_d_fast_model_actuation_tpu_torch.models import llama, moe

    free_memory(torch)
    cfg = dataclasses.replace(moe.MoeConfig.mixtral_8x7b(), num_layers=MOE_PARITY_LAYERS, quantization="int8")
    model = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    ps = 16
    pages = -(-(n + 1) // ps)
    kv = tuple(torch.zeros((cfg.num_layers, pages + 1, ps, cfg.num_kv_heads, cfg.head_dim), dtype=cfg.dtype,
                           device="cuda") for _ in range(2))
    pt = torch.arange(1, pages + 1, dtype=torch.int32, device="cuda")[None]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (n,), generator=gen, device="cuda", dtype=torch.int32)
    # the prefill's n rows take the plain products: the batched kernel's
    # launches are the decode step's
    launches = kernel_wrappers()["w8a16_experts"].launches
    pre, dec, nxt, routes = moe_logits_and_routes(torch, model, prompt[None], kv, pt)
    launches = kernel_wrappers()["w8a16_experts"].launches - launches
    pre, dec, nxt, routes = pre[0], dec[0], nxt, routes[0]
    del kv
    L = cfg.num_layers
    if launches != 3 * L:
        raise AssertionError(f"the parity run launched the batched W8A16 kernel {launches} times in its decode "
                             f"step (want {3 * L})")
    oracle, differ = moe_oracle_logits(torch, Dequantized(model), torch.cat([prompt, nxt]), [n - 1, n], routes)
    figures = {"prefill": parity_figure(torch, pre, oracle[0]), "decode_inline": parity_figure(torch, dec, oracle[1])}
    limit = moe_parity_limit(L)
    refused = parity_gate(figures, L, limit=limit)
    del model
    free_memory(torch)
    if refused:
        raise AssertionError(f"an MoE int8 path breaks the parity gate against the oracle of its quantized weights: "
                             f"{refused}")
    return {"layers": L, "against_fp32_oracle": figures, "limit_rel_l2": limit,
            "predicted_rel_l2": [ROUNDING_RMS * (2 * L + 4) ** 0.5, limit],
            "routing_decisions_fp32_would_change": differ,
            "oracle": "plain fp32 forward of q x s, a layer dequantized at a time, routed as the bf16 path routed"}


def serve_moe(torch, smi: str) -> dict:
    """Mixtral-8x7B at full width and depth under ``--quantization int8``
    (random weights from ``--seed``), bucketed: its parameter bytes
    exactly ``MOE_PARAM_BYTES``; the serve traffic, every decode chunk a
    replay whose graph holds L x T decode nodes and (7 L + 1) x T W8A16
    nodes; the replayed step's device time by kernel kind; one level-1
    cycle of exactly ``MOE_SLEEP_BYTES`` (the host's MemAvailable checked
    for room first), priced by ``/v1/costs`` to the byte, capturing
    nothing and moving no state tensor, the tokens after the wake those
    before; then :func:`moe_parity` at reduced depth. Reports TTFT, TPOT
    and the wake's seconds and GB/s."""
    import numpy as np

    t_phase = time.monotonic()
    service, server, init_s, free_before = start_service(torch, MOE_OPTS)
    port = server.server_address[1]
    try:
        eng = service.engine
        L, vocab = eng.cfg.model.num_layers, eng.cfg.model.vocab_size
        nbytes = sum(p.numel() * p.element_size() for p in eng.model.parameters())
        if nbytes != MOE_PARAM_BYTES:
            raise AssertionError(f"the Mixtral int8 engine holds {nbytes} parameter bytes, want {MOE_PARAM_BYTES}")
        traffic = run_traffic(torch, port, vocab)
        counts = path_counts(eng)
        check_probe_launch(counts)
        check_replays(eng, counts, "decode_inline")
        by_shape = moe_w8a16_launches(eng, counts)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, vocab, n).tolist() for n in GRAPH_PROMPT_LENS]
        probe = {"prompt": traffic["prompts"][0], "max_tokens": 16}
        post(port, "/v1/completions", probe)
        before = post(port, "/v1/completions", probe)["choices"][0]["token_ids"]
        ptrs, captures = state_ptrs(eng), eng.graph_captures
        host = mem_available()
        if host < MOE_SLEEP_BYTES + MOE_SLEEP_HOST_SLACK_BYTES:
            raise AssertionError(f"the host has {host} bytes available, the level-1 sleep needs {MOE_SLEEP_BYTES} "
                                 f"and {MOE_SLEEP_HOST_SLACK_BYTES} beside them")
        info = post(port, "/sleep?level=1")
        priced_exactly(last_record(port, "sleep"), "the Mixtral level-1 sleep")
        asleep = check_asleep(torch, eng, free_before)
        woke = post(port, "/wake_up")
        priced_exactly(last_record(port, "wake"), "the Mixtral wake")
        after = post(port, "/v1/completions", probe)["choices"][0]["token_ids"]
        if info["bytes_offloaded"] != MOE_SLEEP_BYTES or after != before:
            raise AssertionError(f"the Mixtral level-1 cycle moved {info['bytes_offloaded']} bytes (want "
                                 f"{MOE_SLEEP_BYTES}), tokens equal after the wake: {after == before}")
        if eng.graph_captures != captures or state_ptrs(eng) != ptrs:
            raise AssertionError("the Mixtral sleep/wake cycle re-captured a graph or moved a state tensor")
        counts = path_counts(eng)
        check_replays(eng, counts, "decode_inline")
        by_shape = moe_w8a16_launches(eng, counts)
        # after the counts: the profile replays graphs outside the serving path
        device = service._on_loop(lambda: int8_profile(torch, eng, prompts))
        out = {
            "phase": "serve_moe", "model": "mixtral-8x7b", "quantization": "int8", "layers": L,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "init_s": init_s,
            "param_bytes": nbytes, **traffic["summary"], **graph_stats(eng),
            "w8a16_launches_by_shape": by_shape, "launches": counts, "replayed_step": device,
            "sleep": {"bytes_offloaded": info["bytes_offloaded"], "sleep_s": info["last_sleep_seconds"],
                      "wake_s": woke["last_wake_seconds"], "host_available_bytes": host,
                      "wake_gb_per_s": info["bytes_offloaded"] / 1e9 / woke["last_wake_seconds"], **asleep},
            "tokens_identical_after_wake": True, "graph_captures_unchanged": True,
        }
    finally:
        stop_service(torch, service, server)
        # the pinned host copies of the level-1 cycle go back to the host now
        service._runtime = eng = None
        gc.collect()
        torch._C._host_emptyCache()
    out["parity"] = moe_parity(torch)
    out["seconds"] = time.monotonic() - t_phase
    emit(out)
    return {"counts": counts, "by_shape": by_shape}


def moe_hf_model(name: str):
    """Mixtral-8x7B at ``MOE_HF_LAYERS`` layers under the server's name
    ``name``: the model an ``hf:`` directory of ``MIXTRAL_HF_CONFIG``
    holds, offered to the server for the in-process engines."""
    from llm_d_fast_model_actuation_tpu_torch.engine import server as srv
    from llm_d_fast_model_actuation_tpu_torch.models import moe

    srv.MODEL_CONFIGS[name] = lambda: dataclasses.replace(moe.MoeConfig.mixtral_8x7b(), num_layers=MOE_HF_LAYERS)


def moe_tokens(port: int, prompts: list) -> list:
    """Greedy completions of ``prompts`` one at a time (each alone in the
    batch, at slot 0), 32 tokens each, past eos."""
    return [post(port, "/v1/completions", {"prompt": p, "max_tokens": 32, "ignore_eos": True})["choices"][0]
            ["token_ids"] for p in prompts]


def serve_moe_hf(torch, smi: str) -> dict:
    """A ``MOE_HF_LAYERS``-layer, full-width Mixtral checkpoint in
    Mixtral's HF tensor names (3.43 GB at one layer), written from an in-process bf16
    engine's seeded weights and served with ``--model hf:<dir>``: its
    greedy tokens bit-equal to the in-process engine's; then under
    ``--quantization int8`` the parameter bytes, the weights' fingerprints
    and the tokens equal to an in-process int8 engine of the same seed,
    and that engine's build (the load, staged in bf16 on the host and
    quantized on the card a layer's [E, in, out] slice at a time, then the
    captures) holding at most one layer's bf16 expert stacks
    (``MOE_LAYER_STACK_BYTES``) on the card beyond its parameters. The
    checkpoint is deleted at the end."""
    import numpy as np

    from llm_d_fast_model_actuation_tpu_torch.engine import server as srv

    t_phase = time.monotonic()
    name = f"mixtral-8x7b-{MOE_HF_LAYERS}-layers"
    moe_hf_model(name)
    base = "--num-pages 512 --seed 0 --max-batch 8 --device cuda"
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 32000, n).tolist() for n in (20, 300, 1500)]
    from llm_d_fast_model_actuation_tpu_torch.models import llama, moe

    shapes = llama.param_shapes(dataclasses.replace(moe.MoeConfig.mixtral_8x7b(), num_layers=MOE_HF_LAYERS))
    ckpt = checkpoint_dir(2 * 2 * sum(math.prod(s) for s in shapes.values()))  # bf16, and room to spare
    runs = {}
    try:
        for quant in ("", " --quantization int8"):
            service, server, init_s, _ = start_service(torch, f"--model {name} {base}{quant}")
            try:
                eng = service.engine
                if not quant:
                    written = write_hf_checkpoint(torch, eng.model, ckpt, MIXTRAL_HF_CONFIG, MIXTRAL_HF_GENERATION)
                runs[f"in_process{quant}"] = {
                    "tokens": moe_tokens(server.server_address[1], prompts),
                    "param_bytes": sum(p.numel() * p.element_size() for p in eng.model.parameters()),
                    "fingerprint": fingerprint(torch, list(eng.model.parameters())), "init_s": init_s}
            finally:
                stop_service(torch, service, server)
                service._runtime = eng = None
            service = server = None
            free_memory(torch)
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            service, server, init_s, _ = start_service(torch, f"--model hf:{ckpt} {base}{quant}")
            try:
                eng = service.engine
                # the build's peak beyond what was allocated before it: the
                # load's temporaries (the parameters and the KV pool are
                # the arena's, which the allocator does not count), and the
                # captures' graph pools
                beyond = torch.cuda.max_memory_allocated() - held
                runs[f"hf{quant}"] = {"build_peak_beyond_params_bytes": beyond,
                    "tokens": moe_tokens(server.server_address[1], prompts),
                    "param_bytes": sum(p.numel() * p.element_size() for p in eng.model.parameters()),
                    "fingerprint": fingerprint(torch, list(eng.model.parameters())), "init_s": init_s,
                    "load": service.load_stats.summary()}
            finally:
                stop_service(torch, service, server)
                service._runtime = eng = None
        for quant in ("", " --quantization int8"):
            a, b = runs[f"in_process{quant}"], runs[f"hf{quant}"]
            if a["tokens"] != b["tokens"] or a["param_bytes"] != b["param_bytes"] or a["fingerprint"] != b["fingerprint"]:
                raise AssertionError(f"hf:<Mixtral checkpoint>{quant or ' (bf16)'}: tokens equal "
                                     f"{a['tokens'] == b['tokens']}, parameter bytes {b['param_bytes']} against "
                                     f"{a['param_bytes']}, weights equal {a['fingerprint'] == b['fingerprint']}")
        beyond = runs["hf --quantization int8"]["build_peak_beyond_params_bytes"]
        if not beyond <= MOE_LAYER_STACK_BYTES:
            raise AssertionError(f"the int8 load held {beyond} bytes beyond its parameters, more than one layer's bf16 "
                                 f"expert stacks ({MOE_LAYER_STACK_BYTES})")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        srv.MODEL_CONFIGS.pop(name, None)
    out = {"phase": "serve_moe_hf", "model": f"hf:<{MOE_HF_LAYERS}-layer Mixtral-8x7B checkpoint>", "layers": MOE_HF_LAYERS,
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "checkpoint": written,
           "tokens_bit_equal": {"bf16": True, "int8": True}, "int8_build_peak_beyond_params_bytes": beyond,
           "int8_build_peak_limit_bytes": MOE_LAYER_STACK_BYTES,
           "runs": {k: {kk: vv for kk, vv in v.items() if kk not in ("tokens", "fingerprint")} for k, v in runs.items()},
           "seconds": time.monotonic() - t_phase}
    emit(out)
    return out


# -- training, the full mesh and expert parallelism ---------------------------

#: the train phase: Llama-3-8B at full width and depth, three AdamW steps
#: on one batch of two rows of 1024 ids, the second padded after 777
TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ_LENS, TRAIN_STEPS = 2, 1024, (1024, 777), 3
#: the ids of row 0 on which the training forward and the serving prefill
#: are held to the fp32 oracle; the prefill runs at the 512 bucket, as the
#: engine runs a prompt of 257 to 512 ids
TRAIN_PARITY_IDS, TRAIN_PARITY_BUCKET = 256, 512
#: fine-tune-then-serve: the serve mix's prompt lengths, 16 new ids each
TRAIN_SERVE_LENS, TRAIN_SERVE_NEW = (20, 300, 1500, 3000), 16
#: the mesh phases' steps against one rank's (bf16 both): the loss within
#: 1% of it; adamw's first moment, 0.1 x the gradient rounded to bf16,
#: within 0.1 of it in rel-L2 over all leaves (bf16 rounding of the
#: gradients is of order 1e-2; a gradient summed twice or not at all over
#: a replica is off by 0.5 to 1); the step's update within 0.5 in rel-L2
#: (Adam's first step is g / |g| elementwise, so elements whose gradient
#: sits within the paths' rounding of 0 flip sign between them: a share f
#: of flips gives about 2 sqrt(f))
MESH_LOSS_RTOL, MESH_MU_REL_L2, MESH_UPDATE_REL_L2 = 1e-2, 0.1, 0.5
#: the ring against the dense attention in f32 at s = 4096: max abs
#: error over outputs of order 1 (f32 sums in another order)
RING_F32_ATOL = 1e-4
#: train_mesh: Llama-3-8B widths at 4 layers, sp 2 x tp 2, one row of 4096
TRAIN_MESH_LAYERS, TRAIN_MESH_SEQ = 4, 4096
#: train_moe: Mixtral-8x7B widths at 2 layers, dp 2 x ep 2, four rows of 512
TRAIN_MOE_LAYERS, TRAIN_MOE_BATCH, TRAIN_MOE_SEQ = 2, 4, 512
#: serve_moe_ep's mesh: tp 2 x ep 2, four ranks on card 0; its parity:
#: a prefill of 8 prompts of 300 ids and one decode step of the 8 rows
MOE_EP_PLAN = {"tp": 2, "ep": 2}
#: serve_moe_ep's pipeline mesh: two stages of two layers, each stage's
#: two ranks E/ep = 4 experts (tp 1: attention and the FFN's f whole)
MOE_PP_EP_PLAN = {"pp": 2, "ep": 2}
MOE_EP_PARITY_ROWS, MOE_EP_PARITY_IDS = 8, 300
#: the W8A16 products of a Mixtral rank at tp 2 (a decode step's, <= 64 rows):
#: wq, wk and wv, wo, lm_head; and its expert stacks at ep 2 (E = 4)
W8A16_EP_SHAPES = ((4096, 2048), (4096, 512), (2048, 4096), (4096, 16000))
W8A16_EP_EXPERT_SHAPES = ((4, 4096, 7168, True), (4, 7168, 4096, False))
#: the pp 2 x ep 2 mesh's: tp 1, so wq/wo, wk/wv and lm_head whole, and
#: the expert stacks at E = 4 over the whole f
W8A16_PP_EP_SHAPES = ((4096, 4096), (4096, 1024), (4096, 32000))
W8A16_PP_EP_EXPERT_SHAPES = ((4, 4096, 14336, True), (4, 14336, 4096, False))


def rows_parity(torch, logits, oracle, layers: int, limit: float) -> dict:
    """A block of rows ``logits`` [n, vocab] against the oracle's: the
    block's rel-L2 (the rows' RMS, where the predicted band applies: one
    row's figure spreads about it) under ``limit``, and every row's
    argmax the oracle's unless the oracle's top-2 margin there lies inside
    the path's expected error (:func:`parity_gate`'s exemption, at the
    block's rel-L2). The rows' own rel-L2 are printed, not gated."""
    whole = ((logits - oracle).norm() / oracle.norm()).item()
    rel = (logits - oracle).norm(dim=-1) / oracle.norm(dim=-1)
    top = oracle.topk(2, dim=-1).values
    margin = top[:, 0] - top[:, 1]
    tie = ARGMAX_TIE_SIGMAS * 2 ** 0.5 * whole * oracle.pow(2).mean(-1).sqrt()
    agree = logits.argmax(-1) == oracle.argmax(-1)
    bad = (~agree & ~(margin < tie)).nonzero()[:, 0].tolist()
    refused = [f"rel_l2 {whole:.4e} > {limit:.4e}"] if not whole <= limit else []
    refused += [f"row {i}: argmax differs from the oracle's at a margin of {margin[i].item():.4e} (exempt under "
                f"{tie[i].item():.4e})" for i in bad]
    return {"rows": oracle.shape[0], "rel_l2": whole, "row_rel_l2_max": rel.max().item(),
            "row_rel_l2_median": rel.median().item(), "argmax_equal_rows": int(agree.sum()),
            "near_ties_exempt": int((~agree).sum()) - len(bad), "limit_rel_l2": limit, "refused": refused}


def greedy_against_oracle(torch, model, prompts: list, outs: list, limit: float) -> dict:
    """Greedy completions held against the fp32 oracle of ``model``,
    teacher-forced on the completions: at each generated position the
    oracle's argmax must be the token, unless the oracle's top-2 margin
    lies inside the path's expected error there (the tie exemption of
    :func:`parity_gate`). Returns the counts and the refusals."""
    checked = exempt = 0
    refused = []
    for i, (p, out) in enumerate(zip(prompts, outs)):
        ids = torch.tensor(p + out[:-1], dtype=torch.int32, device="cuda")
        rows = list(range(len(p) - 1, len(p) - 1 + len(out)))
        lg = oracle_logits(torch, model, ids, rows)
        for j, tok in enumerate(out):
            checked += 1
            top = lg[j].topk(2)
            if int(top.indices[0]) == tok:
                continue
            tie = ARGMAX_TIE_SIGMAS * 2 ** 0.5 * limit * lg[j].pow(2).mean().sqrt().item()
            margin = (top.values[0] - lg[j, tok]).item()
            if margin < tie:
                exempt += 1
            else:
                refused.append(f"completion {i} position {j}: token {tok} is {margin:.4e} under the oracle's top "
                               f"(exempt under {tie:.4e})")
        del lg
    return {"tokens_checked": checked, "near_ties_exempt": exempt, "refused": refused}


def train_phase(torch, smi: str) -> dict:
    """``models/train.py`` at Llama-3-8B's full size on the card: seeded
    random bf16 weights drawn on the card, three AdamW steps with remat on
    one batch (``TRAIN_*``); ``forward_train`` and the serving prefill
    (the prefill kernel) on row 0's first ids held to the fp32 oracle;
    then fine-tune-then-serve: the gradients and the optimizer state
    freed, an engine built from the trained parameters serving four
    greedy completions through its captured decode chunks, held to the
    oracle of the trained weights. Reports the losses, each step's ms and
    tokens/s, the share of 989 TF/s that 6 N T plus remat's 2 N T make,
    and the peak allocated bytes."""
    import numpy as np

    from llm_d_fast_model_actuation_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from llm_d_fast_model_actuation_tpu_torch.models import llama, train

    t_phase = time.monotonic()
    free_memory(torch)
    cfg = llama.LlamaConfig.llama3_8b()
    n_params = sum(math.prod(s) for s in llama.param_shapes(cfg).values())
    free = torch.cuda.mem_get_info()[0]
    need = 4 * 2 * n_params  # bf16 parameters, gradients and both moments
    if free < need:
        raise AssertionError(f"the card has {free} bytes free, training Llama-3-8B needs {need} beside activations")
    torch.cuda.reset_peak_memory_stats()
    model = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    params = dict(model.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), generator=gen, device="cuda", dtype=torch.int32)
    seq_lens = torch.tensor(TRAIN_SEQ_LENS, dtype=torch.int32, device="cuda")
    limit = parity_limit(cfg.num_layers)

    # the training forward and the serving prefill against the oracle
    n = TRAIN_PARITY_IDS
    ids = tokens[0, :n]
    with torch.no_grad():
        fwd = train.forward_train(params, cfg, ids[None], torch.tensor([n], device="cuda"), remat=False)[0]
        ps = 16
        pages = TRAIN_PARITY_BUCKET // ps
        kv = tuple(torch.zeros((cfg.num_layers, pages + 1, ps, cfg.num_kv_heads, cfg.head_dim), dtype=cfg.dtype,
                               device="cuda") for _ in range(2))
        padded = torch.zeros((1, TRAIN_PARITY_BUCKET), dtype=torch.int32, device="cuda")
        padded[0, :n] = ids
        pt = torch.arange(1, pages + 1, dtype=torch.int32, device="cuda")[None]
        served = llama.prefill(model, padded, torch.tensor([n], dtype=torch.int32, device="cuda"), kv, pt)[0, :n]
        del kv
        oracle = oracle_logits(torch, model, ids, list(range(n)))
    parity = {"forward_train": rows_parity(torch, fwd, oracle, cfg.num_layers, limit),
              "serving_prefill": rows_parity(torch, served, oracle, cfg.num_layers, limit),
              "forward_train_vs_serving_rel_l2": ((fwd - served).norm() / served.norm()).item()}
    del fwd, served, oracle
    refused = parity["forward_train"]["refused"] + parity["serving_prefill"]["refused"]
    if refused:
        emit({"phase": "train", "parity": parity})
        raise AssertionError(f"training's forward or the serving prefill breaks the oracle gate: {refused[:8]}")

    # three steps
    state = train.make_train_state(params)
    losses, step_ms, allocator = [], [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, metrics = train.train_step(state, cfg, tokens, seq_lens)
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
        losses.append(metrics["loss"].item())
        st = torch.cuda.memory_stats()
        # cudaMalloc calls and the retries after freeing the cache, so far
        allocator.append({"device_allocs": st.get("num_device_alloc"), "alloc_retries": st.get("num_alloc_retries")})
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses) or state.step != TRAIN_STEPS:
        raise AssertionError(f"training: losses {losses}, step {state.step} (want {TRAIN_STEPS} finite)")
    T = TRAIN_BATCH * TRAIN_SEQ
    flops = (6 + 2) * n_params * T
    best = min(step_ms) / 1e3

    # fine-tune-then-serve: drop the optimizer state, serve the trained weights
    trained = state.params
    del state, metrics, model, params
    free_memory(torch)
    # the counts read below are the serving path's alone: the engine's probe
    # and warm-ups, its prefills and its decode chunks
    reset_counts()
    eng = InferenceEngine(EngineConfig(model=cfg, max_batch=8, num_pages=1024, prefix_caching=False),
                          params=trained, device="cuda")
    del trained
    free_memory(torch)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, k).tolist() for k in TRAIN_SERVE_LENS]
    t0 = time.monotonic()
    outs = eng.generate(prompts, max_new_tokens=TRAIN_SERVE_NEW)
    serve_s = time.monotonic() - t0
    counts = path_counts(eng)
    check_probe_launch(counts)
    check_replays(eng, counts, "decode_inline")
    L = cfg.num_layers
    launches = {"decode_steps": eng.decode_steps, "cold_prefills": eng.cold_prefills,
                **{k: v for k, v in counts.items() if not isinstance(v, dict)}}
    if (counts["decode_inline"] != L * eng.decode_steps or counts["prefill"] != L * eng.cold_prefills
            or eng.cold_prefills < len(prompts)):
        emit({"phase": "train", "serve_launches": launches})
        raise AssertionError(f"the trained weights' serving launches {counts} against {eng.decode_steps} decode "
                             f"steps and {eng.cold_prefills} cold prefills (want >= {len(prompts)})")
    if counts["ragged"] or counts["ragged_sharded"] or counts["decode_scatter_first"]:
        emit({"phase": "train", "serve_launches": launches})
        raise AssertionError(f"the trained weights' bucketed serving launched kernels off its path: {counts}")
    served = greedy_against_oracle(torch, eng.model, prompts, outs, limit)
    out = {
        "phase": "train", "model": "llama3-8b", "layers": cfg.num_layers, "params": n_params,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "seq_lens": list(TRAIN_SEQ_LENS), "remat": True,
        "optimizer": "adamw lr 3e-4 wd 0.01, one leaf (a stacked leaf one layer view) at a time",
        "losses": losses, "step": TRAIN_STEPS, "step_ms": step_ms, "tokens_per_s": [T / (ms / 1e3) for ms in step_ms],
        "flops_per_step_8NT": flops, "share_of_989_tflops": flops / best / PEAK_BF16_FLOPS,
        "peak_allocated_bytes": peak, "allocator_after_each_step": allocator, "parity": parity,
        "serve": {"prompt_lens": list(TRAIN_SERVE_LENS), "new_tokens": TRAIN_SERVE_NEW, "seconds": serve_s,
                  **graph_stats(eng), "launches": launches, "against_fp32_oracle": served},
    }
    del eng
    free_memory(torch)
    out["seconds"] = time.monotonic() - t_phase
    emit(out)
    if served["refused"]:
        raise AssertionError(f"the trained weights' greedy completions break the oracle gate: {served['refused'][:8]}")
    return {"counts": counts}


def step_against(torch, mesh_state, one_state, before: dict, losses: tuple) -> dict:
    """A mesh step against one rank's from the same state (both whole, on
    the card): the loss, adamw's first moment and the update, and whether
    each holds its limit (``MESH_*``; the caller raises after it prints
    them)."""
    def rel(a, b):
        num = sum((a[k].float() - b[k].float()).pow(2).sum() for k in b)
        den = sum(b[k].float().pow(2).sum() for k in b)
        return (num / den).sqrt().item()

    mu = rel(mesh_state["mu"], one_state["mu"])
    d_mesh = {k: mesh_state["params"][k].float() - before[k].float() for k in before}
    d_one = {k: one_state["params"][k].float() - before[k].float() for k in before}
    upd = rel(d_mesh, d_one)
    del d_mesh, d_one
    loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
    out = {"loss_mesh": losses[0], "loss_one_rank": losses[1], "loss_rel_diff": loss_rel, "mu_rel_l2": mu,
           "update_rel_l2": upd, "limits": {"loss_rel": MESH_LOSS_RTOL, "mu_rel_l2": MESH_MU_REL_L2,
                                            "update_rel_l2": MESH_UPDATE_REL_L2}}
    out["held"] = loss_rel <= MESH_LOSS_RTOL and mu <= MESH_MU_REL_L2 and upd <= MESH_UPDATE_REL_L2
    return out


def mesh_step(torch, cfg, params: dict, tokens, seq_lens, plan: dict) -> tuple:
    """One ``train_step`` on ``MeshPlan(**plan)`` with every rank on card
    0, from a sharded copy of ``params``; returns its loss, the whole
    updated parameters and first moment, and the step's ms."""
    from llm_d_fast_model_actuation_tpu_torch.models import train
    from llm_d_fast_model_actuation_tpu_torch.parallel.mesh import MeshPlan, make_mesh

    p = MeshPlan(**plan)
    mesh = make_mesh(p, ["cuda:0"] * p.size)
    state = train.make_train_state(train.shard_train_params(params, cfg, mesh))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    state, m = train.train_step(state, cfg, tokens, seq_lens, mesh=mesh)
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) * 1e3
    whole = {"params": train.unshard_train_params(state.params, cfg, mesh, "cuda"),
             "mu": train.unshard_train_params(state.opt_state.mu, cfg, mesh, "cuda")}
    loss = m["loss"].item()
    del state, m
    free_memory(torch)
    return loss, whole, ms


def one_rank_step(torch, cfg, params: dict, tokens, seq_lens) -> tuple:
    from llm_d_fast_model_actuation_tpu_torch.models import train

    state = train.make_train_state(params)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    state, m = train.train_step(state, cfg, tokens, seq_lens)
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) * 1e3
    out = {"params": state.params, "mu": state.opt_state.mu}
    return m["loss"].item(), out, ms


def ring_against_dense(torch, model, tokens, seq_lens, mesh) -> dict:
    """Layer 0's attention over ``tokens`` [1, s] as the ring over the
    mesh's ``sp`` ranks (each rank its chunk of the sequence and its
    ``tp`` slice of the heads) against the dense function, both in f32."""
    from llm_d_fast_model_actuation_tpu_torch.models import llama
    from llm_d_fast_model_actuation_tpu_torch.ops.attention import dense_causal_attention
    from llm_d_fast_model_actuation_tpu_torch.ops.ring_attention import ring_prefill_attention

    cfg = model.cfg
    s = tokens.shape[1]
    with torch.no_grad():
        lp = model.layer(0)
        x = llama._embed_tokens(model, tokens)
        h = llama._norm(cfg, x, lp["attn_norm"])
        pos = torch.arange(s, device="cuda")[None]
        q, k, v = (t.float() for t in llama._project_qkv(model, lp, h, pos))
        dense = dense_causal_attention(q, k, v, seq_lens)
        sp, tp = mesh.shape["sp"], mesh.shape["tp"]
        c, hq, hk = s // sp, cfg.num_heads // tp, cfg.num_kv_heads // tp

        def part(t, r, heads):
            i, j = mesh.index(r, "sp"), mesh.index(r, "tp")
            return t[:, i * c:(i + 1) * c, j * heads:(j + 1) * heads].contiguous()

        ring = ring_prefill_attention([part(q, r, hq) for r in range(mesh.size)],
                                      [part(k, r, hk) for r in range(mesh.size)],
                                      [part(v, r, hk) for r in range(mesh.size)],
                                      mesh.replicate(seq_lens), mesh)
        err = max((ring[r] - part(dense, r, hq)).abs().max().item() for r in range(mesh.size))
    if not err <= RING_F32_ATOL:
        raise AssertionError(f"layer 0's ring attention in f32 is {err:.3e} off the dense function (limit "
                             f"{RING_F32_ATOL})")
    return {"max_abs_err": err, "atol": RING_F32_ATOL, "seq": s, "sp": sp, "tp": tp}


def train_mesh_phase(torch, smi: str) -> dict:
    """Llama-3-8B widths at ``TRAIN_MESH_LAYERS`` layers on ``MeshPlan(sp=2,
    tp=2)``, four ranks on the card (the JAX dry run's 4-device plan): one
    step on one row of ``TRAIN_MESH_SEQ`` ids (2048 a sp rank) against the
    same step on one rank from the same seed (:func:`step_against`), and
    layer 0's ring in f32 against the dense attention."""
    from llm_d_fast_model_actuation_tpu_torch.models import llama
    from llm_d_fast_model_actuation_tpu_torch.parallel.mesh import MeshPlan, make_mesh

    t_phase = time.monotonic()
    free_memory(torch)
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=TRAIN_MESH_LAYERS)
    model = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(3), "cuda")
    params = dict(model.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (1, TRAIN_MESH_SEQ), generator=gen, device="cuda", dtype=torch.int32)
    seq_lens = torch.tensor([TRAIN_MESH_SEQ], dtype=torch.int32, device="cuda")
    plan = {"sp": 2, "tp": 2}
    mesh = make_mesh(MeshPlan(**plan), ["cuda:0"] * 4)
    ring = ring_against_dense(torch, model, tokens, seq_lens, mesh)
    before = {k: v.clone() for k, v in params.items()}
    loss_m, whole_m, ms_m = mesh_step(torch, cfg, params, tokens, seq_lens, plan)
    # the pipeline: two stages of two layers, each with its tp 2 ranks (from
    # the same state: the one-rank step below updates ``params`` in place)
    pp_plan = {"pp": 2, "tp": 2}
    loss_p, whole_p, ms_p = mesh_step(torch, cfg, params, tokens, seq_lens, pp_plan)
    loss_1, whole_1, ms_1 = one_rank_step(torch, cfg, params, tokens, seq_lens)
    figures = step_against(torch, whole_m, whole_1, before, (loss_m, loss_1))
    figures_pp = step_against(torch, whole_p, whole_1, before, (loss_p, loss_1))
    del model, params, before, whole_m, whole_p, whole_1
    free_memory(torch)
    out = {"phase": "train_mesh", "model": "llama3-8b", "layers": cfg.num_layers, "mesh": plan,
           "devices": ["cuda:0"] * 4, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "batch": 1, "seq": TRAIN_MESH_SEQ, "step_ms": {"mesh": ms_m, "pp_mesh": ms_p, "one_rank": ms_1},
           "against_one_rank": figures, "pp_mesh": pp_plan, "pp_against_one_rank": figures_pp,
           "ring_vs_dense_f32": ring, "seconds": time.monotonic() - t_phase}
    emit(out)
    if not figures["held"] or not figures_pp["held"]:
        raise AssertionError(f"a mesh step differs from one rank's: sp x tp {figures}, pp x tp {figures_pp}")
    return out


def train_moe_phase(torch, smi: str) -> dict:
    """Mixtral-8x7B widths at ``TRAIN_MOE_LAYERS`` layers on ``MeshPlan(dp=2,
    ep=2)`` (the reference test's mesh), four ranks on the card: one step
    on ``TRAIN_MOE_BATCH`` rows of ``TRAIN_MOE_SEQ`` ids against the same
    step on one rank (:func:`step_against`)."""
    from llm_d_fast_model_actuation_tpu_torch.models import llama, moe

    t_phase = time.monotonic()
    free_memory(torch)
    cfg = dataclasses.replace(moe.MoeConfig.mixtral_8x7b(), num_layers=TRAIN_MOE_LAYERS)
    model = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(5), "cuda")
    params = dict(model.state_dict())
    n_params = sum(p.numel() for p in params.values())
    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_MOE_BATCH, TRAIN_MOE_SEQ), generator=gen, device="cuda",
                           dtype=torch.int32)
    seq_lens = torch.tensor([TRAIN_MOE_SEQ, TRAIN_MOE_SEQ - 100, TRAIN_MOE_SEQ, 300], dtype=torch.int32, device="cuda")
    plan = {"dp": 2, "ep": 2}
    before = {k: v.clone() for k, v in params.items()}
    loss_m, whole_m, ms_m = mesh_step(torch, cfg, params, tokens, seq_lens, plan)
    loss_1, whole_1, ms_1 = one_rank_step(torch, cfg, params, tokens, seq_lens)
    figures = step_against(torch, whole_m, whole_1, before, (loss_m, loss_1))
    del model, params, before, whole_m, whole_1
    free_memory(torch)
    out = {"phase": "train_moe", "model": "mixtral-8x7b", "layers": cfg.num_layers, "params": n_params,
           "mesh": plan, "devices": ["cuda:0"] * 4, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "batch": TRAIN_MOE_BATCH, "seq": TRAIN_MOE_SEQ, "step_ms": {"mesh": ms_m, "one_rank": ms_1},
           "against_one_rank": figures, "seconds": time.monotonic() - t_phase}
    emit(out)
    if not figures["held"]:
        raise AssertionError(f"the dp x ep step differs from one rank's: {figures}")
    return out


def moe_logits_and_routes(torch, model, prompts, caches, pt) -> tuple:
    """The bucketed prefill at ``n - 1`` of ``prompts`` [B, n] and one
    inline decode step of their argmax tokens at ``n`` (B rows: the W8A16
    kernels at a decode step's rows) of an MoE ``model`` (one rank or a
    mesh, on fresh ``caches``, ``pt`` [B, pages]), each layer's routing
    recorded (rank 0's: every rank of a mesh routes the same replicated
    rows, which is checked). Returns the prefill and decode logits [B,
    vocab], the decoded tokens, and each row's routes by layer."""
    from llm_d_fast_model_actuation_tpu_torch.engine.engine import prefill_bucket
    from llm_d_fast_model_actuation_tpu_torch.models import llama, moe

    cfg = model.cfg
    B, n = prompts.shape
    # the ranks that route each layer: every rank of a mesh, a stage's with pp
    ranks = 1 if not isinstance(model, llama.ShardedLlama) else model.mesh.size // model.mesh.pp
    bucket = prefill_bucket(n, cfg.max_seq_len)
    tokens = torch.zeros((B, bucket), dtype=torch.int32, device="cuda")
    tokens[:, :n] = prompts
    recorded = []
    plain_route = moe.route

    def recording(cfg_, router, x):
        idx, probs = plain_route(cfg_, router, x)
        recorded.append(idx)
        return idx, probs

    lens = torch.full((B,), n, dtype=torch.int32, device="cuda")
    moe.route = recording
    try:
        with torch.no_grad():
            pre = llama.prefill(model, tokens, lens, caches, pt)[:, n - 1]
            nxt = pre.argmax(-1).to(torch.int32)
            dec = llama.decode_step(model, nxt, lens, caches, pt)
    finally:
        moe.route = plain_route
    L = cfg.num_layers
    if len(recorded) != 2 * L * ranks:
        raise AssertionError(f"the MoE forward routed {len(recorded)} times, want {2 * L * ranks}")
    for i in range(0, len(recorded), ranks):
        if any(not torch.equal(recorded[i], recorded[i + r]) for r in range(1, ranks)):
            raise AssertionError("the ranks of the mesh routed the same rows apart")
    rank0 = recorded[::ranks]
    routes = [[torch.cat([rank0[i][b * bucket:b * bucket + n], rank0[L + i][b:b + 1]]) for i in range(L)]
              for b in range(B)]
    return pre, dec, nxt, routes


def moe_ep_parity_limit(layers: int) -> float:
    """The top of the tp 2 x ep 2 int8 path's band: :func:`moe_parity_limit`'s
    roundings and one more a layer, the bf16 sum of ``wo``'s two row
    halves (its FFN partials are summed in f32 and rounded once, as one
    rank rounds them; each half's product rounds half the magnitude, so
    two halves weigh one rounding)."""
    return ROUNDING_RMS * ((MOE_INT8_ROUNDINGS_PER_LAYER + 1) * layers + 4) ** 0.5


def moe_ep_ratio_limit(layers: int) -> float:
    """The limit of the ep path's rel-L2 over the one-rank path's: the
    ``L`` ``wo`` sums at full weight against one rank at the band's bottom
    (``2 L + 2`` roundings), as :func:`tp_ratio_limit` counts the dense
    tp 2 path's ``2 L``."""
    return ((3 * layers + 2) / (2 * layers + 2)) ** 0.5


def serve_moe_ep(torch, smi: str) -> dict:
    """Mixtral-8x7B at ``MOE_PARITY_LAYERS`` layers and full width under
    int8 on ``MeshPlan(tp=2, ep=2)``, four ranks on the card (each holding
    E/ep = 4 experts and its tp half of attention), against the same model
    on one rank (same seed): the serve mix's four greedy completions, the
    mesh's counts read right after them (the W8A16 expert kernel at E = 4);
    then both paths' prefill and decode logits held to the fp32 oracle of
    the quantized weights routed as each path routed, and where the
    completions part, the one-rank logits' top-2 margin inside the tie
    exemption."""
    import numpy as np

    from llm_d_fast_model_actuation_tpu_torch.engine.engine import EngineConfig, InferenceEngine, prefill_bucket
    from llm_d_fast_model_actuation_tpu_torch.models import llama, moe
    from llm_d_fast_model_actuation_tpu_torch.parallel.mesh import MeshPlan, make_mesh

    t_phase = time.monotonic()
    free_memory(torch)
    cfg = dataclasses.replace(moe.MoeConfig.mixtral_8x7b(), num_layers=MOE_PARITY_LAYERS, quantization="int8")
    ecfg = EngineConfig(model=cfg, max_batch=8, num_pages=1024, prefix_caching=False)
    plan = MeshPlan(**MOE_EP_PLAN)
    mesh = make_mesh(plan, ["cuda:0"] * plan.size)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, k).tolist() for k in TRAIN_SERVE_LENS]
    reset_counts()
    eng = InferenceEngine(ecfg, seed=5, mesh=mesh)
    t0 = time.monotonic()
    ep_out = eng.generate(prompts, max_new_tokens=TRAIN_SERVE_NEW)
    torch.cuda.synchronize()
    ep_s = time.monotonic() - t0
    counts = read_counts()
    check_probe_launch(counts)
    by_shape = {"w8a16": dict(counts["w8a16_by_shape"]), "w8a16_experts": dict(counts["w8a16_experts_by_shape"])}
    for key, shapes in (("w8a16", [f"{K}x{N}" for K, N in W8A16_EP_SHAPES]),
                        ("w8a16_experts", [f"{E}x{K}x{N}" for E, K, N, _ in W8A16_EP_EXPERT_SHAPES])):
        if any(not by_shape[key].get(k) for k in shapes) or set(by_shape[key]) - set(shapes):
            raise AssertionError(f"the ep mesh launched {key} at {by_shape[key]}, want {shapes} (E = 4) only")
    # the pipeline mesh: the same model in two stages, its counts read right
    # after its generate as the ep mesh's are
    pp_plan = MeshPlan(**MOE_PP_EP_PLAN)
    reset_counts()
    eng_pp = InferenceEngine(ecfg, seed=5, mesh=make_mesh(pp_plan, ["cuda:0"] * pp_plan.size))
    t0 = time.monotonic()
    pp_out = eng_pp.generate(prompts, max_new_tokens=TRAIN_SERVE_NEW)
    torch.cuda.synchronize()
    pp_s = time.monotonic() - t0
    pp_counts = read_counts()
    check_probe_launch(pp_counts)
    pp_by_shape = {"w8a16": dict(pp_counts["w8a16_by_shape"]), "w8a16_experts": dict(pp_counts["w8a16_experts_by_shape"])}
    for key, shapes in (("w8a16", [f"{K}x{N}" for K, N in W8A16_PP_EP_SHAPES]),
                        ("w8a16_experts", [f"{E}x{K}x{N}" for E, K, N, _ in W8A16_PP_EP_EXPERT_SHAPES])):
        if any(not pp_by_shape[key].get(k) for k in shapes) or set(pp_by_shape[key]) - set(shapes):
            raise AssertionError(f"the pp x ep mesh launched {key} at {pp_by_shape[key]}, want {shapes} only")
    per_stage = pp_plan.size // pp_plan.pp  # each layer's attention runs on its stage's ep ranks
    if pp_counts["decode_inline"] != cfg.num_layers * per_stage * eng_pp.decode_steps or eng_pp.decode_steps == 0:
        raise AssertionError(f"the pp x ep mesh's decode launches {pp_counts['decode_inline']} != {cfg.num_layers} x "
                             f"{per_stage} x {eng_pp.decode_steps} decode steps")
    one = InferenceEngine(ecfg, seed=5, device="cuda")
    t0 = time.monotonic()
    one_out = one.generate(prompts, max_new_tokens=TRAIN_SERVE_NEW)
    torch.cuda.synchronize()
    one_s = time.monotonic() - t0
    if not torch.equal(eng.model.ranks[0].layers["router"], one.model.layers["router"]):
        raise AssertionError("the mesh and the one-rank engine drew different routers from one seed")
    if not torch.equal(eng_pp.model.ranks[2].layers["router"], one.model.layers["router"][cfg.num_layers // 2:]):
        raise AssertionError("the pp x ep mesh's second stage does not hold the one-rank engine's last layers")

    # both paths' logits against the oracle: a prefill and a decode step of
    # MOE_EP_PARITY_ROWS sequences, the block of rows gated (rows_parity)
    B, n = MOE_EP_PARITY_ROWS, MOE_EP_PARITY_IDS
    gen = torch.Generator(device="cuda").manual_seed(8)
    batch = torch.randint(0, cfg.vocab_size, (B, n), generator=gen, device="cuda", dtype=torch.int32)
    ps = 16
    per = -(-(n + 1) // ps)
    shape = (cfg.num_layers, B * per + 1, ps, cfg.num_kv_heads, cfg.head_dim)
    pt = torch.arange(1, B * per + 1, dtype=torch.int32, device="cuda").reshape(B, per)

    def pool(kvh, layers=cfg.num_layers):
        return tuple(torch.zeros((layers,) + shape[1:3] + (kvh,) + shape[4:], dtype=cfg.dtype, device="cuda")
                     for _ in range(2))

    paths = {"one_rank": moe_logits_and_routes(torch, one.model, batch, pool(cfg.num_kv_heads), pt),
             "ep_mesh": moe_logits_and_routes(torch, eng.model, batch,
                                              [pool(cfg.num_kv_heads // plan.tp) for _ in range(plan.size)], pt),
             "pp_ep_mesh": moe_logits_and_routes(torch, eng_pp.model, batch,
                                                 [pool(cfg.num_kv_heads, cfg.num_layers // pp_plan.pp)
                                                  for _ in range(pp_plan.size)], pt)}
    L = cfg.num_layers
    # the pp x ep path rounds as the ep one at most (tp 1: no wo halves)
    limits = {"one_rank": moe_parity_limit(L), "ep_mesh": moe_ep_parity_limit(L), "pp_ep_mesh": moe_ep_parity_limit(L)}
    figures, differ = {}, {}
    for name, (pre, dec, nxt, routes) in paths.items():
        oracle = torch.empty((2, B, cfg.vocab_size), dtype=torch.float32, device="cuda")
        share = 0.0
        for b in range(B):
            o, d = moe_oracle_logits(torch, Dequantized(one.model), torch.cat([batch[b], nxt[b:b + 1]]),
                                     [n - 1, n], routes[b])
            oracle[:, b] = o
            share += d / B
        differ[name] = share
        figures[f"prefill_{name}"] = rows_parity(torch, pre, oracle[0], L, limits[name])
        figures[f"decode_inline_{name}"] = rows_parity(torch, dec, oracle[1], L, limits[name])
        del oracle
    del paths
    refused = [f"{k}: {r}" for k, f in figures.items() for r in f["refused"]]
    ratio_limit = moe_ep_ratio_limit(L)
    ratios = {f"{k}_{m}": figures[f"{k}_{m}"]["rel_l2"] / figures[f"{k}_one_rank"]["rel_l2"]
              for k in ("prefill", "decode_inline") for m in ("ep_mesh", "pp_ep_mesh")}
    refused += [f"{k}: {r:.3f} x one rank's rel_l2 > {ratio_limit:.3f}" for k, r in ratios.items()
                if not r <= ratio_limit]
    limit = limits["one_rank"]

    # where the greedy completions part: a near-tie of the one-rank logits
    parts = []
    parted = [(name, i, a, b) for name, outs in (("ep_mesh", ep_out), ("pp_ep_mesh", pp_out))
              for i, (a, b) in enumerate(zip(outs, one_out))]
    for name, i, a, b in parted:
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        ids = prompts[i] + b[:j]
        m = len(ids)
        pages_m = -(-m // ps)
        kv = tuple(torch.zeros(shape[:1] + (pages_m + 1,) + shape[2:], dtype=cfg.dtype, device="cuda")
                   for _ in range(2))
        x = torch.zeros((1, prefill_bucket(m, cfg.max_seq_len)), dtype=torch.int32, device="cuda")
        x[0, :m] = torch.tensor(ids, dtype=torch.int32, device="cuda")
        with torch.no_grad():
            lg = llama.prefill(one.model, x, torch.tensor([m], dtype=torch.int32, device="cuda"), kv,
                               torch.arange(1, pages_m + 1, dtype=torch.int32, device="cuda")[None])[0, m - 1]
        tie = ARGMAX_TIE_SIGMAS * 2 ** 0.5 * limit * lg.pow(2).mean().sqrt().item()
        gap = (lg[b[j]] - lg[a[j]]).item()
        parts.append({"mesh": name, "completion": i, "position": j, "logit_gap": gap, "exempt_under": tie})
        if not abs(gap) < tie:
            refused.append(f"{name}: completion {i} parts at position {j} by {gap:.4e} (exempt under {tie:.4e})")
        del kv, lg
    steps = TRAIN_SERVE_NEW * len(prompts)
    out = {"phase": "serve_moe_ep", "model": "mixtral-8x7b", "quantization": "int8", "layers": L,
           "mesh": MOE_EP_PLAN, "devices": ["cuda:0"] * plan.size, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": smi, "experts_per_rank": cfg.num_experts // plan.ep,
           "generate_s": {"ep_mesh": ep_s, "pp_ep_mesh": pp_s, "one_rank": one_s}, "new_tokens": steps,
           "pp_ep_mesh": MOE_PP_EP_PLAN, "pp_ep_launches": {k: v for k, v in pp_counts.items() if not isinstance(v, dict)},
           "pp_ep_w8a16_launches_by_shape": pp_by_shape, "pp_ep_decode_steps": eng_pp.decode_steps,
           "tokens_equal_one_rank": ep_out == one_out, "pp_ep_tokens_equal_one_rank": pp_out == one_out,
           "parted": parts,
           "against_fp32_oracle": figures, "ep_over_one_rank": ratios, "ratio_limit": ratio_limit,
           "routing_decisions_fp32_would_change": differ, "w8a16_launches_by_shape": by_shape,
           "launches": {k: v for k, v in counts.items() if not isinstance(v, dict)},
           "note": "the mesh runs its chunks eagerly (a graph belongs to one device); the one-rank engine replays"}
    del eng, eng_pp, one
    free_memory(torch)
    out["seconds"] = time.monotonic() - t_phase
    emit(out)
    if refused:
        raise AssertionError(f"ep serving breaks the oracle gate: {refused}")
    return {"counts": sum_counts(counts, pp_counts), "by_shape": sum_counts(by_shape, pp_by_shape)}


#: serve_pp: the serve mix's four prompt lengths and its new tokens (16,
#: as serve_moe_ep takes: the meshes run their chunks eagerly); the
#: parity and timing block: 8 rows of 300 ids, then decode steps
PP_PROMPT_LENS, PP_NEW_TOKENS = (20, 300, 1500, 3000), 16
PP_PARITY_ROWS, PP_PARITY_IDS, PP_TIMED_STEPS = 8, 300, 5
PP_PLANS = {"pp2": {"pp": 2}, "pp2tp2": {"pp": 2, "tp": 2}}


def pp_engine(plan, packed: bool = False):
    """Llama-3-8B at full size, seed 0, on ``MeshPlan(**plan)`` with every
    rank on card 0 (``plan`` None: one rank)."""
    from llm_d_fast_model_actuation_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from llm_d_fast_model_actuation_tpu_torch.models.llama import LlamaConfig
    from llm_d_fast_model_actuation_tpu_torch.parallel.mesh import MeshPlan, make_mesh

    cfg = EngineConfig(model=LlamaConfig.llama3_8b(), max_batch=8, num_pages=2048, packed_serving=packed)
    if plan is None:
        return InferenceEngine(cfg, seed=0, device="cuda")
    p = MeshPlan(**plan)
    return InferenceEngine(cfg, seed=0, mesh=make_mesh(p, ["cuda:0"] * p.size))


def pp_serve(torch, plan, prompts: list, packed: bool = False) -> tuple:
    """A :func:`pp_engine` built with the counts at 0 and the prompts
    generated; returns the engine, its tokens, its counts (read right
    after the generate: the probe, the warm-ups and the serving path) and
    its figures, and the card's free bytes before it was built."""
    free_memory(torch)
    free_before = torch.cuda.mem_get_info()[0]
    reset_counts()
    t0 = time.monotonic()
    eng = pp_engine(plan, packed)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    t0 = time.monotonic()
    outs = eng.generate(prompts, max_new_tokens=PP_NEW_TOKENS)
    torch.cuda.synchronize()
    gen_s = time.monotonic() - t0
    counts = path_counts(eng)
    figures = {"init_s": init_s, "generate_s": gen_s, "decode_steps": eng.decode_steps,
               "cold_prefills": eng.cold_prefills, "packed_steps": eng.packed_steps, "mixed_impl": eng.mixed_impl,
               "launches": {k: v for k, v in counts.items() if not isinstance(v, dict) and k not in ("eager", "replayed")},
               "prefill_by_seq": counts["prefill_by_seq"], "ragged_by_rows": counts["ragged_by_rows"],
               **graph_stats(eng)}
    return eng, outs, counts, figures, free_before


def check_pp_launches(eng, counts: dict, packed: bool) -> None:
    """A mesh engine's launches (all eager): L x tp decode launches a
    decode step, and L x tp prefill launches a cold prefill (bucketed) or
    L ragged launches a packed step (packed, one rank a stage); one
    probe; nothing off the path."""
    mesh = eng.mesh
    L, tp = eng.cfg.model.num_layers, mesh.tp
    check_probe_launch(counts)
    want = {"decode_inline": L * tp * eng.decode_steps, "decode_scatter_first": 0, "ragged_sharded": 0}
    if packed:
        want.update(prefill=0, ragged=L * eng.packed_steps)
    else:
        want.update(prefill=L * tp * eng.cold_prefills, ragged=0)
    got = {k: counts[k] for k in want}
    if got != want or eng.decode_steps == 0 or (eng.packed_steps == 0 if packed else eng.cold_prefills < 4):
        raise AssertionError(f"{mesh}: launches {got}, want {want} ({eng.decode_steps} decode steps, "
                             f"{eng.cold_prefills} cold prefills, {eng.packed_steps} packed steps)")
    untimed = sorted(set(counts["ragged_by_rows"]) - set(RAGGED_ROWS))
    if untimed:
        raise AssertionError(f"{mesh}: the packed run launched ragged at untimed buffer sizes {untimed}")


def pp_logits(torch, model, batch) -> tuple:
    """A prefill of ``batch`` [B, n] (its head on row n - 1 alone, as the
    engine's cold prefill runs it) and one inline
    decode step of their argmax tokens (its logits) on fresh pools (one
    pair per rank: its stage's layers, its KV-head slice), then
    ``PP_TIMED_STEPS`` decode steps timed one by one; returns the two
    logits blocks and the median step's ms."""
    from llm_d_fast_model_actuation_tpu_torch.engine.engine import prefill_bucket
    from llm_d_fast_model_actuation_tpu_torch.models import llama

    cfg = model.cfg
    B, n = batch.shape
    ps = 16
    per = -(-(n + 2 + PP_TIMED_STEPS) // ps)
    pt = torch.arange(1, B * per + 1, dtype=torch.int32, device="cuda").reshape(B, per)

    def pair(layers, kvh):
        return tuple(torch.zeros((layers, B * per + 1, ps, kvh, cfg.head_dim), dtype=cfg.dtype, device="cuda")
                     for _ in range(2))

    if isinstance(model, llama.ShardedLlama):
        mesh = model.mesh
        caches = [pair(cfg.num_layers // mesh.pp, cfg.num_kv_heads // mesh.tp) for _ in range(mesh.size)]
    else:
        caches = pair(cfg.num_layers, cfg.num_kv_heads)
    tokens = torch.zeros((B, prefill_bucket(n, cfg.max_seq_len)), dtype=torch.int32, device="cuda")
    tokens[:, :n] = batch
    lens = torch.full((B,), n, dtype=torch.int32, device="cuda")
    times = []
    with torch.no_grad():
        pre = llama.prefill(model, tokens, lens, caches, pt, last_only=True)[:, 0]
        dec = llama.decode_step(model, pre.argmax(-1).to(torch.int32), lens, caches, pt)
        tok = dec.argmax(-1).to(torch.int32)
        for k in range(PP_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = llama.decode_step(model, tok, lens + 1 + k, caches, pt)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            tok = out.argmax(-1).to(torch.int32)
    del caches
    return pre, dec, sorted(times)[len(times) // 2]


def serve_pp(torch, smi: str) -> dict:
    """Llama-3-8B at full size on the pipeline axis (the module docstring's
    ``serve_pp``): ``pp`` 2 and ``pp`` 2 x ``tp`` 2 against one rank of the
    same seed, bucketed; one packed run and one level-1 sleep and wake on
    ``pp`` 2."""
    import numpy as np

    from llm_d_fast_model_actuation_tpu_torch.engine.sleep import attach_sleep

    t_phase = time.monotonic()
    from llm_d_fast_model_actuation_tpu_torch.models.llama import LlamaConfig

    rng = np.random.default_rng(11)
    vocab = LlamaConfig.llama3_8b().vocab_size
    prompts = [rng.integers(0, vocab, k).tolist() for k in PP_PROMPT_LENS]
    gen = torch.Generator(device="cuda").manual_seed(12)
    batch = torch.randint(0, vocab, (PP_PARITY_ROWS, PP_PARITY_IDS), generator=gen, device="cuda", dtype=torch.int32)
    refused, runs, out = [], [], {"phase": "serve_pp", "model": "llama3-8b", "device": torch.cuda.get_device_name(0),
                                  "nvidia_smi": smi, "prompt_lens": list(PP_PROMPT_LENS), "new_tokens": PP_NEW_TOKENS,
                                  "devices": "every rank on cuda:0"}

    # one rank: the tokens, the logits and the state's bytes every mesh is held to
    one, one_out, counts, figures, _ = pp_serve(torch, None, prompts)
    runs.append(counts)
    L = one.cfg.model.num_layers
    one_bytes = sum(p.numel() * p.element_size() for p in one.model.parameters()) + one.pool.nbytes()
    one_pre, one_dec, one_ms = pp_logits(torch, one.model, batch)
    out["one_rank"] = dict(figures, eager_decode_step_ms=one_ms, state_bytes=one_bytes)
    del one
    meshes = {}
    for name, plan in PP_PLANS.items():
        eng, outs, counts, figures, free_before = pp_serve(torch, plan, prompts)
        runs.append(counts)
        check_pp_launches(eng, counts, packed=False)
        pre, dec, ms = pp_logits(torch, eng.model, batch)
        diff = {"prefill": (pre - one_pre).abs().max().item(), "decode_inline": (dec - one_dec).abs().max().item()}
        row = dict(figures, plan=plan, eager_decode_step_ms=ms, logits_max_abs_diff_vs_one_rank=diff,
                   tokens_equal_one_rank=outs == one_out,
                   first_difference_from_one_rank=first_differences(outs, one_out),
                   wq_shapes=[tuple(m.layers["wq"].shape) for m in eng.model.ranks],
                   pool_shard_shapes=[tuple(k.shape) for k, _ in eng.pool.shards])
        if name == "pp2":
            if not (torch.equal(pre, one_pre) and torch.equal(dec, one_dec)):
                refused.append(f"pp 2's logits are not one rank's bits: largest differences {diff}")
            if outs != one_out:
                refused.append(f"pp 2's greedy tokens part from one rank's at {first_differences(outs, one_out)}")
            # one level-1 sleep and wake: the one-rank state's bytes, nothing
            # mapped asleep, the same tokens and addresses after the wake
            probe = prompts[1]
            before = eng.generate([probe], max_new_tokens=PP_NEW_TOKENS)[0]
            ptrs = state_ptrs(eng)
            free_memory(torch)  # the parity run's cached blocks go back first
            mgr = attach_sleep(eng)
            info = mgr.sleep(1)
            asleep = check_asleep(torch, eng, free_before)
            woke = mgr.wake_up()
            after = eng.generate([probe], max_new_tokens=PP_NEW_TOKENS)[0]
            del mgr  # its pinned host copies go with it
            row["sleep_wake"] = {"bytes_offloaded": info["bytes_offloaded"], "bytes_one_rank": one_bytes,
                                 "sleep_s": info.get("last_sleep_seconds"), "wake_s": woke.get("last_wake_seconds"),
                                 **asleep, "tokens_identical": after == before,
                                 "state_addresses_unchanged": state_ptrs(eng) == ptrs, "addresses": len(ptrs)}
            if info["bytes_offloaded"] != one_bytes:
                refused.append(f"pp 2 offloaded {info['bytes_offloaded']} bytes, one rank's state is {one_bytes}")
            if after != before or state_ptrs(eng) != ptrs:
                refused.append(f"pp 2's level-1 cycle changed the tokens ({before[:4]} -> {after[:4]}) or addresses")
        meshes[name] = (outs, row)
        out[name] = row
        del eng, pre, dec
    # pp 2 x tp 2 reorders the row-parallel sums as tp 2 does: where it parts
    # from one rank, it is held to a tp 2 engine of the same seed
    outs, row = meshes["pp2tp2"]
    if outs != one_out:
        tp2, tp2_out, counts, figures, _ = pp_serve(torch, {"tp": 2}, prompts)
        runs.append(counts)
        check_pp_launches(tp2, counts, packed=False)
        row["tp2_engine"] = dict(figures, tokens_equal_one_rank=tp2_out == one_out)
        row["tokens_equal_tp2"] = outs == tp2_out
        if outs != tp2_out:
            refused.append(f"pp 2 x tp 2's greedy tokens part from tp 2's at {first_differences(outs, tp2_out)}")
        del tp2
    # one packed run on pp 2 against one rank's packed engine
    one_p, one_p_out, counts, figures, _ = pp_serve(torch, None, prompts, packed=True)
    runs.append(counts)
    out["one_rank_packed"] = figures
    del one_p
    eng, outs, counts, figures, _ = pp_serve(torch, PP_PLANS["pp2"], prompts, packed=True)
    runs.append(counts)
    check_pp_launches(eng, counts, packed=True)
    out["pp2_packed"] = dict(figures, tokens_equal_one_rank_packed=outs == one_p_out,
                             first_difference=first_differences(outs, one_p_out))
    if outs != one_p_out:
        refused.append(f"pp 2's packed tokens part from one rank's at {first_differences(outs, one_p_out)}")
    del eng
    free_memory(torch)
    total = runs[0]
    for c in runs[1:]:
        total = sum_counts(total, c)
    out["seconds"] = time.monotonic() - t_phase
    out["refused"] = refused
    emit(out)
    if refused:
        raise AssertionError(f"serve_pp: {refused}")
    return {"counts": total}


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
    w8 = check_w8a16(torch, gen)
    emit({"phase": "kernel_check", "kernel": "w8a16", "checks": w8, "nvidia_smi": smi})
    if any(k["int8pack_ms"] is None for k in w8):
        has = torch._C._dispatch_has_kernel_for_dispatch_key("aten::_weight_int8pack_mm", "CUDA")
        emit({"phase": "note", "int8pack_ms": "null: " + ("the call refused some shapes" if has else
                                                          "this PyTorch has no CUDA kernel for aten::_weight_int8pack_mm")})
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
        int8 = serve_int8(torch, smi, bucketed, swapped)
        zero_drain = zero_drain_phase(torch, smi, ckpt, swapped)
        migrated = migrate_phase(torch, smi, ckpt)
        coresident = coresident_phase(torch, smi, ckpt, swapped)
        co_engine = coresident_engine(torch, smi, ckpt)
    finally:
        shutil.rmtree(ckpt)
        for suffix in ("-sibling", "-sibling2"):
            shutil.rmtree(ckpt.rstrip("/") + suffix, ignore_errors=True)
    # an Orbax checkpoint of serve's weights, once the Hugging Face ones
    # are gone (their disk is its)
    orbax = orbax_phase(torch, smi, bucketed, hf)
    dual = dualpods_phase(torch, smi, bucketed, launched)
    speculative_phase(torch, smi)
    pipeline_phase(torch, smi)
    # the MoE family, every earlier engine stopped and its pinned memory
    # given back
    w8_experts = check_w8a16_experts(torch, gen)
    emit({"phase": "kernel_check", "kernel": "w8a16_experts", "checks": w8_experts, "nvidia_smi": smi})
    moe = serve_moe(torch, smi)
    serve_moe_hf(torch, smi)
    moe_ep = serve_moe_ep(torch, smi)
    # training, every engine before it stopped: the card's memory is its
    trained = train_phase(torch, smi)
    train_mesh_phase(torch, smi)
    train_moe_phase(torch, smi)
    staged = serve_pp(torch, smi)
    packed = serve_packed(torch, smi, bucketed)
    tp2, eng_tp2 = serve_tp2_packed(torch, smi, bucketed, packed)
    reference, eng = serve_reference(torch, smi, bucketed)
    model_parity(torch, eng, eng_tp2, bucketed,
                 {"serve_packed": packed["tokens"], "serve_tp2_packed": tp2["tokens"],
                  "serve_reference": reference["tokens"]})
    del eng, eng_tp2
    gang = gang_phase(torch, smi)
    profile_again(torch, smi)
    runs = (bucketed["counts"], hf["counts"], swapped["counts"], launched["counts"], quant["counts"], int8["counts"],
            zero_drain["counts"], *migrated["counts"], coresident["counts"], co_engine["counts"], orbax["counts"],
            *dual["counts"], launched["release_counts"],
            moe["counts"], moe_ep["counts"], trained["counts"], staged["counts"], packed["counts"],
            tp2["counts"], reference["counts"], gang["counts"])

    def total(key):
        return sum(c[key] for c in runs)

    untimed = sorted({s for c in runs for s in c["prefill_by_seq"]} - set(PREFILL_SEQS))
    if untimed:
        raise AssertionError(f"the serve run launched prefill at untimed lengths {untimed}")
    # the ragged kernel's launches by buffer size: the packed serve's, the
    # coresident child's (one shape, 72 rows) and the pipeline's packed runs
    by_rows = dict(packed["counts"]["ragged_by_rows"])
    for run in (coresident, co_engine, staged):
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
    for k in w8:  # one entry per product shape, at a decode step's 8 rows
        if k["rows"] == 8:
            shape = f"{k['in']}x{k['out']}"
            kernels.append(dict(k, launches=int8["by_shape"].get(shape, 0) + sum(
                run["by_shape"]["w8a16"].get(shape, 0) for run in (moe, moe_ep))))
    for k in w8_experts:  # the batched product, one entry per expert-stack shape (E = 4: the ep ranks')
        if k["rows"] == 8:
            shape = f"{k['experts']}x{k['in']}x{k['out']}"
            kernels.append(dict(k, launches=sum(run["by_shape"]["w8a16_experts"].get(shape, 0) for run in (moe, moe_ep))))
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
