#!/usr/bin/env python3
"""The profiled replay of ``chip_smoke.py``'s ``graphs`` phase in several
``torch.profiler`` windows of one process, on one card.

A Llama-3-8B engine at full width (random weights) with eight requests
running; the replayed T = 8 greedy chunk is profiled (``chip_smoke.py:
chunk_device_profile``) in the process's first window, then after two
large windows (thirty replays each with CPU and CUDA activity, one on
this thread and one on another, as a served engine's ``/v1/profile`` runs
on its engine thread), three times with no pad of spins around the
replay and four times between two pads of ``PROFILE_PAD_KERNELS`` short
spins. Each window prints one JSON line: the decode kernel's recorded
runs against the graph's nodes, all kernel records against the nodes,
the first device records, and how many spins of each pad were lost. The
last line says whether every window with the pads held the gate.

Run from the root of a checkout, on a machine with one card:

    python3 profile_windows.py
"""

import json
import os
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    from torch.profiler import ProfilerActivity, profile

    from llm_d_fast_model_actuation_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from llm_d_fast_model_actuation_tpu_torch.models import llama
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import build

    if not torch.cuda.is_available():
        print("profile_windows: no CUDA device is available", file=sys.stderr)
        return 2
    build.build_all()
    print(cs.nvidia_smi(), flush=True)
    cfg = EngineConfig(model=llama.LlamaConfig.llama3_8b(), max_batch=8, num_pages=2048, prefix_caching=False)
    eng = InferenceEngine(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(1)
    for n in cs.GRAPH_PROMPT_LENS:
        eng.add_request(rng.integers(0, cfg.model.vocab_size, n).tolist(), max_new_tokens=4000)
    eng.step()
    out = []

    def window(label: str, pad: int) -> None:
        try:
            r = cs.chunk_device_profile(torch, eng, 8, pad=pad)
            out.append({"window": label, "pad": pad, "ok": True,
                        **{k: r[k] for k in ("decode_kernel_runs_profiled", "kernel_records", "kernel_nodes",
                                             "first_device_records", "lead_spins_lost", "trail_spins_lost")}})
        except AssertionError as e:
            out.append({"window": label, "pad": pad, "ok": False, "error": str(e)[:600]})
        print(json.dumps(out[-1]), flush=True)

    def large(where: str) -> None:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(30):
                eng.graphs.replay(8, False)
            torch.cuda.synchronize()
        print(json.dumps({"large_window": where, "events": len(prof.events())}), flush=True)

    window("first", cs.PROFILE_PAD_KERNELS)
    large("this thread")
    t = threading.Thread(target=large, args=("another thread",))
    t.start()
    t.join()
    for i in range(3):
        window(f"late-no-pad-{i}", 0)
    for i in range(4):
        window(f"late-pad-{i}", cs.PROFILE_PAD_KERNELS)
    ok = all(o["ok"] for o in out if o["pad"])
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
