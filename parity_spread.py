#!/usr/bin/env python3
"""``chip_smoke.py``'s model-parity figures over several prompts, on one card.

Usage, from the root of a checkout, on a machine with one NVIDIA card:

    python3 parity_spread.py [--seeds 5,1,2]

Builds ``chip_smoke.py``'s two models (full-width, full-depth
``llama3-8b``, seed 0, random weights: one rank on ``cuda:0``, and two
ranks sharing it). For each prompt seed (``chip_smoke.py``'s own prompt
is seed 5: 300 token ids) it prints the three figures that
``model_parity`` holds to its limits,
each the relative L2 distance of two logit vectors: ``mixed_step`` against
``prefill``, and two ranks against one in ``mixed_step`` and in the
``decode_step`` that follows. It shows how far those figures move from one
prompt to the next; it gates nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", default="5,1,2,3,4,6,7,8")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("parity_spread: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from llm_d_fast_model_actuation_tpu_torch.engine import server as srv
    from llm_d_fast_model_actuation_tpu_torch.engine.engine import kv_pages_bucket, prefill_bucket
    from llm_d_fast_model_actuation_tpu_torch.models import llama

    def engine(opts):
        return srv.EngineService(srv.parse_engine_options(opts)).engine

    one = engine("--model llama3-8b --num-pages 64 --seed 0 --max-batch 8 --device cuda --attention-impl reference")
    two = engine("--model llama3-8b --num-pages 64 --seed 0 --max-batch 8 --tensor-parallel-size 2 "
                 "--device cuda:0,cuda:0 --packed-serving on")
    m1, m2 = one.model, two.model
    cfg = m1.cfg
    ps, n = 16, 300  # as model_parity
    pages = kv_pages_bucket(n + 1, ps, one.cfg.pages_per_seq)
    shape = (cfg.num_layers, pages + 1, ps, cfg.num_kv_heads, cfg.head_dim)
    shard = shape[:3] + (cfg.num_kv_heads // m2.mesh.tp,) + shape[4:]
    pt = torch.arange(1, pages + 1, dtype=torch.int32, device="cuda")[None]
    dev = "cuda"

    def zeros(shp, d=dev):
        return tuple(torch.zeros(shp, dtype=cfg.dtype, device=d) for _ in range(2))

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    runs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        gen = torch.Generator(device=dev).manual_seed(seed)
        prompt = torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=dev, dtype=torch.int32)
        tokens = torch.zeros((1, prefill_bucket(n, one.cfg.seq_len)), dtype=torch.int32, device=dev)
        tokens[0, :n] = prompt
        lp = llama.prefill(m1, tokens, torch.tensor([n], dtype=torch.int32, device=dev), zeros(shape), pt)[0, n - 1]
        rows = -(-n // 8) * 8
        slot = torch.full((rows,), -1, dtype=torch.int32, device=dev)
        slot[:n] = 0
        pos = torch.zeros((rows,), dtype=torch.int32, device=dev)
        pos[:n] = torch.arange(n, dtype=torch.int32, device=dev)
        toks = torch.zeros((rows,), dtype=torch.int32, device=dev)
        toks[:n] = prompt
        pool1, pool2 = zeros(shape), [zeros(shard, d) for d in m2.mesh.devices]
        lm = llama.mixed_step(m1, toks, slot, pos, pool1, pt)[n - 1]
        lm2 = llama.mixed_step(m2, toks, slot, pos, pool2, pt)[n - 1]
        nxt = lm.argmax().to(torch.int32)[None]
        at = torch.tensor([n], dtype=torch.int32, device=dev)
        decode = []
        for model, pool in ((m1, pool1), (m2, pool2)):
            base = model.cfg
            model.cfg = dataclasses.replace(base, attention_impl="grouped")
            decode.append(llama.decode_step(model, nxt, at, pool, pt)[0])
            model.cfg = base
        torch.cuda.synchronize()
        run = {"seed": seed, "mixed_vs_prefill": rel(lm, lp), "tp2_vs_tp1_mixed_step": rel(lm2, lm),
               "tp2_vs_tp1_decode_step": rel(decode[1], decode[0])}
        runs.append(run)
        print(json.dumps(run), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(json.dumps({"parity_spread": runs, "limits": "chip_smoke.py:PARITY_TOL",
                      "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
