#!/usr/bin/env python3
"""``chip_smoke.py``'s model-parity figures over several prompts, on one card.

Usage, from the root of a checkout, on a machine with one NVIDIA card:

    python3 parity_spread.py [--seeds 5,1,2]

Builds ``chip_smoke.py``'s two models (full-width, full-depth
``llama3-8b``, seed 0, random weights: one rank on ``cuda:0``, and two
ranks sharing it). For each prompt seed (``chip_smoke.py``'s own prompt
is seed 5: 300 token ids) it prints, beside each other:

* the gated figures of ``model_parity``: each bf16 path's rel-L2 against
  the fp32 oracle of the same weights (``chip_smoke.py:oracle_logits``),
  the tp 2 paths over their tp 1 partners, and the gate's margin on each
  (its limit over the figure: above 1 passes), with what the gate says;
* the old pairwise figures (``mixed_step`` against ``prefill``, the
  scatter-first decode against the inline one, two ranks against one in
  ``mixed_step`` and in ``decode_step``), which are no longer gated.

It shows how far the figures move from one prompt to the next; it gates
nothing, and the limits are derived in ``chip_smoke.py``, not from it.
"""

from __future__ import annotations

import argparse
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
    import chip_smoke as cs
    from llm_d_fast_model_actuation_tpu_torch.engine import server as srv

    def engine(opts):
        return srv.EngineService(srv.parse_engine_options(opts)).engine

    one = engine("--model llama3-8b --num-pages 64 --seed 0 --max-batch 8 --device cuda --attention-impl reference")
    two = engine("--model llama3-8b --num-pages 64 --seed 0 --max-batch 8 --tensor-parallel-size 2 "
                 "--device cuda:0,cuda:0 --packed-serving on")
    layers = one.model.cfg.num_layers
    limit, ratio_limit = cs.parity_limit(layers), cs.tp_ratio_limit(layers)
    runs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        run = cs.parity_logits(torch, one.model, two.model, seed=seed)
        _, figures, pairwise = cs.parity_figures(torch, one.model, run)
        ratios = {p: figures[p]["rel_l2"] / figures[q]["rel_l2"] for p, q in cs.TP_PAIRS.items()}
        out = {
            "seed": seed,
            "against_fp32_oracle": {p: f["rel_l2"] for p, f in figures.items()},
            "margin": {p: limit / f["rel_l2"] for p, f in figures.items()},
            "tp2_over_tp1": ratios,
            "ratio_margin": {p: ratio_limit / r for p, r in ratios.items()},
            "argmax_equal": {p: f["argmax_equal"] for p, f in figures.items()},
            "refused": cs.parity_gate(figures, layers),
            "pairwise_not_gated": {k: v["rel_l2"] for k, v in pairwise.items()},
        }
        del run
        runs.append(out)
        print(json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(json.dumps({"parity_spread": runs, "limits": {"rel_l2": limit, "tp2_over_tp1": ratio_limit},
                      "predicted_rel_l2": cs.parity_band(layers), "passes": sum(not r["refused"] for r in runs),
                      "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
