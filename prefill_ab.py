#!/usr/bin/env python3
"""Time this checkout's prefill kernel against other builds of it, on one card.

Usage, from the root of a checkout, on a machine with one NVIDIA card:

    git show <rev>:llm_d_fast_model_actuation_tpu_torch/csrc/prefill.cu > build/ab/parent.cu
    python3 prefill_ab.py parent=build/ab/parent.cu [name=path.cu ...]

Each ``path.cu`` is a version of ``csrc/prefill.cu`` (an earlier commit's,
or a variant), built with this checkout's nvcc flags into ``build/ab/``
(``csrc/`` on the include path, for ``hopper.cuh``).
Two C interfaces are understood: the launch plan of this checkout
(``fma_prefill_set_encoder`` present; a variant's tile sizes are read
from its ``Tiles<>``) and the earlier twelve-stride one.

Every version is first checked against the plain version at every shape
it is timed at (row-relative error, limit 1.6e-2 as in ``chip_smoke.py``).
Then, at Llama-3-8B's 32/8 heads of dim 128, batch 1 and seq_len = s - 3
for s = 16, 32, 512, 2048 and 4096, and at head_dim 64 (32/4 heads) and
256 (8/4) for s = 4096, each version is timed in a palindrome (this
checkout, the others, the others again in reverse, this checkout) on the
same inputs (four sets, rotated so launches find them cold in L2):

- ``device_ms``: device time per launch, from CUDA events around the
  replay of a CUDA graph of N launches (no host time in it);
- ``wrapper_ms`` (this checkout only): wall time per call through
  ``causal_prefill_attention`` from CUDA events, as ``chip_smoke.py``
  times it, host overhead included.

Prints one JSON line per shape and a last line with all of them, the card's
name and ``nvidia-smi``'s name and power limit. Exits non-zero without a
card, or if any version disagrees with the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import math
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
REL_TOL = 1.6e-2
SHAPES = [(128, 32, 8, s) for s in (16, 32, 512, 2048, 4096)] + [(64, 32, 4, 4096), (256, 8, 4, 4096)]


def build_version(path: str):
    """(launch function, interface, tiles) of one prefill.cu, built once."""
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import build

    src = open(path).read()
    headers = b"".join(open(os.path.join(build.CSRC, h), "rb").read() for h in sorted(os.listdir(build.CSRC))
                       if h.endswith(".cuh"))
    digest = hashlib.sha256(src.encode() + headers + " ".join(build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = os.path.join(ROOT, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"libprefill-{digest}.so")
    if not os.path.exists(so):
        subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", so, path],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    fn = lib.fma_causal_prefill_bf16
    fn.restype = ctypes.c_int
    if hasattr(lib, "fma_prefill_set_encoder"):
        lib.fma_prefill_set_encoder.argtypes = [ctypes.c_void_p]
        encode = ctypes.CDLL("libcuda.so.1").cuTensorMapEncodeTiled
        lib.fma_prefill_set_encoder(ctypes.cast(encode, ctypes.c_void_p))
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
        tiles = {int(d): (int(bk), int(st)) for d, bk, st in re.findall(
            r"struct Tiles<(\d+)> \{ static constexpr int kBlockK = (\d+), kStages = (\d+); \}", src)}
        return fn, "plan", tiles
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_float,
                                                                  ctypes.c_void_p]
    return fn, "strides", None


def launcher(torch, version, q, k, v, lens):
    """A call with no arguments that launches ``version`` on these tensors."""
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import prefill as P

    fn, interface, tiles = version
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(), b, s, h,
            k.shape[2], d)
    if interface == "plan":
        plan = P.launch_plan(q, k, v, out)
        block_k, stages = tiles[d]
        plan[1:4] = [block_k, stages, 1024 + 2 * d * (P.BLOCK_Q + 2 * stages * block_k) + 8 * (1 + 3 * stages)]
        args = (*ptrs, (ctypes.c_longlong * len(plan))(*plan), d**-0.5 * math.log2(math.e))
    else:
        strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                           *out.stride()[:3])
        args = (*ptrs, ctypes.cast(strides, ctypes.c_void_p), d**-0.5)

    def go():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"prefill launch failed: error {err}")
        return out

    go.keep = args
    return go


def device_ms(torch, calls, n: int) -> float:
    """Device time per launch: a CUDA graph of n launches rotating over calls."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * n)


def wrapper_ms(torch, fn, sets, lens, n: int) -> float:
    for x in sets[:2]:
        fn(*x, lens)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(*sets[i % len(sets)], lens)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("prefill_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import prefill as P

    others = dict(arg.split("=", 1) for arg in sys.argv[1:])
    versions = {"this": (P._kernel(), "plan", P.TILES)}
    versions.update({name: build_version(path) for name, path in others.items()})
    order = ["this", *others, *reversed(list(others)), "this"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, bad = [], []
    for d, h, kvh, s in SHAPES:
        sets = [tuple(torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                      for shape in ((1, s, h, d), (1, s, kvh, d), (1, s, kvh, d))) for _ in range(4)]
        lens = torch.tensor([s - 3], dtype=torch.int32, device="cuda")
        ref = P.causal_prefill_attention_plain(*sets[0], lens).float()
        row = {"head_dim": d, "heads": h, "kv_heads": kvh, "seq": s, "seq_len": s - 3,
               "max_row_rel_err": {}, "device_ms": {}}
        for name, version in versions.items():
            out = launcher(torch, version, *sets[0], lens)().float()
            torch.cuda.synchronize()
            rel = ((out - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)).max().item()
            row["max_row_rel_err"][name] = rel
            if not rel <= REL_TOL:
                bad.append((name, d, s, rel))
        n = 20 if s >= 2048 else 100
        for i, name in enumerate(order):
            calls = [launcher(torch, versions[name], *x, lens) for x in sets]
            row["device_ms"][f"{name}{1 if i < len(order) // 2 else 2}"] = device_ms(torch, calls, n)
        row["wrapper_ms"] = wrapper_ms(torch, P.causal_prefill_attention, sets, lens, n)
        visible = sum(min(i, s - 4) + 1 for i in range(s))
        row["flops"] = 4 * h * d * visible
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"prefill_ab": rows, "versions": {"this": "csrc/prefill.cu", **others},
                      "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    if bad:
        print(f"prefill_ab: versions disagree with the plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
