#!/usr/bin/env python3
"""Time this checkout's W8A16 kernel against other builds of it and the plain version, on one card.

Usage, from the root of a checkout, on a machine with one NVIDIA card:

    mkdir -p build/ab/parent
    git show <rev>:llm_d_fast_model_actuation_tpu_torch/csrc/w8a16.cu > build/ab/parent/w8a16.cu
    git show <rev>:llm_d_fast_model_actuation_tpu_torch/ops/cuda/w8a16.py > build/ab/parent/w8a16.py
    python3 w8a16_ab.py parent=build/ab/parent [name=dir ...] [--rows 1,8,16,64]

Each ``dir`` holds a version of ``csrc/w8a16.cu`` (an earlier commit's, or
a variant) and the ``ops/cuda/w8a16.py`` whose ``launch_plan`` it takes;
the source is built with this checkout's nvcc flags into ``build/ab/``.
Every version has the same C interface: ``fma_w8a16_bf16`` (the 2-D
product) and ``fma_w8a16_bf16_experts`` (the batched one).

Shapes: Llama-3-8B's five products (4096 -> 4096, 1024, 14336, 128256 and
14336 -> 4096) and Mixtral-8x7B's two expert stacks (E = 8; 4096 -> 14336
with one x for every expert, 14336 -> 4096 with an x per expert), at 1,
8, 16, 32, 64 and 128 rows (``--rows`` picks others). At every shape and
row count each version is first checked against the plain version (the
error over the largest plain value, limit 7.81e-3 as in
``chip_smoke.py``), this checkout's for the same bits from a second
launch, and every version's output compared bit for bit with this
checkout's (``bit_equal_to_this``, with the count of elements that
differ; the tensor cores sum in another order than the CUDA-core kernel
did, so differences are expected against it). Then each version is timed
in a palindrome (this checkout, the others, the others again in reverse,
this checkout), beside the plain version and bf16 ``torch.matmul`` of the
same product (the library yardstick), on the same inputs: as many weight
sets as make one rotation read at least 128 MB, so every launch finds its
weight cold in the 50 MB L2, as a decode step does.

- ``rel_err``: each version's error over the largest plain value;
  ``oracle_rel_err``: each version's and the plain version's against an
  fp32 oracle (the exact product, the reference's epilogue), which says
  which side of a disagreement rounds away from the product;
- ``device_ms``: device time per launch, from CUDA events around the
  replay of a CUDA graph of launches rotating over the sets
  (``prefill_ab.device_ms``); ``plain_ms`` and ``matmul_ms`` likewise.

A line per shape and row count, then a ``cap`` line: the largest row
count at which this checkout's kernel is faster than the plain version at
all seven shapes (what ``models/quant.py:W8A16_MAX_ROWS`` is set to), and
every (shape, rows) at which a version is slower than this checkout's;
the last line has all rows, the card's name and ``nvidia-smi``'s name and
power limit. Exits non-zero without a card, or if any version disagrees
with the plain version or this checkout's kernel gives other bits on a
second launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 7.81e-3
ROWS = (1, 8, 16, 32, 64, 128)
#: (name, experts, in, out, one x for every expert); E = 0 is the 2-D product
SHAPES = [
    ("wq/wo 4096x4096", 0, 4096, 4096, True),
    ("wk/wv 4096x1024", 0, 4096, 1024, True),
    ("gate/up 4096x14336", 0, 4096, 14336, True),
    ("down 14336x4096", 0, 14336, 4096, True),
    ("lm_head 4096x128256", 0, 4096, 128256, True),
    ("moe gate/up 8x4096x14336", 8, 4096, 14336, True),
    ("moe down 8x14336x4096", 8, 14336, 4096, False),
]
ROTATION_BYTES = 128 << 20


def bind(lib):
    """(2-D, batched) launch functions of a loaded w8a16 library."""
    two = lib.fma_w8a16_bf16
    two.argtypes, two.restype = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p], ctypes.c_int
    batched = lib.fma_w8a16_bf16_experts
    batched.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    batched.restype = ctypes.c_int
    return two, batched


def build_version(path: str):
    """(2-D, batched, launch_plan) of the version in directory ``path``."""
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import build

    src_path = os.path.join(path, "w8a16.cu")
    src = open(src_path, "rb").read()
    digest = hashlib.sha256(src + " ".join(build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = os.path.join(ROOT, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"libw8a16-{digest}.so")
    if not os.path.exists(so):
        subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", so, src_path],
                       check=True, capture_output=True)
    # the version's plan: its module, loaded inside ops.cuda so its relative imports resolve
    name = f"llm_d_fast_model_actuation_tpu_torch.ops.cuda._ab_{hashlib.sha256(path.encode()).hexdigest()[:16]}"
    spec = importlib.util.spec_from_file_location(name, os.path.join(path, "w8a16.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return (*bind(ctypes.CDLL(so)), mod.launch_plan)


def launcher(torch, version, E, x, q, s):
    """A call with no arguments that launches one version on these tensors."""
    two, batched, plan = version
    K, N = q.shape[-2:]
    M = x.shape[-2]
    mb, k_split, splits = plan(M, K, N, max(E, 1))
    y = torch.empty((max(E, 1), M, N), dtype=torch.bfloat16, device="cuda")
    part = torch.empty((splits, max(E, 1), M, N), dtype=torch.float32, device="cuda") if splits > 1 else None
    ptrs = (x.data_ptr(), q.data_ptr(), s.data_ptr(), 0 if part is None else part.data_ptr(), y.data_ptr())
    if E:
        args = (*ptrs, E, M * K if x.ndim == 3 else 0, M, K, N, mb, k_split, splits)
        fn = batched
    else:
        args = (*ptrs, M, K, N, mb, k_split, splits)
        fn = two

    def go():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"w8a16 launch failed: error {err}")
        return y

    go.keep = (part, args)
    return go


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("w8a16_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from prefill_ab import device_ms

    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import w8a16 as W

    args = sys.argv[1:]
    rows = ROWS
    if "--rows" in args:
        i = args.index("--rows")
        rows = tuple(int(r) for r in args[i + 1].split(","))
        del args[i:i + 2]
    others = dict(arg.split("=", 1) for arg in args)
    versions = {"this": (W._kernel(), W._kernel("fma_w8a16_bf16_experts"), W.launch_plan)}
    versions.update({name: build_version(path) for name, path in others.items()})
    order = ["this", *others, *reversed(list(others)), "this"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows_out, bad, slower, bad_rows = [], [], [], []
    faster_than_plain = {m: True for m in rows}
    for name, E, K, N, shared in SHAPES:
        n_sets = max(2, min(32, -(-ROTATION_BYTES // (max(E, 1) * K * N))))
        qs = [torch.randint(-127, 128, (max(E, 1), K, N), generator=gen, device="cuda", dtype=torch.int8)
              for _ in range(n_sets)]
        ss = [(torch.rand((max(E, 1), 1, N), generator=gen, device="cuda") + 3.0) * (K**-0.5 / 127)
              for _ in range(n_sets)]
        ws = [q.to(torch.bfloat16) for q in qs[:2]]  # the library yardstick's bf16 weights (two: memory)
        for M in rows:
            x = torch.randn((M, K) if shared else (E, M, K), generator=gen, device="cuda").to(torch.bfloat16)
            if E:
                plain_fn, w_of = W.w8a16_matmul_experts_plain, (lambda i: qs[i])
            else:
                plain_fn, w_of = W.w8a16_matmul_plain, (lambda i: qs[i][0])
            s_of = (lambda i: ss[i]) if E else (lambda i: ss[i][0])
            ref = plain_fn(x, w_of(0), s_of(0))
            top = ref.float().abs().max().item()
            # the fp32 oracle: the exact product (bf16 x int8 is exact in
            # fp32; the sum in fp32), then the reference's epilogue
            acc = torch.matmul(x.float(), w_of(0).float())
            oracle = (acc.to(torch.bfloat16).float() * s_of(0).to(torch.bfloat16).float()).to(torch.bfloat16).float()
            del acc
            row = {"shape": name, "experts": E, "in": K, "out": N, "rows": M, "weight_sets": n_sets,
                   "plan": {}, "rel_err": {}, "oracle_rel_err": {}, "bit_equal_to_this": {}, "device_ms": {}}
            outs = {}
            for vname, version in versions.items():
                call = launcher(torch, version, E, x, w_of(0), s_of(0))
                out = call().clone()
                torch.cuda.synchronize()
                if vname == "this" and not torch.equal(out, call()):
                    bad.append(("this", name, M, "bits differ on a second launch"))
                row["plan"][vname] = list(version[2](M, K, N, max(E, 1)))
                outs[vname] = out = out if E else out[0]
                rel = (out.float() - ref.float()).abs().max().item() / top
                row["rel_err"][vname] = rel
                row["oracle_rel_err"][vname] = (out.float() - oracle).abs().max().item() / top
                if not rel < TOL:
                    bad.append((vname, name, M, rel))
                    bad_rows.append(row)
                differing = int((out.view(torch.int16) != outs["this"].view(torch.int16)).sum())
                row["bit_equal_to_this"][vname] = {"equal": differing == 0, "elements_differing": differing}
            row["oracle_rel_err"]["plain"] = (ref.float() - oracle).abs().max().item() / top
            del oracle
            for i, vname in enumerate(order):
                calls = [launcher(torch, versions[vname], E, x, w_of(j), s_of(j)) for j in range(n_sets)]
                row["device_ms"][f"{vname}{1 if i < len(order) // 2 else 2}"] = device_ms(torch, calls, 2 * n_sets)
            row["plain_ms"] = device_ms(torch, [lambda j=j: plain_fn(x, w_of(j), s_of(j)) for j in range(n_sets)],
                                        2 * n_sets)
            row["matmul_ms"] = device_ms(torch, [lambda j=j: torch.matmul(x, ws[j] if E else ws[j][0])
                                                 for j in range(2)], 4)
            this = min(row["device_ms"]["this1"], row["device_ms"]["this2"])
            for vname in others:
                if min(row["device_ms"][f"{vname}1"], row["device_ms"][f"{vname}2"]) < this:
                    slower.append({"shape": name, "rows": M, "than": vname})
            if not this < row["plain_ms"]:
                faster_than_plain[M] = False
            # what the product must move: the int8 weight, its scales, x and y
            row["bytes"] = max(E, 1) * (K * N + 4 * N + 2 * M * N) + 2 * x.numel()
            rows_out.append(row)
            print(json.dumps(row), flush=True)
            del x, ref, outs
        del qs, ss, ws
        torch.cuda.empty_cache()
    cap = max((m for m in rows if faster_than_plain[m]), default=None)
    print(json.dumps({"cap": cap, "faster_than_plain_at_every_shape": faster_than_plain,
                      "this_slower_than": slower}), flush=True)
    print(json.dumps({"w8a16_ab": rows_out, "versions": {"this": "csrc/w8a16.cu", **others},
                      "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    if bad:
        print(f"w8a16_ab: versions disagree with the plain version: {bad}; the errors against the fp32 "
              f"oracle there: {[r['oracle_rel_err'] for r in bad_rows]}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
