#!/usr/bin/env python3
"""Time this checkout's ragged paged-attention kernel against other builds of it, on one card.

Usage, from the root of a checkout, on a machine with one NVIDIA card:

    git show <rev>:llm_d_fast_model_actuation_tpu_torch/csrc/ragged.cu > build/ab/parent.cu
    python3 ragged_ab.py parent=build/ab/parent.cu [name=path.cu ...]

Each ``path.cu`` is a version of ``csrc/ragged.cu`` (an earlier commit's,
or a variant), built with this checkout's nvcc flags into ``build/ab/``
(``csrc/`` on the include path, for ``hopper.cuh``). Two C interfaces are
understood: this checkout's, with a launch plan and tensor maps
(``fma_ragged_encode_maps`` present; a variant's key tile and ring stages
are read from its source, ``Tiles<>`` or ``kBlockK`` and ``Stages<>``, and
so is whether it takes the score scale times log2 e), and the earlier one
of sixteen arguments.

Every version is first checked against the plain version at every shape
it is timed at (row-relative error, limit 1.6e-2 as in ``chip_smoke.py``),
and its output compared bit for bit with this checkout's
(``bit_equal_to_this``, with the count of elements that differ).
Then each version is timed in a palindrome (this checkout, the others,
the others again in reverse, this checkout) on the same inputs (four sets
of queries and pools, rotated so launches find their pages cold in L2):

- ``device_ms``: device time per launch, from CUDA events around the
  replay of a CUDA graph of N launches (``prefill_ab.device_ms``);
- ``wrapper_ms`` (this checkout only): wall time per call through
  ``ragged_paged_attention``, host overhead included, as ``chip_smoke.py``
  times it.

Shapes (Llama-3-8B unless named; page 16): the packed serve's buffers of
256 and 72 rows (``chip_smoke.ragged_scenarios``); the 256-row buffer at a
tensor-parallel rank's 16/4 heads; a long context, a 512-token segment at
position 7680 of an 8192-position table; and the 256-row buffer at
head_dim 64 (32/4 heads) and 256 (8/4).

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
PS = 16


def shapes():
    """(name, heads, kv_heads, head_dim, rows, segments, table positions)."""
    from chip_smoke import ragged_scenarios

    (t256, seg256), (t72, seg72) = ragged_scenarios()
    return [
        ("T=256", 32, 8, 128, t256, seg256, 8192),
        ("T=72", 32, 8, 128, t72, seg72, 8192),
        ("T=256, tp-2 rank (16/4)", 16, 4, 128, t256, seg256, 8192),
        ("long: 512 at 7680", 32, 8, 128, 512, [(0, 7680, 512)], 8192),
        ("T=256, d 64 (32/4)", 32, 4, 64, t256, seg256, 8192),
        ("T=256, d 256 (8/4)", 8, 4, 256, t256, seg256, 8192),
    ]


def build_version(path: str):
    """(library, interface, stages) of one ragged.cu, built once."""
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import build

    src = open(path).read()
    headers = b"".join(open(os.path.join(build.CSRC, h), "rb").read() for h in sorted(os.listdir(build.CSRC))
                       if h.endswith(".cuh"))
    digest = hashlib.sha256(src.encode() + headers + " ".join(build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = os.path.join(ROOT, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"libragged-{digest}.so")
    if not os.path.exists(so):
        subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", so, path],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    fn = lib.fma_ragged_paged_attention_bf16
    fn.restype = ctypes.c_int
    if hasattr(lib, "fma_ragged_encode_maps"):
        lib.fma_ragged_set_encoder.argtypes = [ctypes.c_void_p]
        lib.fma_ragged_set_encoder(ctypes.cast(ctypes.CDLL("libcuda.so.1").cuTensorMapEncodeTiled, ctypes.c_void_p))
        lib.fma_ragged_encode_maps.argtypes = [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
        lib.fma_ragged_map_bytes.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
        tiles = {int(d): (int(bk), int(st)) for d, bk, st in re.findall(
            r"struct Tiles<(\d+)> \{ static constexpr int kBlockK = (\d+), kStages = (\d+); \}", src)}
        if not tiles:  # one key tile for every head_dim
            bk = int(re.search(r"constexpr int kBlockK = (\d+);", src).group(1))
            tiles = {int(d): (bk, int(st)) for d, st in re.findall(
                r"struct Stages<(\d+)> \{ static constexpr int kStages = (\d+); \}", src)}
        # the score scale it takes: head_dim**-0.5, or that times log2(e)
        log2 = "float scale_log2" in src[src.index('extern "C" int fma_ragged_paged_attention_bf16'):]
        return lib, "plan", (tiles, log2)
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    return lib, "args", None


def launcher(torch, version, q, kp, vp, pt, slot, pos):
    """A call with no arguments that launches ``version`` on these tensors."""
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import ragged as R

    lib, interface, plan_info = version
    fn = lib.fma_ragged_paged_attention_bf16
    t, h, d = q.shape
    num_pages, ps, kvh, _ = kp.shape
    out = torch.empty_like(q)
    if interface == "plan":
        plan = R.launch_plan(q, kp)
        tiles, log2 = plan_info
        block_k, stages = tiles[d]
        plan[1:4] = [block_k, stages, 1024 + 2 * d * (R.TILE_ROWS + 2 * stages * block_k) + 24 * stages]
        plan = (ctypes.c_longlong * len(plan))(*plan)
        maps = (ctypes.c_ubyte * (2 * lib.fma_ragged_map_bytes()))()
        if lib.fma_ragged_encode_maps(maps, kp.data_ptr(), vp.data_ptr(), plan):
            raise RuntimeError("a tensor map was refused")
        args = (maps, q.data_ptr(), pt.data_ptr(), slot.data_ptr(), pos.data_ptr(), out.data_ptr(), t, h, kvh,
                d, ps, pt.stride(0), pt.shape[0], plan, d**-0.5 * (math.log2(math.e) if log2 else 1.0))
    else:
        args = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), pt.data_ptr(), slot.data_ptr(), pos.data_ptr(),
                out.data_ptr(), t, h, kvh, d, ps, pt.stride(0), pt.shape[0], d**-0.5)

    def go():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ragged launch failed: error {err}")
        return out

    go.keep = args
    return go


def inputs(torch, gen, h, kvh, d, rows, segments, table_positions, n_sets=4):
    """``n_sets`` (q, k pool, v pool) sets and the shared table and row
    metadata, in the packed serve's layout: shuffled pages, the table a
    column slice of a wider one."""
    from chip_smoke import pack
    from llm_d_fast_model_actuation_tpu_torch.engine.engine import kv_pages_bucket

    need = {s: -(-(p0 + n) // PS) for s, p0, n in segments}
    num_pages = sum(need.values()) + 1
    perm = (torch.randperm(num_pages - 1, generator=torch.Generator().manual_seed(rows)) + 1).tolist()
    pps = table_positions // PS
    table = torch.zeros((max(need) + 1, pps), dtype=torch.int32)
    for s, n in need.items():
        table[s, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    kvp = kv_pages_bucket(max(p0 + n for _, p0, n in segments), PS, pps)
    pt = table.cuda()[:, :kvp]
    slot, pos = pack(torch, segments, rows, "cuda")

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(torch.bfloat16)

    sets = [(rnd(rows, h, d), rnd(num_pages, PS, kvh, d), rnd(num_pages, PS, kvh, d)) for _ in range(n_sets)]
    return sets, (pt, slot, pos)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ragged_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from prefill_ab import device_ms

    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import ragged as R

    others = dict(arg.split("=", 1) for arg in sys.argv[1:])
    R._kernel()
    versions = {"this": (R._lib, "plan", ({d: (R.BLOCK_K, st) for d, st in R.STAGES.items()}, False))}
    versions.update({name: build_version(path) for name, path in others.items()})
    order = ["this", *others, *reversed(list(others)), "this"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows_out, bad = [], []
    for name, h, kvh, d, rows, segments, table_positions in shapes():
        sets, meta = inputs(torch, gen, h, kvh, d, rows, segments, table_positions)
        ref = R.ragged_paged_attention_plain(*sets[0], *meta).float()
        row = {"shape": name, "heads": h, "kv_heads": kvh, "head_dim": d, "rows": rows, "page_size": PS,
               "segments": [list(s) for s in segments], "max_row_rel_err": {}, "bit_equal_to_this": {},
               "device_ms": {}}
        outs = {}
        for vname, version in versions.items():
            outs[vname] = out = launcher(torch, version, *sets[0], *meta)().float()
            torch.cuda.synchronize()
            rel = ((out - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)).max().item()
            row["max_row_rel_err"][vname] = rel
            if not rel <= REL_TOL:
                bad.append((vname, name, rel))
            row["bit_equal_to_this"][vname] = {"equal": bool(torch.equal(out, outs["this"])),
                                               "elements_differing": int((out != outs["this"]).sum())}
        for i, vname in enumerate(order):
            calls = [launcher(torch, versions[vname], *x, *meta) for x in sets]
            row["device_ms"][f"{vname}{1 if i < len(order) // 2 else 2}"] = device_ms(torch, calls, 40)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for x in sets[:2]:
            R.ragged_paged_attention(*x, *meta)
        torch.cuda.synchronize()
        start.record()
        for i in range(50):
            R.ragged_paged_attention(*sets[i % len(sets)], *meta)
        end.record()
        end.synchronize()
        row["wrapper_ms"] = start.elapsed_time(end) / 50
        row["flops"] = sum(4 * h * d * (p0 + j + 1) for _, p0, n in segments for j in range(n))
        rows_out.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"ragged_ab": rows_out, "versions": {"this": "csrc/ragged.cu", **others},
                      "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    if bad:
        print(f"ragged_ab: versions disagree with the plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
