#!/usr/bin/env python3
"""Time this checkout's paged-decode kernel against other builds of it, on one card.

Usage, from the root of a checkout, on a machine with one NVIDIA card:

    git show <rev>:llm_d_fast_model_actuation_tpu_torch/csrc/decode.cu > build/ab/parent.cu
    python3 decode_ab.py parent=build/ab/parent.cu [name=path.cu ...]

Each ``path.cu`` is a version of ``csrc/decode.cu`` (an earlier commit's,
or a variant), built with this checkout's nvcc flags into ``build/ab/``
(``csrc/`` on the include path, for ``hopper.cuh``). Every version has the
same C interface: ``fma_paged_decode_inline_bf16`` (the inline variant)
and ``fma_paged_decode_bf16`` (scatter-first).

For both variants and at every shape, every version is first checked
against the plain version (row-relative error, limit 1.6e-2 as in
``chip_smoke.py``), and its output compared bit for bit with this
checkout's (``bit_equal_to_this``, with the count of elements that
differ). Then each version is timed in a palindrome (this checkout, the
others, the others again in reverse, this checkout) on the same inputs
(four sets of queries and pools, rotated so launches find their pages
cold in L2):

- ``device_ms``: device time per launch, from CUDA events around the
  replay of a CUDA graph of N launches (``prefill_ab.device_ms``);
- ``wrapper_ms`` (this checkout only): wall time per call through
  ``paged_decode_attention_inline`` or ``paged_decode_attention``, host
  overhead included, as ``chip_smoke.py`` times it.

Shapes (Llama-3-8B's 32/8 heads of dim 128 and page 16 unless named):
``chip_smoke.py``'s batch 8 at positions 0 ... 4095, the same at a
tensor-parallel rank's 16/4 heads, batch 1 at position 4095, the batch
with its longest sequence at 8191 of an 8192-position table, head_dim 64
(32/4) and 256 (8/4), GQA groups 1 (8/8), 7 (28/4) and 8 (32/4), and page
sizes 8, 12 and 64. The scatter-first variant reads ``positions + 1``
entries.

Prints one JSON line per shape and variant and a last line with all of
them, the card's name and ``nvidia-smi``'s name and power limit. Exits
non-zero without a card, or if any version disagrees with the plain
version.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
REL_TOL = 1.6e-2
SMOKE = [0, 1, 17, 250, 1000, 2049, 3001, 4095]  # chip_smoke.check_decode's positions

# (name, heads, kv_heads, head_dim, page_size, positions, table positions)
SHAPES = [
    ("chip_smoke", 32, 8, 128, 16, SMOKE, 4096),
    ("tp-2 rank (16/4)", 16, 4, 128, 16, SMOKE, 4096),
    ("batch 1 at 4095", 32, 8, 128, 16, [4095], 4096),
    ("8192 table, longest at 8191", 32, 8, 128, 16, SMOKE[:-1] + [8191], 8192),
    ("d 64 (32/4)", 32, 4, 64, 16, SMOKE, 4096),
    ("d 256 (8/4)", 8, 4, 256, 16, SMOKE, 4096),
    ("group 1 (8/8)", 8, 8, 128, 16, SMOKE, 4096),
    ("group 7 (28/4)", 28, 4, 128, 16, SMOKE, 4096),
    ("group 8 (32/4)", 32, 4, 128, 16, SMOKE, 4096),
    ("page 8", 32, 8, 128, 8, SMOKE, 4096),
    ("page 12", 32, 8, 128, 12, SMOKE, 4104),
    ("page 64", 32, 8, 128, 64, SMOKE, 4096),
]

_ARGTYPES = {
    "fma_paged_decode_inline_bf16": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
    "fma_paged_decode_bf16": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
}


def bind(lib):
    """(inline, scatter-first) launch functions of a loaded decode library."""
    fns = []
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns.append(fn)
    return tuple(fns)


def build_version(path: str):
    """The (inline, scatter-first) functions of one decode.cu, built once."""
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import build

    src = open(path, "rb").read()
    headers = b"".join(open(os.path.join(build.CSRC, h), "rb").read() for h in sorted(os.listdir(build.CSRC))
                       if h.endswith(".cuh"))
    digest = hashlib.sha256(src + headers + " ".join(build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = os.path.join(ROOT, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"libdecode-{digest}.so")
    if not os.path.exists(so):
        subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", so, path],
                       check=True, capture_output=True)
    return bind(ctypes.CDLL(so))


def launcher(torch, fn, inline, q, kp, vp, kn, vn, pt, lens):
    """A call with no arguments that launches ``fn`` on these tensors."""
    b, h, d = q.shape
    _, ps, kvh, _ = kp.shape
    out = torch.empty_like(q)
    tensors = (q, kp, vp, kn, vn, pt, lens) if inline else (q, kp, vp, pt, lens)
    args = (*(t.data_ptr() for t in tensors), out.data_ptr(), b, h, kvh, d, ps, pt.shape[1], d**-0.5)

    def go():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"decode launch failed: error {err}")
        return out

    go.keep = args
    return go


def inputs(torch, gen, h, kvh, d, ps, positions, table_positions, n_sets=4):
    """``n_sets`` (q, k pool, v pool, k_new, v_new) sets and the shared
    page table (each sequence's pages shuffled over the pool)."""
    b = len(positions)
    pps = table_positions // ps
    num_pages = b * pps + 1
    perm = torch.randperm(num_pages - 1, generator=torch.Generator().manual_seed(1)) + 1
    pt = perm.reshape(b, pps).to(torch.int32).cuda()

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(torch.bfloat16)

    sets = [(rnd(b, h, d), rnd(num_pages, ps, kvh, d), rnd(num_pages, ps, kvh, d), rnd(b, kvh, d), rnd(b, kvh, d))
            for _ in range(n_sets)]
    return sets, pt


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from prefill_ab import device_ms

    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import decode as D

    others = dict(arg.split("=", 1) for arg in sys.argv[1:])
    versions = {"this": D._kernels()}
    versions.update({name: build_version(path) for name, path in others.items()})
    order = ["this", *others, *reversed(list(others)), "this"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows_out, bad = [], []
    for name, h, kvh, d, ps, positions, table_positions in SHAPES:
        sets, pt = inputs(torch, gen, h, kvh, d, ps, positions, table_positions)
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        for variant, lens in (("inline", pos), ("scatter_first", pos + 1)):
            inline = variant == "inline"

            def data(x):
                q, kp, vp, kn, vn = x
                return (q, kp, vp, kn, vn, pt, lens) if inline else (q, kp, vp, pt, lens)

            plain = D.paged_decode_attention_inline_plain if inline else D.paged_decode_attention_plain
            wrapper = D.paged_decode_attention_inline if inline else D.paged_decode_attention
            ref = plain(*data(sets[0])).float()
            row = {"shape": name, "variant": variant, "heads": h, "kv_heads": kvh, "head_dim": d,
                   "page_size": ps, "table_positions": table_positions,
                   ("positions" if inline else "seq_lens"): lens.tolist(),
                   "max_row_rel_err": {}, "bit_equal_to_this": {}, "device_ms": {}}
            outs = {}
            for vname, fns in versions.items():
                fn = fns[0] if inline else fns[1]
                outs[vname] = out = launcher(torch, fn, inline, *sets[0], pt, lens)().clone()
                torch.cuda.synchronize()
                rel = ((out.float() - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)).max().item()
                row["max_row_rel_err"][vname] = rel
                if not rel <= REL_TOL:
                    bad.append((vname, name, variant, rel))
                differing = int((out.view(torch.int16) != outs["this"].view(torch.int16)).sum())
                row["bit_equal_to_this"][vname] = {"equal": differing == 0, "elements_differing": differing}
            for i, vname in enumerate(order):
                fn = versions[vname][0] if inline else versions[vname][1]
                calls = [launcher(torch, fn, inline, *x, pt, lens) for x in sets]
                row["device_ms"][f"{vname}{1 if i < len(order) // 2 else 2}"] = device_ms(torch, calls, 40)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            for x in sets[:2]:
                wrapper(*data(x))
            torch.cuda.synchronize()
            start.record()
            for i in range(50):
                wrapper(*data(sets[i % len(sets)]))
            end.record()
            end.synchronize()
            row["wrapper_ms"] = start.elapsed_time(end) / 50
            # what the launch must move: q in, out, the new token's K/V, and
            # the K/V rows the lengths need
            n = sum(lens.tolist())
            row["kv_bytes"] = 2 * n * kvh * d * 2
            rows_out.append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({"decode_ab": rows_out, "versions": {"this": "csrc/decode.cu", **others},
                      "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    if bad:
        print(f"decode_ab: versions disagree with the plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
