"""The W8A16 weight product: the CUDA kernel (``csrc/w8a16.cu``) and its
plain PyTorch version.

``y = bf16(bf16(x @ q) * bf16(s))`` for bf16 activations ``x [..., K]``,
an int8 weight ``q [K, N]`` in the reference's ``[in, out]`` layout and
its f32 scale per output channel ``s [1, N]`` (or ``[N]``): the meaning
of the JAX package's ``models/quant.py:qmat`` on a quantized leaf, whose
product is XLA (no Pallas kernel), with the reference's rounding (the
product rounded to the activation dtype, then multiplied by the scale
rounded to it).

The kernel reads each int8 weight byte once and never writes a
dequantized weight; the plain version, ``torch.matmul(x, q.to(x.dtype))
* s.to(x.dtype)``, materializes the bf16 weight. Its host-side plan
(rows per pass, the split of K) is :func:`launch_plan`, mirrored in the
kernel's source and tested on the CPU. The wrapper takes the plain
version for CPU tensors and launches the kernel for CUDA tensors (bf16
only), or raises; it never falls back. It allocates its output and the
split partials with ``torch.empty`` and does not synchronize, so a
launch can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from .build import count_launch

#: output columns of one CTA (kTileN)
TILE_N = 256
#: a split's K is a multiple of this (kKStep: 8 k-lanes x 4 rows in flight)
K_STEP = 32
#: rows of x one pass of a CTA holds in shared memory at most
MAX_MB = 8
#: shared memory of one CTA's rows of x, f32 (no opt-in above 48 KiB)
SMEM_BYTES = 32 * 1024
#: CTAs the plan aims at: two resident on each of the H100's 132 SMs
TARGET_CTAS = 2 * 132


def launch_plan(M: int, K: int, N: int) -> Tuple[int, int, int]:
    """(mb, k_split, splits) for ``[M, K] @ [K, N]``: ``mb`` rows of x a
    pass (the power of two up to 8 that covers M, or 8), K cut into
    ``splits`` ranges of ``k_split`` (a multiple of :data:`K_STEP`) so
    that the ``ceil(N / 256)`` column tiles times the splits fill
    :data:`TARGET_CTAS` without passing it (a second wave of a few CTAs
    would double the time), and each split's rows of x fit
    :data:`SMEM_BYTES`."""
    if K % K_STEP or N % 8:
        raise ValueError(f"the W8A16 kernel takes K % {K_STEP} == 0 and N % 8 == 0, got K={K}, N={N}")
    mb = min(MAX_MB, 1 << max(0, (M - 1).bit_length()))
    tiles = -(-N // TILE_N)
    want = max(1, min(K // K_STEP, TARGET_CTAS // tiles))
    k_split = -(-K // want // K_STEP) * K_STEP
    k_split = min(k_split, SMEM_BYTES // (4 * mb) // K_STEP * K_STEP)
    return mb, k_split, -(-K // k_split)


def w8a16_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (``qmat`` on a quantized
    leaf, the reference's expression): the weight dequantized to
    ``x.dtype``, the product, the scale rounded to ``x.dtype``."""
    return torch.matmul(x, q.to(x.dtype)) * s.to(x.dtype)


def w8a16_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``x @ (q * s)`` with the reference's rounding. CPU tensors take the
    plain version; CUDA tensors launch the kernel (bf16 ``x``) or raise.
    ``launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return w8a16_matmul_plain(x, q, s)
    if not x.is_cuda:
        raise ValueError(f"x must be a CPU or CUDA tensor, got {x.device}")
    return _launch(x, q, s)


w8a16_matmul.launches = 0
#: launches by product shape, ``"<K>x<N>"``
w8a16_matmul.launches_by_shape = {}


def _check(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> None:
    K = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the W8A16 kernel takes bf16 activations, got {x.dtype}")
    if q.dtype != torch.int8 or q.ndim != 2 or q.shape[0] != K or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous int8 [{K}, N], got {q.dtype} {tuple(q.shape)}")
    N = q.shape[1]
    if s.dtype != torch.float32 or s.numel() != N or s.shape[-1] != N or not s.is_contiguous():
        raise ValueError(f"s must be a contiguous float32 [1, {N}], got {s.dtype} {tuple(s.shape)}")
    if q.device != x.device or s.device != x.device:
        raise ValueError("x, q and s must be on one device")


_fn = None


def _kernel():
    """``fma_w8a16_bf16``, built and bound on first use."""
    global _fn
    if _fn is None:
        from .build import library

        fn = library("w8a16").fma_w8a16_bf16
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    _check(x, q, s)
    K, N = q.shape
    lead = tuple(x.shape[:-1])
    M = math.prod(lead)
    x2 = x.reshape(M, K).contiguous()
    y = torch.empty(lead + (N,), dtype=x.dtype, device=x.device)
    if M == 0:
        return y
    mb, k_split, splits = launch_plan(M, K, N)
    part = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) if splits > 1 else None
    args = (x2.data_ptr(), q.data_ptr(), s.data_ptr(), 0 if part is None else part.data_ptr(), y.data_ptr(),
            M, K, N, mb, k_split, splits)
    fn = _kernel()
    # the launch goes to the runtime's current device: switch only if needed
    if x.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(x.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"W8A16 kernel launch failed: CUDA error {err}")
    count_launch(w8a16_matmul, "launches_by_shape", f"{K}x{N}")
    return y
