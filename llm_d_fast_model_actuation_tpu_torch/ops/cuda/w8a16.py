"""The W8A16 weight product: the CUDA kernel (``csrc/w8a16.cu``) and its
plain PyTorch version.

``y = bf16(bf16(x @ q) * bf16(s))`` for bf16 activations ``x [..., K]``,
an int8 weight ``q [K, N]`` in the reference's ``[in, out]`` layout and
its f32 scale per output channel ``s [1, N]`` (or ``[N]``): the meaning
of the JAX package's ``models/quant.py:qmat`` on a quantized leaf, whose
product is XLA (no Pallas kernel), with the reference's rounding (the
product rounded to the activation dtype, then multiplied by the scale
rounded to it).

The batched form, :func:`w8a16_matmul_experts`, is the same product over
the expert stacks of an MoE layer (the reference's ``models/moe.py:
_qeinsum``): ``y[e] = bf16(bf16(x[e] @ q[e]) * bf16(s[e]))`` for every
expert ``e`` of ``q [E, K, N]`` and ``s [E, 1, N]``, with ``x [M, K]``
shared by all experts (the gate and up products) or ``x [E, M, K]`` one
per expert (the down product), into ``y [E, M, N]``: one launch for all
E experts, each expert the 2-D product's plan on its own slice.

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


def launch_plan(M: int, K: int, N: int, experts: int = 1) -> Tuple[int, int, int]:
    """(mb, k_split, splits) for ``[M, K] @ [K, N]`` in each of
    ``experts`` experts: ``mb`` rows of x a pass (the power of two up to 8
    that covers M, or 8), K cut into ``splits`` ranges of ``k_split`` (a
    multiple of :data:`K_STEP`) so that the ``ceil(N / 256)`` column tiles
    times the experts times the splits fill :data:`TARGET_CTAS` without
    passing it (a second wave of a few CTAs would double the time), and
    each split's rows of x fit :data:`SMEM_BYTES`. Every expert runs the
    same plan; with E = 8 the experts alone give Mixtral's products more
    column tiles than the target, and the split is then the one the
    shared memory forces."""
    if K % K_STEP or N % 8:
        raise ValueError(f"the W8A16 kernel takes K % {K_STEP} == 0 and N % 8 == 0, got K={K}, N={N}")
    if experts < 1:
        raise ValueError(f"the W8A16 kernel takes at least one expert, got {experts}")
    mb = min(MAX_MB, 1 << max(0, (M - 1).bit_length()))
    tiles = -(-N // TILE_N) * experts
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


def w8a16_matmul_experts_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The batched kernel's function in plain PyTorch (the reference's
    ``_qeinsum`` on a quantized expert stack, expert major): every
    expert's stack dequantized to ``x.dtype``, the products, each scale
    rounded to ``x.dtype``. ``x [M, K]`` or ``[E, M, K]``, ``q [E, K, N]``,
    ``s [E, 1, N]``; gives ``[E, M, N]``."""
    return torch.matmul(x, q.to(x.dtype)) * s.to(x.dtype)


def w8a16_matmul_experts(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """:func:`w8a16_matmul_experts_plain`'s function over all experts in
    one launch. CPU tensors take the plain version; CUDA tensors launch
    the kernel (bf16 ``x``) or raise. ``launches`` counts kernel
    launches."""
    if x.device.type == "cpu":
        return w8a16_matmul_experts_plain(x, q, s)
    if not x.is_cuda:
        raise ValueError(f"x must be a CPU or CUDA tensor, got {x.device}")
    return _launch_experts(x, q, s)


w8a16_matmul_experts.launches = 0
#: launches by expert stack shape, ``"<E>x<K>x<N>"``
w8a16_matmul_experts.launches_by_shape = {}


_fns = {}


def _kernel(name: str = "fma_w8a16_bf16"):
    """The library's entry ``name`` (``fma_w8a16_bf16``, or the batched
    ``fma_w8a16_bf16_experts``), built and bound on first use."""
    if name not in _fns:
        from .build import library

        fn = getattr(library("w8a16"), name)
        if name == "fma_w8a16_bf16":
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        else:  # ..., E, x's expert stride (elements), M, K, N, mb, k_split, splits, stream
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _call(fn, x: torch.Tensor, args: tuple) -> None:
    # the launch goes to the runtime's current device: switch only if needed
    if x.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(x.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"W8A16 kernel launch failed: CUDA error {err}")


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
    _call(_kernel(), x, args)
    count_launch(w8a16_matmul, "launches_by_shape", f"{K}x{N}")
    return y


def _check_experts(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the W8A16 kernel takes bf16 activations, got {x.dtype}")
    if q.dtype != torch.int8 or q.ndim != 3 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous int8 [E, K, N], got {q.dtype} {tuple(q.shape)}")
    E, K, N = q.shape
    if x.ndim not in (2, 3) or x.shape[-1] != K or (x.ndim == 3 and x.shape[0] != E):
        raise ValueError(f"x must be [M, {K}] or [{E}, M, {K}], got {tuple(x.shape)}")
    if s.dtype != torch.float32 or s.numel() != E * N or s.shape[0] != E or s.shape[-1] != N or not s.is_contiguous():
        raise ValueError(f"s must be a contiguous float32 [{E}, 1, {N}], got {s.dtype} {tuple(s.shape)}")
    if q.device != x.device or s.device != x.device:
        raise ValueError("x, q and s must be on one device")


def _launch_experts(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    _check_experts(x, q, s)
    E, K, N = q.shape
    M = x.shape[-2]
    x = x.contiguous()
    y = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y
    mb, k_split, splits = launch_plan(M, K, N, E)
    part = torch.empty((splits, E, M, N), dtype=torch.float32, device=x.device) if splits > 1 else None
    # a shared x is read by every expert: its expert stride is 0
    x_stride = M * K if x.ndim == 3 else 0
    args = (x.data_ptr(), q.data_ptr(), s.data_ptr(), 0 if part is None else part.data_ptr(), y.data_ptr(),
            E, x_stride, M, K, N, mb, k_split, splits)
    _call(_kernel("fma_w8a16_bf16_experts"), x, args)
    count_launch(w8a16_matmul_experts, "launches_by_shape", f"{E}x{K}x{N}")
    return y
