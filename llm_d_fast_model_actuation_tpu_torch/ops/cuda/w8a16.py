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
* s.to(x.dtype)``, materializes the bf16 weight. It multiplies on the
tensor cores (``mma.sync.m16n8k16``, bf16 fragments converted in
registers from the int8 bytes, f32 sums), so its time is its bytes' up to
well past decode's rows. Its host-side plan (rows per pass, the split of
K) is :func:`launch_plan`, mirrored in the kernel's source and tested on
the CPU (``tests/test_torch_w8a16_plan.py`` emulates the decomposition).
The wrapper takes the plain version for CPU tensors and launches the
kernel for CUDA tensors (bf16 only), or raises; it never falls back. It
allocates its output and the split partials with ``torch.empty`` and does
not synchronize, so a launch can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from .build import count_launch

#: output channels of one CTA (kTileN): a warp's 8 lane groups x 16
#: channels, one 16-byte load of a q row each
TILE_N = 128
#: K of one mma step (kStepK); K must be a multiple of it
STEP_K = 16
#: warps of a CTA (kWarps), taking its K steps in turn
WARPS = 4
#: a split's K is a multiple of this (kSplitK: every warp one step)
K_STEP = WARPS * STEP_K
#: rows of x one pass of a CTA holds in its mma tiles at most (4 n-tiles
#: of 8); more rows loop over passes
MAX_MB = 32
#: SMs of an H100
SMS = 132
#: CTAs of the kernel an SM holds at once, by rows a pass: the registers
#: its ``__launch_bounds__`` give a lane (128, 170 and 255)
RESIDENT = {8: 4, 16: 3, 32: 2}
#: the least K of a split: four of each warp's steps, two rounds of its ring
MIN_SPLIT_K = 256
#: a CTA's fixed cost (its launch, the ring's first loads, the hand-over of
#: the warps' sums and the epilogue), counted in K of streaming
OVERHEAD_K = 256


@functools.lru_cache(maxsize=1024)
def launch_plan(M: int, K: int, N: int, experts: int = 1) -> Tuple[int, int, int]:
    """(mb, k_split, splits) for ``[M, K] @ [K, N]`` in each of
    ``experts`` experts: ``mb`` rows of x a pass (8, 16 or
    :data:`MAX_MB`: one, two or four n-tiles of 8), K cut into ``splits``
    ranges of ``k_split`` (a multiple of :data:`K_STEP`, at least
    :data:`MIN_SPLIT_K` unless K is shorter). The ``ceil(N / 128)``
    column tiles times the experts times the splits run in waves of
    ``SMS x RESIDENT[mb]`` CTAs; the split taken is the one whose waves
    times a CTA's work (its K plus :data:`OVERHEAD_K`) is least, the fewer
    splits on a tie: one wave as full as it gets for a small product, no
    split, or the split that evens out the last wave, for a large one.
    Every expert runs the same plan, and every row count of one pass
    (M <= 8 at decode) the same split. Kept per shape: a decode step asks
    225 times."""
    if K % STEP_K or N % 16:
        raise ValueError(f"the W8A16 kernel takes K % {STEP_K} == 0 and N % 16 == 0, got K={K}, N={N}")
    if experts < 1:
        raise ValueError(f"the W8A16 kernel takes at least one expert, got {experts}")
    mb = 8 if M <= 8 else 16 if M <= 16 else MAX_MB
    tiles = -(-N // TILE_N) * experts
    slots = SMS * RESIDENT[mb]
    best = None
    for want in range(1, max(1, K // MIN_SPLIT_K) + 1):
        k_split = -(-K // want // K_STEP) * K_STEP
        splits = -(-K // k_split)
        cost = -(-tiles * splits // slots) * (k_split + OVERHEAD_K)
        if best is None or cost < best[0]:
            best = (cost, k_split, splits)
    return mb, best[1], best[2]


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
    _check_aligned(q, s)


def _check_aligned(q: torch.Tensor, s: torch.Tensor) -> None:
    # the kernel reads q and s 16 bytes at a time
    if q.data_ptr() % 16 or s.data_ptr() % 16:
        raise ValueError(f"q and s must be 16-byte aligned, got addresses {q.data_ptr():#x} and {s.data_ptr():#x}")


def _aligned_x(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at an address the kernel's 8-byte loads take (a view
    at an odd offset is copied)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


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
    x2 = _aligned_x(x.reshape(M, K))
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
    _check_aligned(q, s)


def _launch_experts(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    _check_experts(x, q, s)
    E, K, N = q.shape
    M = x.shape[-2]
    x = _aligned_x(x)
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
