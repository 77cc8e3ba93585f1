"""Weight products of the model forward, weight-only int8 serving
(``--quantization int8``), and the transfer quantization of compressed
actuation (``--sleep-quant``).

Port of ``llm_d_fast_model_actuation_tpu/models/quant.py``:

  * :func:`qmat`, the model forward's every weight product. For a plain
    (bf16 or fp32) weight the JAX package leaves ``x @ w`` to XLA, so the
    port leaves it to ``torch.matmul``. Weights keep the reference's
    ``[in, out]`` layout, so the product is ``x @ w`` with no transpose.
  * the serving half of weight-only int8 (W8A16, ``--quantization int8``):
    :func:`quantize_weight` and :func:`quantize_params` turn every layer
    weight stack and ``lm_head`` into ``{"q": int8[..., out], "s":
    f32[..., 1, out]}``, a symmetric scale per output channel over the
    fan-in axis (embeddings and norms stay bf16), and :func:`qmat` on
    such a leaf computes ``(x @ q.to(x.dtype)) * s.to(x.dtype)``, the
    reference's rounding. On the card, at the rows of a decode step, of a
    speculative verify window and of a prefill bucket up to
    :data:`W8A16_MAX_ROWS`, that is the hand-written tensor-core kernel
    ``csrc/w8a16.cu`` (``ops/cuda/w8a16.py``), which reads each int8
    weight byte once and never writes a dequantized weight: the flag
    exists to halve decode's weight reads. Larger products (longer
    prefill buckets, packed buffers) and the CPU take the plain version,
    as the JAX package leaves them to XLA.
  * the transfer half: how weight bytes cross the PCIe boundary on a
    sleep, a wake and a swap (``engine/sleep.py``). An eligible leaf is
    quantized right before it leaves the card (or on the host, when a
    full-precision pool entry or a prefetch is staged), only the int8 or
    fp8 payload moves, and the wake dequantizes on the card into the
    leaf's own tensor. The engine always serves plain ``cfg.dtype``
    tensors, so nothing is captured again.

Numerics are the reference's, bit for bit, and lossy once. The first
quantized offload rounds each eligible weight (symmetric int8 with an f32
scale per output channel, or a dtype round trip through fp8 e4m3); every
later cycle reproduces the same bits, because the sleeper caches the int8
scales and ``round(dequant(q, s) / s) == q`` for ``|q| <= 127``, and an
fp8 round trip is exact. Rounding is half to even (``torch.round``), the
division f32. The fp8 conversion follows ``ml_dtypes`` (and so
``jnp.astype``) where torch does not: torch saturates a value above
e4m3's largest finite 448, ``ml_dtypes`` gives NaN (sign kept) for
``|x| > 464`` (464 itself rounds to 448), and so does the port, on the
card and on the host alike.

On the card a leaf is quantized and dequantized one ``[in, out]`` slice at
a time (``leaf[l]``, ``leaf[l, e]`` of an MoE expert stack; a 2-D leaf in
column blocks): the int8 scale reduces over
axis ``ndim - 2``, the fan-in, so the slices give the same bits as the
whole leaf, and no f32 temporary of a whole stack (7.5 GB for
Llama-3-8B's ``w_gate``) ever exists. These ops are XLA in the reference,
not Pallas: plain torch ops per slice are their port.
"""

from __future__ import annotations

import hashlib
import itertools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..ops.cuda.w8a16 import (
    w8a16_matmul,
    w8a16_matmul_experts,
    w8a16_matmul_experts_plain,
    w8a16_matmul_plain,
)

#: weight stacks of a llama-family layer tree that int8 serving and a
#: transfer quantize
LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

#: transfer quantization modes (--sleep-quant)
TRANSFER_MODES = ("off", "int8", "fp8")

#: top-level leaves the default "hot head" keeps at full precision
HOT_HEAD_KEYS = ("embed", "lm_head")

#: ``ml_dtypes``' e4m3fn overflow: a magnitude above this converts to NaN
FP8_NAN_ABOVE = 464.0

#: elements of one block of a 2-D leaf (column blocks bound the f32
#: temporaries as the layer slices do for a stack)
_BLOCK_ELEMS = 1 << 26


#: rows of ``x`` (all axes but the last) up to which a product with a
#: quantized weight on the card runs the W8A16 kernel. The kernel reads
#: the weight's int8 bytes once where the plain version reads them, writes
#: a bf16 copy and reads that again; on the tensor cores its time grows
#: with the rows only past one pass of 32. Timed by ``w8a16_ab.py`` on an
#: NVIDIA H100 80GB HBM3 at 700 W (weights cold in L2) at Llama-3-8B's
#: five products and Mixtral-8x7B's two expert stacks, it is faster than
#: the plain version at all seven at 1, 8, 16, 32 and 64 rows (at 64 the
#: closest is 4096 -> 1024, 0.0169 ms against 0.0243), and not at 128
#: (4096 -> 1024, 0.0287 ms against 0.0251). So 64: a decode step's rows
#: (``max_batch``), a speculative verify window's (16) and prefill buckets
#: up to 64 take the kernel; larger products (longer prefill buckets,
#: packed buffers) stay ``torch.matmul``, as the JAX package leaves them
#: to XLA.
W8A16_MAX_ROWS = 64


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def w8a16_routed(x: torch.Tensor, rows: int) -> bool:
    """Whether a product of ``x`` (``rows`` rows) with a quantized weight
    launches the W8A16 kernel: a bf16 ``x`` on the card with at most
    :data:`W8A16_MAX_ROWS` rows."""
    return _on_card(x) and x.dtype == torch.bfloat16 and rows <= W8A16_MAX_ROWS


def is_quantized(w: Any) -> bool:
    """Whether ``w`` is a quantized leaf ``{"q": int8, "s": f32}``."""
    return isinstance(w, dict) and "q" in w and "s" in w


def qmat(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` for a plain or a quantized weight (``x @ q`` rounded to
    ``x.dtype``, then times ``s`` rounded to ``x.dtype``): a bf16 ``x`` on
    the card with at most :data:`W8A16_MAX_ROWS` rows launches the W8A16
    kernel, any other product of a quantized weight takes its plain
    version."""
    if is_quantized(w):
        q, s = w["q"], w["s"]
        if w8a16_routed(x, x.numel() // max(1, x.shape[-1])):
            return w8a16_matmul(x, q, s)
        return w8a16_matmul_plain(x, q, s)
    if not isinstance(w, torch.Tensor):
        raise TypeError(f"a weight is a tensor or a quantized leaf {{'q', 's'}}, got {type(w).__name__}")
    return torch.matmul(x, w)


def qeinsum(x: torch.Tensor, w: Any) -> torch.Tensor:
    """The expert products of an MoE layer (the reference's ``moe.py:
    _qeinsum``), expert major: ``x [rows, in]`` (one input every expert
    reads) or ``[E, rows, in]`` (an input per expert) times an expert
    stack ``w [E, in, out]``, plain or ``{"q", "s"}`` with ``s [E, 1,
    out]``, gives ``[E, rows, out]``, each product rounded to ``x.dtype``
    and a quantized one then times its scale rounded to ``x.dtype``. A
    bf16 ``x`` on the card with at most :data:`W8A16_MAX_ROWS` rows and a
    quantized stack launches the batched W8A16 kernel, one launch for all
    E experts; any other product of a quantized stack takes its plain
    version, and a plain stack is ``torch.matmul``."""
    if is_quantized(w):
        q, s = w["q"], w["s"]
        if w8a16_routed(x, x.shape[-2]):
            return w8a16_matmul_experts(x, q, s)
        return w8a16_matmul_experts_plain(x, q, s)
    if not isinstance(w, torch.Tensor):
        raise TypeError(f"a weight is a tensor or a quantized leaf {{'q', 's'}}, got {type(w).__name__}")
    return torch.matmul(x, w)


@torch.no_grad()
def quantize_weight(w: torch.Tensor, q_out: Optional[torch.Tensor] = None,
                    s_out: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Symmetric int8 with an f32 scale per output channel, reduced over
    the fan-in axis (``ndim - 2``) only, so a layer stack ``[L, in, out]``
    keeps a scale per layer (``[L, 1, out]``) and slicing a layer slices
    its scale: the reference's ``quantize_weight``, bit for bit (the same
    formula as the transfer's :func:`quantize_leaf`, whose slice-at-a-time
    code it runs, where ``w`` lies). An expert stack ``[E, in, out]`` or
    ``[L, E, in, out]`` keeps a scale per expert too, and is quantized an
    expert slice at a time. ``q_out``/``s_out`` are the tensors to
    write in place (an engine's arena tensors), else new ones."""
    q, meta = quantize_leaf(w, "int8", out=q_out)
    s = meta.scale
    if s_out is not None:
        s_out.copy_(s)
        s = s_out
    return {"q": q, "s": s}


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's ``quantize_params`` on a nested weight tree
    (``{"embed", "layers": {"wq", ...}, "lm_head", ...}``): every stack
    of :data:`LAYER_WEIGHTS` (3-D, or an MoE layer's 4-D expert stacks
    ``[L, E, in, out]``, a scale per expert) and ``lm_head`` becomes a
    quantized leaf; the embedding, the norms and an MoE router stay as
    they are."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in LAYER_WEIGHTS:
        w = layers.get(name)
        if w is not None and not is_quantized(w):
            if w.ndim not in (3, 4):
                raise ValueError(f"layers/{name}: a layer stack is 3-D, or 4-D for experts; got {tuple(w.shape)}")
            layers[name] = quantize_weight(w)
    out["layers"] = layers
    head = params.get("lm_head")
    if head is not None and not is_quantized(head):
        out["lm_head"] = quantize_weight(head)
    return out


def quantized_axes(axes: Dict[str, Any]) -> Dict[str, Any]:
    """The logical-axes tree of :func:`quantize_params`' structure (the
    reference's ``quantized_axes``): ``q`` keeps the weight's axes; the
    scale keeps every axis but the fan-in (size 1 there), so it is split
    only where its output axis is: with its ``q`` for a column-parallel
    weight, whole on every rank for a row-parallel one."""
    out = dict(axes)
    layers = dict(axes["layers"])
    for name in LAYER_WEIGHTS:
        ax = layers.get(name)
        if ax is not None and len(ax) in (3, 4):
            layers[name] = {"q": ax, "s": ax[:-2] + (None, ax[-1])}
    out["layers"] = layers
    if "lm_head" in axes:
        ax = axes["lm_head"]
        out["lm_head"] = {"q": ax, "s": (None, ax[-1])}
    return out


def fp8_dtype() -> torch.dtype:
    """The fp8 transfer dtype (e4m3: weight-shaped range, 3 mantissa
    bits)."""
    return torch.float8_e4m3fn


def transfer_quant_supported(mode: str) -> Optional[str]:
    """None when ``mode`` can run here, else a reason (the flag's
    validation)."""
    if mode in ("", "off"):
        return None
    if mode not in TRANSFER_MODES:
        return f"unknown sleep-quant mode {mode!r} (want {TRANSFER_MODES})"
    if mode == "fp8" and not hasattr(torch, "float8_e4m3fn"):
        return f"fp8 transfers need torch.float8_e4m3fn (torch {torch.__version__})"
    return None


@dataclass
class TransferQuant:
    """What a wake needs to rebuild one quantized leaf: kept beside the
    host state (a list aligned with its leaves), never inside it."""

    mode: str  #: "int8" | "fp8"
    orig_dtype: str  #: numpy dtype name of the full-precision leaf
    #: f32 scale per output channel, broadcastable: shape[:-2] + (1, out)
    #: (int8 only). On the device it was computed on until a sleep moves
    #: it to the host with the payload.
    scale: Optional[torch.Tensor] = None
    #: the shard view a mesh leaf was quantized from; always None here
    #: (one card: ``--sleep-quant`` on a mesh is refused)
    spec: Optional[str] = None
    #: the payload's :func:`transfer_digest`, kept once computed: a slept
    #: payload is never written again, and it moves between models (a
    #: delta swap hands it on) with this metadata, so it is hashed once
    digest: Optional[str] = None

    @property
    def scale_nbytes(self) -> int:
        return 0 if self.scale is None else self.scale.numel() * self.scale.element_size()


def quant_eligible(keys: Sequence[str], ndim: int, hot_head: bool = True) -> bool:
    """Whether a quantized transfer compresses the floating-point weight at
    ``keys`` (its path in the weight tree) with ``ndim`` dimensions: the
    layer matmul weights (:data:`LAYER_WEIGHTS`, ndim 3 or 4), and
    ``embed`` and ``lm_head`` (ndim 2) when ``hot_head`` is False."""
    if not keys or ndim < 2:
        return False
    if keys[0] == "layers" and keys[-1] in LAYER_WEIGHTS and ndim in (3, 4):
        return True
    return not hot_head and keys[-1] in HOT_HEAD_KEYS and ndim == 2


def transfer_quant_plan(state: Any, hot_head: bool = True, prefix: str = "params") -> List[bool]:
    """Which leaves of ``state`` a quantized transfer compresses, aligned
    with ``flatten_state(state)``: the floating-point weights under
    ``prefix`` that :func:`quant_eligible` takes. Norms, biases, the KV
    pool and scheduler tensors never quantize."""
    cs = _chunk_store()
    out: List[bool] = []
    for keys, leaf in zip(cs.leaf_paths(state), cs.flatten_state(state)):
        if prefix:
            if not keys or keys[0] != prefix:
                out.append(False)
                continue
            keys = keys[1:]
        out.append(leaf.dtype.is_floating_point and quant_eligible(keys, leaf.ndim, hot_head))
    return out


def payload_nbytes(shape: Sequence[int], mode: str) -> int:
    """Wire bytes of one quantized leaf: the 1-byte payload plus the int8
    path's f32 scale (axis ``ndim-2`` reduced to 1). Shapes only."""
    elems = math.prod(int(d) for d in shape)
    scale = (elems // max(1, int(shape[-2]))) * 4 if mode == "int8" else 0
    return elems + scale


def _blocks(shape: Sequence[int]) -> List[Tuple[Any, ...]]:
    """Index tuples that cut a leaf into pieces whose int8 scales are
    independent: its ``[in, out]`` slices (``[l]`` of a layer stack,
    ``[l, e]`` of an MoE expert stack), or for a 2-D leaf column blocks
    (``[:, a:b]``), each a bounded number of elements."""
    if len(shape) >= 3:
        return list(itertools.product(*(range(int(n)) for n in shape[:-2])))
    if len(shape) < 2:
        return [(Ellipsis,)]
    rows, cols = int(shape[0]), int(shape[1])
    step = max(1, _BLOCK_ELEMS // max(1, rows))
    return [(slice(None), slice(a, min(cols, a + step))) for a in range(0, cols, step)]


def _chunk_store():
    # imported where used: the engine package imports the model, which
    # imports this module
    from ..engine import chunk_store

    return chunk_store


def payload_dtype(mode: str) -> torch.dtype:
    """The dtype of a ``mode`` payload."""
    return torch.int8 if mode == "int8" else fp8_dtype()


def _fp8_fix_overflow(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``ml_dtypes``' overflow rule on an fp8 payload converted from
    ``src``: NaN (0x7f, or 0xff for a negative value) wherever ``|src| >
    464`` or ``src`` is NaN, where torch saturated."""
    bits = dst.view(torch.uint8)
    bad = ~(src.abs() <= FP8_NAN_ABOVE)
    nan = torch.where(torch.signbit(src), 0xFF, 0x7F).to(torch.uint8)
    bits.copy_(torch.where(bad, nan, bits))


#: a quiet NaN's bits per dtype, positive and negative, as ``ml_dtypes``
#: writes an fp8 NaN widened (torch keeps neither the payload nor, for
#: bf16, the sign)
_QUIET_NAN = {
    torch.float32: (torch.int32, 0x7FC00000, -0x400000),
    torch.bfloat16: (torch.int16, 0x7FC0, -0x40),
    torch.float16: (torch.int16, 0x7E00, -0x200),
    torch.float64: (torch.int64, 0x7FF8000000000000, -0x8000000000000),
}


def _fp8_widen(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` from an fp8 payload, with each NaN written as
    ``ml_dtypes`` widens it (a quiet NaN of the payload's sign)."""
    dst.copy_(src)
    ibits, pos, neg = _QUIET_NAN[dst.dtype]
    raw = src.view(torch.uint8)
    nan = (raw & 0x7F) == 0x7F
    bits = dst.view(ibits)
    bits.copy_(torch.where(nan, torch.where(raw >= 0x80, neg, pos).to(ibits), bits))


@torch.no_grad()
def quantize_leaf(
    t: torch.Tensor, mode: str, scale: Optional[torch.Tensor] = None, out: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, TransferQuant]:
    """Quantize one leaf for transfer, where it lies (on the card when
    ``t`` is there, so only the payload crosses the boundary), one layer
    slice at a time. ``scale`` (the sleeper's cached scale from the leaf's
    first quantization, on any device) makes re-quantization
    bit-idempotent. ``out`` is the payload tensor to write (allocated
    beside ``t`` when None). Returns (payload, meta); the meta's scale is
    on ``t``'s device."""
    orig = _chunk_store().NP_NAMES[t.dtype]
    q = out if out is not None else torch.empty(t.shape, dtype=payload_dtype(mode), device=t.device)
    if mode == "fp8":
        for idx in _blocks(t.shape):
            q[idx].copy_(t[idx])
            _fp8_fix_overflow(q[idx], t[idx])
        return q, TransferQuant(mode="fp8", orig_dtype=orig)
    if mode != "int8":
        raise ValueError(f"unknown transfer quantization mode {mode!r}")
    want = tuple(t.shape[:-2]) + (1, t.shape[-1])
    if scale is None:
        s = torch.empty(want, dtype=torch.float32, device=t.device)
        for idx in _blocks(t.shape):
            amax = torch.amax(t[idx].abs(), dim=-2, keepdim=True).float()
            # a true division by a tensor: on the card, torch divides by a
            # Python scalar as a product with its reciprocal, which can
            # round the last bit apart from the reference's quotient
            s[idx].copy_(torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-8))
    else:
        s = scale.to(device=t.device, dtype=torch.float32)
        if tuple(s.shape) != want:
            raise ValueError(f"cached scale {tuple(s.shape)} does not fit a leaf of {tuple(t.shape)}")
    tmp = None
    for idx in _blocks(t.shape):
        piece = t[idx]
        if tmp is None or tmp.shape != piece.shape:
            tmp = torch.empty(piece.shape, dtype=torch.float32, device=t.device)
        torch.div(piece, s[idx], out=tmp)
        q[idx].copy_(tmp.round_().clamp_(-127, 127))
    return q, TransferQuant(mode="int8", orig_dtype=orig, scale=s)


def quantize_leaf_host(
    t: torch.Tensor, mode: str, scale: Optional[torch.Tensor] = None, pin: bool = False
) -> Tuple[torch.Tensor, TransferQuant]:
    """Host twin of :func:`quantize_leaf` (the reference's
    ``quantize_leaf_np``): the staging of a full-precision pool entry or a
    prefetch, with no round trip through the card. The same ops on the
    CPU, so the payload's bits equal the card's for the same input;
    ``pin`` allocates the payload in pinned memory."""
    if t.device.type != "cpu":
        raise ValueError(f"the host twin quantizes host tensors, got one on {t.device}")
    out = torch.empty(t.shape, dtype=payload_dtype(mode), pin_memory=pin)
    return quantize_leaf(t, mode, scale=None if scale is None else scale.cpu(), out=out)


@torch.no_grad()
def dequantize_leaf(payload: torch.Tensor, meta: TransferQuant, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rebuild the full-precision leaf from a payload where the payload
    lies (on the card for a wake), one layer slice at a time, into ``out``
    in place (the arena's own tensor: no second copy of the leaf) or a new
    tensor when None."""
    dt = _chunk_store().TORCH_DTYPES[meta.orig_dtype]
    dst = out if out is not None else torch.empty(payload.shape, dtype=dt, device=payload.device)
    if meta.mode == "fp8":
        for idx in _blocks(payload.shape):
            _fp8_widen(dst[idx], payload[idx])
        return dst
    s = meta.scale.to(device=payload.device, dtype=torch.float32)
    for idx in _blocks(payload.shape):
        dst[idx].copy_(torch.mul(payload[idx], s[idx]))
    return dst


@torch.no_grad()
def dequantize_into(
    dest: torch.Tensor, payload: torch.Tensor, meta: TransferQuant, copy_stream: Optional[Any] = None
) -> None:
    """Rebuild a quantized leaf into ``dest``, its own tensor, in place:
    the one way a wake, a swap, its rollback and a staged placement
    dequantize. Where ``dest`` lies with the payload (the CPU), it
    dequantizes there. For the card, the host payload and its scale are
    first copied into device buffers on ``copy_stream`` (the current
    stream when None); the current stream waits for those copies and
    dequantizes, and both buffers go back to the allocator only after
    that has run (``record_stream``), so a later copy on ``copy_stream``
    can never overwrite them early."""
    if dest.device == payload.device:
        dequantize_leaf(payload, meta, out=dest)
        return
    compute = torch.cuda.current_stream(dest.device)
    copy = compute if copy_stream is None else copy_stream
    with torch.cuda.stream(copy):
        buf = payload.to(dest.device, non_blocking=True)
        scale = None if meta.scale is None else meta.scale.to(dest.device, non_blocking=True)
    if copy != compute:
        compute.wait_stream(copy)
        buf.record_stream(compute)
        if scale is not None:
            scale.record_stream(compute)
    dequantize_leaf(buf, TransferQuant(meta.mode, meta.orig_dtype, scale=scale), out=dest)


def dequantize_leaf_host(payload: torch.Tensor, meta: TransferQuant) -> torch.Tensor:
    """Host twin of :func:`dequantize_leaf`."""
    if payload.device.type != "cpu":
        raise ValueError(f"the host twin dequantizes host tensors, got one on {payload.device}")
    return dequantize_leaf(payload, meta)


def transfer_digest(payload: torch.Tensor, meta: TransferQuant, payload_digest: Optional[str] = None) -> str:
    """Content digest of a quantized chunk (payload, scale, mode and the
    dtype it dequantizes to), the reference's string: what the tiered
    pool dedupes quantized entries on. Its own digest space
    (``QUANT_DIGEST_PREFIX``): a payload never content-matches, and is
    never handed out as, the full-precision tensor it came from. Host
    tensors; ``payload_digest`` is the payload's ``leaf_digest`` when the
    caller hashed it already."""
    cs = _chunk_store()
    h = hashlib.sha256()
    h.update(f"tq|{meta.mode}|{meta.orig_dtype}|".encode())
    h.update((payload_digest or cs.leaf_digest(payload)).encode())
    if meta.scale is not None:
        h.update(cs.leaf_digest(meta.scale).encode())
    return cs.QUANT_DIGEST_PREFIX + h.hexdigest()


def transfer_digest_map(state: Any, metas: Sequence[Optional[TransferQuant]], prefix: str = "params") -> Dict[str, str]:
    """Flat weight key -> :func:`transfer_digest` for the quantized leaves
    of a slept or staged tree (``metas`` aligned with its flatten order).
    The payloads are hashed side by side (``chunk_store.digest_leaves``)."""
    cs = _chunk_store()
    picked: Dict[str, Tuple[torch.Tensor, TransferQuant]] = {}
    for keys, leaf, meta in zip(cs.leaf_paths(state), cs.flatten_state(state), metas):
        if meta is None:
            continue
        if prefix:
            if not keys or keys[0] != prefix:
                continue
            keys = keys[1:]
        picked["/".join(keys)] = (leaf, meta)
    todo = {k: leaf for k, (leaf, meta) in picked.items() if meta.digest is None}
    hashed = cs.digest_leaves(todo) if todo else {}
    for k, d in hashed.items():
        leaf, meta = picked[k]
        meta.digest = transfer_digest(leaf, meta, payload_digest=d)
    return {k: meta.digest for k, (_, meta) in picked.items()}
