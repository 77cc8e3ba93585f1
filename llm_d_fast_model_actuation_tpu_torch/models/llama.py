"""Llama-family decoder (Llama 2/3, Qwen2-style GQA, Gemma-style knobs).

Port of ``llm_d_fast_model_actuation_tpu/models/llama.py``. The module
keeps the reference's parameter names and stacked layouts — layer weights
carry a leading layer axis (``layers.wq`` is ``[L, hidden, q_dim]``) and
every product is ``x @ w`` — so carrying weights across is a copy and the
sleep byte counts equal the reference's. The reference's ``lax.scan`` over
layers becomes a Python loop over the layer index, on views of the
stacked weights and of the page pool (``k_pages[l]``).

The paged KV pool ``[L, num_pages, page_size, kv_heads, head_dim]`` is
written IN PLACE by the forward functions (the JAX functions return a new
pool; here the caller's tensors are updated). The reference drops the
writes of padding and inactive rows by sending them to the out-of-range
page ``num_pages``; ``index_put_`` has no drop mode and an out-of-range
index on CUDA is a device-side assert, so here they go to page 0, the
null page the allocator never hands out and no attention reads unmasked.
The write then needs no mask and no host sync.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (
    causal_prefill_attention,
    paged_decode_attention,
    paged_decode_attention_inline,
    paged_suffix_attention,
    ragged_paged_attention,
)
from ..ops.norm import rms_norm
from ..ops.rope import apply_rope, rope_table
from .quant import qmat

Cache = Tuple[torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 14336
    rope_theta: float = 500000.0
    #: HF-style rope_scaling as a tuple (ops/rope.py):
    #: ("linear", factor) or ("llama3", factor, low_ff, high_ff, orig_max).
    rope_scaling: Any = None
    rms_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False
    #: the decode step's cache-write strategy, with the reference's values:
    #: "reference" scatters each layer's new K/V into the pool before it
    #: attends (paged_decode_attention); "grouped" and "pallas" attend with
    #: the new K/V inline and write all layers once after the loop. The
    #: kernel is chosen by the device of the tensors, not by this field.
    attention_impl: str = "reference"
    #: weight-only quantization: only "" (plain weights) is ported yet
    quantization: str = ""
    # -- Gemma-family knobs (llama-neutral defaults; one shared forward) --
    #: MLP gate activation: "silu" (llama) or "gelu" (gemma GeGLU, tanh form)
    hidden_activation: str = "silu"
    #: RMSNorm weight offset: 0.0 (llama) or 1.0 (gemma's (1+w) convention)
    norm_offset: float = 0.0
    #: sandwich norms: normalize attention/FFN outputs before the residual
    post_norms: bool = False
    #: scale embeddings by sqrt(hidden_size) (gemma)
    embed_scale: bool = False
    #: per-head RMSNorm on q and k before RoPE (gemma-3 style)
    qk_norm: bool = False
    #: biases on the q/k/v projections (Qwen2 convention)
    attn_bias: bool = False

    @classmethod
    def tiny(cls, vocab: int = 256) -> "LlamaConfig":
        """CPU test size."""
        return cls(
            vocab_size=vocab,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            intermediate_size=128,
            rope_theta=10000.0,
            max_seq_len=128,
        )

    @classmethod
    def tiny_gemma(cls, vocab: int = 256) -> "LlamaConfig":
        """Gemma-3-style tiny config: GeGLU, (1+w) norms, sandwich norms,
        scaled embeddings, QK-norm, tied embeddings."""
        return dataclasses.replace(
            cls.tiny(vocab),
            hidden_activation="gelu",
            norm_offset=1.0,
            post_norms=True,
            embed_scale=True,
            qk_norm=True,
            tie_embeddings=True,
        )

    @classmethod
    def gemma3_4b(cls) -> "LlamaConfig":
        return cls(
            vocab_size=262144,
            hidden_size=2560,
            num_layers=34,
            num_heads=8,
            num_kv_heads=4,
            head_dim=256,
            intermediate_size=10240,
            rope_theta=1e6,
            max_seq_len=32768,
            tie_embeddings=True,
            hidden_activation="gelu",
            norm_offset=1.0,
            post_norms=True,
            embed_scale=True,
            qk_norm=True,
        )

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def llama3_70b(cls) -> "LlamaConfig":
        return cls(
            hidden_size=8192,
            num_layers=80,
            num_heads=64,
            num_kv_heads=8,
            intermediate_size=28672,
        )

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


def param_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[int, ...]]:
    """Flat parameter name -> shape, in the reference's names and stacked
    layouts (``layers.<name>`` for the per-layer stacks)."""
    h, L = cfg.hidden_size, cfg.num_layers
    shapes = {
        "embed": (cfg.vocab_size, h),
        "layers.attn_norm": (L, h),
        "layers.wq": (L, h, cfg.q_dim),
        "layers.wk": (L, h, cfg.kv_dim),
        "layers.wv": (L, h, cfg.kv_dim),
        "layers.wo": (L, cfg.q_dim, h),
        "layers.mlp_norm": (L, h),
        "layers.w_gate": (L, h, cfg.intermediate_size),
        "layers.w_up": (L, h, cfg.intermediate_size),
        "layers.w_down": (L, cfg.intermediate_size, h),
    }
    if cfg.post_norms:
        shapes["layers.post_attn_norm"] = (L, h)
        shapes["layers.post_ffn_norm"] = (L, h)
    if cfg.qk_norm:
        shapes["layers.q_norm"] = (L, cfg.head_dim)
        shapes["layers.k_norm"] = (L, cfg.head_dim)
    if cfg.attn_bias:
        shapes["layers.bq"] = (L, cfg.q_dim)
        shapes["layers.bk"] = (L, cfg.kv_dim)
        shapes["layers.bv"] = (L, cfg.kv_dim)
    shapes["final_norm"] = (h,)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (h, cfg.vocab_size)
    return shapes


class Llama(nn.Module):
    """The decoder's parameters (uninitialized until loaded or
    :func:`init_params` fills them) plus its RoPE table, all on one
    device. Parameters never require grad: this is a serving model."""

    def __init__(self, cfg: LlamaConfig, device: "torch.device | str") -> None:
        super().__init__()
        if cfg.quantization:
            raise ValueError(
                f"quantization {cfg.quantization!r} is not supported by the port yet"
            )
        self.cfg = cfg
        self.layers = nn.ParameterDict()
        for name, shape in param_shapes(cfg).items():
            p = nn.Parameter(
                torch.empty(shape, dtype=cfg.dtype, device=device),
                requires_grad=False,
            )
            if name.startswith("layers."):
                self.layers[name[len("layers."):]] = p
            else:
                self.register_parameter(name, p)
        self.register_buffer("rope_cos", None, persistent=False)
        self.register_buffer("rope_sin", None, persistent=False)
        self.build_tables()

    @property
    def device(self) -> torch.device:
        return self.rope_cos.device

    def build_tables(self) -> None:
        """(Re)build the RoPE tables on the model's device."""
        cfg = self.cfg
        device = self.embed.device
        self.rope_cos, self.rope_sin = rope_table(
            cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
            device=device,
        )

    def free_tables(self) -> None:
        """Free the RoPE tables (a sleeping model holds no device memory;
        :meth:`build_tables` restores them, bit for bit)."""
        self.rope_cos = torch.empty(0, device=self.rope_cos.device)
        self.rope_sin = torch.empty(0, device=self.rope_sin.device)

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        """Views of layer ``i``'s weights (the scan body's ``lp``)."""
        return {name: p[i] for name, p in self.layers.items()}

    def head(self) -> torch.Tensor:
        return self.embed.t() if self.cfg.tie_embeddings else self.lm_head


def init_params(
    cfg: LlamaConfig,
    generator: torch.Generator,
    device: "torch.device | str",
) -> Llama:
    """Random-init parameters (serving loads checkpoints; random init is
    for tests and benchmarks), drawn from ``generator``, which must live
    on ``device``. Same distributions as the reference (normal scaled by
    fan_in**-0.5, identity norms); not the same numbers — JAX's threefry
    and torch's Philox differ. Stacked weights are drawn one layer at a
    time, so the fp32 staging never exceeds one layer's slice."""
    model = Llama(cfg, device)
    fill = 0.0 if cfg.norm_offset else 1.0
    with torch.no_grad():
        for name, p in model.named_parameters():
            short = name.split(".")[-1]
            if "norm" in short:
                p.fill_(fill)
            elif short in ("bq", "bk", "bv"):
                p.zero_()
            else:
                fan_in = p.shape[-2] if short != "embed" else p.shape[-1]
                slices = [p] if p.dim() == 2 else list(p)
                for dst in slices:
                    src = torch.randn(
                        dst.shape, generator=generator, device=device,
                        dtype=torch.float32,
                    )
                    dst.copy_(src.mul_(fan_in**-0.5))
    return model


# -- forward -----------------------------------------------------------------


def _norm(cfg: LlamaConfig, x, w):
    return rms_norm(x, w, cfg.rms_eps, offset=cfg.norm_offset)


def _post(cfg: LlamaConfig, lp, name: str, y):
    """Sandwich (post) norm on a block output, when the family has them."""
    if cfg.post_norms:
        return _norm(cfg, y, lp[name])
    return y


def _embed_tokens(model: Llama, tokens):
    cfg = model.cfg
    x = model.embed[tokens.long()].to(cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.hidden_size**0.5, dtype=cfg.dtype)
    return x


def _mlp(cfg: LlamaConfig, x, gate, up, down):
    g = qmat(x, gate).float()
    if cfg.hidden_activation == "gelu":
        a = F.gelu(g, approximate="tanh")
    else:
        a = F.silu(g)
    return qmat(a.to(x.dtype) * qmat(x, up), down)


def _project_qkv(model: Llama, lp, x, positions):
    """x: [b, s, hidden] -> q [b,s,heads,hd], k/v [b,s,kvh,hd], roped."""
    cfg = model.cfg
    b, s, _ = x.shape
    q, k, v = qmat(x, lp["wq"]), qmat(x, lp["wk"]), qmat(x, lp["wv"])
    if cfg.attn_bias:
        q = q + lp["bq"].to(q.dtype)
        k = k + lp["bk"].to(k.dtype)
        v = v + lp["bv"].to(v.dtype)
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        # per-head RMSNorm before RoPE (gemma-3 convention)
        q = rms_norm(q, lp["q_norm"], cfg.rms_eps, offset=cfg.norm_offset)
        k = rms_norm(k, lp["k_norm"], cfg.rms_eps, offset=cfg.norm_offset)
    q = apply_rope(q, positions, model.rope_cos, model.rope_sin)
    k = apply_rope(k, positions, model.rope_cos, model.rope_sin)
    return q, k, v


def _scatter_prefill(pages, new, page_table, positions, valid, page_size):
    """Write prefill K or V [b,s,kvh,hd] into one layer's pages, in place.
    Padding positions (``valid`` false) write to the null page 0; their
    logical page is clamped first, as it may lie past the page table."""
    page_of = (positions // page_size).long().clamp_(max=page_table.shape[1] - 1)
    slot_of = (positions % page_size).long()
    phys = torch.gather(page_table.long(), 1, page_of)  # [b, s]
    phys = torch.where(valid, phys, 0)
    pages[phys.reshape(-1), slot_of.reshape(-1)] = new.reshape((-1,) + new.shape[2:])


def _row_targets(page_table, row_slot, positions, page_size):
    """(page, slot) each row of a packed buffer writes its K/V to: its OWN
    sequence's page (``page_table[row_slot[t]]``) at its own position.
    Padding rows (``row_slot < 0``) write the null page 0; the reference
    drops them (``llama.py:_scatter_rows``). The logical page is clamped
    first: a padding row's may lie past the table. Computed once per
    step, shared by every layer's write."""
    page_of = (positions // page_size).long().clamp_(max=page_table.shape[1] - 1)
    safe = row_slot.long().clamp(0, page_table.shape[0] - 1)
    phys = page_table[safe, page_of].long()
    return torch.where(row_slot >= 0, phys, 0), (positions % page_size).long()


def _scatter_rows(pages, new, targets):
    """Write a packed buffer's K or V [T, kvh, hd] into one layer's pages,
    in place, at ``targets`` (:func:`_row_targets`)."""
    pages[targets] = new


def _scatter_decode(pages, new, page_table, positions, page_size):
    """Write one token's K or V [b, kvh, hd] per sequence at ``positions``
    [b] into one layer's pages, in place (rows of the null page in
    ``page_table`` write there)."""
    phys = torch.gather(page_table.long(), 1, (positions.long() // page_size)[:, None])[:, 0]
    pages[phys, positions.long() % page_size] = new


def _logits(model: Llama, x):
    x = _norm(model.cfg, x, model.final_norm)
    return qmat(x, model.head()).float()


def _layer_tail(model: Llama, lp, x, attn):
    cfg = model.cfg
    x = x + _post(cfg, lp, "post_attn_norm", qmat(attn, lp["wo"]))
    h = _norm(cfg, x, lp["mlp_norm"])
    return x + _post(cfg, lp, "post_ffn_norm", _mlp(cfg, h, lp["w_gate"], lp["w_up"], lp["w_down"]))


@torch.no_grad()
def prefill(
    model: Llama,
    tokens: torch.Tensor,  # [b, s] int, right-padded
    seq_lens: torch.Tensor,  # [b] int32
    cache: Cache,  # k/v pages [L, P, ps, kvh, hd], written in place
    page_table: torch.Tensor,  # [b, pages_per_seq] int32
) -> torch.Tensor:
    """Prefill a batch of prompts, writing their KV into the pool.
    Returns logits [b, s, vocab] fp32; the caller reads them at
    seq_lens-1."""
    cfg = model.cfg
    b, s = tokens.shape
    k_pages, v_pages = cache
    page_size = k_pages.shape[2]
    positions = torch.arange(s, dtype=torch.int64, device=tokens.device).expand(b, s)
    valid = positions < seq_lens[:, None]
    x = _embed_tokens(model, tokens)
    for i in range(cfg.num_layers):
        lp = model.layer(i)
        h = _norm(cfg, x, lp["attn_norm"])
        q, k, v = _project_qkv(model, lp, h, positions)
        _scatter_prefill(k_pages[i], k, page_table, positions, valid, page_size)
        _scatter_prefill(v_pages[i], v, page_table, positions, valid, page_size)
        attn = causal_prefill_attention(q, k, v, seq_lens)
        x = _layer_tail(model, lp, x, attn.reshape(b, s, cfg.q_dim))
    return _logits(model, x)


@torch.no_grad()
def prefill_continue(
    model: Llama,
    tokens: torch.Tensor,  # [b, s] int suffix tokens, right-padded
    start: torch.Tensor,  # [b] int32 — absolute position of tokens[:, 0]
    suffix_lens: torch.Tensor,  # [b] int32 — valid suffix length per row
    cache: Cache,  # written in place
    page_table: torch.Tensor,  # [b, pages_per_seq] int32
) -> torch.Tensor:
    """Prefill a prompt SUFFIX against a pool whose first ``start`` tokens
    are already present (prefix-cache hits, chunked prefill): writes only
    the suffix's KV, then attends over the paged cache. Returns logits
    [b, s, vocab] fp32; the caller samples at suffix_lens-1."""
    cfg = model.cfg
    b, s = tokens.shape
    k_pages, v_pages = cache
    page_size = k_pages.shape[2]
    ar = torch.arange(s, dtype=torch.int64, device=tokens.device)
    positions = start.long()[:, None] + ar[None, :]
    valid = ar[None, :] < suffix_lens[:, None]
    x = _embed_tokens(model, tokens)
    for i in range(cfg.num_layers):
        lp = model.layer(i)
        h = _norm(cfg, x, lp["attn_norm"])
        q, k, v = _project_qkv(model, lp, h, positions)
        _scatter_prefill(k_pages[i], k, page_table, positions, valid, page_size)
        _scatter_prefill(v_pages[i], v, page_table, positions, valid, page_size)
        attn = paged_suffix_attention(q, k_pages[i], v_pages[i], page_table, start)
        x = _layer_tail(model, lp, x, attn.reshape(b, s, cfg.q_dim))
    return _logits(model, x)


@torch.no_grad()
def mixed_step(
    model: Llama,
    tokens: torch.Tensor,  # [T] int — flat packed token buffer
    row_slot: torch.Tensor,  # [T] int32 — page_table row per token; -1 = pad
    positions: torch.Tensor,  # [T] int32 — absolute position per token
    cache: Cache,  # written in place
    page_table: torch.Tensor,  # [rows, pages] int32, may be a column slice
) -> torch.Tensor:
    """One token-packed mixed-batch step: prefill segments, suffix
    continuations and decode rows of many sequences in one forward over a
    flat buffer (the packed serving path). Each token's K/V is written
    into its own sequence's pages first, then ragged paged attention
    masks every row to its own sequence at positions <= its own — causal
    prefill, suffix continuation and decode are the same mask.

    Returns logits [T, vocab] fp32; the caller gathers the rows that
    sample. Padding rows write only the null page and produce values
    nobody reads."""
    cfg = model.cfg
    (T,) = tokens.shape
    k_pages, v_pages = cache
    targets = _row_targets(page_table, row_slot, positions, k_pages.shape[2])
    pos = positions.long()[None]
    x = _embed_tokens(model, tokens)  # [T, hidden]
    for i in range(cfg.num_layers):
        lp = model.layer(i)
        h = _norm(cfg, x, lp["attn_norm"])
        q, k, v = _project_qkv(model, lp, h[None], pos)
        q, k, v = q[0], k[0], v[0]  # [T, heads/kvh, hd]
        _scatter_rows(k_pages[i], k, targets)
        _scatter_rows(v_pages[i], v, targets)
        attn = ragged_paged_attention(
            q, k_pages[i], v_pages[i], page_table, row_slot, positions
        )
        x = _layer_tail(model, lp, x, attn.reshape(T, cfg.q_dim))
    return _logits(model, x)


@torch.no_grad()
def decode_step(
    model: Llama,
    tokens: torch.Tensor,  # [b] int — the latest token per sequence
    positions: torch.Tensor,  # [b] int32 — its position (seq_len - 1)
    cache: Cache,  # written in place
    page_table: torch.Tensor,  # [b, pages_per_seq] int32
    active: Optional[torch.Tensor] = None,  # [b] bool; inactive rows write the null page
) -> torch.Tensor:
    """One decode step for the whole running batch; returns logits
    [b, vocab] fp32.

    Two cache-write strategies, selected by ``cfg.attention_impl`` as in
    the reference:

    * ``"reference"`` — scatter each layer's new K/V into the pool, then
      attend over positions < pos + 1 (:func:`_decode_step_scatter_first`);
    * any other value — the serving fast path: attention reads the pool
      at positions < pos and takes the new token's K/V inline, so all
      layers' cache writes defer to ONE write after the layer loop.

    ``active`` masks rows of a frozen slot: their K/V go to the null page,
    and their logits are values the caller ignores."""
    if model.cfg.attention_impl == "reference":
        return _decode_step_scatter_first(model, tokens, positions, cache, page_table, active)
    cfg = model.cfg
    b = tokens.shape[0]
    k_pages, v_pages = cache
    page_size = k_pages.shape[2]
    x = _embed_tokens(model, tokens)  # [b, hidden]
    pos2 = positions.long()[:, None]
    k_all, v_all = [], []
    for i in range(cfg.num_layers):
        lp = model.layer(i)
        h = _norm(cfg, x, lp["attn_norm"])
        q, k, v = _project_qkv(model, lp, h[:, None, :], pos2)
        q, k, v = q[:, 0], k[:, 0], v[:, 0]  # [b, heads/kvh, hd]
        attn = paged_decode_attention_inline(
            q, k_pages[i], v_pages[i], k, v, page_table, positions
        )
        x = _layer_tail(model, lp, x, attn.reshape(b, cfg.q_dim))
        k_all.append(k)
        v_all.append(v)
    # One write for all layers: [L, b, kvh, hd] at (page, slot) per row.
    phys = torch.gather(page_table.long(), 1, (pos2 // page_size))[:, 0]
    slot = positions.long() % page_size
    k_all = torch.stack(k_all)
    v_all = torch.stack(v_all)
    if active is not None:
        phys = torch.where(active, phys, 0)  # inactive rows: the null page
    k_pages[:, phys, slot] = k_all
    v_pages[:, phys, slot] = v_all
    return _logits(model, x)


def _decode_step_scatter_first(model, tokens, positions, cache, page_table, active=None):
    """The reference's baseline decode step: each layer writes its new K/V
    into the pool, then attends over the cache with ``seq_lens = pos + 1``
    (:func:`~..ops.attention.paged_decode_attention`). Inactive rows write
    the null page 0 (the reference drops them) and attend through their
    unmasked table; their logits are ignored."""
    cfg = model.cfg
    b = tokens.shape[0]
    k_pages, v_pages = cache
    page_size = k_pages.shape[2]
    seq_lens = positions + 1
    table = page_table
    if active is not None:
        table = torch.where(active[:, None], page_table, 0)
    x = _embed_tokens(model, tokens)  # [b, hidden]
    pos2 = positions.long()[:, None]
    for i in range(cfg.num_layers):
        lp = model.layer(i)
        h = _norm(cfg, x, lp["attn_norm"])
        q, k, v = _project_qkv(model, lp, h[:, None, :], pos2)
        q, k, v = q[:, 0], k[:, 0], v[:, 0]  # [b, heads/kvh, hd]
        _scatter_decode(k_pages[i], k, table, positions, page_size)
        _scatter_decode(v_pages[i], v, table, positions, page_size)
        attn = paged_decode_attention(q, k_pages[i], v_pages[i], page_table, seq_lens)
        x = _layer_tail(model, lp, x, attn.reshape(b, cfg.q_dim))
    return _logits(model, x)
