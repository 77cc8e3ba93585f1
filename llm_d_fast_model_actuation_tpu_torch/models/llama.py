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

**Tensor parallelism.** The reference annotates each weight with logical
axes (:func:`param_logical_axes`) and leaves slicing and collectives to
XLA's partitioner. Here they are written out: a :class:`ShardedLlama` is
``tp`` :class:`Llama` modules, rank ``r`` on ``mesh.devices[r]``, each
built from a LOCAL config (``num_heads/tp``, ``num_kv_heads/tp``,
``intermediate_size/tp``, ``vocab_size/tp``), so the projections, the
cache writes and every attention kernel run unchanged per rank on its own
heads and its own KV-head slice of the pool. ``wo`` and ``w_down`` are
row-parallel: each rank's product is a partial sum, reduced over the mesh
BEFORE the post-norm and the residual, which every rank then computes for
itself (replicated). The partials are reduced in the model dtype (bf16
products give a bf16 sum), as the partitioner reduces them. The embedding
is vocab-split (a rank looks up the ids it owns and contributes zeros for
the rest, then a reduce), the logits are column-parallel and gathered on
the vocab axis to rank 0, where sampling runs. Norms, ``q_norm``/``k_norm``
and the RoPE tables are replicated. A plain :class:`Llama` runs through
the same functions as a single rank with no mesh: no collective and no
copy.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (
    causal_prefill_attention,
    paged_decode_attention,
    paged_decode_attention_inline,
    paged_suffix_attention,
    ragged_paged_attention,
    ragged_paged_attention_sharded,
)
from ..ops.norm import rms_norm
from ..ops.rope import apply_rope, rope_table
from ..parallel.mesh import TpMesh, shard, tp_dim
from .quant import qmat

#: one device's k and v pages; a sharded model takes one pair per rank
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


def param_logical_axes(cfg: LlamaConfig) -> Dict[str, Any]:
    """Logical axis names of every parameter, in the reference's nested
    structure (its ``param_logical_axes``, the same table)."""
    layers = {
        "attn_norm": ("layers", "embed"),
        "wq": ("layers", "embed", "heads"),
        "wk": ("layers", "embed", "kv_heads"),
        "wv": ("layers", "embed", "kv_heads"),
        "wo": ("layers", "heads", "embed"),
        "mlp_norm": ("layers", "embed"),
        "w_gate": ("layers", "embed", "mlp"),
        "w_up": ("layers", "embed", "mlp"),
        "w_down": ("layers", "mlp", "embed"),
    }
    if cfg.post_norms:
        layers["post_attn_norm"] = ("layers", "embed")
        layers["post_ffn_norm"] = ("layers", "embed")
    if cfg.qk_norm:
        layers["q_norm"] = ("layers", None)
        layers["k_norm"] = ("layers", None)
    if cfg.attn_bias:
        layers["bq"] = ("layers", "heads")
        layers["bk"] = ("layers", "kv_heads")
        layers["bv"] = ("layers", "kv_heads")
    axes = {
        "embed": ("vocab", "embed"),
        "layers": layers,
        "final_norm": ("embed",),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def param_tp_dims(cfg: LlamaConfig) -> Dict[str, Optional[int]]:
    """Flat parameter name (as in :func:`param_shapes`) -> the dimension
    split over ``tp``, or None for a replicated parameter."""
    axes = param_logical_axes(cfg)
    flat = {f"layers.{k}": v for k, v in axes.pop("layers").items()}
    flat.update(axes)
    return {name: tp_dim(ax) for name, ax in flat.items()}


def shard_config(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """One rank's LOCAL config on a ``tp`` mesh: heads, KV heads, MLP width
    and vocabulary divided by ``tp``; raises if one does not divide."""
    for name in ("num_kv_heads", "num_heads", "intermediate_size", "vocab_size"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"{name}={getattr(cfg, name)} is not divisible by tensor_parallel_size {tp}")
    return dataclasses.replace(
        cfg,
        num_heads=cfg.num_heads // tp,
        num_kv_heads=cfg.num_kv_heads // tp,
        intermediate_size=cfg.intermediate_size // tp,
        vocab_size=cfg.vocab_size // tp,
    )


class Llama(nn.Module):
    """The decoder's parameters (uninitialized until loaded or
    :func:`fill_params` fills them) plus its RoPE table, all on one
    device. Parameters never require grad: this is a serving model.

    With an ``arena`` (``engine/arena.py``, the engine's) every parameter
    and both RoPE tables are allocations of it, at addresses that a sleep
    and wake keep; loading and drawing fill that storage in place. Without
    one they are ordinary tensors (:func:`init_params`, the tests)."""

    def __init__(self, cfg: LlamaConfig, device: "torch.device | str", arena=None) -> None:
        super().__init__()
        if cfg.quantization:
            raise ValueError(
                f"quantization {cfg.quantization!r} is not supported by the port yet"
            )
        self.cfg = cfg

        def empty(shape, dtype, tag, name):
            if arena is None:
                return torch.empty(shape, dtype=dtype, device=device)
            return arena.empty(shape, dtype, tag, name)

        self.layers = nn.ParameterDict()
        for name, shape in param_shapes(cfg).items():
            p = nn.Parameter(empty(shape, cfg.dtype, "offload", name), requires_grad=False)
            if name.startswith("layers."):
                self.layers[name[len("layers."):]] = p
            else:
                self.register_parameter(name, p)
        table = (cfg.max_seq_len, cfg.head_dim // 2)
        self.register_buffer("rope_cos", empty(table, torch.float32, "discard", "rope_cos"), persistent=False)
        self.register_buffer("rope_sin", empty(table, torch.float32, "discard", "rope_sin"), persistent=False)
        self.build_tables()

    @property
    def device(self) -> torch.device:
        return self.rope_cos.device

    def build_tables(self) -> None:
        """Write the RoPE tables into their storage (at start, and again
        after a wake, which brings that storage back with no content), bit
        for bit the same each time."""
        cfg = self.cfg
        cos, sin = rope_table(
            cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
            device=self.rope_cos.device,
        )
        self.rope_cos.copy_(cos)
        self.rope_sin.copy_(sin)

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        """Views of layer ``i``'s weights (the scan body's ``lp``)."""
        return {name: p[i] for name, p in self.layers.items()}

    def head(self) -> torch.Tensor:
        return self.embed.t() if self.cfg.tie_embeddings else self.lm_head


class VariantView:
    """A sibling variant of a :class:`Llama` that shares its tensors: the
    surface the forwards read (``cfg``, ``embed``, ``final_norm``,
    ``lm_head``, the RoPE tables, ``layers``, :meth:`layer`,
    :meth:`head`), where each name resolves to the variant's delta leaf
    first (``delta``: the reference's flat keys, ``lm_head``,
    ``layers/w_down``, ... -> a tensor of the base leaf's shape and dtype)
    and to the base model's own tensor otherwise. Nothing is copied: a
    pass through the view reads the base's addresses for every shared
    leaf, and the base's tensors, which its captured graphs read, are
    never written."""

    def __init__(self, base: Llama, delta: Dict[str, torch.Tensor]) -> None:
        self.base = base
        self.cfg = base.cfg
        self.delta = dict(delta)
        self.layers = {name: self.delta.get(f"layers/{name}", p) for name, p in base.layers.items()}

    def __getattr__(self, name: str):
        # the top-level leaves (embed, final_norm, lm_head) and the RoPE
        # tables; only reached for names the instance does not hold
        if name in ("base", "delta"):
            raise AttributeError(name)
        if name in self.delta:
            return self.delta[name]
        return getattr(self.base, name)

    @property
    def device(self) -> torch.device:
        return self.base.device

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        return {name: p[i] for name, p in self.layers.items()}

    def head(self) -> torch.Tensor:
        return self.embed.t() if self.cfg.tie_embeddings else self.lm_head


class ShardedLlama(nn.Module):
    """The decoder on a tensor-parallel mesh: ``mesh.tp`` :class:`Llama`
    modules, rank ``r`` on ``mesh.devices[r]`` holding its slice of every
    split weight and a copy of every replicated one. ``cfg`` is the
    GLOBAL config; each rank's own is :func:`shard_config` of it."""

    def __init__(self, cfg: LlamaConfig, mesh: TpMesh, arenas=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        local = shard_config(cfg, mesh.tp)
        # each rank's state in its device's arena (``arenas``: device -> arena)
        self.ranks = nn.ModuleList(
            Llama(local, d, arena=None if arenas is None else arenas[d]) for d in mesh.devices
        )

    @property
    def device(self) -> torch.device:
        """Rank 0's device: where tokens go in and logits come out."""
        return self.mesh.devices[0]

    def build_tables(self) -> None:
        for m in self.ranks:
            m.build_tables()

    def replicas(self) -> List[torch.Tensor]:
        """The parameters of ranks 1.. that repeat rank 0's (norms and the
        like): the reference holds each of them as ONE replicated array."""
        dims = param_tp_dims(self.cfg)
        return [
            p for m in list(self.ranks)[1:] for name, p in m.named_parameters() if dims[name] is None
        ]


def shard_params(
    state: Dict[str, torch.Tensor], cfg: LlamaConfig, mesh: TpMesh
) -> Dict[str, torch.Tensor]:
    """A full model's state dict (``Llama.state_dict()`` names) -> the
    state dict of a :class:`ShardedLlama` on ``mesh``: rank ``r``'s slice of
    each split weight (a contiguous copy) and a copy of each replicated
    one, on ``mesh.devices[r]``, under ``ranks.<r>.<name>``."""
    dims = param_tp_dims(cfg)
    out: Dict[str, torch.Tensor] = {}
    for r, d in enumerate(mesh.devices):
        for name, t in state.items():
            out[f"ranks.{r}.{name}"] = shard(t, dims[name], r, mesh.tp).to(d, copy=True).contiguous()
    return out


def init_params(
    cfg: LlamaConfig,
    generator: torch.Generator,
    device: "torch.device | str",
    mesh: Optional[TpMesh] = None,
) -> "Llama | ShardedLlama":
    """Random-init parameters (serving loads checkpoints; random init is
    for tests and benchmarks), drawn from ``generator``, which must live
    on ``device``: a new model, filled by :func:`fill_params`. With a
    ``mesh`` (``device`` is then its rank 0's) a :class:`ShardedLlama`."""
    model: "Llama | ShardedLlama" = Llama(cfg, device) if mesh is None else ShardedLlama(cfg, mesh)
    fill_params(model, generator)
    return model


def fill_params(model: "Llama | ShardedLlama", generator: torch.Generator) -> None:
    """Draw ``model``'s parameters from ``generator`` (on the model's
    device) into its tensors, in place. Same distributions as the
    reference (normal scaled by fan_in**-0.5, identity norms); not the
    same numbers — JAX's threefry and torch's Philox differ. Stacked
    weights are drawn one layer at a time and one draw is staged at a
    time, so the fp32 staging never exceeds the largest slice (the
    embedding's, at Llama-3-8B 2.1 GB).

    On a :class:`ShardedLlama` the FULL tensor of each layer is drawn and
    every rank is copied its slice, so a seed gives a sharded model the
    very numbers it gives a single-device one."""
    ranks = list(model.ranks) if isinstance(model, ShardedLlama) else [model]
    cfg, device = model.cfg, model.device
    tp = len(ranks)
    shapes, dims = param_shapes(cfg), param_tp_dims(cfg)
    fill = 0.0 if cfg.norm_offset else 1.0
    with torch.no_grad():
        # rank 0's registration order: the order the draws have always had
        for name, _ in ranks[0].named_parameters():
            short = name.split(".")[-1]
            dests = [m.get_parameter(name) for m in ranks]
            if "norm" in short:
                for p in dests:
                    p.fill_(fill)
            elif short in ("bq", "bk", "bv"):
                for p in dests:
                    p.zero_()
            else:
                shape, dim = shapes[name], dims[name]
                fan_in = shape[-2] if short != "embed" else shape[-1]
                stacked = len(shape) == 3
                for i in range(shape[0] if stacked else 1):
                    src = torch.randn(
                        shape[-2:], generator=generator, device=device,
                        dtype=torch.float32,
                    ).mul_(fan_in**-0.5)
                    for r, p in enumerate(dests):
                        piece = src if tp == 1 else shard(src, dim - 1 if stacked and dim else dim, r, tp)
                        (p[i] if stacked else p).copy_(piece)
                    del src, piece  # the next draw's staging replaces this one, not beside it


# -- forward -----------------------------------------------------------------
#
# Every forward below runs over RANKS: a ShardedLlama's modules with their
# per-rank caches, or a plain Llama as the one rank of no mesh. Per-rank
# work is a closure run once per rank, on that rank's tensors and so on
# its device (_each); the mesh's collectives join the ranks. With no mesh
# each closure runs once and the collectives are the identity.


def _norm(cfg: LlamaConfig, x, w):
    return rms_norm(x, w, cfg.rms_eps, offset=cfg.norm_offset)


def _post(cfg: LlamaConfig, lp, name: str, y):
    """Sandwich (post) norm on a block output, when the family has them."""
    if cfg.post_norms:
        return _norm(cfg, y, lp[name])
    return y


def _ranks(model, cache):
    """(mesh, per-rank modules, per-rank caches) of a model and the cache
    it was handed: a sharded model takes one (k, v) pair per rank."""
    if isinstance(model, ShardedLlama):
        if len(cache) != model.mesh.tp or isinstance(cache[0], torch.Tensor):
            raise ValueError(f"a model on {model.mesh} takes one (k_pages, v_pages) pair per rank")
        return model.mesh, list(model.ranks), list(cache)
    return None, [model], [cache]


def _each(mesh: Optional[TpMesh], fn: Callable[[int], Any]) -> List[Any]:
    """``fn(rank)`` for every rank, in rank order."""
    return [fn(r) for r in range(1 if mesh is None else mesh.tp)]


def _replicated(mesh: Optional[TpMesh], *tensors):
    """Per-rank copies of the forward's replicated inputs (tokens,
    positions, page table, ...; each one tensor, or already a list with
    one tensor per rank)."""
    if mesh is None:
        return [[t] for t in tensors]
    return [[None] * mesh.tp if t is None else mesh.replicate(t) for t in tensors]


def _reduce(mesh: Optional[TpMesh], parts):
    return parts if mesh is None else mesh.all_reduce_sum(parts)


def _embed_tokens(model: Llama, tokens, rank: int = 0, tp: int = 1):
    """Embedding rows of ``tokens``. On a mesh the table is split over the
    vocabulary: rank ``rank`` looks up the ids it owns and gives zeros for
    the rest, so the ranks' sum is the row."""
    cfg = model.cfg
    ids = tokens.long()
    if tp > 1:
        ids = ids - rank * cfg.vocab_size
        own = (ids >= 0) & (ids < cfg.vocab_size)
        x = model.embed[ids.clamp(0, cfg.vocab_size - 1)].to(cfg.dtype)
        x = torch.where(own[..., None], x, torch.zeros((), dtype=cfg.dtype, device=x.device))
    else:
        x = model.embed[ids].to(cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.hidden_size**0.5, dtype=cfg.dtype)
    return x


def _embed(mesh, ms, tokens):
    tp = len(ms)
    return _reduce(mesh, _each(mesh, lambda r: _embed_tokens(ms[r], tokens[r], r, tp)))


def _mlp(cfg: LlamaConfig, x, gate, up, down):
    g = qmat(x, gate).float()
    if cfg.hidden_activation == "gelu":
        a = F.gelu(g, approximate="tanh")
    else:
        a = F.silu(g)
    return qmat(a.to(x.dtype) * qmat(x, up), down)


def _project_qkv(model: Llama, lp, x, positions):
    """x: [b, s, hidden] -> q [b,s,heads,hd], k/v [b,s,kvh,hd], roped
    (the module's own heads: all of them, or one rank's)."""
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


def _logits(mesh, ms, x):
    """Final norm and the head product: fp32 logits over the whole
    vocabulary, on rank 0. Each rank's product covers its own slice of
    the vocabulary (column-parallel); the slices are gathered in the
    model dtype and widened once."""
    parts = _each(mesh, lambda r: qmat(_norm(ms[r].cfg, x[r], ms[r].final_norm), ms[r].head()))
    return (parts[0] if mesh is None else mesh.gather(parts, dim=-1)).float()


def _layer_tail(mesh, ms, lps, x, attn):
    """The rest of a layer after attention. ``wo`` and ``w_down`` are
    row-parallel on a mesh: each rank's product is a partial sum, reduced
    FIRST; the post-norm and the residual then run on the full sum,
    replicated on every rank."""
    cfg = ms[0].cfg
    o = _reduce(mesh, _each(mesh, lambda r: qmat(attn[r], lps[r]["wo"])))

    def mlp(r):
        lp = lps[r]
        xr = x[r] + _post(cfg, lp, "post_attn_norm", o[r])
        h = _norm(cfg, xr, lp["mlp_norm"])
        return xr, _mlp(cfg, h, lp["w_gate"], lp["w_up"], lp["w_down"])

    mid = _each(mesh, mlp)
    y = _reduce(mesh, [m[1] for m in mid])
    return _each(mesh, lambda r: mid[r][0] + _post(cfg, lps[r], "post_ffn_norm", y[r]))


@torch.no_grad()
def prefill(
    model: "Llama | ShardedLlama",
    tokens: torch.Tensor,  # [b, s] int, right-padded
    seq_lens: torch.Tensor,  # [b] int32
    cache: "Cache | Sequence[Cache]",  # k/v pages [L, P, ps, kvh, hd], written in place
    page_table: torch.Tensor,  # [b, pages_per_seq] int32
) -> torch.Tensor:
    """Prefill a batch of prompts, writing their KV into the pool.
    Returns logits [b, s, vocab] fp32; the caller reads them at
    seq_lens-1."""
    mesh, ms, caches = _ranks(model, cache)
    cfg = ms[0].cfg
    tokens, seq_lens, page_table = _replicated(mesh, tokens, seq_lens, page_table)
    b, s = tokens[0].shape
    page_size = caches[0][0].shape[2]

    def prepare(r):
        positions = torch.arange(s, dtype=torch.int64, device=tokens[r].device).expand(b, s)
        return positions, positions < seq_lens[r][:, None]

    pv = _each(mesh, prepare)
    x = _embed(mesh, ms, tokens)
    for i in range(cfg.num_layers):
        lps = [m.layer(i) for m in ms]

        def attend(r):
            positions, valid = pv[r]
            k_pages, v_pages = caches[r]
            h = _norm(cfg, x[r], lps[r]["attn_norm"])
            q, k, v = _project_qkv(ms[r], lps[r], h, positions)
            _scatter_prefill(k_pages[i], k, page_table[r], positions, valid, page_size)
            _scatter_prefill(v_pages[i], v, page_table[r], positions, valid, page_size)
            return causal_prefill_attention(q, k, v, seq_lens[r]).reshape(b, s, cfg.q_dim)

        x = _layer_tail(mesh, ms, lps, x, _each(mesh, attend))
    return _logits(mesh, ms, x)


@torch.no_grad()
def prefill_continue(
    model: "Llama | ShardedLlama",
    tokens: torch.Tensor,  # [b, s] int suffix tokens, right-padded
    start: torch.Tensor,  # [b] int32 — absolute position of tokens[:, 0]
    suffix_lens: torch.Tensor,  # [b] int32 — valid suffix length per row
    cache: "Cache | Sequence[Cache]",  # written in place
    page_table: torch.Tensor,  # [b, pages_per_seq] int32
) -> torch.Tensor:
    """Prefill a prompt SUFFIX against a pool whose first ``start`` tokens
    are already present (prefix-cache hits, chunked prefill): writes only
    the suffix's KV, then attends over the paged cache. Returns logits
    [b, s, vocab] fp32; the caller samples at suffix_lens-1."""
    mesh, ms, caches = _ranks(model, cache)
    cfg = ms[0].cfg
    tokens, start, suffix_lens, page_table = _replicated(mesh, tokens, start, suffix_lens, page_table)
    b, s = tokens[0].shape
    page_size = caches[0][0].shape[2]

    def prepare(r):
        ar = torch.arange(s, dtype=torch.int64, device=tokens[r].device)
        return start[r].long()[:, None] + ar[None, :], ar[None, :] < suffix_lens[r][:, None]

    pv = _each(mesh, prepare)
    x = _embed(mesh, ms, tokens)
    for i in range(cfg.num_layers):
        lps = [m.layer(i) for m in ms]

        def attend(r):
            positions, valid = pv[r]
            k_pages, v_pages = caches[r]
            h = _norm(cfg, x[r], lps[r]["attn_norm"])
            q, k, v = _project_qkv(ms[r], lps[r], h, positions)
            _scatter_prefill(k_pages[i], k, page_table[r], positions, valid, page_size)
            _scatter_prefill(v_pages[i], v, page_table[r], positions, valid, page_size)
            attn = paged_suffix_attention(q, k_pages[i], v_pages[i], page_table[r], start[r])
            return attn.reshape(b, s, cfg.q_dim)

        x = _layer_tail(mesh, ms, lps, x, _each(mesh, attend))
    return _logits(mesh, ms, x)


@torch.no_grad()
def mixed_step(
    model: "Llama | ShardedLlama",
    tokens: torch.Tensor,  # [T] int — flat packed token buffer
    row_slot: torch.Tensor,  # [T] int32 — page_table row per token; -1 = pad
    positions: torch.Tensor,  # [T] int32 — absolute position per token
    cache: "Cache | Sequence[Cache]",  # written in place
    page_table: torch.Tensor,  # [rows, pages] int32, may be a column slice
) -> torch.Tensor:
    """One token-packed mixed-batch step: prefill segments, suffix
    continuations and decode rows of many sequences in one forward over a
    flat buffer (the packed serving path). Each token's K/V is written
    into its own sequence's pages first, then ragged paged attention
    masks every row to its own sequence at positions <= its own — causal
    prefill, suffix continuation and decode are the same mask. On a mesh
    the attention is ``ragged_paged_attention_sharded``: the ragged kernel
    once per rank over the rank's heads, no collective inside.

    Returns logits [T, vocab] fp32; the caller gathers the rows that
    sample. Padding rows write only the null page and produce values
    nobody reads."""
    mesh, ms, caches = _ranks(model, cache)
    cfg = ms[0].cfg
    tokens, row_slot, positions, page_table = _replicated(mesh, tokens, row_slot, positions, page_table)
    (T,) = tokens[0].shape
    page_size = caches[0][0].shape[2]
    prep = _each(mesh, lambda r: (
        _row_targets(page_table[r], row_slot[r], positions[r], page_size),
        positions[r].long()[None],
    ))
    x = _embed(mesh, ms, tokens)  # [T, hidden] per rank
    for i in range(cfg.num_layers):
        lps = [m.layer(i) for m in ms]

        def project_and_write(r):
            targets, pos = prep[r]
            k_pages, v_pages = caches[r]
            h = _norm(cfg, x[r], lps[r]["attn_norm"])
            q, k, v = _project_qkv(ms[r], lps[r], h[None], pos)
            q, k, v = q[0], k[0], v[0]  # [T, heads/kvh, hd]
            _scatter_rows(k_pages[i], k, targets)
            _scatter_rows(v_pages[i], v, targets)
            return q

        q = _each(mesh, project_and_write)
        if mesh is None:
            attn = [ragged_paged_attention(
                q[0], caches[0][0][i], caches[0][1][i], page_table[0], row_slot[0], positions[0]
            )]
        else:
            attn = ragged_paged_attention_sharded(
                mesh, q, [c[0][i] for c in caches], [c[1][i] for c in caches],
                page_table, row_slot, positions,
            )
        x = _layer_tail(mesh, ms, lps, x, [a.reshape(T, cfg.q_dim) for a in attn])
    return _logits(mesh, ms, x)


@torch.no_grad()
def decode_step(
    model: "Llama | ShardedLlama",
    tokens: torch.Tensor,  # [b] int — the latest token per sequence
    positions: torch.Tensor,  # [b] int32 — its position (seq_len - 1)
    cache: "Cache | Sequence[Cache]",  # written in place
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
    mesh, ms, caches = _ranks(model, cache)
    cfg = ms[0].cfg
    tokens, positions, page_table, active = _replicated(mesh, tokens, positions, page_table, active)
    b = tokens[0].shape[0]
    page_size = caches[0][0].shape[2]
    pos2 = _each(mesh, lambda r: positions[r].long()[:, None])
    x = _embed(mesh, ms, tokens)  # [b, hidden] per rank
    kv_all: List[Tuple[list, list]] = [([], []) for _ in ms]
    for i in range(cfg.num_layers):
        lps = [m.layer(i) for m in ms]

        def attend(r):
            k_pages, v_pages = caches[r]
            h = _norm(cfg, x[r], lps[r]["attn_norm"])
            q, k, v = _project_qkv(ms[r], lps[r], h[:, None, :], pos2[r])
            q, k, v = q[:, 0], k[:, 0], v[:, 0]  # [b, heads/kvh, hd]
            attn = paged_decode_attention_inline(
                q, k_pages[i], v_pages[i], k, v, page_table[r], positions[r]
            )
            kv_all[r][0].append(k)
            kv_all[r][1].append(v)
            return attn.reshape(b, cfg.q_dim)

        x = _layer_tail(mesh, ms, lps, x, _each(mesh, attend))

    def write_all(r):
        # One write for all layers: [L, b, kvh, hd] at (page, slot) per row.
        k_pages, v_pages = caches[r]
        phys = torch.gather(page_table[r].long(), 1, (pos2[r] // page_size))[:, 0]
        slot = positions[r].long() % page_size
        if active[r] is not None:
            phys = torch.where(active[r], phys, 0)  # inactive rows: the null page
        k_pages[:, phys, slot] = torch.stack(kv_all[r][0])
        v_pages[:, phys, slot] = torch.stack(kv_all[r][1])

    _each(mesh, write_all)
    return _logits(mesh, ms, x)


def _decode_step_scatter_first(model, tokens, positions, cache, page_table, active=None):
    """The reference's baseline decode step: each layer writes its new K/V
    into the pool, then attends over the cache with ``seq_lens = pos + 1``
    (:func:`~..ops.attention.paged_decode_attention`). Inactive rows write
    the null page 0 (the reference drops them) and attend through their
    unmasked table; their logits are ignored."""
    mesh, ms, caches = _ranks(model, cache)
    cfg = ms[0].cfg
    tokens, positions, page_table, active = _replicated(mesh, tokens, positions, page_table, active)
    b = tokens[0].shape[0]
    page_size = caches[0][0].shape[2]

    def prepare(r):
        table = page_table[r]
        if active[r] is not None:
            table = torch.where(active[r][:, None], table, 0)
        return positions[r] + 1, table, positions[r].long()[:, None]

    prep = _each(mesh, prepare)
    x = _embed(mesh, ms, tokens)  # [b, hidden] per rank
    for i in range(cfg.num_layers):
        lps = [m.layer(i) for m in ms]

        def attend(r):
            seq_lens, table, pos2 = prep[r]
            k_pages, v_pages = caches[r]
            h = _norm(cfg, x[r], lps[r]["attn_norm"])
            q, k, v = _project_qkv(ms[r], lps[r], h[:, None, :], pos2)
            q, k, v = q[:, 0], k[:, 0], v[:, 0]  # [b, heads/kvh, hd]
            _scatter_decode(k_pages[i], k, table, positions[r], page_size)
            _scatter_decode(v_pages[i], v, table, positions[r], page_size)
            attn = paged_decode_attention(q, k_pages[i], v_pages[i], page_table[r], seq_lens)
            return attn.reshape(b, cfg.q_dim)

        x = _layer_tail(mesh, ms, lps, x, _each(mesh, attend))
    return _logits(mesh, ms, x)
