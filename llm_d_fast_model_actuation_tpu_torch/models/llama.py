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

**Expert parallelism.** On a ``tp`` x ``ep`` mesh (the MoE family) the
ranks are ``tp * ep`` modules in the mesh's rank order; a rank holds its
E/ep experts of every expert stack (``q`` and ``s`` alike under int8), a
whole router, and its ``tp`` slice of everything else, replicated over
``ep`` as the reference replicates it. Each rank routes every row over
all E experts and weights its own; the FFN's partials are reduced over
``tp`` and ``ep`` in f32 and rounded once (:func:`_layer_tail`). The
forwards' ``tp`` reduces run within each ``ep`` group. ``models/train.py``
runs the same layer functions under autograd on ``dp`` x ``sp`` x ``tp``
x ``ep`` meshes.

**Pipeline stages.** On a mesh with ``pp`` the ranks at ``pp`` coordinate
``s`` hold layers ``[s * L / pp, (s + 1) * L / pp)`` of every layer stack
and of the pool (their local config has ``L / pp`` layers), and a forward
walks the stages in order (:func:`_walk`): the first stage embeds, each
stage runs its layers on its own mesh of the other axes
(``Mesh.stage_mesh``, so the ``tp`` reduces group within the stage), the
residual stream is handed to the next stage at each boundary
(``Mesh.hand_off``), and the last stage's ranks compute the logits. The
replicated leaves (embedding, final norm, head) are held by every stage,
as the reference replicates them over ``pp``; the copies past the first
stage are :meth:`ShardedLlama.replicas`.
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
from ..parallel.mesh import Mesh, replica_of, shard_for, spec_for, stage_layers
from .quant import LAYER_WEIGHTS, qmat, quantize_weight, quantized_axes

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
    #: weight-only quantization: "" (plain weights) or "int8" (W8A16: every
    #: layer weight stack and ``lm_head`` held as int8 with an f32 scale per
    #: output channel, ``models/quant.py``)
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


def is_moe(cfg: Any) -> bool:
    """Whether ``cfg`` is of the MoE family (``models/moe.py``): its layers
    hold a router and expert stacks, and its FFN is :func:`~.moe.moe_ffn`."""
    from .moe import MoeConfig  # moe.py imports this module

    return isinstance(cfg, MoeConfig)


#: the weight-only quantization modes (``--quantization``)
QUANTIZATION_MODES = ("", "int8")


def quantized_names(cfg: LlamaConfig) -> Tuple[str, ...]:
    """The flat names of the weights ``cfg.quantization`` holds quantized:
    none, or under "int8" every layer weight stack and an untied
    ``lm_head``. Raises for an unknown mode."""
    if cfg.quantization not in QUANTIZATION_MODES:
        raise ValueError(f"unknown quantization {cfg.quantization!r}; known: {QUANTIZATION_MODES}")
    if not cfg.quantization:
        return ()
    return tuple(f"layers.{n}" for n in LAYER_WEIGHTS) + (() if cfg.tie_embeddings else ("lm_head",))


def param_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[int, ...]]:
    """Flat parameter name -> shape, in the reference's names and stacked
    layouts (``layers.<name>`` for the per-layer stacks). A quantized
    weight is two leaves, ``<name>.q`` (the weight's shape, int8) and
    ``<name>.s`` (the fan-in axis reduced to 1, f32): the reference's
    ``{"q", "s"}`` leaf (:func:`param_dtype`)."""
    quant = set(quantized_names(cfg))
    shapes = _plain_shapes(cfg)
    if not quant:
        return shapes
    out: Dict[str, Tuple[int, ...]] = {}
    for name, shape in shapes.items():
        if name in quant:
            out[f"{name}.q"] = shape
            out[f"{name}.s"] = shape[:-2] + (1, shape[-1])
        else:
            out[name] = shape
    return out


def param_dtype(cfg: LlamaConfig, name: str) -> torch.dtype:
    """The dtype of the parameter ``name`` (:func:`param_shapes`): int8 and
    f32 for a quantized weight's ``q`` and ``s``, else ``cfg.dtype``."""
    base, _, leaf = name.rpartition(".")
    if leaf in ("q", "s") and base in quantized_names(cfg):
        return torch.int8 if leaf == "q" else torch.float32
    return cfg.dtype


def _plain_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[int, ...]]:
    h, L = cfg.hidden_size, cfg.num_layers
    shapes = {
        "embed": (cfg.vocab_size, h),
        "layers.attn_norm": (L, h),
        "layers.wq": (L, h, cfg.q_dim),
        "layers.wk": (L, h, cfg.kv_dim),
        "layers.wv": (L, h, cfg.kv_dim),
        "layers.wo": (L, cfg.q_dim, h),
        "layers.mlp_norm": (L, h),
    }
    f = cfg.intermediate_size
    if is_moe(cfg):
        # the MoE family: a router, and the FFN's stacks per expert
        E = cfg.num_experts
        shapes["layers.router"] = (L, h, cfg.router_experts or E)
        shapes["layers.w_gate"] = (L, E, h, f)
        shapes["layers.w_up"] = (L, E, h, f)
        shapes["layers.w_down"] = (L, E, f, h)
    else:
        shapes["layers.w_gate"] = (L, h, f)
        shapes["layers.w_up"] = (L, h, f)
        shapes["layers.w_down"] = (L, f, h)
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
    structure (its ``param_logical_axes``, the same table; an MoE config's
    is the reference's ``models/moe.py`` table)."""
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
    if is_moe(cfg):
        # the reference's models/moe.py:param_logical_axes: the router
        # replicated, the experts' f split over tp as the dense FFN's
        layers["router"] = ("layers", "embed", None)
        layers["w_gate"] = ("layers", "expert", "embed", "mlp")
        layers["w_up"] = ("layers", "expert", "embed", "mlp")
        layers["w_down"] = ("layers", "expert", "mlp", "embed")
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


def _flat_axes(cfg: LlamaConfig) -> Dict[str, Any]:
    """Flat parameter name (as in :func:`param_shapes`) -> its logical
    axes; a quantized weight's ``q`` and ``s`` as ``quant.quantized_axes``
    gives them."""
    axes = param_logical_axes(cfg)
    if quantized_names(cfg):
        axes = quantized_axes(axes)
    flat: Dict[str, Any] = {}

    def walk(node, prefix: str) -> None:
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = v

    walk(axes, "")
    return flat


def param_specs(cfg: LlamaConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Flat parameter name -> the mesh axis of each dimension (None =
    replicated): the reference's ``PartitionSpec`` of every weight, from
    the logical-axes table. An MoE expert stack splits its expert axis
    over ``ep`` and its ``mlp`` axis over ``tp``; a quantized stack's
    scale splits over ``ep`` with its ``q``."""
    return {name: spec_for(ax) for name, ax in _flat_axes(cfg).items()}


def shard_config(cfg: LlamaConfig, tp: int, ep: int = 1, pp: int = 1) -> LlamaConfig:
    """One rank's LOCAL config on a ``pp`` x ``tp`` x ``ep`` mesh: heads,
    KV heads, MLP width and vocabulary divided by ``tp``, layers by ``pp``
    (a stage's), an MoE config's experts by ``ep``; raises if one does not
    divide."""
    for name in ("num_kv_heads", "num_heads", "intermediate_size", "vocab_size"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"{name}={getattr(cfg, name)} is not divisible by tensor_parallel_size {tp}")
    local = dataclasses.replace(
        cfg,
        num_heads=cfg.num_heads // tp,
        num_kv_heads=cfg.num_kv_heads // tp,
        intermediate_size=cfg.intermediate_size // tp,
        vocab_size=cfg.vocab_size // tp,
        num_layers=len(stage_layers(cfg.num_layers, pp, 0)),
    )
    if ep > 1:
        if not is_moe(cfg):
            raise ValueError(f"ep={ep} splits experts, and {type(cfg).__name__} has none")
        if cfg.num_experts % ep:
            raise ValueError(f"num_experts={cfg.num_experts} is not divisible by ep={ep}")
        local = dataclasses.replace(local, num_experts=cfg.num_experts // ep, router_experts=cfg.num_experts)
    return local


class LayerStacks(nn.Module):
    """The per-layer weight stacks of a :class:`Llama` (its ``layers``):
    a parameter per plain stack and, for a quantized one, an
    ``nn.ParameterDict`` with its ``q`` and ``s``, so the state dict names
    them ``layers.wq`` and ``layers.wq.q``/``layers.wq.s``, the reference's
    tree paths. Indexed and iterated like a dict, in registration order."""

    def __init__(self) -> None:
        super().__init__()
        self._order: List[str] = []

    def __getitem__(self, name: str):
        return self._parameters[name] if name in self._parameters else self._modules[name]

    def items(self) -> List[Tuple[str, Any]]:
        return [(k, self[k]) for k in self._order]

    def put(self, name: str, value: "nn.Parameter | nn.ParameterDict") -> None:
        if isinstance(value, nn.Parameter):
            self.register_parameter(name, value)
        else:
            self.add_module(name, value)
        self._order.append(name)


def _leaf(p: Any, i: Optional[int] = None) -> Any:
    """A stored weight as a forward takes it: the tensor, or a quantized
    one's ``{"q", "s"}``, sliced at layer ``i`` when given."""
    if isinstance(p, nn.ParameterDict):
        return {k: (p[k] if i is None else p[k][i]) for k in ("q", "s")}
    return p if i is None else p[i]


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
        self.cfg = cfg

        def empty(shape, dtype, tag, name):
            if arena is None:
                return torch.empty(shape, dtype=dtype, device=device)
            return arena.empty(shape, dtype, tag, name)

        quant = set(quantized_names(cfg))
        self.layers = LayerStacks()
        groups: Dict[str, nn.ParameterDict] = {}
        for name, shape in param_shapes(cfg).items():
            p = nn.Parameter(empty(shape, param_dtype(cfg, name), "offload", name), requires_grad=False)
            base, _, leaf = name.rpartition(".")
            if base in quant:
                if base not in groups:
                    groups[base] = nn.ParameterDict()
                    if base.startswith("layers."):
                        self.layers.put(base[len("layers."):], groups[base])
                    else:
                        self.add_module(base, groups[base])
                groups[base][leaf] = p
            elif name.startswith("layers."):
                self.layers.put(name[len("layers."):], p)
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

    def layer(self, i: int) -> Dict[str, Any]:
        """Views of layer ``i``'s weights (the scan body's ``lp``); a
        quantized stack's as ``{"q", "s"}``."""
        return {name: _leaf(p, i) for name, p in self.layers.items()}

    def head(self) -> Any:
        return self.embed.t() if self.cfg.tie_embeddings else _leaf(self.lm_head)


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
        if quantized_names(base.cfg):
            raise ValueError("a sibling variant is base-precision only (co-residency with --quantization is refused)")
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


class RankModules(nn.Module):
    """A :class:`ShardedLlama`'s per-rank modules, indexed by global rank:
    ``[r]`` and iteration give None for a rank another process of a gang
    holds. Each module is registered under its rank's number, so the
    state dict names are ``ranks.<r>.<name>`` as a ``ModuleList``'s."""

    def __init__(self, modules: Dict[int, nn.Module], size: int) -> None:
        super().__init__()
        for r, m in modules.items():
            self.add_module(str(r), m)
        self._size = size

    def __getitem__(self, rank: int) -> Optional[nn.Module]:
        return self._modules.get(str(rank))

    def __iter__(self):
        return (self._modules.get(str(r)) for r in range(self._size))

    def __len__(self) -> int:
        return self._size

    def held(self) -> List[Tuple[int, nn.Module]]:
        """(rank, module) of every rank this process holds."""
        return [(int(k), m) for k, m in self._modules.items()]


class ShardedLlama(nn.Module):
    """The decoder on a ``pp`` x ``tp`` x ``ep`` mesh: ``mesh.size``
    :class:`Llama` modules, rank ``r`` on ``mesh.devices[r]`` holding its
    slice of every split weight and a copy of every replicated one (an
    ``ep`` rank holds its E/ep experts, and the attention weights whole for
    its ``tp`` coordinate, as the reference replicates them over ``ep``; a
    ``pp`` rank its stage's layers of every stack, and the embedding,
    final norm and head whole for its ``tp`` coordinate). ``cfg`` is the
    GLOBAL config; each rank's own is :func:`shard_config` of it. On a
    gang's mesh only this process's ranks are built (:class:`RankModules`)."""

    def __init__(self, cfg: LlamaConfig, mesh: Mesh, arenas=None) -> None:
        super().__init__()
        for axis in ("dp", "sp"):
            if mesh.shape[axis] > 1:
                raise ValueError(
                    f"a serving model splits over pp, tp and ep only; {mesh} has {axis}={mesh.shape[axis]}"
                )
        self.cfg = cfg
        self.mesh = mesh
        local = shard_config(cfg, mesh.tp, mesh.shape["ep"], mesh.pp)
        # each rank's state in its device's arena (``arenas``: device -> arena)
        self.ranks = RankModules({
            r: Llama(local, mesh.devices[r], arena=None if arenas is None else arenas[mesh.devices[r]])
            for r in mesh.local_ranks
        }, mesh.size)

    @property
    def device(self) -> torch.device:
        """Rank 0's device: where tokens go in and logits come out (in a
        gang, this process's first rank's)."""
        return self.mesh.devices[self.mesh.local_ranks[0]]

    def build_tables(self) -> None:
        for _, m in self.ranks.held():
            m.build_tables()

    def replicas(self) -> List[torch.Tensor]:
        """The parameters that repeat an earlier rank's (norms and the
        like; on an ``ep`` mesh also the attention weights of every ``ep``
        rank past the first; on a ``pp`` mesh the embedding, final norm and
        head of every stage past the first): the reference holds each of
        them as ONE replicated array."""
        specs = param_specs(self.cfg)
        return [
            p for r, m in self.ranks.held() for name, p in m.named_parameters()
            if replica_of(specs[name], self.mesh, r) != r
        ]


def shard_params(
    state: Dict[str, torch.Tensor], cfg: LlamaConfig, mesh: Mesh
) -> Dict[str, torch.Tensor]:
    """A full model's state dict (``Llama.state_dict()`` names) -> the
    state dict of a :class:`ShardedLlama` on ``mesh``: rank ``r``'s slice of
    each split weight (a contiguous copy) and a copy of each replicated
    one, on ``mesh.devices[r]``, under ``ranks.<r>.<name>``, for each
    rank this process holds."""
    specs = param_specs(cfg)
    out: Dict[str, torch.Tensor] = {}
    for r in mesh.local_ranks:
        d = mesh.devices[r]
        for name, t in state.items():
            out[f"ranks.{r}.{name}"] = shard_for(t, specs[name], mesh, r).to(d, copy=True).contiguous()
    return out


def _draw_order(cfg: LlamaConfig) -> List[str]:
    """The order :func:`fill_params` draws the weights in, a plain model's
    parameter registration order (its top-level leaves, then the layer
    stacks), the order the draws have always had: a quantized model draws
    the same bf16 weights in the same order, then quantizes them."""
    names = list(_plain_shapes(cfg))
    return [n for n in names if not n.startswith("layers.")] + [n for n in names if n.startswith("layers.")]


def init_params(
    cfg: LlamaConfig,
    generator: torch.Generator,
    device: "torch.device | str",
    mesh: Optional[Mesh] = None,
) -> "Llama | ShardedLlama":
    """Random-init parameters (serving loads checkpoints; random init is
    for tests and benchmarks), drawn from ``generator``, which must live
    on ``device``: a new model, filled by :func:`fill_params`. With a
    ``mesh`` (``device`` is then its rank 0's) a :class:`ShardedLlama`."""
    model: "Llama | ShardedLlama" = Llama(cfg, device) if mesh is None else ShardedLlama(cfg, mesh)
    fill_params(model, generator)
    return model


def held_ranks(model: "Llama | ShardedLlama") -> List[Tuple[int, nn.Module]]:
    """(rank, module) of every rank this process holds (a gang member
    holds its own ranks only); a plain model is rank 0."""
    return model.ranks.held() if isinstance(model, ShardedLlama) else [(0, model)]


def layer_at(model: "Llama | ShardedLlama") -> Callable[[int, int], Optional[int]]:
    """``at(rank, i)``: where global layer ``i`` lies in rank ``rank``'s
    own layer stacks, or None when another pipeline stage holds it (every
    rank holds every layer without ``pp``)."""
    mesh = model.mesh if isinstance(model, ShardedLlama) else None
    if mesh is None or mesh.pp == 1:
        return lambda r, i: i
    L = model.cfg.num_layers

    def at(r: int, i: int) -> Optional[int]:
        held = stage_layers(L, mesh.pp, mesh.stage(r))
        return i - held.start if i in held else None

    return at


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
    very numbers it gives a single-device one (and each process of a gang
    draws the same numbers and keeps its own ranks' slices).

    A quantized weight (``cfg.quantization``) is drawn as the plain model
    draws it, rounded to ``cfg.dtype`` and quantized one layer slice at a
    time (:func:`~.quant.quantize_weight`), so a quantized and a plain
    model of one seed hold the same underlying weights. An MoE expert
    stack ``[L, E, in, out]`` is drawn a layer's ``[E, in, out]`` at a
    time, with the fan-in's scaling. The scale is
    taken over the whole fan-in before any split: a row-parallel weight's
    ranks share one scale."""
    ranks = held_ranks(model)
    mesh = model.mesh if isinstance(model, ShardedLlama) else None
    cfg, device = model.cfg, model.device
    at = layer_at(model)
    plain = dataclasses.replace(cfg, quantization="")
    shapes, specs = param_shapes(plain), param_specs(plain)
    quant = set(quantized_names(cfg))
    fill = 0.0 if cfg.norm_offset else 1.0
    with torch.no_grad():
        for name in _draw_order(plain):
            short = name.split(".")[-1]
            if name in quant:
                _draw_quantized(ranks, mesh, name, shapes[name], param_specs(cfg), generator, device, at)
                continue
            dests = [(r, m.get_parameter(name)) for r, m in ranks]
            if "norm" in short:
                for _, p in dests:
                    p.fill_(fill)
            elif short in ("bq", "bk", "bv"):
                for _, p in dests:
                    p.zero_()
            else:
                shape = shapes[name]
                fan_in = shape[-2] if short != "embed" else shape[-1]
                stacked = len(shape) >= 3
                spec = specs[name][1:] if stacked else specs[name]  # one layer slice's
                for i in range(shape[0] if stacked else 1):
                    src = torch.randn(
                        shape[1:] if stacked else shape, generator=generator, device=device,
                        dtype=torch.float32,
                    ).mul_(fan_in**-0.5)
                    for r, p in dests:
                        if stacked and at(r, i) is None:
                            continue  # another pipeline stage's layer
                        (p[at(r, i)] if stacked else p).copy_(shard_for(src, spec, mesh, r))
                    # the next draw's staging replaces this one, not beside it:
                    # no name may keep it (a slice without a mesh is src itself)
                    del src


def _draw_quantized(ranks: List[Tuple[int, Llama]], mesh: Optional[Mesh], name: str, shape, specs, generator, device,
                    at: Callable[[int, int], Optional[int]]) -> None:
    """One quantized weight of :func:`fill_params`: each layer slice drawn
    whole as the plain model draws it, rounded to the model dtype,
    quantized, and its ``q`` and ``s`` cut per rank by their specs
    (``specs``: :func:`param_specs` of the quantized config; ``s`` is
    split over ``tp`` only where the split is its output axis) into the
    ranks whose stage holds the layer (``at``, :func:`layer_at`)."""
    cfg = ranks[0][1].cfg
    stacked = len(shape) >= 3
    q_spec, s_spec = (specs[f"{name}.{k}"][1:] if stacked else specs[f"{name}.{k}"] for k in ("q", "s"))
    qs = [m.get_parameter(f"{name}.q") for _, m in ranks]
    ss = [m.get_parameter(f"{name}.s") for _, m in ranks]
    for i in range(shape[0] if stacked else 1):
        src = torch.randn(shape[1:] if stacked else shape, generator=generator, device=device,
                          dtype=torch.float32).mul_(shape[-2] ** -0.5)
        w = src.to(cfg.dtype)
        del src
        qd = quantize_weight(w)
        del w
        for j, (r, _) in enumerate(ranks):
            if stacked and at(r, i) is None:
                continue
            qp, sp = shard_for(qd["q"], q_spec, mesh, r), shard_for(qd["s"], s_spec, mesh, r)
            (qs[j][at(r, i)] if stacked else qs[j]).copy_(qp)
            (ss[j][at(r, i)] if stacked else ss[j]).copy_(sp)
        del qd


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
        if len(cache) != model.mesh.size or isinstance(_first(cache), torch.Tensor):
            raise ValueError(f"a model on {model.mesh} takes one (k_pages, v_pages) pair per rank")
        return model.mesh, list(model.ranks), list(cache)
    return None, [model], [cache]


class _Stage:
    """One pipeline stage of a forward: its mesh (the stage's, of the other
    four axes; the model's own without ``pp``; None for a plain model), its
    global ranks in rank order, and its modules and caches in that order.
    The forward's per-rank closures run on a stage's lists (:meth:`take`),
    indexed by the stage mesh's ranks."""

    def __init__(self, mesh: Optional[Mesh], ranks: List[int], ms: List[Any], caches: List[Any]) -> None:
        self.mesh, self.ranks = mesh, ranks
        self.ms, self.caches = self.take(ms), self.take(caches)

    def take(self, per_rank: Sequence[Any]) -> List[Any]:
        """This stage's entries of a per-rank list of the whole mesh."""
        return [per_rank[r] for r in self.ranks]


def _stages(mesh: Optional[Mesh], ms, caches) -> List[_Stage]:
    """The stages of a forward, in order: one with no ``pp``."""
    if mesh is None or mesh.pp == 1:
        return [_Stage(mesh, list(range(len(ms))), ms, caches)]
    return [_Stage(mesh.stage_mesh(s), mesh.stage_ranks(s), ms, caches) for s in range(mesh.pp)]


def _walk(mesh: Optional[Mesh], ms, caches, embed, layers) -> Tuple[_Stage, List[Any]]:
    """Run a forward's layers stage after stage: ``embed(stage)`` gives the
    first stage's residual stream, ``layers(stage, x)`` runs a stage's own
    layers on it, and at each boundary the stream goes to the next stage's
    ranks (``Mesh.hand_off``, the reference's ``ppermute`` along ``pp``).
    Returns the last stage and its residual stream."""
    stages = _stages(mesh, ms, caches)
    x = embed(stages[0])
    for k, st in enumerate(stages):
        if k:
            full: List[Any] = [None] * mesh.size
            for r, t in zip(stages[k - 1].ranks, x):
                full[r] = t
            x = st.take(mesh.hand_off(full))
        x = layers(st, x)
    return st, x


def _first(per_rank: Sequence[Any]) -> Any:
    """The first entry this process holds (a gang's per-rank lists carry
    None for another process's ranks)."""
    return next(x for x in per_rank if x is not None)


def _each(mesh: Optional[Mesh], fn: Callable[[int], Any]) -> List[Any]:
    """``fn(rank)`` for every rank this process holds, in rank order (None
    for a gang's other ranks)."""
    return [fn(0)] if mesh is None else mesh.per_rank(fn)


def _replicated(mesh: Optional[Mesh], *tensors):
    """Per-rank copies of the forward's replicated inputs (tokens,
    positions, page table, ...; each one tensor, or already a list with
    one tensor per rank)."""
    if mesh is None:
        return [[t] for t in tensors]
    return [[None] * mesh.size if t is None else mesh.replicate(t) for t in tensors]


def _reduce(mesh: Optional[Mesh], parts):
    """The sum of the ranks' partials over ``tp``."""
    return parts if mesh is None else mesh.all_reduce_sum(parts)  # its default axis, tp


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
    if mesh is None:
        return [_embed_tokens(ms[0], tokens[0])]
    return _reduce(mesh, _each(mesh, lambda r: _embed_tokens(ms[r], tokens[r], mesh.index(r, "tp"), mesh.tp)))


def _mlp(cfg: LlamaConfig, x, gate, up, down):
    g = qmat(x, gate).float()
    if cfg.hidden_activation == "gelu":
        a = F.gelu(g, approximate="tanh")
    else:
        a = F.silu(g)
    return qmat(a.to(x.dtype) * qmat(x, up), down)


def _ffn(cfg: LlamaConfig, lp, x, expert0: int = 0, partial: bool = False):
    """The layer's FFN by family, as the reference's ``llama.py:_ffn``:
    the dense gated MLP, or the MoE family's routed experts (on an ``ep``
    rank its experts from ``expert0`` on, and with ``partial`` the f32
    sum before its one rounding, :func:`~.moe.moe_ffn`)."""
    if is_moe(cfg):
        from .moe import moe_ffn

        return moe_ffn(cfg, lp, x, expert0=expert0, partial=partial)
    return _mlp(cfg, x, lp["w_gate"], lp["w_up"], lp["w_down"])


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


def _logits(mesh, ms, x, home: Optional[torch.device] = None):
    """Final norm and the head product: fp32 logits over the whole
    vocabulary, on rank 0. Each rank of rank 0's ``tp`` group computes the
    product over its own slice of the vocabulary (column-parallel); the
    slices are gathered in the model dtype and widened once. In a gang
    every process but rank 0's gives its slices and gets None: sampling
    runs on rank 0, and the engine sends the sampled tokens on
    (``engine/engine.py:chunk_body``). With ``pp`` this runs on the last
    stage's mesh, and ``home`` (the model's rank 0's device, where
    sampling runs) takes the logits."""
    def head(r):
        return qmat(_norm(ms[r].cfg, x[r], ms[r].final_norm), ms[r].head())

    if mesh is None:
        out = head(0).float()
    else:
        group = mesh.group(0, "tp")
        out = mesh.gather(mesh.per_rank(lambda r: head(r) if r in group else None), dim=-1)
        out = None if out is None else out.float()
    return out if out is None or home is None else out.to(home)


def _last_rows(mesh, x, lens):
    """Each row's hidden state at its last valid position (``lens`` - 1),
    [b, 1, d]: all of a prefill that the head needs when the caller
    samples there and reads no prompt log-probabilities."""
    def last(r):
        at = (lens[r].long() - 1)[:, None, None].expand(-1, 1, x[r].shape[-1])
        return x[r].gather(1, at)

    return _each(mesh, last)


def _layer_tail(mesh, ms, lps, x, attn):
    """The rest of a layer after attention. ``wo`` and ``w_down`` are
    row-parallel on a mesh: each rank's product is a partial sum, reduced
    FIRST; the post-norm and the residual then run on the full sum,
    replicated on every rank. An MoE FFN's output is reduced where the
    dense one's is: each rank routes the same replicated input with the
    replicated router and sums its experts' partial down products. On an
    ``ep`` mesh each rank's experts are a slice of E, and its partial is
    the f32 sum before the FFN's one rounding: the partials are reduced
    over ``tp`` and ``ep`` in f32 and rounded once, where the reference's
    f32 contraction over E puts its ``psum``."""
    cfg = _first(ms).cfg
    o = _reduce(mesh, _each(mesh, lambda r: qmat(attn[r], lps[r]["wo"])))
    ep = 1 if mesh is None else mesh.shape["ep"]

    def mlp(r):
        lp = lps[r]
        xr = x[r] + _post(cfg, lp, "post_attn_norm", o[r])
        h = _norm(cfg, xr, lp["mlp_norm"])
        if ep > 1:
            return xr, _ffn(cfg, lp, h, expert0=mesh.index(r, "ep") * cfg.num_experts, partial=True)
        return xr, _ffn(cfg, lp, h)

    mid = _each(mesh, mlp)
    if ep > 1:
        sums = mesh.all_reduce_sum([None if m is None else m[1] for m in mid], ("tp", "ep"))
        rounded: Dict[int, torch.Tensor] = {}  # ranks that share a sum round it once
        dtype = _first(mid)[0].dtype
        for t in sums:
            if t is not None and id(t) not in rounded:
                rounded[id(t)] = t.to(dtype)
        y = [None if t is None else rounded[id(t)] for t in sums]
    else:
        y = _reduce(mesh, [None if m is None else m[1] for m in mid])
    return _each(mesh, lambda r: mid[r][0] + _post(cfg, lps[r], "post_ffn_norm", y[r]))


def _home(mesh: Optional[Mesh]) -> Optional[torch.device]:
    """Where a forward's logits go: rank 0's device on a pipeline (its last
    stage computes them), else where :func:`_logits` forms them."""
    return None if mesh is None or mesh.pp == 1 else mesh.devices[0]


@torch.no_grad()
def prefill(
    model: "Llama | ShardedLlama",
    tokens: torch.Tensor,  # [b, s] int, right-padded
    seq_lens: torch.Tensor,  # [b] int32
    cache: "Cache | Sequence[Cache]",  # k/v pages [L, P, ps, kvh, hd], written in place
    page_table: torch.Tensor,  # [b, pages_per_seq] int32
    last_only: bool = False,
) -> torch.Tensor:
    """Prefill a batch of prompts, writing their KV into the pool.
    Returns logits [b, s, vocab] fp32; the caller reads them at
    seq_lens-1. With ``last_only`` only that position goes through the
    final norm and the head: logits [b, 1, vocab] (on a mesh the head's
    gather then moves one row, not the bucket's)."""
    mesh, ms, caches = _ranks(model, cache)
    cfg = _first(ms).cfg
    tokens, seq_lens, page_table = _replicated(mesh, tokens, seq_lens, page_table)
    b, s = _first(tokens).shape
    page_size = _first(caches)[0].shape[2]

    def prepare(r):
        positions = torch.arange(s, dtype=torch.int64, device=tokens[r].device).expand(b, s)
        return positions, positions < seq_lens[r][:, None]

    pv = _each(mesh, prepare)

    def layers(st: _Stage, x):
        ms, caches, spv, lens, table = st.ms, st.caches, st.take(pv), st.take(seq_lens), st.take(page_table)
        for i in range(cfg.num_layers):
            lps = [None if m is None else m.layer(i) for m in ms]

            def attend(r):
                positions, valid = spv[r]
                k_pages, v_pages = caches[r]
                h = _norm(cfg, x[r], lps[r]["attn_norm"])
                q, k, v = _project_qkv(ms[r], lps[r], h, positions)
                _scatter_prefill(k_pages[i], k, table[r], positions, valid, page_size)
                _scatter_prefill(v_pages[i], v, table[r], positions, valid, page_size)
                return causal_prefill_attention(q, k, v, lens[r]).reshape(b, s, cfg.q_dim)

            x = _layer_tail(st.mesh, ms, lps, x, _each(st.mesh, attend))
        return x

    st, x = _walk(mesh, ms, caches, lambda st: _embed(st.mesh, st.ms, st.take(tokens)), layers)
    if last_only:
        x = _last_rows(st.mesh, x, st.take(seq_lens))
    return _logits(st.mesh, st.ms, x, _home(mesh))


@torch.no_grad()
def prefill_continue(
    model: "Llama | ShardedLlama",
    tokens: torch.Tensor,  # [b, s] int suffix tokens, right-padded
    start: torch.Tensor,  # [b] int32 — absolute position of tokens[:, 0]
    suffix_lens: torch.Tensor,  # [b] int32 — valid suffix length per row
    cache: "Cache | Sequence[Cache]",  # written in place
    page_table: torch.Tensor,  # [b, pages_per_seq] int32
    last_only: bool = False,
) -> torch.Tensor:
    """Prefill a prompt SUFFIX against a pool whose first ``start`` tokens
    are already present (prefix-cache hits, chunked prefill): writes only
    the suffix's KV, then attends over the paged cache. Returns logits
    [b, s, vocab] fp32; the caller samples at suffix_lens-1. With
    ``last_only``, that position's alone, [b, 1, vocab], as :func:`prefill`."""
    mesh, ms, caches = _ranks(model, cache)
    cfg = _first(ms).cfg
    tokens, start, suffix_lens, page_table = _replicated(mesh, tokens, start, suffix_lens, page_table)
    b, s = _first(tokens).shape
    page_size = _first(caches)[0].shape[2]

    def prepare(r):
        ar = torch.arange(s, dtype=torch.int64, device=tokens[r].device)
        return start[r].long()[:, None] + ar[None, :], ar[None, :] < suffix_lens[r][:, None]

    pv = _each(mesh, prepare)

    def layers(st: _Stage, x):
        ms, caches, spv, first, table = st.ms, st.caches, st.take(pv), st.take(start), st.take(page_table)
        for i in range(cfg.num_layers):
            lps = [None if m is None else m.layer(i) for m in ms]

            def attend(r):
                positions, valid = spv[r]
                k_pages, v_pages = caches[r]
                h = _norm(cfg, x[r], lps[r]["attn_norm"])
                q, k, v = _project_qkv(ms[r], lps[r], h, positions)
                _scatter_prefill(k_pages[i], k, table[r], positions, valid, page_size)
                _scatter_prefill(v_pages[i], v, table[r], positions, valid, page_size)
                attn = paged_suffix_attention(q, k_pages[i], v_pages[i], table[r], first[r])
                return attn.reshape(b, s, cfg.q_dim)

            x = _layer_tail(st.mesh, ms, lps, x, _each(st.mesh, attend))
        return x

    st, x = _walk(mesh, ms, caches, lambda st: _embed(st.mesh, st.ms, st.take(tokens)), layers)
    if last_only:
        x = _last_rows(st.mesh, x, st.take(suffix_lens))
    return _logits(st.mesh, st.ms, x, _home(mesh))


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
    once per rank over the rank's heads, no collective inside (with
    ``pp``, once per rank of the stage that holds the layer; a stage of
    one rank launches the kernel itself, as one device does).

    Returns logits [T, vocab] fp32; the caller gathers the rows that
    sample. Padding rows write only the null page and produce values
    nobody reads."""
    mesh, ms, caches = _ranks(model, cache)
    cfg = _first(ms).cfg
    tokens, row_slot, positions, page_table = _replicated(mesh, tokens, row_slot, positions, page_table)
    (T,) = _first(tokens).shape
    page_size = _first(caches)[0].shape[2]
    prep = _each(mesh, lambda r: (
        _row_targets(page_table[r], row_slot[r], positions[r], page_size),
        positions[r].long()[None],
    ))

    def layers(st: _Stage, x):
        ms, caches, sprep = st.ms, st.caches, st.take(prep)
        table, slots, pos_t = st.take(page_table), st.take(row_slot), st.take(positions)
        for i in range(cfg.num_layers):
            lps = [None if m is None else m.layer(i) for m in ms]

            def project_and_write(r):
                targets, pos = sprep[r]
                k_pages, v_pages = caches[r]
                h = _norm(cfg, x[r], lps[r]["attn_norm"])
                q, k, v = _project_qkv(ms[r], lps[r], h[None], pos)
                q, k, v = q[0], k[0], v[0]  # [T, heads/kvh, hd]
                _scatter_rows(k_pages[i], k, targets)
                _scatter_rows(v_pages[i], v, targets)
                return q

            q = _each(st.mesh, project_and_write)
            if st.mesh is None or st.mesh.size == 1:  # one rank (a stage of pp alone): the kernel itself
                attn = [ragged_paged_attention(q[0], caches[0][0][i], caches[0][1][i], table[0], slots[0], pos_t[0])]
            else:
                attn = ragged_paged_attention_sharded(
                    st.mesh, q, [c[0][i] for c in caches], [c[1][i] for c in caches], table, slots, pos_t,
                )
            x = _layer_tail(st.mesh, ms, lps, x, [a.reshape(T, cfg.q_dim) for a in attn])
        return x

    st, x = _walk(mesh, ms, caches, lambda st: _embed(st.mesh, st.ms, st.take(tokens)), layers)  # [T, hidden] per rank
    return _logits(st.mesh, st.ms, x, _home(mesh))


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
      layers' cache writes defer to ONE write after the layer loop (with
      ``pp``, one per stage, into its own layers).

    ``active`` masks rows of a frozen slot: their K/V go to the null page,
    and their logits are values the caller ignores."""
    if model.cfg.attention_impl == "reference":
        return _decode_step_scatter_first(model, tokens, positions, cache, page_table, active)
    mesh, ms, caches = _ranks(model, cache)
    cfg = _first(ms).cfg
    tokens, positions, page_table, active = _replicated(mesh, tokens, positions, page_table, active)
    b = _first(tokens).shape[0]
    page_size = _first(caches)[0].shape[2]
    pos2 = _each(mesh, lambda r: positions[r].long()[:, None])

    def layers(st: _Stage, x):
        ms, caches, spos2 = st.ms, st.caches, st.take(pos2)
        table, pos_t, live = st.take(page_table), st.take(positions), st.take(active)
        kv_all: List[Tuple[list, list]] = [([], []) for _ in ms]
        for i in range(cfg.num_layers):
            lps = [None if m is None else m.layer(i) for m in ms]

            def attend(r):
                k_pages, v_pages = caches[r]
                h = _norm(cfg, x[r], lps[r]["attn_norm"])
                q, k, v = _project_qkv(ms[r], lps[r], h[:, None, :], spos2[r])
                q, k, v = q[:, 0], k[:, 0], v[:, 0]  # [b, heads/kvh, hd]
                attn = paged_decode_attention_inline(q, k_pages[i], v_pages[i], k, v, table[r], pos_t[r])
                kv_all[r][0].append(k)
                kv_all[r][1].append(v)
                return attn.reshape(b, cfg.q_dim)

            x = _layer_tail(st.mesh, ms, lps, x, _each(st.mesh, attend))

        def write_all(r):
            # One write for the stage's layers: [L, b, kvh, hd] at (page, slot) per row.
            k_pages, v_pages = caches[r]
            phys = torch.gather(table[r].long(), 1, (spos2[r] // page_size))[:, 0]
            slot = pos_t[r].long() % page_size
            if live[r] is not None:
                phys = torch.where(live[r], phys, 0)  # inactive rows: the null page
            k_pages[:, phys, slot] = torch.stack(kv_all[r][0])
            v_pages[:, phys, slot] = torch.stack(kv_all[r][1])

        _each(st.mesh, write_all)
        return x

    st, x = _walk(mesh, ms, caches, lambda st: _embed(st.mesh, st.ms, st.take(tokens)), layers)  # [b, hidden] per rank
    return _logits(st.mesh, st.ms, x, _home(mesh))


def _decode_step_scatter_first(model, tokens, positions, cache, page_table, active=None):
    """The reference's baseline decode step: each layer writes its new K/V
    into the pool, then attends over the cache with ``seq_lens = pos + 1``
    (:func:`~..ops.attention.paged_decode_attention`). Inactive rows write
    the null page 0 (the reference drops them) and attend through their
    unmasked table; their logits are ignored."""
    mesh, ms, caches = _ranks(model, cache)
    cfg = _first(ms).cfg
    tokens, positions, page_table, active = _replicated(mesh, tokens, positions, page_table, active)
    b = _first(tokens).shape[0]
    page_size = _first(caches)[0].shape[2]

    def prepare(r):
        table = page_table[r]
        if active[r] is not None:
            table = torch.where(active[r][:, None], table, 0)
        return positions[r] + 1, table, positions[r].long()[:, None]

    prep = _each(mesh, prepare)

    def layers(st: _Stage, x):
        ms, caches, sprep, pos_t, tables = st.ms, st.caches, st.take(prep), st.take(positions), st.take(page_table)
        for i in range(cfg.num_layers):
            lps = [None if m is None else m.layer(i) for m in ms]

            def attend(r):
                seq_lens, table, pos2 = sprep[r]
                k_pages, v_pages = caches[r]
                h = _norm(cfg, x[r], lps[r]["attn_norm"])
                q, k, v = _project_qkv(ms[r], lps[r], h[:, None, :], pos2)
                q, k, v = q[:, 0], k[:, 0], v[:, 0]  # [b, heads/kvh, hd]
                _scatter_decode(k_pages[i], k, table, pos_t[r], page_size)
                _scatter_decode(v_pages[i], v, table, pos_t[r], page_size)
                attn = paged_decode_attention(q, k_pages[i], v_pages[i], tables[r], seq_lens)
                return attn.reshape(b, cfg.q_dim)

            x = _layer_tail(st.mesh, ms, lps, x, _each(st.mesh, attend))
        return x

    st, x = _walk(mesh, ms, caches, lambda st: _embed(st.mesh, st.ms, st.take(tokens)), layers)  # [b, hidden] per rank
    return _logits(st.mesh, st.ms, x, _home(mesh))
