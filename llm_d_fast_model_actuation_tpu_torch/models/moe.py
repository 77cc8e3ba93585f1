"""Mixtral-style sparse-MoE decoder: the second model family.

Port of ``llm_d_fast_model_actuation_tpu/models/moe.py``. The family
shares the Llama attention trunk and every forward of ``models/llama.py``
(bucketed, packed, speculative verify); only the FFN differs: a router
picks the top ``experts_per_token`` of ``num_experts`` experts for each
token, and the experts' SwiGLU outputs are summed with the renormalized
router probabilities.

Layout, as the reference's: the router is ``layers.router [L, h, E]``, the
expert stacks ``layers.w_gate``/``w_up [L, E, h, f]`` and ``w_down [L, E,
f, h]``, every one a tensor of the engine's arena like the dense stacks,
so sleeping, waking, swapping and the captured graphs carry over. Under
``--quantization int8`` the expert stacks hold int8 with an f32 scale per
expert and per output channel (``[L, E, 1, out]``); the router stays in
the model dtype.

Dispatch is DENSE compute, as in the reference: every expert runs on every
token and the router's weights are zero for the experts a token did not
pick. That keeps every shape static (the decode graphs capture it) at E/k
times the FFN's operations; a routed, sparse dispatch changes the work,
not the answer.

Numerics are the reference's, rounding for rounding (:func:`moe_ffn`).
Ties in the router's top-k break as ``jax.lax.top_k`` breaks them, the
lower expert index first: :func:`route` takes the first k of a stable
descending sort (``torch.sort(..., stable=True)``), which keeps equal
logits in index order. Bf16-rounded router logits tie often enough that
``torch.topk``, which promises no order among ties, would change routing.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .llama import LlamaConfig
from .quant import qeinsum

#: the expert stacks of an MoE layer (its FFN), in the dense FFN's names
EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")


@dataclass(frozen=True)
class MoeConfig(LlamaConfig):
    num_experts: int = 8
    experts_per_token: int = 2
    #: the router's width when this config is one expert-parallel rank's
    #: (``llama.shard_config``: ``num_experts`` is then the rank's E/ep
    #: experts, and the router stays whole); 0 means ``num_experts``
    router_experts: int = 0

    @classmethod
    def mixtral_8x7b(cls) -> "MoeConfig":
        return cls(
            vocab_size=32000,
            hidden_size=4096,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            intermediate_size=14336,
            rope_theta=1e6,
            max_seq_len=32768,
            num_experts=8,
            experts_per_token=2,
        )

    @classmethod
    def tiny_moe(cls, vocab: int = 256) -> "MoeConfig":
        """CPU test size."""
        return cls(
            vocab_size=vocab,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            intermediate_size=96,
            rope_theta=10000.0,
            max_seq_len=128,
            num_experts=4,
            experts_per_token=2,
        )

    def num_params(self) -> int:
        h, f, e = self.hidden_size, self.intermediate_size, self.num_experts
        per_layer = (
            2 * h  # norms
            + h * self.q_dim
            + 2 * h * self.kv_dim
            + self.q_dim * h
            + h * e  # router
            + e * 3 * h * f  # experts
        )
        head = 0 if self.tie_embeddings else h * self.vocab_size
        return self.vocab_size * h + self.num_layers * per_layer + h + head


def moe_config(cfg: LlamaConfig, **moe_fields: Any) -> MoeConfig:
    """``cfg``'s fields with the MoE family's (``num_experts``,
    ``experts_per_token``) over them: a config read field by field (an HF
    ``config.json``, the reference's config) made an :class:`MoeConfig`."""
    return MoeConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(LlamaConfig)}, **moe_fields)


def route(cfg: MoeConfig, router: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The router's choice for each row of ``x [..., h]``: the indices of
    its top ``experts_per_token`` experts ``[..., k]`` (int64, best first,
    ties to the lower index) and their softmax over those k, f32. The
    logits ``x @ router`` are rounded to ``x.dtype`` and then widened, as
    the reference's are."""
    logits = torch.matmul(x, router).float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    return idx[..., :k], torch.softmax(vals[..., :k], dim=-1)


def moe_ffn(
    cfg: MoeConfig, lp: Dict[str, Any], x: torch.Tensor, expert0: int = 0, partial: bool = False
) -> torch.Tensor:
    """The reference's ``moe_ffn``: the top-k routed expert FFN, dense
    compute, on ``x [..., h]`` with one layer's ``lp`` (``router [h, E]``,
    the expert stacks ``[E, h, f]``/``[E, f, h]``, plain or ``{"q",
    "s"}``). Each expert's gate and up product (:func:`~.quant.qeinsum`:
    the product rounded to ``x.dtype``, a quantized one's scale after it),
    ``silu`` in f32 rounded to ``x.dtype`` times up, each expert's down
    product, then the f32 sum over the experts weighted by the router's
    dense ``[..., E]`` weights, rounded to ``x.dtype``.

    The expert products run in the layout the W8A16 kernel takes, expert
    major (``[E, rows, ...]``); on a tensor-parallel rank ``f`` is the
    rank's slice and the result a partial sum the caller reduces. On an
    expert-parallel rank the stacks hold the experts ``expert0 ..
    expert0 + E/ep - 1`` while the router is whole: every row is routed
    over all E experts and weights its own ones. ``partial`` returns the
    f32 sum unrounded, for the caller to reduce over the mesh and round
    once."""
    lead, h = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, h)
    idx, probs = route(cfg, lp["router"], x2)
    weights = torch.zeros((x2.shape[0], lp["router"].shape[-1]), dtype=torch.float32, device=x.device)
    weights = weights.scatter(-1, idx, probs)  # [rows, E]
    local = cfg.num_experts
    if local != weights.shape[-1]:
        weights = weights[:, expert0:expert0 + local]
    g = qeinsum(x2, lp["w_gate"])  # [E, rows, f]
    u = qeinsum(x2, lp["w_up"])
    act = F.silu(g.float()).to(x.dtype) * u
    y = qeinsum(act, lp["w_down"])  # [E, rows, h]
    out = (y.float() * weights.t()[:, :, None]).sum(0)
    if partial:
        return out.reshape(lead + (h,))
    return out.to(x.dtype).reshape(lead + (h,))
