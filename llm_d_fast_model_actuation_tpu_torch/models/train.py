"""Training step (next-token LM loss) for the model zoo.

Port of ``llm_d_fast_model_actuation_tpu/models/train.py``, with the
reference's names: :func:`forward_train`, :func:`lm_loss`,
:class:`TrainState`, :func:`make_optimizer`, :func:`make_train_state`,
:func:`train_step`. The serving framework's main job is inference
actuation; the training step exists for the reference's two reasons:
(a) it runs over a real ``dp`` x ``pp`` x ``sp`` x ``tp`` x ``ep`` mesh, every
sharding the engine uses plus the gradient reductions; (b) it makes the
model zoo usable for fine-tune-then-serve loops (the trained parameters
are a state dict ``InferenceEngine`` takes).

Parameters are a flat dict in ``Llama.state_dict()`` names, stacked
(``layers.wq`` is ``[L, hidden, q_dim]``), as ``models/convert.py``, the
digests and the engine read them; on a mesh each name maps to one tensor
per rank (:func:`shard_train_params`). A step updates them IN PLACE: the
state handed to :func:`train_step` is consumed, and the one it returns
holds the same tensors. The layer loop reads per-layer views of the
stacks; :func:`train_step` makes each view a leaf of its own, so a layer's
backward writes a gradient the size of one layer, not a zero-filled one
the size of the whole stack (what indexing a stacked leaf under autograd
gives), and the optimizer writes each update through the view into the
stack.

Attention is :func:`~..ops.attention.dense_causal_attention`, the
counterpart of the XLA function the reference's training runs (its
Pallas kernel has no transpose rule), or with ``sp > 1`` the ring
(:mod:`~..ops.ring_attention`). ``remat`` recomputes each layer's
activations in the backward (``torch.utils.checkpoint``, non-reentrant),
the reference's ``jax.checkpoint`` of the scan body.

**Under a mesh.** Tokens are split over ``dp`` (rows) and ``sp``
(positions); weights by their logical axes (``tp``, ``ep``, and the layer
stacks over ``pp``). Every rank runs its block of the forward; with
``pp`` the stages run in turn as the serving forwards walk them
(``models/llama.py:_walk``), the last stage's ranks computing the logits.
The collectives and the pipeline's hand-off are the mesh's
differentiable ones, so one ``backward`` from the loss reaches every
rank's tensors, and the loss is normalised over the GLOBAL mask (the
numerator and the count summed over ``dp`` x ``sp`` before the divide).
A weight replicated over some axes then holds, on each copy, the part of
its gradient that flowed through that copy; the gradient is their sum
(:func:`reduce_replica_grads`). Ranks on one device may share one tensor
of a replicated weight (``Mesh.replicate`` hands them one): autograd has
then summed it already, so the sum runs over the DISTINCT tensors of a
replica group only, never twice over one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.attention import dense_causal_attention
from ..ops.rope import rope_table
from ..parallel.mesh import AXES, Mesh, join_for, replica_of, shard_for
from .llama import (
    LlamaConfig,
    _each,
    _embed,
    _layer_tail,
    _norm,
    _project_qkv,
    _walk,
    param_specs,
    quantized_names,
    shard_config,
)

#: a flat parameter tree: ``Llama.state_dict()`` name -> tensor, or on a
#: mesh -> one tensor per rank
Params = Dict[str, Any]


class _Rank:
    """What the shared forward helpers of ``models/llama.py`` read of a
    model (``cfg``, ``embed``, the RoPE tables, ``head()``), over one
    rank's tensors and per-layer weight dicts."""

    def __init__(self, cfg: LlamaConfig, top: Dict[str, torch.Tensor], layers: List[Dict[str, torch.Tensor]],
                 rope: Tuple[torch.Tensor, torch.Tensor]) -> None:
        self.cfg = cfg
        self.embed = top["embed"]
        self.final_norm = top["final_norm"]
        self.lm_head = top.get("lm_head")
        self.rope_cos, self.rope_sin = rope
        self.layers = layers

    def head(self) -> torch.Tensor:
        return self.embed.t() if self.cfg.tie_embeddings else self.lm_head


def _layered(tree: Params, mesh: Optional[Mesh], num_layers: int):
    """One (top-level leaves, per-layer weight dicts) pair per rank, over
    the rank's own ``num_layers`` (its stage's, :func:`_local_cfg`). A
    stacked leaf is a tensor, indexed per layer under autograd, or already
    a list of per-layer views (:func:`_leaf_views`)."""
    if mesh is not None:
        for name, v in tree.items():
            if isinstance(v, torch.Tensor) or len(v) != mesh.size:
                raise ValueError(f"on {mesh} a parameter is one tensor per rank; {name} is not")
    out = []
    for r in range(1 if mesh is None else mesh.size):
        top: Dict[str, torch.Tensor] = {}
        layers: List[Dict[str, torch.Tensor]] = [{} for _ in range(num_layers)]
        for name, v in tree.items():
            leaf = v if mesh is None else v[r]
            if name.startswith("layers."):
                for i in range(num_layers):
                    layers[i][name[len("layers."):]] = leaf[i]
            else:
                top[name] = leaf
        out.append((top, layers))
    return out


def _check_plain(cfg: LlamaConfig) -> None:
    if quantized_names(cfg):
        raise ValueError("training runs on plain weights (bf16 or fp32); int8 is a serving-time quantization")


def _local_cfg(cfg: LlamaConfig, mesh: Optional[Mesh]) -> LlamaConfig:
    """One rank's config: its ``tp`` and ``ep`` slices, and with ``pp``
    its stage's layers."""
    if mesh is None:
        return cfg
    return shard_config(cfg, mesh.tp, mesh.shape["ep"], mesh.pp)


def _blocks(mesh: Optional[Mesh], tokens: torch.Tensor, seq_lens: torch.Tensor, devices: Sequence[torch.device]):
    """Each rank's (tokens, seq_lens, positions): its ``dp`` rows and ``sp``
    positions of the global batch."""
    b, s = tokens.shape
    dp = 1 if mesh is None else mesh.shape["dp"]
    sp = 1 if mesh is None else mesh.shape["sp"]
    if b % dp or s % sp:
        raise ValueError(f"batch {b} x seq {s} does not split over dp={dp} x sp={sp}")
    rows, chunk = b // dp, s // sp
    out = []
    for r, dev in enumerate(devices):
        i = 0 if mesh is None else mesh.index(r, "dp")
        k = 0 if mesh is None else mesh.index(r, "sp")
        tok = tokens[i * rows:(i + 1) * rows, k * chunk:(k + 1) * chunk].to(dev)
        pos = (k * chunk + torch.arange(chunk, device=dev)).expand(rows, chunk)
        out.append((tok, seq_lens[i * rows:(i + 1) * rows].to(dev), pos))
    return out


def _loss_ranks(mesh: Optional[Mesh]) -> List[int]:
    """The ranks that compute the loss: the last pipeline stage's at
    ``tp`` and ``ep`` coordinate 0, every ``dp`` and ``sp`` block once
    (that stage's first rank's group over dp x sp)."""
    return [0] if mesh is None else mesh.group(mesh.stage_ranks(mesh.pp - 1)[0], ("dp", "sp"))


def _forward_ranks(
    layered: List[Tuple[Dict[str, torch.Tensor], List[Dict[str, torch.Tensor]]]],
    cfg: LlamaConfig,
    tokens: torch.Tensor,
    seq_lens: torch.Tensor,
    remat: bool,
    mesh: Optional[Mesh],
) -> Dict[int, torch.Tensor]:
    """The forward over every rank; returns the f32 logits over the whole
    vocabulary of each loss rank's block (:func:`_loss_ranks`)."""
    local = _local_cfg(cfg, mesh)
    devices = [top["embed"].device for top, _ in layered]
    tables = {}
    for d in dict.fromkeys(devices):
        tables[d] = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling, device=d)
    ms = [_Rank(local, top, layers, tables[devices[r]]) for r, (top, layers) in enumerate(layered)]
    blocks = _blocks(mesh, tokens, seq_lens, devices)
    use_ring = mesh is not None and mesh.shape["sp"] > 1
    if use_ring:
        from ..ops.ring_attention import ring_prefill_attention

    def layers(st, x):
        sms, sblocks = st.ms, st.take(blocks)

        def layer(i: int, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
            lps = [m.layers[i] for m in sms]

            def project(r):
                h = _norm(local, xs[r], lps[r]["attn_norm"])
                return _project_qkv(sms[r], lps[r], h, sblocks[r][2])

            qkv = _each(st.mesh, project)
            lens = [blk[1] for blk in sblocks]
            if use_ring:
                attn = ring_prefill_attention(
                    [t[0] for t in qkv], [t[1] for t in qkv], [t[2] for t in qkv], lens, st.mesh
                )
            else:
                attn = [dense_causal_attention(q, k, v, lens[r]) for r, (q, k, v) in enumerate(qkv)]
            attn = [a.reshape(a.shape[0], a.shape[1], local.q_dim) for a in attn]
            return tuple(_layer_tail(st.mesh, sms, lps, list(xs), attn))

        for i in range(local.num_layers):
            if remat:
                x = list(checkpoint(layer, i, *x, use_reentrant=False))
            else:
                x = list(layer(i, *x))
        return x

    def embed(st):
        return _embed(st.mesh, st.ms, [blk[0] for blk in st.take(blocks)])

    last, x = _walk(mesh, ms, [None] * len(ms), embed, layers)
    x = dict(zip(last.ranks, x))  # the last stage's residual stream, by global rank

    out = {}
    heads = {}
    for r in last.ranks:
        if mesh is None or mesh.index(r, "ep") == 0:
            heads[r] = _norm(local, x[r], ms[r].final_norm) @ ms[r].head()
    for r in _loss_ranks(mesh):
        group = [r] if mesh is None else mesh.group(r, "tp")
        parts = [heads[q].to(devices[r]) for q in group]
        out[r] = (parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)).float()
    return out


def forward_train(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [b, s]
    seq_lens: torch.Tensor,  # [b]
    remat: bool = True,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Dense causal forward (no KV cache), logits fp32 ``[b, s, vocab]``.
    Keeps the Gemma-family helpers of the serving forward ((1+w) norms,
    sandwich norms, scaled embeddings, QK-norm) and its FFN by family
    (the MoE family's routed experts too).

    With a ``mesh`` (``params`` one tensor per rank,
    :func:`shard_train_params`) every rank runs its block; attention runs
    as RING attention over ``sp`` when ``sp > 1``. The logits are joined
    on rank 0's device (from the last pipeline stage's ranks)."""
    _check_plain(cfg)
    layered = _layered(params, mesh, _local_cfg(cfg, mesh).num_layers)
    out = _forward_ranks(layered, cfg, tokens, seq_lens, remat, mesh)
    if mesh is None:
        return out[0]
    dev = mesh.devices[0]
    last = mesh.stage_ranks(mesh.pp - 1)
    parts = [out[r].to(dev) if r in out else None for r in last]
    return join_for(parts, ("dp", "sp", None), mesh.stage_mesh(mesh.pp - 1))


def _masked_nll(logits: torch.Tensor, tokens: torch.Tensor, seq_lens: torch.Tensor, start: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the masked next-token NLL, count of the mask) of one block
    of logits ``[b, c, vocab]`` at positions ``start ..`` of the GLOBAL
    ``tokens [b, s]``: position p predicts ``tokens[:, p + 1]`` and counts
    when ``p < seq_len - 1`` (so never at ``s - 1``, whose target is
    clamped)."""
    b, c, _ = logits.shape
    s = tokens.shape[1]
    dev = logits.device
    pos = start + torch.arange(c, device=dev)
    nxt = tokens.to(dev)[:, torch.clamp(pos + 1, max=s - 1)]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, nxt[..., None].long())[..., 0]
    mask = (pos[None, :] < (seq_lens.to(dev) - 1)[:, None]).float()
    return (nll * mask).sum(), mask.sum()


def _loss_from_layered(layered, cfg, tokens, seq_lens, mesh) -> torch.Tensor:
    out = _forward_ranks(layered, cfg, tokens, seq_lens, True, mesh)
    dp = 1 if mesh is None else mesh.shape["dp"]
    sp = 1 if mesh is None else mesh.shape["sp"]
    rows, chunk = tokens.shape[0] // dp, tokens.shape[1] // sp
    dev = next(iter(out.values())).device
    num = den = None
    for r, logits in out.items():
        i = 0 if mesh is None else mesh.index(r, "dp")
        k = 0 if mesh is None else mesh.index(r, "sp")
        n, c = _masked_nll(logits, tokens[i * rows:(i + 1) * rows], seq_lens[i * rows:(i + 1) * rows], k * chunk)
        # summed over dp x sp on rank 0's device, in rank order, before the divide
        num = n.to(dev) if num is None else num + n.to(dev)
        den = c.to(dev) if den is None else den + c.to(dev)
    loss = num / torch.clamp(den, min=1.0)
    return loss if mesh is None else loss.to(mesh.devices[0])


def lm_loss(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,
    seq_lens: torch.Tensor,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Masked next-token cross-entropy: the mean NLL over every position
    p with ``p < seq_len - 1``, over ``max(mask.sum(), 1)``; on a mesh the
    numerator and the count are summed over ``dp`` x ``sp`` first. A
    scalar on rank 0's device."""
    _check_plain(cfg)
    return _loss_from_layered(_layered(params, mesh, _local_cfg(cfg, mesh).num_layers), cfg, tokens, seq_lens, mesh)


# -- the optimizer ------------------------------------------------------------


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count and the two moments,
    trees of the parameters' structure and dtype."""

    count: int
    mu: Params
    nu: Params


class TrainState(NamedTuple):
    step: int
    params: Params
    opt_state: AdamState


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.adamw(lr, weight_decay=0.01)``: Adam's moments with bias
    correction, ``u = m̂ / (sqrt(v̂) + eps) + wd * p`` on every leaf, and
    ``p <- p - lr * u``, each expression as optax writes it, in the
    parameters' dtype (optax keeps both moments in it). ``torch.optim``'s
    AdamW is not used: it applies the decay as a separate multiply and
    its default ``foreach`` path builds whole-model temporary lists (its
    ``_foreach_sqrt`` of every second moment alone is another 16 GB at
    Llama-3-8B). Here one leaf is updated at a time, a stacked leaf one
    layer view at a time, so the largest temporary is one layer slice of
    one weight."""

    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01

    def init(self, params: Params) -> AdamState:
        return AdamState(count=0, mu=_zeros_like(params), nu=_zeros_like(params))

    @torch.no_grad()
    def apply_(self, p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, count: int) -> None:
        """One leaf's update in place, ``count`` the incremented step."""
        mu.copy_((1 - self.b1) * g + self.b1 * mu)
        nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
        one = torch.ones((), dtype=torch.float32, device=p.device)
        bc1 = (one - torch.full((), self.b1, dtype=torch.float32, device=p.device) ** count).to(mu.dtype)
        bc2 = (one - torch.full((), self.b2, dtype=torch.float32, device=p.device) ** count).to(nu.dtype)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        u = u + self.weight_decay * p
        u = u * (-self.lr)
        p.copy_(p + u)


def make_optimizer(lr: float = 3e-4) -> AdamW:
    return AdamW(lr=lr)


def _zeros_like(tree: Params) -> Params:
    """Zeros of every leaf; leaves that are one tensor on several ranks
    get one zero tensor there too."""
    made: Dict[int, torch.Tensor] = {}

    def z(t: torch.Tensor) -> torch.Tensor:
        if id(t) not in made:
            made[id(t)] = torch.zeros_like(t)
        return made[id(t)]

    return {k: z(v) if isinstance(v, torch.Tensor) else [z(t) for t in v] for k, v in tree.items()}


def make_train_state(params: Params, optimizer: Optional[AdamW] = None) -> TrainState:
    optimizer = optimizer or make_optimizer()
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def shard_train_params(params: Dict[str, torch.Tensor], cfg: LlamaConfig, mesh: Mesh) -> Params:
    """A single-device flat tree -> one tensor per rank on ``mesh``: each
    rank's slice by the weight's spec (``llama.param_specs``; ``tp``,
    ``ep``, and ``pp`` for the layer stacks), a contiguous copy on its
    device. Ranks that hold the same slice on one device share ONE tensor
    (as ``Mesh.replicate`` hands a replicated input); a tree with a tensor
    of its own for every rank is taken by :func:`train_step` as well."""
    specs = param_specs(cfg)
    out: Params = {}
    for name, t in params.items():
        spec = specs[name]
        held: Dict[Any, torch.Tensor] = {}
        per = []
        for r, dev in enumerate(mesh.devices):
            key = (replica_of(spec, mesh, r), dev)
            if key not in held:
                held[key] = shard_for(t, spec, mesh, r).to(dev, copy=True).contiguous()
            per.append(held[key])
        out[name] = per
    return out


def unshard_train_params(params: Params, cfg: LlamaConfig, mesh: Mesh, device: "torch.device | str") -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_train_params`: the whole tree on
    ``device``."""
    specs = param_specs(cfg)
    return {name: join_for([t.to(device) for t in v], specs[name], mesh) for name, v in params.items()}


# -- the step ------------------------------------------------------------------


def _leaf_views(tree: Params, num_layers: int, grad: bool = True) -> Params:
    """The tree with every stacked leaf as a list of per-layer views over
    the same storage; with ``grad`` each view (and each top-level tensor)
    a new autograd leaf. One set per distinct tensor, so ranks that share
    a tensor share its views."""
    made: Dict[int, Any] = {}

    def views(name: str, t: torch.Tensor):
        key = id(t)
        if key not in made:
            t = t.detach()
            vs = [t[i] for i in range(num_layers)] if name.startswith("layers.") else t
            if grad:
                vs = [v.requires_grad_() for v in vs] if isinstance(vs, list) else vs.requires_grad_()
            made[key] = vs
        return made[key]

    return {k: views(k, v) if isinstance(v, torch.Tensor) else [views(k, t) for t in v] for k, v in tree.items()}


def _distinct(vparams: Params, mu: Params, nu: Params, mesh: Optional[Mesh]):
    """(parameter view, its mu view, its nu view) once per distinct
    parameter view: ranks that share a tensor are updated once."""
    seen = set()
    for name in vparams:
        per = [(vparams[name], mu[name], nu[name])] if mesh is None else zip(vparams[name], mu[name], nu[name])
        for p, m, v in per:
            if id(p) in seen:
                continue
            seen.add(id(p))
            yield from zip(p, m, v) if isinstance(p, list) else [(p, m, v)]


def _unique(items: Sequence[Any]) -> List[Any]:
    seen: Dict[int, Any] = {}
    for it in items:
        seen.setdefault(id(it), it)
    return list(seen.values())


@torch.no_grad()
def reduce_replica_grads(vtree: Params, cfg: LlamaConfig, mesh: Mesh) -> None:
    """Sum each weight's gradient over the ranks it is replicated on, in
    place: within each replica group (the ranks that hold the same
    slice), the DISTINCT leaves' gradients are added in rank order on the
    first one's device and the sum written back to each. A leaf that
    ranks share already holds their sum (autograd added it), so it is
    counted once."""
    specs = param_specs(cfg)
    for name, per in vtree.items():
        split = {a for a in specs[name] if a is not None and mesh.shape[a] > 1}
        replicated = tuple(a for a in AXES if a not in split)
        for group in mesh.groups(replicated):
            uniq = _unique([per[r] for r in group])
            if len(uniq) < 2:
                continue
            for leaves in zip(*(u if isinstance(u, list) else [u] for u in uniq)):
                grads = [leaf.grad for leaf in leaves if leaf.grad is not None]  # a copy no output used has none
                if not grads:
                    continue
                total = grads[0]
                for g in grads[1:]:
                    total = total + g.to(total.device)
                for leaf in leaves:
                    leaf.grad = total.to(leaf.device, copy=True)


def train_step(
    state: TrainState,
    cfg: LlamaConfig,
    tokens: torch.Tensor,
    seq_lens: torch.Tensor,
    optimizer: Optional[AdamW] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step, in place (the module docstring). Under a mesh
    the parameters and moments are one tensor per rank, the batch is
    split over ``dp`` x ``sp``, attention runs as the ring when ``sp >
    1``, the stages run in turn with ``pp`` (each rank's optimizer
    updates its own stage's layers), and each replicated weight's
    gradient is summed over its replicas before the update. Returns the
    new state and ``{"loss"}`` (a scalar on rank 0's device)."""
    _check_plain(cfg)
    optimizer = optimizer or make_optimizer()
    layers = _local_cfg(cfg, mesh).num_layers  # a rank's own: its stage's with pp
    vparams = _leaf_views(state.params, layers)
    loss = _loss_from_layered(_layered(vparams, mesh, layers), cfg, tokens, seq_lens, mesh)
    loss.backward()
    if mesh is not None:
        reduce_replica_grads(vparams, cfg, mesh)
    count = state.opt_state.count + 1
    mu = _leaf_views(state.opt_state.mu, layers, grad=False)
    nu = _leaf_views(state.opt_state.nu, layers, grad=False)
    for p, m, v in _distinct(vparams, mu, nu, mesh):
        optimizer.apply_(p.detach(), p.grad if p.grad is not None else torch.zeros_like(p), m, v, count)
        p.grad = None
    del vparams
    return (
        TrainState(step=state.step + 1, params=state.params,
                   opt_state=AdamState(count=count, mu=state.opt_state.mu, nu=state.opt_state.nu)),
        {"loss": loss.detach()},
    )
