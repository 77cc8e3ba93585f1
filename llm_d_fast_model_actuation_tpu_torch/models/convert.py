"""Carry weights, training states and configs across from the JAX
package, name for name.

The functions take plain data, never JAX objects: the JAX parameter
pytree after ``np.asarray`` on every leaf, and any object with the JAX
``LlamaConfig``'s field names. So this module imports neither JAX nor
the JAX package (nor ``ml_dtypes``, which the GPU machine lacks).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..parallel.mesh import shard_for
from .llama import LlamaConfig, param_specs
from .moe import moe_config

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def _leaf(a: Any) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy the tensor may own
    if str(a.dtype) == "bfloat16":
        # ml_dtypes' bfloat16 is a numpy extension dtype torch.from_numpy
        # refuses: reinterpret the bits as int16 and view them as bf16
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(
    tree: Dict[str, Any],
    device: "torch.device | str" = "cpu",
    mesh=None,
    cfg: "LlamaConfig | None" = None,
) -> Dict[str, torch.Tensor]:
    """The reference's parameter pytree (numpy leaves) -> a state dict
    for :class:`~.llama.Llama` (``layers.<name>`` for the stacked layer
    weights), on ``device``. A quantized leaf ``{"q", "s"}`` (a
    ``--quantization int8`` tree) carries across as it is, as
    ``<name>.q`` and ``<name>.s`` (an MoE expert stack's scale is ``[L,
    E, 1, out]``, a scale per expert).

    With a ``mesh`` (``parallel/mesh.py:Mesh``, ``pp``, ``tp`` and ``ep``) and
    the model's GLOBAL ``cfg``: the state dict of a
    :class:`~.llama.ShardedLlama` (``ranks.<r>.<name>``), each numpy array
    sliced by the logical-axes table before it leaves the host, so rank
    ``r``'s tensor holds what the reference's sharded array holds on its
    ``r``-th device, on ``mesh.devices[r]``, for each rank this process
    holds (a gang member carries its own ranks' slices; a layer stack split
    over ``pp``, a stage its own layers; an MoE expert stack split over ``ep``; a quantized ``cfg`` splits a scale over ``tp`` only along
    its output axis, ``llama.param_specs``)."""
    flat: Dict[str, Any] = {}
    for name, leaf in tree.items():
        for key, sub in ({f"layers.{k}": v for k, v in leaf.items()} if name == "layers" else {name: leaf}).items():
            if isinstance(sub, dict):
                if set(sub) != {"q", "s"}:
                    raise ValueError(f"weight {key} is a dict but not a quantized leaf {{'q', 's'}}: {sorted(sub)}")
                flat[f"{key}.q"], flat[f"{key}.s"] = sub["q"], sub["s"]
            else:
                flat[key] = sub
    if mesh is None:
        return {name: _leaf(a).to(device) for name, a in flat.items()}
    if cfg is None:
        raise ValueError("slicing for a mesh needs the model's config (cfg=)")
    specs = param_specs(cfg)
    return {
        f"ranks.{r}.{name}": _leaf(shard_for(np.asarray(a), specs[name], mesh, r)).to(mesh.devices[r])
        for r in mesh.local_ranks
        for name, a in flat.items()
    }


def train_state_from_jax(step: Any, params: Dict[str, Any], adam: Any, device: "torch.device | str" = "cpu"):
    """A JAX ``train.TrainState`` -> the port's
    (``models/train.py:TrainState``), as plain data: ``step`` and the
    parameter pytree with numpy leaves, and ``adam`` the optax adamw
    state's ``ScaleByAdamState`` (``state.opt_state[0]``) with numpy
    leaves (its ``count``, and ``mu`` and ``nu`` of the parameters'
    structure). Every tree becomes a flat state dict on ``device``
    (:func:`params_from_jax`)."""
    from .train import AdamState, TrainState

    return TrainState(
        step=int(np.asarray(step)),
        params=params_from_jax(params, device),
        opt_state=AdamState(count=int(np.asarray(adam.count)), mu=params_from_jax(adam.mu, device),
                            nu=params_from_jax(adam.nu, device)),
    )


def config_from_jax(cfg: Any) -> LlamaConfig:
    """A port config with the same field values as a reference config
    (its ``dtype`` mapped by name). ``attention_impl`` carries across: in
    the port it selects only the decode step's cache-write strategy
    (``"reference"`` = scatter-first), while the kernel is picked by the
    device of the tensors. A reference ``MoeConfig`` (it has
    ``num_experts``) becomes the port's :class:`~.moe.MoeConfig`."""
    kw = {}
    for f in dataclasses.fields(LlamaConfig):
        v = getattr(cfg, f.name)
        if f.name == "dtype":
            v = _DTYPES[np.dtype(v).name]
        kw[f.name] = v
    port = LlamaConfig(**kw)
    if hasattr(cfg, "num_experts"):
        return moe_config(port, num_experts=cfg.num_experts, experts_per_token=cfg.experts_per_token)
    return port
