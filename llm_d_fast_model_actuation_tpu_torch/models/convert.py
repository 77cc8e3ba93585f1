"""Carry weights and configs across from the JAX package, name for name.

Both functions take plain data, never JAX objects: the JAX parameter
pytree after ``np.asarray`` on every leaf, and any object with the JAX
``LlamaConfig``'s field names. So this module imports neither JAX nor
the JAX package (nor ``ml_dtypes``, which the GPU machine lacks).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..parallel.mesh import shard
from .llama import LlamaConfig, param_tp_dims

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
    weights), on ``device``. Quantized leaves are refused.

    With a ``mesh`` (``parallel/mesh.py:TpMesh``) and the model's GLOBAL
    ``cfg``: the state dict of a :class:`~.llama.ShardedLlama`
    (``ranks.<r>.<name>``), each numpy array sliced by the logical-axes
    table before it leaves the host, so rank ``r``'s tensor holds what the
    reference's sharded array holds on its ``r``-th device, on
    ``mesh.devices[r]``."""
    flat: Dict[str, Any] = {}
    for name, leaf in tree.items():
        for key, sub in ({f"layers.{k}": v for k, v in leaf.items()} if name == "layers" else {name: leaf}).items():
            if isinstance(sub, dict):
                raise ValueError(f"quantized weight {key} is not supported")
            flat[key] = sub
    if mesh is None:
        return {name: _leaf(a).to(device) for name, a in flat.items()}
    if cfg is None:
        raise ValueError("slicing for a mesh needs the model's config (cfg=)")
    dims = param_tp_dims(cfg)
    return {
        f"ranks.{r}.{name}": _leaf(shard(np.asarray(a), dims[name], r, mesh.tp)).to(d)
        for r, d in enumerate(mesh.devices)
        for name, a in flat.items()
    }


def config_from_jax(cfg: Any) -> LlamaConfig:
    """A port config with the same field values as a reference config
    (its ``dtype`` mapped by name). ``attention_impl`` carries across: in
    the port it selects only the decode step's cache-write strategy
    (``"reference"`` = scatter-first), while the kernel is picked by the
    device of the tensors."""
    kw = {}
    for f in dataclasses.fields(LlamaConfig):
        v = getattr(cfg, f.name)
        if f.name == "dtype":
            v = _DTYPES[np.dtype(v).name]
        kw[f.name] = v
    if getattr(cfg, "num_experts", 0) > 1:
        raise ValueError("MoE configs are not supported by the port yet")
    return LlamaConfig(**kw)
