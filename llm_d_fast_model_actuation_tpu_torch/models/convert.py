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

from .llama import LlamaConfig

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


def params_from_jax(tree: Dict[str, Any], device: "torch.device | str" = "cpu") -> Dict[str, torch.Tensor]:
    """The reference's parameter pytree (numpy leaves) -> a state dict
    for :class:`~.llama.Llama` (``layers.<name>`` for the stacked layer
    weights), on ``device``. Quantized leaves are refused."""
    state: Dict[str, torch.Tensor] = {}
    for name, leaf in tree.items():
        if name == "layers":
            for lname, lleaf in leaf.items():
                if isinstance(lleaf, dict):
                    raise ValueError(f"quantized weight layers.{lname} is not supported")
                state[f"layers.{lname}"] = _leaf(lleaf).to(device)
        else:
            if isinstance(leaf, dict):
                raise ValueError(f"quantized weight {name} is not supported")
            state[name] = _leaf(leaf).to(device)
    return state


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
