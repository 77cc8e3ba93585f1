"""Model-family dispatch: random init and weight quantization by config
type.

Port of ``models/registry.py``: the dense Llama family and the MoE family
(``models/moe.py``), which share one model class and one draw: an MoE
config's layers hold a router and expert stacks (``llama.param_shapes``),
drawn a layer at a time like the dense stacks. The draw goes into a model that already
exists (the engine's, in its arenas), in place, and quantizes there when
the config asks for it (``llama.fill_params``). The reference's
``logical_axes_for`` of a quantized config is ``llama.param_specs``
here, which applies ``quant.quantized_axes`` itself.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from . import llama
from .quant import quantize_params


def fill_params_for(model: "llama.Llama | llama.ShardedLlama", generator: torch.Generator) -> None:
    cfg = model.cfg
    if not isinstance(cfg, llama.LlamaConfig):
        raise ValueError(f"unsupported model config {type(cfg).__name__} (the Llama and MoE families)")
    llama.fill_params(model, generator)


def maybe_quantize(cfg: llama.LlamaConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """Apply the config's weight quantization to a nested weight tree
    (runtime quantization: bf16 checkpoints stay bf16 on disk, the card
    holds the int8 form); raises for an unknown mode."""
    if not llama.quantized_names(cfg):
        return params
    return quantize_params(params)
