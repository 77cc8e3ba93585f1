"""Model-family dispatch: random init by config type.

Port of ``models/registry.py:init_params_for`` for the dense Llama family;
the MoE family is not ported yet and is refused. The draw goes into a
model that already exists (the engine's, in its arenas), in place.
"""

from __future__ import annotations

import torch

from . import llama


def fill_params_for(model: "llama.Llama | llama.ShardedLlama", generator: torch.Generator) -> None:
    cfg = model.cfg
    if not isinstance(cfg, llama.LlamaConfig) or getattr(cfg, "num_experts", 0) > 1:
        raise ValueError(f"unsupported model config {type(cfg).__name__} (dense Llama only)")
    llama.fill_params(model, generator)
