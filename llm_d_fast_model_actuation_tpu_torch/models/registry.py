"""Model-family dispatch: random init by config type.

Port of ``models/registry.py:init_params_for`` for the dense Llama family;
the MoE family is not ported yet and is refused.
"""

from __future__ import annotations

import torch

from . import llama


def init_params_for(
    cfg: llama.LlamaConfig, generator: torch.Generator, device: "torch.device | str",
    mesh=None,
) -> "llama.Llama | llama.ShardedLlama":
    if not isinstance(cfg, llama.LlamaConfig) or getattr(cfg, "num_experts", 0) > 1:
        raise ValueError(f"unsupported model config {type(cfg).__name__} (dense Llama only)")
    return llama.init_params(cfg, generator, device, mesh=mesh)
