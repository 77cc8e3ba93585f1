"""Model families: an ``nn.Module`` holding the reference's parameter names
and stacked layouts, and plain forward functions over a paged KV pool."""

from .llama import (  # noqa: F401
    Llama,
    LlamaConfig,
    decode_step,
    init_params,
    prefill,
    prefill_continue,
)
