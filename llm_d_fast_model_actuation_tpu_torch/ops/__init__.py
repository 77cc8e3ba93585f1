"""Compute ops: plain PyTorch functions, and the hand-written CUDA kernels
of the serving path behind the same signatures (``ops/cuda/``)."""

from .attention import (  # noqa: F401
    RAGGED_BLOCK,
    causal_prefill_attention,
    paged_decode_attention,
    paged_decode_attention_inline,
    paged_suffix_attention,
    ragged_paged_attention,
)
from .norm import rms_norm  # noqa: F401
from .rope import apply_rope, rope_table  # noqa: F401
