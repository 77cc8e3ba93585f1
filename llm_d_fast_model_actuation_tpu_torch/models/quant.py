"""Weight products of the model forward.

Port of ``models/quant.py:qmat`` for plain (bf16 or fp32) weights: the
JAX package leaves ``x @ w`` to XLA, so the port leaves it to
``torch.matmul``. Weights keep the reference's ``[in, out]`` layout, so
the product is ``x @ w`` with no transpose. The int8 (W8A16) path and the
transfer-quantization layer are not ported yet; a quantized weight is
refused, never silently dequantized.
"""

from __future__ import annotations

import torch


def qmat(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a plain weight."""
    if not isinstance(w, torch.Tensor):
        raise TypeError(
            "quantized weights are not supported by the port yet "
            f"(got {type(w).__name__})"
        )
    return torch.matmul(x, w)
