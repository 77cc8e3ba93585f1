"""RMSNorm. Computed in fp32, cast back to the input dtype — bf16 variance
accumulation loses too much precision at hidden sizes >= 4k."""

import torch


def rms_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    eps: float = 1e-5,
    offset: float = 0.0,
) -> torch.Tensor:
    """`offset=1.0` gives the Gemma-family convention: weights are stored
    zero-centered and applied as (1 + w)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (y * (weight.float() + offset)).to(x.dtype)
