"""Rotary position embeddings (RoPE), Llama convention.

The model builds its (cos, sin) table once, on its device, and every
forward gathers rows by position (the JAX reference rebuilds the table
inside each traced call, where XLA folds it into a constant).
"""

import math

import torch


def _scale_freqs(freqs: torch.Tensor, scaling) -> torch.Tensor:
    """Apply an HF-style rope_scaling spec to the inverse frequencies.

    `scaling` is a tuple (models/llama.py `LlamaConfig.rope_scaling`):
      ("linear", factor)  — divide every frequency by factor
      ("llama3", factor, low_freq_factor, high_freq_factor, original_max)
        — Llama-3.1's banded scheme: low-frequency bands divide by
        factor, high-frequency bands pass through, mid bands interpolate.
    """
    kind = scaling[0]
    if kind == "linear":
        return freqs / scaling[1]
    if kind == "llama3":
        _, factor, low_ff, high_ff, orig_max = scaling
        low_wavelen = orig_max / low_ff
        high_wavelen = orig_max / high_ff
        wavelen = 2.0 * math.pi / freqs
        scaled = freqs / factor
        smooth = (orig_max / wavelen - low_ff) / (high_ff - low_ff)
        mid = (1.0 - smooth) * scaled + smooth * freqs
        out = torch.where(wavelen > low_wavelen, scaled, freqs)
        is_mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
        return torch.where(is_mid, mid, out)
    raise ValueError(f"unsupported rope scaling {kind!r}")


def rope_table(
    max_len: int,
    head_dim: int,
    theta: float = 10000.0,
    scaling=None,
    device: "torch.device | str" = "cpu",
):
    """(cos, sin) tables of shape [max_len, head_dim//2], fp32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)
    if scaling is not None:
        freqs = _scale_freqs(freqs, tuple(scaling))
    pos = torch.arange(max_len, dtype=torch.float32, device=device)
    angles = pos[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, cos_tab: torch.Tensor,
    sin_tab: torch.Tensor,
) -> torch.Tensor:
    """Rotate q or k by position.

    x: [..., seq, heads, head_dim]; positions: [..., seq] int.
    Uses the "split halves" (rotate-half) layout, matching HF Llama.
    """
    cos = cos_tab[positions][..., None, :]  # broadcast over heads
    sin = sin_tab[positions][..., None, :]
    xf = x.float()
    half = xf.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
