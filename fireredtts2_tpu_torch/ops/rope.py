"""Rotary position embeddings (HF/Qwen2 half-split convention).

Counterpart of ``fireredtts2_tpu/ops/rope.py``.
"""

from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, head_dim: int, base: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for absolute positions (...,) -> each (..., head_dim//2)
    float32."""
    half = head_dim // 2
    exponent = (torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) * 2.0 / head_dim)
    inv_freq = 1.0 / (base ** exponent)
    ang = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotate x (B, S, H, D) by cos/sin (B, S, D//2), channel pairs
    (i, i + D/2); the math runs in fp32 and the result is cast back to x's
    dtype."""
    d = x.shape[-1]
    c = cos[..., None, :].to(torch.float32)
    s = sin[..., None, :].to(torch.float32)
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :d // 2], xf[..., d // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
