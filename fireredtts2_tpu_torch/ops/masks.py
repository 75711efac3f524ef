"""Attention masks (bool, True = attend).

Counterpart of ``fireredtts2_tpu/ops/masks.py`` (the decode-step rows the
generation path uses).
"""

from __future__ import annotations

import torch


def decode_step_mask(input_pos: torch.Tensor, max_seq_len: int
                     ) -> torch.Tensor:
    """Causal rows for queries at absolute positions ``input_pos`` (B, S):
    (B, S, max_seq_len) with [b, s, j] = j <= input_pos[b, s]."""
    kv_pos = torch.arange(max_seq_len, dtype=torch.int32,
                          device=input_pos.device)
    return kv_pos[None, None, :] <= input_pos.to(torch.int32)[:, :, None]
