"""Attention masks (bool, True = attend).

Counterpart of ``fireredtts2_tpu/ops/masks.py``: the decode-step rows the
generation path uses, and the causal, block-causal and padding masks of the
stateless (training and batch decode) forwards.
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


def nonpad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """True where position < length: (B, max_len) bool."""
    pos = torch.arange(max_len, dtype=torch.int32, device=lengths.device)
    return pos[None, :] < lengths.to(torch.int32)[:, None]


def causal_mask(seq_len: int, device=None) -> torch.Tensor:
    """Lower-triangular (seq_len, seq_len) bool, True = attend."""
    return torch.ones((seq_len, seq_len), dtype=torch.bool,
                      device=device).tril()


def block_causal_mask(lengths: torch.Tensor, max_len: int, chunk_size: int
                      ) -> torch.Tensor:
    """Position i attends to j iff j's ``chunk_size`` block is i's or an
    earlier one and both are non-pad: the streaming vocoder's pattern (one
    12.5 Hz token is 8 latents at 100 Hz). Returns (B, max_len, max_len)
    bool, True = attend."""
    valid = nonpad_mask(lengths, max_len)
    pair = valid[:, :, None] & valid[:, None, :]
    blk = torch.arange(max_len, dtype=torch.int32,
                       device=lengths.device) // chunk_size
    return pair & (blk[:, None] >= blk[None, :])[None]
