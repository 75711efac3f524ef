"""Attention primitives: grouped-query attention over static KV slabs.

Counterpart of ``fireredtts2_tpu/ops/attention.py``. Plain PyTorch (einsum,
softmax, where); scores and softmax run in float32 whatever the compute
dtype, masked slots get -1e30, and the probabilities are cast to the V
dtype before the PV product. These are the plain versions the CUDA
kernels are held against (``ops/flash_decode.py``).
"""

from __future__ import annotations

import math

import torch

_MASK_VALUE = -1e30


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """q (B, S, Hq, D); k, v (B, T, Hkv, D); mask bool broadcastable to
    (B, Hq, S, T), True = attend (3-D masks are (B, S, T)).
    Returns (B, S, Hq, D) in q's dtype."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    assert Hq % Hkv == 0, (Hq, Hkv)
    group = Hq // Hkv
    qf = q.reshape(B, S, Hkv, group, D)
    scores = torch.einsum("bshgd,bthd->bhgst", qf.to(torch.float32),
                          k.to(torch.float32)) * (1.0 / math.sqrt(D))
    if mask is not None:
        m = mask
        if m.ndim == 3:
            m = m[:, None, None, :, :]
        elif m.ndim == 4:
            m = m.reshape(B, Hkv, group, S, T)
        scores = scores.masked_fill(~m, _MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v)
    return out.reshape(B, S, Hq, D).to(q.dtype)


def _slab_chunk(T: int, target: int = 640) -> int:
    """Largest divisor of T that is <= target (T itself when T <= target)."""
    if T <= target:
        return T
    for n in range(-(-T // target), T + 1):
        if T % n == 0:
            return T // n
    return T


def gqa_attention_bounded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_end: torch.Tensor, live_hi,
                          q_start: torch.Tensor | None = None,
                          live_lo=None) -> torch.Tensor:
    """Decode attention over the LIVE chunks of a static KV slab.

    Args:
        q: (B, S, Hq, D); k, v: (B, T, Hkv, D) slabs or MERGED (B, T, Hkv*D).
        q_end: (B, S) int exclusive per-query bound.
        live_hi: int or 0-d tensor; slots >= live_hi are dead for every
            query (max(q_end) <= live_hi).
        q_start: optional (B, S) inclusive per-query lower bound.
        live_lo: optional int or 0-d tensor; whole chunks below it are
            skipped.
    Returns:
        (B, S, Hq, D) in q's dtype; equals dense masked attention up to fp32
        summation order. The JAX version walks the chunks with an online
        softmax; this one takes one softmax over the same chunk range
        [live_lo // C * C, ceil(live_hi / C) * C), clamped to T.
    """
    B, S, Hq, D = q.shape
    T = k.shape[1]
    merged = k.ndim == 3
    Hkv = k.shape[-1] // D if merged else k.shape[2]
    assert Hq % Hkv == 0, (Hq, Hkv)
    group = Hq // Hkv
    C = _slab_chunk(T)
    first = 0 if live_lo is None else max(int(live_lo), 0) // C
    n_live = max(-(-int(live_hi) // C), first + 1)
    lo, hi = first * C, min(n_live * C, T)

    kc, vc = k[:, lo:hi], v[:, lo:hi]
    if merged:
        kc = kc.reshape(B, hi - lo, Hkv, D)
        vc = vc.reshape(B, hi - lo, Hkv, D)
    idx = torch.arange(lo, hi, dtype=torch.int32, device=q.device)
    live = idx[None, None, :] < q_end.to(torch.int32)[:, :, None]     # (B, S, W)
    if q_start is not None:
        live &= idx[None, None, :] >= q_start.to(torch.int32)[:, :, None]
    qf = q.reshape(B, S, Hkv, group, D)
    scores = torch.einsum("bshgd,bthd->bhgst", qf.to(torch.float32),
                          kc.to(torch.float32)) * (1.0 / math.sqrt(D))
    scores = scores.masked_fill(~live[:, None, None], _MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", probs, vc)
    return out.reshape(B, S, Hq, D).to(q.dtype)
