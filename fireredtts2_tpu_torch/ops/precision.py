"""Matmul and convolution precision policy.

Counterpart of ``fireredtts2_tpu/ops/precision.py``. There, a product whose
operands are all float32 runs at ``Precision.HIGHEST`` (genuine fp32: codec
numerics, the RVQ's argmin); bf16 operands take the fast path. On the card
the fp32 hazard is TF32: PyTorch runs fp32 convolutions on cuDNN in TF32 by
default (``torch.backends.cudnn.allow_tf32`` is True), and fp32 matmuls too
once a caller lowers ``torch.set_float32_matmul_precision``. So the rule
here: a matmul, einsum or convolution whose operands are all fp32 goes
through :func:`pmatmul`, :func:`peinsum` or :func:`pconv1d`, which run it
inside :func:`fp32_exact`: TF32 off for both cuDNN and cuBLAS for its
duration, the caller's flags restored after. The global flags are never
changed at import.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator

import torch
import torch.nn.functional as F

# The TF32 flags are process-wide, and scopes of several threads overlap
# (a streamed vocoder block beside an encode): the first scope to enter
# saves the caller's flags, the last to leave restores them, and between
# the two they stay off.
_lock = threading.Lock()
_depth = 0
_saved: tuple[bool, bool] = (False, False)


@contextmanager
def fp32_exact() -> Iterator[None]:
    """fp32 matmuls and convolutions in full fp32 (no TF32) inside, in
    every thread while any thread is inside."""
    global _depth, _saved
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    with _lock:
        if _depth == 0:
            _saved = (cudnn.allow_tf32, mm.allow_tf32)
            cudnn.allow_tf32 = False
            mm.allow_tf32 = False
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                cudnn.allow_tf32, mm.allow_tf32 = _saved


def all_fp32(*tensors: torch.Tensor) -> bool:
    return all(t.dtype == torch.float32 for t in tensors)


def pmatmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with the policy applied: full fp32 when both operands are."""
    if all_fp32(x, w):
        with fp32_exact():
            return x @ w
    return x @ w


def peinsum(subscripts: str, *operands: torch.Tensor) -> torch.Tensor:
    """einsum with the policy applied: full fp32 when every operand is."""
    if all_fp32(*operands):
        with fp32_exact():
            return torch.einsum(subscripts, *operands)
    return torch.einsum(subscripts, *operands)


def pconv1d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
            padding: int = 0) -> torch.Tensor:
    """F.conv1d (no bias) with the policy applied."""
    if all_fp32(x, w):
        with fp32_exact():
            return F.conv1d(x, w, None, stride, padding)
    return F.conv1d(x, w, None, stride, padding)
