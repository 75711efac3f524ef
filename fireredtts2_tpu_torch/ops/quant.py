"""Weight-only quantisation: the quantisers and the matmul route.

One decision, written once for every quantised matrix of the port (the
backbone and depth decoder, the vocoder's transformer, kernel B's bundle).
Matrices are stacked ``(L, I, O)`` (input rows, output columns), as in the
JAX package's trees:

- int8: symmetric, one scale per output column (``quantize_int8``);
- int4: symmetric, one scale per group of input rows and output column,
  halves-packed: packed row i holds input row i in its low nibble and row
  i + I/2 in its high nibble (``quantize_int4``; ``ops.int4.unpack_int4``
  undoes it).

``quantized_matmul`` routes ``x @ W`` as the JAX package's
``transformer._mm`` does:
- int8 (``W.dtype == int8``): ``(x @ W.to(x.dtype)) * scale`` in plain
  PyTorch, as the JAX package leaves it to XLA. Its cost here: every call
  converts the whole int8 matrix to a copy in x's dtype in device memory
  (read 1 B, write 2 B, read 2 B per weight where bf16 weights read 2 B)
  and adds two launches per matmul;
- int4 (``name + "_scale4"`` present): always kernel E,
  ``ops.int4.int4_matmul`` (its plain version on the CPU), reading the
  output-major layout that ``ops.int4.prepare_int4_layout`` adds.
"""

from __future__ import annotations

from typing import Any

import torch

from fireredtts2_tpu_torch.ops.int4 import int4_matmul

Params = dict[str, Any]


def quantize_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., I, O) -> (int8 (..., I, O), float32 scales (..., 1, O))."""
    wf = w.to(torch.float32)
    scale = torch.clamp(wf.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-8)
    return torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8), scale


def quantize_int4(w: torch.Tensor, group: int, span: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, I, O) -> halves-packed ((L, I/2, O) int8, (L, I/g, O) float32).
    The group g is the largest power-of-two divisor of `span` at most
    `group`: the JAX transformer quantiser takes span = I, kernel B's
    bundle span = I/2 (so that no group straddles the two halves)."""
    wf = w.to(torch.float32)
    L, I, O = wf.shape
    g = max(min(group, span), 1)
    while span % g:
        g //= 2
    wg = wf.reshape(L, I // g, g, O)
    scale = torch.clamp(wg.abs().amax(dim=2, keepdim=True) / 7.0, min=1e-8)
    q = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int32).reshape(L, I, O)
    lo, hi = q[:, : I // 2], q[:, I // 2:]
    return ((lo & 0x0F) | (hi << 4)).to(torch.int8), scale[:, :, 0, :]


def quantize_tree(params: Params, keys: tuple[str, ...], bits: int = 8,
                  group: int = 128) -> Params:
    """A copy of a stacked tree with each matrix in `keys` quantised: int8
    plus ``name + "_scale"`` (L, 1, O), or int4 plus ``name + "_scale4"``
    (L, I/g, O). Norms and biases stay."""
    out: Params = {}
    for k, v in params.items():
        if k not in keys:
            out[k] = v
        elif bits == 8:
            out[k], out[k + "_scale"] = quantize_int8(v)
        else:
            out[k], out[k + "_scale4"] = quantize_int4(v, group, v.shape[1])
    return out


def quantized_matmul(x: torch.Tensor, lp: Params, name: str) -> torch.Tensor:
    """x @ lp[name], with transparent weight-only int8/int4 (see the
    module docstring for the routes)."""
    w = lp[name]
    if name + "_scale4" in lp:
        return int4_matmul(x, w, lp[name + "_scale4"], lp.get(name + "_t4"),
                           lp.get(name + "_s4t"))
    if w.dtype == torch.int8:
        y = x @ w.to(x.dtype)
        return y * lp[name + "_scale"][0].to(y.dtype)
    return x @ w
