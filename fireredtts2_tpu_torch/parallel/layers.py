"""Tensor-parallel pieces of the model code: split matmuls, vocabulary
lookups and logits, and the attention head window of a tp rank.

Each helper reads the current mesh (``mesh.tp_mesh()``: the engine's,
inside its device calls) and the local shapes of the weights it is given. A leaf narrower than its whole width is
this rank's even part of it (``mesh.shard_params``); a leaf at its whole
width was replicated (``mesh.sanitize_pspecs`` replicates what the mesh
does not divide), so the same code serves both. Without a mesh, or with
tp = 1, every helper is the plain single-rank computation.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from fireredtts2_tpu_torch.ops.flash_decode import flash_lm_tp_ok, gqa1_window
from fireredtts2_tpu_torch.ops.quant import quantized_matmul
from fireredtts2_tpu_torch.parallel.mesh import (
    Mesh, all_reduce, gather_dim, tp_mesh,
)

Params = dict[str, Any]


def gather_cols(x: torch.Tensor, full: int) -> torch.Tensor:
    """The whole last dimension of a column-parallel output (x itself when
    it is already whole)."""
    m = tp_mesh()
    if m is None or x.shape[-1] == full:
        return x
    return gather_dim(x, full, -1, m.tp_group, m.tp_rank)


def local_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    """This rank's `width` columns of a whole last dimension (x itself when
    it is already that narrow)."""
    m = tp_mesh()
    if m is None or x.shape[-1] == width:
        return x
    return x.narrow(-1, m.tp_rank * width, width)


def split_rows(a: torch.Tensor, lp: Params, name: str, m: Mesh
               ) -> torch.Tensor:
    """a @ lp[name] for a weight split by rows (input features) over m's
    tp: the rank's partial product over its columns of a (a itself when
    it is already that narrow), summed over the tp group BEFORE an int8
    scale multiplies it (parallel/mesh.py:_COL_KEYS)."""
    rows = lp[name].shape[-2]
    if a.shape[-1] != rows:
        a = a.narrow(-1, m.tp_rank * rows, rows)
    return quantized_matmul(a, lp, name,
                            reduce=lambda y: all_reduce(y, m.tp_group))


def row_matmul(a: torch.Tensor, lp: Params, name: str, full_in: int
               ) -> torch.Tensor:
    """a @ lp[name] for a row-parallel weight of full_in input features:
    split (:func:`split_rows`) when it holds fewer rows; a replicated
    weight takes the whole activation and needs no sum."""
    m = tp_mesh()
    if m is None:
        return quantized_matmul(a, lp, name)
    if lp[name].shape[-2] == full_in:
        return quantized_matmul(gather_cols(a, full_in), lp, name)
    return split_rows(a, lp, name, m)


def vocab_lookup(table: torch.Tensor, idx: torch.Tensor, full_rows: int,
                 reduce: bool = True) -> torch.Tensor:
    """table[idx] for a table whose rows (the vocabulary) may be split over
    tp: the rank looks up the ids in its slice, zeros elsewhere, and the tp
    sum assembles the rows (exact: one rank adds a row, the others zeros).
    reduce=False returns the rank's part for a caller that sums first and
    then takes the tp sum once (:func:`tp_sum`); a whole table's rows then
    come from tp rank 0 alone."""
    m = tp_mesh()
    n = table.shape[0]
    if m is None:
        return table[idx]
    if n == full_rows:
        rows = table[idx]
        return rows if reduce or m.tp_rank == 0 else torch.zeros_like(rows)
    local = idx - m.tp_rank * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)] * inside[..., None].to(table.dtype)
    return all_reduce(rows, m.tp_group) if reduce else rows


def tp_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the tp group of the ranks' parts (x itself without
    tp)."""
    m = tp_mesh()
    return x if m is None else all_reduce(x, m.tp_group)


def vocab_logits(h: torch.Tensor, w: torch.Tensor, full_cols: int
                 ) -> torch.Tensor:
    """h @ w for a head whose columns (the vocabulary) may be split over
    tp, gathered whole so that sampling sees every logit."""
    return gather_cols(h @ w, full_cols)


def head_window(hq_local: int, Hq: int, Hkv: int) -> Optional[tuple[int, int]]:
    """(kv_base, hkv) of the kv heads this rank's hq_local query heads read
    (ops/flash_decode.py:gqa1_window), or None when its heads do not form
    one (the attention then runs on the gathered heads)."""
    m = tp_mesh()
    if m is None or hq_local == Hq:
        return 0, Hkv
    if hq_local * m.tp != Hq or not flash_lm_tp_ok(m, Hq, Hkv, 0, 0,
                                                   cuda=False):
        return None
    return gqa1_window(Hq, Hkv, m.tp, m.tp_rank)
