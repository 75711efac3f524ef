"""Residual vector quantisation: encode features to codes, decode codes to
embeddings.

Counterpart of ``fireredtts2_tpu/models/codec/rvq.py``. All quantizers'
codebooks and projections are stacked on a leading nq axis. The encode's
distances and argmin run in fp32, in full fp32 on the card
(``ops.precision``), so the same features give the same codes on the card
and on the CPU up to near-ties, which :func:`code_gaps` and
:func:`code_mismatches` tell apart.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from fireredtts2_tpu_torch.config import RVQConfig
from fireredtts2_tpu_torch.ops.precision import peinsum
from fireredtts2_tpu_torch.ops.quant import promoting_matmul

Params = dict[str, Any]


def init_rvq_params(gen: torch.Generator, cfg: RVQConfig, dtype=torch.float32,
                    device=None) -> Params:
    """Random params in the JAX tree layout (codebooks and biases stay
    float32, as there): the decode side's leaves are drawn first, then the
    encoder's projections."""
    nq = cfg.num_quantizers
    rd, cd, cs = cfg.resolved_rvq_dim, cfg.codebook_dim, cfg.codebook_size

    def w(*shape, to=dtype):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * 0.02).to(to)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    p: Params = {
        "codebook": w(nq, cs, cd, to=torch.float32),
        "out_proj_w": w(nq, cd, rd), "out_proj_b": zeros(nq, rd),
    }
    if cfg.resolved_output_dim != rd:
        p["output_proj_w"] = w(rd, cfg.resolved_output_dim)
        p["output_proj_b"] = zeros(cfg.resolved_output_dim)
    p["in_proj_w"] = w(nq, rd, cd)
    p["in_proj_b"] = zeros(nq, cd)
    if cfg.input_dim != rd:
        p["input_proj_w"] = w(cfg.input_dim, rd)
        p["input_proj_b"] = zeros(rd)
    return p


def _distances(z_e: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """||z - c||^2 = z.z - 2 z.c + c.c: z_e (B, T, cd) fp32, codebook
    (cs, cd) fp32 -> (B, T, cs)."""
    z2 = (z_e * z_e).sum(dim=-1, keepdim=True)
    zc = peinsum("btd,cd->btc", z_e, codebook)
    c2 = (codebook * codebook).sum(dim=-1)[None, None, :]
    return z2 - 2.0 * zc + c2


def _nearest_code(z_e: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(B, T) int32 argmin over the distances; ties take the first index,
    as jnp.argmin does."""
    return torch.argmin(_distances(z_e, codebook), dim=-1).to(torch.int32)


def _quantize(params: Params, z: torch.Tensor, choose) -> torch.Tensor:
    """The residual loop: quantizer i projects the residual into its code
    space (z_e, (B, T, cd) fp32), ``choose(i, z_e, codebook)`` picks the
    (B, T) int32 codes, and their reconstruction leaves the residual.
    Returns the codes (nq, B, T)."""
    z = z.to(torch.float32)
    if "input_proj_w" in params:
        z = promoting_matmul(z, params["input_proj_w"]) + params["input_proj_b"]
    residual, codes = z, []
    for i in range(params["codebook"].shape[0]):
        cb = params["codebook"][i]
        z_e = promoting_matmul(residual, params["in_proj_w"][i]) \
            + params["in_proj_b"][i]
        idx = choose(i, z_e, cb)
        recon = promoting_matmul(cb[idx.to(torch.int64)],
                                 params["out_proj_w"][i]) + params["out_proj_b"][i]
        residual = residual - recon
        codes.append(idx)
    return torch.stack(codes)


def rvq_encode(params: Params, cfg: RVQConfig, z: torch.Tensor
               ) -> torch.Tensor:
    """Quantize features z (B, T, input_dim) -> codes (nq, B, T) int32."""
    return _quantize(params, z, lambda i, z_e, cb: _nearest_code(z_e, cb))


def code_gaps(params: Params, cfg: RVQConfig, z: torch.Tensor,
              codes: torch.Tensor) -> torch.Tensor:
    """How near a tie each of ``rvq_encode(params, cfg, z)``'s codes was,
    on the same device: replays `codes` through the residual loop and
    returns (nq, B, T) float32, each step's distance gap between the
    second-best and the best code relative to z.z + c.c of the best (the
    scale of the terms whose cancellation gives a distance)."""
    gaps = []

    def replay(i, z_e, cb):
        two = torch.topk(_distances(z_e, cb), 2, dim=-1, largest=False).values
        idx = codes[i]
        scale = (z_e * z_e).sum(-1) + (cb * cb).sum(-1)[idx.to(torch.int64)]
        gaps.append((two[..., 1] - two[..., 0]) / scale.clamp(min=1e-30))
        return idx

    _quantize(params, z, replay)
    return torch.stack(gaps)


def code_mismatches(want: np.ndarray, got: np.ndarray, gaps: np.ndarray,
                    rel: float = 1e-5) -> tuple[int, int]:
    """Compare two encodes' codes (nq, B, T) frame by frame. A frame (b, t)
    whose codes differ is a near-tie when its first differing quantizer's
    gap (:func:`code_gaps` of `want`'s side) is below `rel`; the
    quantizers after it see another residual. Returns (frames that
    differ, of them not near-ties)."""
    diff = np.asarray(want) != np.asarray(got)                 # (nq, B, T)
    frames = diff.any(axis=0)
    first = np.argmax(diff, axis=0)                            # (B, T)
    gap = np.take_along_axis(np.asarray(gaps), first[None], axis=0)[0]
    return int(frames.sum()), int((frames & (gap >= rel)).sum())


def rvq_decode(params: Params, cfg: RVQConfig, codes: torch.Tensor
               ) -> torch.Tensor:
    """Codes (nq, B, T) -> features (B, T, output_dim) float32: the sum over
    quantizers of out_project(codebook[code]), then output_proj. The math
    runs in float32, as JAX's type promotion of the float32 codebooks with
    the (possibly bf16) projections does. Codes are clamped into the
    codebook, as JAX's gather clamps: the LM's audio vocabulary (2051)
    is larger than the codebook (2048)."""
    f32 = torch.float32
    nq = codes.shape[0]
    cb = params["codebook"][:nq]                                  # (nq, cs, cd)
    qidx = torch.arange(nq, device=codes.device)[:, None, None]
    codes = codes.to(torch.int64).clamp(0, cb.shape[1] - 1)
    emb = cb[qidx, codes].to(f32)                                # (nq, B, T, cd)
    out = peinsum("qbtc,qcr->btr", emb, params["out_proj_w"][:nq].to(f32))
    out = out + params["out_proj_b"][:nq].to(f32).sum(dim=0)[None, None, :]
    if "output_proj_w" in params:
        out = (promoting_matmul(out, params["output_proj_w"])
               + params["output_proj_b"].to(f32))
    return out
