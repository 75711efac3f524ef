"""Residual vector quantisation: decode codes to embeddings.

Counterpart of the decode half of ``fireredtts2_tpu/models/codec/rvq.py``
(encoding belongs to prompt encoding, a later slice). All quantizers'
codebooks and projections are stacked on a leading nq axis.
"""

from __future__ import annotations

from typing import Any

import torch

from fireredtts2_tpu_torch.config import RVQConfig

Params = dict[str, Any]


def init_rvq_params(gen: torch.Generator, cfg: RVQConfig, dtype=torch.float32,
                    device=None) -> Params:
    """Random decode-side params in the JAX tree layout (codebooks and
    biases stay float32, as there); the encoder's projections come with
    prompt encoding."""
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
    return p


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
    out = torch.einsum("qbtc,qcr->btr", emb,
                       params["out_proj_w"][:nq].to(f32))
    out = out + params["out_proj_b"][:nq].to(f32).sum(dim=0)[None, None, :]
    if "output_proj_w" in params:
        out = (out @ params["output_proj_w"].to(f32)
               + params["output_proj_b"].to(f32))
    return out
