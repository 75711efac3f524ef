"""Codec encoder side: the SSL adaptor and the GLU-conv downsample.

Counterpart of ``fireredtts2_tpu/models/codec/encoder.py``:
- SslAdaptor: Linear in_proj -> whisper layers -> LN -> Linear out_proj;
- ResidualDownConv: two stride-4 convs as GLU gate/up, residual with the
  4x-stacked input, LN, out_proj -- 50 Hz -> 12.5 Hz.
Mixed fp32 activations and bf16 weights promote to fp32, as in JAX.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from fireredtts2_tpu_torch.config import SslAdaptorConfig
from fireredtts2_tpu_torch.models.codec.whisper_nn import (
    init_whisper_layers, layer_norm, whisper_layers_forward,
)
from fireredtts2_tpu_torch.ops.quant import promoting_matmul as _mm

Params = dict[str, Any]


def _normal(gen, shape, dtype, device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * 0.02).to(dtype)


def init_ssl_adaptor(gen: torch.Generator, cfg: SslAdaptorConfig,
                     dtype=torch.float32, device=None) -> Params:
    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    return {
        "in_proj_w": _normal(gen, (cfg.in_dim, cfg.embed_dim), dtype, device),
        "in_proj_b": zeros(cfg.embed_dim),
        "layers": init_whisper_layers(gen, cfg.num_layers, cfg.embed_dim,
                                      cfg.resolved_ffn_dim, dtype, device),
        "ln_w": torch.ones((cfg.embed_dim,), dtype=dtype, device=device),
        "ln_b": zeros(cfg.embed_dim),
        "out_proj_w": _normal(gen, (cfg.embed_dim, cfg.out_dim), dtype, device),
        "out_proj_b": zeros(cfg.out_dim),
    }


def ssl_adaptor_forward(params: Params, cfg: SslAdaptorConfig,
                        x: torch.Tensor, lengths: torch.Tensor,
                        remat: str | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, in_dim) -> ((B, T, out_dim), lengths); padded keys masked;
    `remat` as in ``whisper_nn.whisper_layers_forward``."""
    h = _mm(x, params["in_proj_w"]) + params["in_proj_b"]
    T = h.shape[1]
    valid = torch.arange(T, device=h.device)[None, :] < lengths[:, None]
    h, _ = whisper_layers_forward(params["layers"], cfg.num_heads, h,
                                  mask=valid[:, None, :].expand(-1, T, -1),
                                  remat=remat)
    h = layer_norm(h, params["ln_w"], params["ln_b"])
    return _mm(h, params["out_proj_w"]) + params["out_proj_b"], lengths


def init_down_conv(gen: torch.Generator, embed_dim: int, factor: int,
                   dtype=torch.float32, device=None) -> Params:
    """Stride-`factor` convs with kernel == stride, torch layout
    (out, in, k); they run as reshape-matmuls."""
    inter = embed_dim * factor
    return {
        "gate_w": _normal(gen, (inter, embed_dim, factor), dtype, device),
        "up_w": _normal(gen, (inter, embed_dim, factor), dtype, device),
        "down_w": _normal(gen, (inter, inter), dtype, device),
        "ln_w": torch.ones((inter,), dtype=dtype, device=device),
        "ln_b": torch.zeros((inter,), dtype=dtype, device=device),
        "out_w": _normal(gen, (inter, embed_dim), dtype, device),
        "out_b": torch.zeros((embed_dim,), dtype=dtype, device=device),
    }


def down_conv_forward(params: Params, factor: int, x: torch.Tensor,
                      lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """GLU downsample 50 -> 12.5 Hz. x (B, T, D) with T % factor == 0."""
    B, T, D = x.shape
    assert T % factor == 0, (T, factor)
    # conv(k = s = factor) == fold `factor` frames, then a matmul: the
    # weight's tap j multiplies frame t*f + j, i.e. j-major blocks of D
    xf = x.reshape(B, T // factor, factor * D)
    gw = params["gate_w"].permute(2, 1, 0).reshape(factor * D, -1)
    uw = params["up_w"].permute(2, 1, 0).reshape(factor * D, -1)
    g = _mm(xf, gw.to(x.dtype))
    u = _mm(xf, uw.to(x.dtype))
    c = _mm(F.silu(g.to(torch.float32)).to(x.dtype) * u, params["down_w"])
    res = layer_norm(c + xf, params["ln_w"], params["ln_b"])
    return _mm(res, params["out_w"]) + params["out_b"], lengths // factor
