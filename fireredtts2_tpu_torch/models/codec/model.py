"""RedCodec, decode side: 12.5 Hz RVQ tokens -> 24 kHz audio.

Counterpart of the decode half of ``fireredtts2_tpu/models/codec/model.py``
(RVQ decode -> UpConv x4 -> streaming acoustic decoder). Encoding (mel,
SSL and acoustic encoders, RVQ encode) is prompt encoding, a later slice.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from fireredtts2_tpu_torch.config import CodecConfig
from fireredtts2_tpu_torch.models.codec.rvq import init_rvq_params, rvq_decode
from fireredtts2_tpu_torch.models.codec.decoder import (
    VocoderStreamState, init_acoustic_decoder, init_upconv,
    stream_decode_scan, stream_state_init, upconv_forward,
)

Params = dict[str, Any]


def init_codec_params(gen: torch.Generator, cfg: CodecConfig,
                      dtype=torch.float32, device=None) -> Params:
    """Random decode-side params ("rvq", "upsample", "acoustic_decoder") in
    the JAX tree layout."""
    return {
        "rvq": init_rvq_params(gen, cfg.rvq, dtype, device),
        "upsample": init_upconv(gen, cfg.upsample_embed_dim,
                                cfg.upsample_stride, dtype, device),
        "acoustic_decoder": init_acoustic_decoder(gen, cfg.acoustic_decoder,
                                                  dtype, device),
    }


def codec_decode_chunks(params: Params, cfg: CodecConfig, tokens: torch.Tensor):
    """Bucket-safe decode: tokens (B, nq, Lpad) -> (middles (L, B, 1920),
    tails (L, B, 360)) with exact streaming semantics, assembled for any
    true length T <= Lpad by :func:`assemble_chunks`."""
    codes = tokens.permute(1, 0, 2)
    feats = rvq_decode(params["rvq"], cfg.rvq, codes)
    dtype = params["upsample"]["in_proj_w"].dtype
    up = upconv_forward(params["upsample"], cfg.upsample_stride,
                        feats.to(dtype))
    return stream_decode_scan(params["acoustic_decoder"], cfg.acoustic_decoder, up)


def assemble_chunks(middles: np.ndarray, tails: np.ndarray, T: int,
                    hop_length: int, n_fft: int) -> np.ndarray:
    """Host assembly of codec_decode_chunks output for true length T.
    Returns (B, T*8*hop) float32."""
    pad = (n_fft - hop_length) // 2
    lead = (n_fft - hop_length) - pad
    parts = [middles[0][:, lead:]]
    for t in range(1, T):
        parts.append(middles[t])
    parts.append(tails[T - 1])
    return np.concatenate(parts, axis=1)


def stream_decode_init(cfg: CodecConfig, batch: int, dtype=torch.float32,
                       device=None) -> VocoderStreamState:
    return stream_state_init(cfg.acoustic_decoder, batch, dtype, device=device)
