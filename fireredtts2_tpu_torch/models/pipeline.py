"""Fused LM + vocoder streaming blocks: K frames per call.

Counterpart of ``fireredtts2_tpu/models/pipeline.py``. The JAX package
scans K AR frames and their vocoder chunks inside one compiled program to
pay one host round trip per block; here the block runs eagerly (one packed
host copy per block). Capturing the block in a CUDA graph is later work.
"""

from __future__ import annotations

from typing import Any

import torch

from fireredtts2_tpu_torch.config import CodecConfig, LLMConfig
from fireredtts2_tpu_torch.models.codec.decoder import (
    VocoderStreamState, stream_decode_block_batched, upconv_forward,
)
from fireredtts2_tpu_torch.models.codec.rvq import rvq_decode
from fireredtts2_tpu_torch.models.lm.model import (
    LMState, build_step_frame, lm_generate_frame,
)

Params = dict[str, Any]


def stream_block(lm_params: Params, codec_params: Params, llm_cfg: LLMConfig,
                 codec_cfg: CodecConfig, state: LMState,
                 vstate: VocoderStreamState, frame: torch.Tensor,
                 emitted: torch.Tensor, noise: torch.Tensor, block: int,
                 temperature: float = 0.9, topk: int = 20,
                 depth_topk: int = 10, depth_temperature: float = 0.75):
    """Decode `block` frames with the LM, then vocode them in grouped
    backbone passes.

    Args:
        frame: (B, ncb) the current sampled, not yet vocoded frame.
        emitted: (B,) int32 chunks emitted so far.
        noise: (block, B, ncb, V_audio) sampling noise, noise[t] for the
            frame sampled at step t (global index t_base + t).
    Returns:
        (state, vstate, next_frame, emitted, packed), packed (B, block*chunk
        + block*tail + block + block*ncb) float32 per stream:
        [middles | cut tails | EOS flags of the input frames | input frames].
    """
    B = frame.shape[0]
    step_valid = torch.ones((B, 1), dtype=torch.bool, device=frame.device)
    frames_seq, eos_seq = [], []
    for t in range(block):
        frames_seq.append(frame)
        eos_seq.append((frame == 0).all(dim=-1))
        tokens, mask = build_step_frame(llm_cfg, frame)
        state, frame = lm_generate_frame(
            lm_params, llm_cfg, state, tokens, mask, step_valid, noise[t],
            temperature, topk, depth_topk, depth_temperature)
    frames_seq = torch.stack(frames_seq)                       # (K, B, ncb)
    eos_seq = torch.stack(eos_seq)                             # (K, B)

    # Grouped vocode: G tokens per backbone pass, G capped by batch size.
    G = max(1, min(block, 64 // max(B, 1)))
    while block % G:
        G -= 1
    vo_dtype = vstate.istft_cache.dtype
    feats = rvq_decode(codec_params["rvq"], codec_cfg.rvq,
                       frames_seq.permute(2, 1, 0))            # (nq, B, K)
    up = upconv_forward(codec_params["upsample"], codec_cfg.upsample_stride,
                        feats.to(vo_dtype))                    # (B, 4K, D)
    first = emitted == 0
    middles, tails = [], []
    for g in range(block // G):
        middle, tails_g, vstate = stream_decode_block_batched(
            codec_params["acoustic_decoder"], codec_cfg.acoustic_decoder,
            up[:, 4 * G * g: 4 * G * (g + 1)], vstate, is_first=first)
        first = torch.zeros_like(first)
        middles.append(middle)
        tails.append(tails_g)
    emitted = emitted + block

    middle = torch.cat(middles, dim=1)                         # (B, K*cs)
    tails_flat = torch.cat(tails).permute(1, 0, 2).reshape(B, -1)
    tokens_flat = frames_seq.permute(1, 0, 2).reshape(B, -1)
    packed = torch.cat([middle.to(torch.float32), tails_flat.to(torch.float32),
                        eos_seq.to(torch.float32).T,
                        tokens_flat.to(torch.float32)], dim=-1)
    return state, vstate, frame, emitted, packed
