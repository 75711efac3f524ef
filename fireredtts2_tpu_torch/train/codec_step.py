"""Codec training step (the generator's objectives), on one card.

Counterpart of ``fireredtts2_tpu/train/codec_step.py`` (its single-device
part): the differentiable full pass

    16 kHz audio -> mel -> [frozen whisper SSL teacher] -> ssl_adaptor ┐
                       \\-> acoustic encoder ─────────────────────────┤
    concat -> ResidualDownConv (12.5 Hz) -> straight-through RVQ       │
    -> UpConv (x4, back to 50 Hz) ─┬-> semantic_decoder ≈ SSL teacher ◄┘
                                   └-> batch acoustic decoder -> 24 kHz

trained on ``train.codec_losses``. The SSL teacher and the mel filterbank
are frozen: the teacher runs under ``torch.no_grad()``, and both stay out
of the optimizer state (no weight decay can drift them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from fireredtts2_tpu_torch.config import CodecConfig
from fireredtts2_tpu_torch.models.codec.decoder import (
    acoustic_decoder_forward, upconv_forward,
)
from fireredtts2_tpu_torch.models.codec.encoder import (
    down_conv_forward, ssl_adaptor_forward,
)
from fireredtts2_tpu_torch.models.codec.model import _mel
from fireredtts2_tpu_torch.models.codec.whisper_nn import whisper_encoder_forward
from fireredtts2_tpu_torch.train.codec_losses import (
    codec_train_losses, rvq_encode_st,
)
from fireredtts2_tpu_torch.train.step import (
    AdamW, make_optimizer, tree_leaves, tree_map, tree_unflatten,
)

FROZEN_KEYS = ("ssl", "mel_filters")


def split_codec_params(params: Any) -> tuple[dict, dict]:
    """-> (trainable, frozen): the SSL teacher and the mel filterbank never
    train."""
    trainable = {k: v for k, v in params.items() if k not in FROZEN_KEYS}
    frozen = {k: params[k] for k in FROZEN_KEYS if k in params}
    return trainable, frozen


def codec_train_forward(params: Any, cfg: CodecConfig, audio16k: torch.Tensor,
                        lengths: torch.Tensor, target24k: torch.Tensor,
                        remat: str | None = None) -> dict:
    """The differentiable full pass -> the loss dict of codec_train_losses.

    audio16k (B, T16) float32; lengths (B,) valid samples; target24k
    (B, T16 * 3 // 2) float32 at the output rate (the decoder emits 1.5
    samples per input sample). remat ("full" / "dots", ``ops.remat``)
    applies per layer to every trained whisper stack; the frozen teacher
    keeps no activations anyway."""
    mel, mel_len = _mel(params, cfg, audio16k, lengths)
    with torch.no_grad():                                # frozen teacher
        ssl_t, ssl_len = whisper_encoder_forward(
            params["ssl"], cfg.ssl.num_heads, mel, mel_len)
    sem, _ = ssl_adaptor_forward(params["ssl_adaptor"], cfg.ssl_adaptor,
                                 ssl_t, ssl_len, remat=remat)
    aco, aco_len = whisper_encoder_forward(
        params["acoustic_encoder"], cfg.acoustic_encoder.num_heads,
        mel, mel_len, remat=remat)
    feats = torch.cat([sem, aco], dim=-1)
    down, down_len = down_conv_forward(params["downsample"],
                                       cfg.downsample_factor, feats, aco_len)
    q, _codes, vq_losses = rvq_encode_st(params["rvq"], cfg.rvq,
                                         down.to(torch.float32))
    dtype = params["upsample"]["in_proj_w"].dtype
    up = upconv_forward(params["upsample"], cfg.upsample_stride, q.to(dtype))
    up_len = down_len * cfg.upsample_stride              # back at 50 Hz
    pred_ssl, _ = ssl_adaptor_forward(params["semantic_decoder"],
                                      cfg.semantic_decoder, up, up_len,
                                      remat=remat)
    wav, _ = acoustic_decoder_forward(params["acoustic_decoder"],
                                      cfg.acoustic_decoder, up, up_len,
                                      remat=remat)
    return codec_train_losses(
        wav.to(torch.float32), target24k, vq_losses,
        pred_ssl=pred_ssl.to(torch.float32), target_ssl=ssl_t,
        ssl_lengths=ssl_len, sample_rate=cfg.output_sample_rate)


@dataclass
class CodecTrainState:
    params: Any     # trainable subtree, fp32 leaves that require grad
    frozen: Any     # SSL teacher + mel filterbank (never updated)
    opt_state: dict
    step: int


def init_codec_train_state(params: Any, optimizer: AdamW) -> CodecTrainState:
    """Copies of the trainable leaves that require grad (the caller's
    tensors are never updated), the frozen ones as they are, fresh
    moments, step 0."""
    trainable, frozen = split_codec_params(params)
    trainable = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                         trainable)
    return CodecTrainState(trainable, frozen, optimizer.init(trainable), 0)


def make_codec_optimizer(peak_lr: float = 2e-4, warmup_steps: int = 1000,
                         total_steps: int = 200_000,
                         weight_decay: float = 0.01, clip: float = 1.0
                         ) -> AdamW:
    return make_optimizer(peak_lr, warmup_steps, total_steps, weight_decay,
                          clip, b2=0.95)


def codec_train_step(state: CodecTrainState, audio16k: torch.Tensor,
                     lengths: torch.Tensor, target24k: torch.Tensor, *,
                     cfg: CodecConfig, optimizer: AdamW,
                     remat: str | None = None) -> tuple:
    """One step -> (the state, updated in place, step advanced; metrics as
    0-d tensors, grad_norm before clipping)."""
    losses = codec_train_forward({**state.params, **state.frozen}, cfg,
                                 audio16k, lengths, target24k, remat=remat)
    leaves = tree_leaves(state.params)
    grads = torch.autograd.grad(losses["loss"], leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    metrics = {k: v.detach() for k, v in losses.items()}
    state.opt_state, metrics["grad_norm"] = optimizer.step(
        state.params, tree_unflatten(state.params, grads), state.opt_state)
    state.step += 1
    return state, metrics
