"""Codec training objectives: reconstruction, quantization, distillation.

Counterpart of ``fireredtts2_tpu/train/codec_losses.py``: straight-through
RVQ with commitment and codebook losses, multi-scale log-mel and waveform
L1 reconstruction, and distillation of the frozen SSL features through the
semantic decoder head. Where JAX has ``stop_gradient`` the port has
``.detach()``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, Optional

import numpy as np
import torch

from fireredtts2_tpu_torch.config import RVQConfig
from fireredtts2_tpu_torch.models.codec.rvq import _nearest_code
from fireredtts2_tpu_torch.ops.audio import mel_filter_bank
from fireredtts2_tpu_torch.ops.precision import peinsum
from fireredtts2_tpu_torch.ops.quant import promoting_matmul as _mm
from fireredtts2_tpu_torch.ops.stft import stft_power

Params = dict[str, Any]


def rvq_encode_st(params: Params, cfg: RVQConfig, z: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """The RVQ's residual chain for training: the decoded features with
    straight-through gradients, the codes and the VQ losses.

    Returns (features (B, T, output_dim) fp32, codes (nq, B, T) int32,
    {"commit_loss", "codebook_loss"})."""
    z = z.to(torch.float32)
    if "input_proj_w" in params:
        z = _mm(z, params["input_proj_w"]) + params["input_proj_b"]
    residual = z
    codes, recons, commits, codebooks = [], [], [], []
    for i in range(params["codebook"].shape[0]):
        cb = params["codebook"][i]
        z_e = _mm(residual, params["in_proj_w"][i]) + params["in_proj_b"][i]
        idx = _nearest_code(z_e.detach(), cb)
        z_q = cb[idx.to(torch.int64)]
        commits.append(((z_e - z_q.detach()) ** 2).mean())
        codebooks.append(((z_e.detach() - z_q) ** 2).mean())
        # straight-through: the forward uses z_q, the gradient reaches z_e
        z_st = z_e + (z_q - z_e).detach()
        recon = _mm(z_st, params["out_proj_w"][i]) + params["out_proj_b"][i]
        residual = residual - recon
        codes.append(idx)
        recons.append(recon)
    out = torch.stack(recons).sum(0)
    if "output_proj_w" in params:
        out = _mm(out, params["output_proj_w"]) + params["output_proj_b"]
    return out, torch.stack(codes), {
        "commit_loss": torch.stack(commits).mean(),
        "codebook_loss": torch.stack(codebooks).mean()}


@lru_cache(maxsize=16)
def _mel_filters(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    return mel_filter_bank(
        num_frequency_bins=1 + n_fft // 2, num_mel_filters=n_mels,
        min_frequency=0.0, max_frequency=sample_rate / 2,
        sampling_rate=sample_rate, norm="slaney", mel_scale="slaney")


def multiscale_mel_loss(pred: torch.Tensor, target: torch.Tensor,
                        sample_rate: int = 24_000,
                        scales: tuple[int, ...] = (512, 1024, 2048),
                        n_mels: int = 80) -> torch.Tensor:
    """Mean L1 over log-mel spectrograms at several FFT scales."""
    total = 0.0
    for n_fft in scales:
        hop = n_fft // 4
        fb = torch.from_numpy(_mel_filters(sample_rate, n_fft, n_mels)).to(
            pred.device)
        pm = peinsum("fm,bft->bmt", fb, stft_power(pred, n_fft, hop))
        tm = peinsum("fm,bft->bmt", fb, stft_power(target, n_fft, hop))
        pl = torch.log(torch.clamp(pm, min=1e-7))
        tl = torch.log(torch.clamp(tm, min=1e-7))
        total = total + (pl - tl).abs().mean()
    return total / len(scales)


def waveform_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    n = min(pred.shape[-1], target.shape[-1])
    return (pred[..., :n] - target[..., :n]).abs().mean()


def semantic_distill_loss(pred_ssl: torch.Tensor, target_ssl: torch.Tensor,
                          lengths: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Masked L1 + (1 - cosine) between the reconstructed and the frozen
    SSL features."""
    B, T = pred_ssl.shape[:2]
    if lengths is None:
        mask = torch.ones((B, T), dtype=torch.bool, device=pred_ssl.device)
    else:
        mask = torch.arange(T, device=pred_ssl.device)[None, :] < lengths[:, None]
    m = mask[..., None].to(torch.float32)
    denom = m.sum().clamp(min=1.0)
    l1 = ((pred_ssl - target_ssl).abs() * m).sum() / denom
    pn = pred_ssl * torch.rsqrt((pred_ssl ** 2).sum(-1, keepdim=True) + 1e-8)
    tn = target_ssl * torch.rsqrt((target_ssl ** 2).sum(-1, keepdim=True) + 1e-8)
    cos = (pn * tn).sum(-1, keepdim=True)
    cos_loss = ((1.0 - cos) * m[..., :1]).sum() / m[..., 0].sum().clamp(min=1.0)
    return l1 + cos_loss


def codec_train_losses(pred_wav: torch.Tensor, target_wav: torch.Tensor,
                       vq_losses: dict, pred_ssl: Optional[torch.Tensor] = None,
                       target_ssl: Optional[torch.Tensor] = None,
                       ssl_lengths: Optional[torch.Tensor] = None,
                       mel_weight: float = 15.0, wave_weight: float = 1.0,
                       commit_weight: float = 0.25, codebook_weight: float = 1.0,
                       semantic_weight: float = 1.0,
                       sample_rate: int = 24_000) -> dict:
    """The total codec objective and its terms."""
    mel = multiscale_mel_loss(pred_wav, target_wav, sample_rate)
    wave = waveform_l1(pred_wav, target_wav)
    total = (mel_weight * mel + wave_weight * wave
             + commit_weight * vq_losses["commit_loss"]
             + codebook_weight * vq_losses["codebook_loss"])
    out = {"mel_loss": mel, "wave_loss": wave, **vq_losses}
    if pred_ssl is not None and target_ssl is not None:
        sem = semantic_distill_loss(pred_ssl, target_ssl, ssl_lengths)
        total = total + semantic_weight * sem
        out["semantic_loss"] = sem
    out["loss"] = total
    return out
