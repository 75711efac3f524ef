"""Mel filterbank construction and Whisper-style log-mel features.

Counterpart of ``fireredtts2_tpu/ops/audio.py``. The filterbank is host
numpy, built once at model build (the same code as the JAX package's);
the features are PyTorch over ``ops.stft.stft_power``, in fp32 with the
mel projection in full fp32 (``ops.precision``).
"""

from __future__ import annotations

import numpy as np
import torch

from fireredtts2_tpu_torch.ops.precision import peinsum
from fireredtts2_tpu_torch.ops.stft import stft_power


def hertz_to_mel(freq, mel_scale: str = "htk"):
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    if mel_scale == "kaldi":
        return 1127.0 * np.log(1.0 + freq / 700.0)
    if mel_scale != "slaney":
        raise ValueError("mel_scale must be htk, kaldi, or slaney")
    # Slaney: linear below 1 kHz, log above.
    min_log_hertz, min_log_mel = 1000.0, 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    log_region = freq >= min_log_hertz
    mels = np.where(log_region,
                    min_log_mel + np.log(np.maximum(freq, min_log_hertz) / min_log_hertz) * logstep,
                    mels)
    return mels


def mel_to_hertz(mels, mel_scale: str = "htk"):
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (np.power(10.0, mels / 2595.0) - 1.0)
    if mel_scale == "kaldi":
        return 700.0 * (np.exp(mels / 1127.0) - 1.0)
    if mel_scale != "slaney":
        raise ValueError("mel_scale must be htk, kaldi, or slaney")
    min_log_hertz, min_log_mel = 1000.0, 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    log_region = mels >= min_log_mel
    freq = np.where(log_region,
                    min_log_hertz * np.exp(logstep * (np.maximum(mels, min_log_mel) - min_log_mel)),
                    freq)
    return freq


def mel_filter_bank(
    num_frequency_bins: int,
    num_mel_filters: int,
    min_frequency: float,
    max_frequency: float,
    sampling_rate: int,
    norm: str | None = None,
    mel_scale: str = "htk",
) -> np.ndarray:
    """Triangular mel filterbank, shape (num_frequency_bins, num_mel_filters):
    centres linearly spaced in mel, triangles in Hz, optional slaney area
    norm."""
    mel_min = hertz_to_mel(min_frequency, mel_scale)
    mel_max = hertz_to_mel(max_frequency, mel_scale)
    mel_freqs = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = mel_to_hertz(mel_freqs, mel_scale)

    fft_freqs = np.linspace(0, sampling_rate // 2, num_frequency_bins)

    # Triangles: rising edge between f[i] and f[i+1], falling between
    # f[i+1] and f[i+2].
    fdiff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))

    if norm == "slaney":
        enorm = 2.0 / (filter_freqs[2:num_mel_filters + 2] - filter_freqs[:num_mel_filters])
        fb = fb * enorm[None, :]
    elif norm is not None:
        raise ValueError("norm must be None or 'slaney'")
    return fb.astype(np.float32)


def whisper_mel_filters(num_mels: int = 128, n_fft: int = 400,
                        sampling_rate: int = 16_000,
                        fmin: float = 0.0, fmax: float = 8000.0) -> np.ndarray:
    """The reference mel frontend's filterbank: slaney scale, slaney norm."""
    return mel_filter_bank(
        num_frequency_bins=1 + n_fft // 2,
        num_mel_filters=num_mels,
        min_frequency=fmin,
        max_frequency=fmax,
        sampling_rate=sampling_rate,
        norm="slaney",
        mel_scale="slaney",
    )


def log_mel_spectrogram(audio: torch.Tensor, mel_filters: torch.Tensor,
                        n_fft: int = 400, hop_length: int = 160
                        ) -> torch.Tensor:
    """Whisper-style log-mel: audio (B, T) -> (B, n_mels, T//hop) float32.

    The STFT's last frame (center=True yields 1 + T//hop) is dropped; then
    log10, a clamp at (max - 8) over the whole padded window (no length
    mask, as in the reference), and (x + 4) / 4."""
    power = stft_power(audio, n_fft=n_fft, hop_length=hop_length)[..., :-1]
    mel = peinsum("fm,bft->bmt", mel_filters.to(power.dtype), power)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    max_val = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, max_val - 8.0)
    return (log_spec + 4.0) / 4.0
