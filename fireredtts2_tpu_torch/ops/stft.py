"""STFT power and streaming iSTFT pieces as matmul DFTs and strided
convolutions, no FFT primitive.

Counterpart of ``fireredtts2_tpu/ops/stft.py``: the mel frontend's forward
STFT (``stft_power``: reflect pad, then the windowed DFT as one strided
conv over the basis), what the streaming vocoder uses (a matmul inverse
DFT, overlap-add and the window envelope), the batch decoder's ``istft``
and the one-token vocoder's ``istft_chunk``. The bases are built once in
float64 numpy, exactly as the JAX package builds them, and cached per
device; the products follow ``ops.precision`` (full fp32 for fp32
operands), as JAX runs them at ``Precision.HIGHEST``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from fireredtts2_tpu_torch.ops.precision import pconv1d, peinsum


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (matches torch.hann_window's default)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


@lru_cache(maxsize=8)
def _stft_basis_np(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Windowed rDFT analysis basis: (F, n_fft) cos and -sin matrices such
    that re = cos_b @ frame, im = sin_b @ frame equal rfft(window*frame)."""
    freqs = np.arange(n_fft // 2 + 1, dtype=np.float64)
    times = np.arange(n_fft, dtype=np.float64)
    ang = 2.0 * np.pi * freqs[:, None] * times[None, :] / n_fft
    w = hann_window(n_fft, np.float64)
    cos_b = (np.cos(ang) * w[None, :]).astype(np.float32)
    sin_b = (-np.sin(ang) * w[None, :]).astype(np.float32)
    return cos_b, sin_b


@lru_cache(maxsize=8)
def _istft_basis_np(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """irfft synthesis basis: x = Cr @ re + Ci @ im, each (n_fft, F)."""
    F = n_fft // 2 + 1
    freqs = np.arange(F, dtype=np.float64)
    times = np.arange(n_fft, dtype=np.float64)
    ang = 2.0 * np.pi * times[:, None] * freqs[None, :] / n_fft
    scale = np.full(F, 2.0)
    scale[0] = 1.0
    if n_fft % 2 == 0:
        scale[-1] = 1.0
    cr = (np.cos(ang) * scale[None, :] / n_fft).astype(np.float32)
    ci = (-np.sin(ang) * scale[None, :] / n_fft).astype(np.float32)
    return cr, ci


_TENSORS: dict[tuple, torch.Tensor] = {}


def _const(name: str, n_fft: int, build, dtype, device) -> torch.Tensor:
    """Cached device copy of a host-built constant. It is made outside
    inference mode even when first asked for inside it (serving), so that
    training's autograd may save it for backward later in the process."""
    key = (name, n_fft, dtype, str(device))
    t = _TENSORS.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = torch.as_tensor(build()).to(device=device, dtype=dtype)
        _TENSORS[key] = t
    return t


def hann_tensor(n_fft: int, dtype, device) -> torch.Tensor:
    return _const("hann", n_fft, lambda: hann_window(n_fft), dtype, device)


def stft_power(audio: torch.Tensor, n_fft: int, hop_length: int
               ) -> torch.Tensor:
    """|STFT|^2 with center=True reflect padding and a hann(n_fft) window:
    audio (B, T) -> (B, n_fft//2 + 1, 1 + T//hop) float32, the frame count
    of torch.stft(center=True). One strided conv of the padded signal with
    the (2F, 1, n_fft) basis, in full fp32."""
    pad = n_fft // 2
    x = F.pad(audio.to(torch.float32)[:, None, :], (pad, pad), mode="reflect")
    filt = _const("stft", n_fft,
                  lambda: np.concatenate(_stft_basis_np(n_fft))[:, None, :],
                  torch.float32, audio.device)
    y = pconv1d(x, filt, stride=hop_length)                    # (B, 2F, N)
    nf = n_fft // 2 + 1
    re, im = y[:, :nf], y[:, nf:]
    return re * re + im * im


def irfft_frames(spec_re: torch.Tensor, spec_im: torch.Tensor, n_fft: int
                 ) -> torch.Tensor:
    """Per-frame inverse rDFT (no window): (B, F, T) -> (B, n_fft, T)."""
    dt, dev = spec_re.dtype, spec_re.device
    cr = _const("cr", n_fft, lambda: _istft_basis_np(n_fft)[0], dt, dev)
    ci = _const("ci", n_fft, lambda: _istft_basis_np(n_fft)[1], dt, dev)
    return (peinsum("nf,bft->bnt", cr, spec_re)
            + peinsum("nf,bft->bnt", ci, spec_im))


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Overlap-add frames (B, win, T) -> (B, (T-1)*hop + win); win % hop == 0.
    Each frame is cut into win//hop hop-sized parts summed at shifts."""
    B, win, T = frames.shape
    assert win % hop_length == 0, (win, hop_length)
    r = win // hop_length
    parts = frames.reshape(B, r, hop_length, T)
    total_segs = T + r - 1
    out = torch.zeros((B, hop_length, total_segs), dtype=frames.dtype,
                      device=frames.device)
    for j in range(r):
        out[:, :, j:j + T] += parts[:, j]
    return out.transpose(1, 2).reshape(B, total_segs * hop_length)


def window_envelope(n_fft: int, hop_length: int, num_frames: int,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """Overlap-added squared-window envelope, ((T-1)*hop + win,)."""
    def build():
        w2 = hann_window(n_fft) ** 2
        frames = np.broadcast_to(w2[:, None], (n_fft, num_frames))
        return overlap_add(torch.as_tensor(np.ascontiguousarray(frames))[None],
                           hop_length)[0]
    return _const(f"env{hop_length}x{num_frames}", n_fft, build, dtype, device)



def istft(spec_re: torch.Tensor, spec_im: torch.Tensor, n_fft: int,
          hop_length: int) -> torch.Tensor:
    """Batch iSTFT with "same" padding (win = n_fft), hann window:
    (B, F, T) real and imaginary parts -> (B, T * hop) waveform, trimmed
    by (n_fft - hop)//2 on each side. The envelope is clamped at 1e-11:
    a periodic hann window is 0 at its first sample, so its very edges
    are 0 (inside the trimmed region)."""
    w = hann_tensor(n_fft, spec_re.dtype, spec_re.device)
    frames = irfft_frames(spec_re, spec_im, n_fft) * w[None, :, None]
    y = overlap_add(frames, hop_length)
    env = window_envelope(n_fft, hop_length, spec_re.shape[-1], dtype=y.dtype,
                          device=y.device)
    y = y / torch.clamp(env[None, :], min=1e-11)
    pad = (n_fft - hop_length) // 2
    return y[:, pad:-pad]


def istft_chunk(spec_re: torch.Tensor, spec_im: torch.Tensor,
                cache: torch.Tensor | None, n_fft: int, hop_length: int,
                last_chunk: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming iSTFT over one chunk of frames with a windowed-frame cache.

    spec_*: (B, F, Tc) chunk spectra; cache: (B, n_fft, n_fft//hop - 1)
    the previous chunk's trailing windowed frames, or None on the first
    chunk. Returns (audio, new cache). Only the fully overlapped region is
    emitted: the first chunk drops (n_fft - hop)//2 leading samples and
    later ones n_fft - hop; every chunk holds back its trailing n_fft - hop
    samples for the next one, unless `last_chunk`, which keeps all but the
    last (n_fft - hop)//2. The chained outputs concatenate to the batch
    :func:`istft` of the whole sequence."""
    assert n_fft % hop_length == 0
    r = n_fft // hop_length
    pad = (n_fft - hop_length) // 2
    w = hann_tensor(n_fft, spec_re.dtype, spec_re.device)
    frames = irfft_frames(spec_re, spec_im, n_fft) * w[None, :, None]
    first = cache is None
    if not first:
        frames = torch.cat([cache.to(frames.dtype), frames], dim=-1)
    new_cache = frames[..., -(r - 1):]
    y = overlap_add(frames, hop_length)
    env = window_envelope(n_fft, hop_length, frames.shape[-1], dtype=y.dtype,
                          device=y.device)
    y = y / torch.clamp(env[None, :], min=1e-11)
    y = y[:, pad:] if first else y[:, n_fft - hop_length:]
    y = y[:, :-pad] if last_chunk else y[:, :-(n_fft - hop_length)]
    return y, new_cache
