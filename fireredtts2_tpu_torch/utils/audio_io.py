"""Host-side audio I/O: wav read/write, resampling and PCM16 packing.

Replaces the reference's torchaudio usage (fireredtts2/fireredtts2.py:61-65,
389-391) with scipy (wav I/O + polyphase resampling). The PCM16 packing is
numpy's, the JAX package's ``utils/native.py`` route without its C++
library.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def load_wav_mono(path: str) -> tuple[np.ndarray, int]:
    """Read a wav as float32 mono in [-1, 1]. Returns (samples, sample_rate).

    Multi-channel input keeps channel 0 (reference fireredtts2.py:62-64).
    """
    sr, data = wavfile.read(path)
    if data.ndim > 1:
        data = data[:, 0]
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    return audio, int(sr)


def save_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 2:
        audio = audio[0]
    pcm = np.clip(audio, -1.0, 1.0)
    wavfile.write(path, sample_rate, (pcm * 32767.0).astype(np.int16))


def resample(audio: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Polyphase resample (rational ratio)."""
    if src_rate == dst_rate:
        return np.asarray(audio, np.float32)
    g = math.gcd(src_rate, dst_rate)
    return resample_poly(np.asarray(audio, np.float64),
                         dst_rate // g, src_rate // g).astype(np.float32)


def load_prompt_audio_16k(path: str) -> np.ndarray:
    """Prompt wavs are consumed at 16 kHz mono (reference fireredtts2.py:60-66)."""
    audio, sr = load_wav_mono(path)
    return resample(audio, sr, 16_000)


def f32_to_pcm16(audio: np.ndarray) -> bytes:
    """float32 in [-1, 1] -> little-endian int16 PCM bytes, clipped and
    truncated toward zero."""
    x = np.asarray(audio, np.float32)
    return (np.clip(x, -1, 1) * 32767.0).astype("<i2").tobytes()


def pcm16_to_f32(data: bytes) -> np.ndarray:
    """Little-endian int16 PCM bytes -> float32 (x / 32768)."""
    return np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
