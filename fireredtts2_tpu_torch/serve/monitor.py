"""Performance monitoring and metrics registry.

Counterpart of ``fireredtts2_tpu/serve/monitor.py`` (the reference's
`performance_monitor.py`: inference tracker, latency, tokens/s, audio
quality analyzer, singleton accessor :589). Device memory comes from the
CUDA allocator of the engine's card (``torch.cuda.mem_get_info``,
``torch.cuda.memory_allocated``) instead of nvidia-smi polling.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch


@dataclass
class InferenceRecord:
    request_id: str
    started: float
    ended: float = 0.0
    first_packet_s: Optional[float] = None
    frames: int = 0
    audio_seconds: float = 0.0

    @property
    def wall_s(self) -> float:
        return max(self.ended - self.started, 1e-9)

    @property
    def rtf(self) -> float:
        """Realtime factor: >1 = faster than realtime."""
        return self.audio_seconds / self.wall_s


class PerformanceMonitor:
    """Rolling-window latency/throughput tracker + device memory stats."""

    def __init__(self, window: int = 256):
        self._records: deque[InferenceRecord] = deque(maxlen=window)
        self._active: dict[str, InferenceRecord] = {}
        self._lock = threading.Lock()
        self.counters = {"requests": 0, "errors": 0, "frames": 0}

    # -- request tracking (reference ModelPerformanceTracker,
    #    performance_monitor.py:272-347)

    def start_inference(self, request_id: str) -> None:
        with self._lock:
            self._active[request_id] = InferenceRecord(request_id, time.perf_counter())
            self.counters["requests"] += 1

    def record_first_packet(self, request_id: str) -> None:
        with self._lock:
            r = self._active.get(request_id)
            if r and r.first_packet_s is None:
                r.first_packet_s = time.perf_counter() - r.started

    def record_frame(self, request_id: str, n: int = 1) -> None:
        with self._lock:
            r = self._active.get(request_id)
            if r:
                r.frames += n
            self.counters["frames"] += n

    def end_inference(self, request_id: str, audio_seconds: float = 0.0,
                      error: bool = False) -> Optional[InferenceRecord]:
        with self._lock:
            r = self._active.pop(request_id, None)
            if r is None:
                return None
            r.ended = time.perf_counter()
            r.audio_seconds = audio_seconds
            if error:
                self.counters["errors"] += 1
            else:
                self._records.append(r)
            return r

    # -- aggregates

    def summary(self, device=None) -> dict:
        """Counters, first-packet and RTF percentiles, and the memory of
        `device` (default: the current CUDA device, else the CPU)."""
        with self._lock:
            recs = list(self._records)
        fp = [r.first_packet_s for r in recs if r.first_packet_s is not None]
        rtf = [r.rtf for r in recs if r.audio_seconds > 0]
        out = dict(self.counters)
        out["active"] = len(self._active)
        if fp:
            out["first_packet_ms_p50"] = float(np.percentile(fp, 50) * 1000)
            out["first_packet_ms_p95"] = float(np.percentile(fp, 95) * 1000)
        if rtf:
            out["rtf_p50"] = float(np.percentile(rtf, 50))
        out["device"] = device_memory_stats(device)
        return out


def device_memory_stats(device=None) -> dict:
    """Memory of a CUDA device from its allocator (replaces nvidia-smi
    polling, reference performance_monitor.py:156-200): ``bytes_in_use``
    (tensors allocated), ``bytes_limit`` (the card's total), ``bytes_free``
    and ``bytes_reserved``, with the card's name as ``kind``. device:
    default the current CUDA device when there is one; on the CPU
    {"platform": "cpu"}."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": dev.type}
    free, total = torch.cuda.mem_get_info(dev)
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(dev),
        "bytes_in_use": torch.cuda.memory_allocated(dev),
        "bytes_reserved": torch.cuda.memory_reserved(dev),
        "bytes_free": free,
        "bytes_limit": total,
    }


def analyze_audio_quality(audio: np.ndarray, sample_rate: int = 24_000) -> dict:
    """Cheap SNR / clipping / silence heuristics (reference
    performance_monitor.py:349-391 audio analyzer)."""
    audio = np.asarray(audio, np.float64)
    if audio.size == 0:
        return {"duration_s": 0.0}
    rms = float(np.sqrt(np.mean(audio ** 2)))
    peak = float(np.abs(audio).max())
    # noise floor from the quietest 10% of 50 ms windows
    w = max(1, sample_rate // 20)
    n_win = len(audio) // w
    if n_win >= 2:
        wins = audio[: n_win * w].reshape(n_win, w)
        energies = np.sqrt((wins ** 2).mean(axis=1))
        floor = float(np.percentile(energies, 10)) + 1e-9
        snr_db = 20.0 * np.log10(max(rms, 1e-9) / floor)
    else:
        snr_db = 0.0
    return {
        "duration_s": len(audio) / sample_rate,
        "rms": rms,
        "peak": peak,
        "clipping_ratio": float((np.abs(audio) > 0.999).mean()),
        "silence_ratio": float((np.abs(audio) < 1e-4).mean()),
        "snr_db": float(snr_db),
    }


_GLOBAL: Optional[PerformanceMonitor] = None
_GLOBAL_LOCK = threading.Lock()


def get_performance_monitor() -> PerformanceMonitor:
    """Process-wide singleton (reference performance_monitor.py:589)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = PerformanceMonitor()
        return _GLOBAL


def reset_performance_monitor() -> PerformanceMonitor:
    """Replace the singleton with a fresh monitor (tests; ops reset)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = PerformanceMonitor()
        return _GLOBAL
