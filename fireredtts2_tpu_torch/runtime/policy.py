"""Adaptive serving policies: fused-block sizing and rule-based
recommendations.

Counterpart of ``fireredtts2_tpu/runtime/policy.py`` (the port's own copy;
it imports nothing of the JAX package). The continuous batcher
(``runtime/batcher.py``) runs fused K-frame blocks, and K -- the number of
80 ms frames per block -- is the knob worth adapting:

- each block pays a fixed host cost (its launches, one packed copy to the
  host, the fan-out), so a bigger K amortizes it over more audio;
- a bigger K also means a coarser chunk cadence (K * 80 ms between
  flushes) and slower admission of waiting requests (admission happens at
  block boundaries).

The policy models a block's wall time as  wall(K) = rtt + K * frame_cost,
fits (rtt, frame_cost) online from per-K wall-time EWMAs, and picks the
smallest ladder K whose per-frame wall time clears the realtime bar with
headroom -- the largest K (throughput mode) when none does. K stays on a
small power-of-two ladder, which the batcher warms before serving.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

FRAME_MS = 80.0  # 12.5 Hz tokens (reference fireredtts2.py:143)


@dataclass(frozen=True)
class BlockPolicyConfig:
    ladder: tuple[int, ...] = (1, 2, 4, 8, 16)
    start_block: int = 4
    # A block is "realtime" when it produces audio headroom x faster than
    # wall time; 1.25 leaves margin for fetch/fan-out jitter.
    headroom: float = 1.25
    # Cap on chunk cadence: never pick K whose block spans more audio than
    # this (a client jitter buffer must absorb one block).
    max_cadence_ms: float = 1280.0
    ewma: float = 0.3
    # After this many steady blocks at a single K, dispatch probe blocks at
    # a second ladder point so the wall(K) fit can form even on a replica
    # whose admissions never queue (otherwise the policy would stay pinned
    # at start_block forever and snapshot() would report null estimates).
    probe_after: int = 8


@dataclass
class AdaptiveBlockPolicy:
    """Online chooser for the fused-block size K."""

    cfg: BlockPolicyConfig = field(default_factory=BlockPolicyConfig)
    _wall_ms: dict[int, float] = field(default_factory=dict)  # per-K EWMA
    _count: dict[int, int] = field(default_factory=dict)      # steady blocks
    _seen: set = field(default_factory=set)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record(self, k: int, wall_s: float) -> None:
        ms = wall_s * 1000.0
        with self._lock:
            if k not in self._seen:
                # The first block at a new K includes its one-time costs
                # (kernel builds, allocations): keep it out of the model.
                self._seen.add(k)
                return
            prev = self._wall_ms.get(k)
            self._wall_ms[k] = (ms if prev is None
                                else prev + self.cfg.ewma * (ms - prev))
            self._count[k] = self._count.get(k, 0) + 1

    def estimate(self) -> Optional[tuple[float, float]]:
        """-> (rtt_ms, frame_cost_ms) least-squares fit of wall(K) = rtt +
        K*frame_cost over the observed ladder points; None until two
        distinct K have been measured."""
        with self._lock:
            pts = sorted(self._wall_ms.items())
        if len(pts) < 2:
            return None
        n = len(pts)
        sx = sum(k for k, _ in pts)
        sy = sum(w for _, w in pts)
        sxx = sum(k * k for k, _ in pts)
        sxy = sum(k * w for k, w in pts)
        denom = n * sxx - sx * sx
        if denom == 0:
            return None
        frame_cost = (n * sxy - sx * sy) / denom
        rtt = (sy - frame_cost * sx) / n
        return max(rtt, 0.0), max(frame_cost, 1e-3)

    def choose(self, pending: bool, active: int) -> int:
        """Pick K for the next block. `pending` = requests are waiting for
        a slot (admission happens between blocks, so stay small);
        `active` = live streams (unused by the model today; kept for
        queue-aware rules)."""
        if pending:
            return self.cfg.ladder[0]
        est = self.estimate()
        if est is None:
            probe = self._probe_k()
            return probe if probe is not None else self.cfg.start_block
        rtt, frame_cost = est
        best = None
        for k in self.cfg.ladder:
            if k * FRAME_MS > self.cfg.max_cadence_ms:
                break
            per_frame = frame_cost + rtt / k
            if per_frame * self.cfg.headroom <= FRAME_MS:
                best = k
                break  # smallest realtime K: fastest admission + cadence
        if best is None:
            # Not realtime at any K: maximize amortization (throughput mode).
            best = max(k for k in self.cfg.ladder
                       if k * FRAME_MS <= self.cfg.max_cadence_ms)
        return best

    def _probe_k(self) -> Optional[int]:
        """Second ladder point to measure when only one K has data and it
        has been steady for probe_after blocks (without this, a replica
        with no admission pressure never forms the fit). Returns
        the nearest in-cadence neighbor; needs two blocks to register (the
        first is discarded by record())."""
        with self._lock:
            if len(self._wall_ms) != 1:
                return None
            k0, = self._wall_ms
            if self._count.get(k0, 0) < self.cfg.probe_after:
                return None
        usable = [k for k in self.cfg.ladder
                  if k != k0 and k * FRAME_MS <= self.cfg.max_cadence_ms]
        if not usable:
            return None
        return min(usable, key=lambda k: abs(k - k0))

    def snapshot(self) -> dict:
        est = self.estimate()
        with self._lock:
            walls = dict(self._wall_ms)
        return {
            "wall_ms_per_block": walls,
            "rtt_ms": None if est is None else round(est[0], 2),
            "frame_cost_ms": None if est is None else round(est[1], 2),
        }


# ---------------------------------------------------------------------------
# Rule-based recommendation engine
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Recommendation:
    severity: str   # "info" | "warning" | "critical"
    code: str
    message: str
    action: str

    def to_dict(self) -> dict:
        return {"severity": self.severity, "code": self.code,
                "message": self.message, "action": self.action}


class RecommendationEngine:
    """Evaluates serving stats against operational rules and emits
    actionable recommendations (the JAX package's rules, kept as they
    are). device_margin: the device_regression rule fires above
    device_margin x device_budget_ms (the JAX package's 1.15 by default;
    the port's perf_budget.json may set a wider one)."""

    def __init__(self, fpl_warn_ms: float = 200.0,
                 device_budget_ms: Optional[float] = None,
                 device_margin: float = 1.15):
        self.fpl_warn_ms = fpl_warn_ms
        self.device_budget_ms = device_budget_ms
        self.device_margin = device_margin

    def evaluate(self, stats: dict) -> list[Recommendation]:
        recs: list[Recommendation] = []
        fpl = stats.get("first_packet_p95_ms") or stats.get("first_packet_ms")
        if fpl is not None and fpl > self.fpl_warn_ms:
            recs.append(Recommendation(
                "warning", "fpl_high",
                f"p95 first-packet latency {fpl:.0f} ms exceeds "
                f"{self.fpl_warn_ms:.0f} ms",
                "pre-warm prefill buckets (engine.warmup) and wait for the "
                "batcher's warm-up (wait_ready); check that burst admission "
                "is on (ContinuousBatcher)"))
        active = stats.get("active_streams")
        agg = stats.get("aggregate_rtf")
        if active and agg is not None and agg < active:
            recs.append(Recommendation(
                "critical", "overcommitted",
                f"aggregate RTF {agg:.1f} < {active} active streams — "
                "streams are falling behind realtime",
                "reduce max_streams on this replica or add a replica"))
        depth = stats.get("queue_depth")
        if depth and active is not None and depth > max(active, 1):
            recs.append(Recommendation(
                "warning", "queue_backlog",
                f"{depth} requests waiting vs {active} active",
                "scale out replicas or raise max_streams if aggregate RTF "
                "has margin"))
        dms = stats.get("device_ms_per_frame")
        if dms is not None and self.device_budget_ms is not None \
                and dms > self.device_budget_ms * self.device_margin:
            recs.append(Recommendation(
                "critical", "device_regression",
                f"LM device time {dms:.1f} ms/frame exceeds budget "
                f"{self.device_budget_ms:.1f} ms by "
                f">{(self.device_margin - 1) * 100:.0f}%",
                "check quantization flags (quantize_backbone / "
                "fused_depth_plan) and recent model changes"))
        drops = stats.get("chunk_drops")
        if drops:
            recs.append(Recommendation(
                "warning", "slow_consumers",
                f"{drops} streams dropped for slow chunk consumption",
                "increase the client jitter buffer or the handle queue "
                "size; check client network"))
        mem = stats.get("hbm_used_fraction")
        if mem is not None and mem > 0.92:
            recs.append(Recommendation(
                "warning", "hbm_pressure",
                f"HBM {mem * 100:.0f}% full",
                "lower max_streams (KV slabs scale with B) or shorten "
                "max_seq_len; encode batches are already capped at 48"))
        return recs
