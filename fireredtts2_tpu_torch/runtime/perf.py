"""Performance budget of the port.

Counterpart of ``fireredtts2_tpu/runtime/perf.py: load_perf_budget``. The
rest of that module (the jitted LM timing, the roofline accounting, the
``jax.profiler`` hooks) has no port yet.
"""

from __future__ import annotations

import json
import os
from typing import Any

DEFAULT_BUDGET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "perf_budget.json")


def load_perf_budget() -> dict[str, Any]:
    """The port's ``fireredtts2_tpu_torch/perf_budget.json`` (or
    ``$FRTTS2_PERF_BUDGET``). Keys: ``block_frame_cost_ms``, the live
    serving alarm on the block policy's fitted frame cost
    (``serve/server.py: stats()``, the recommendation engine's
    ``device_regression`` rule), the median of the card's readings in
    ``block_frame_cost_readings_ms``; ``block_frame_cost_margin``, the
    factor above it at which the alarm fires, wider than the readings'
    spread. The repo root's
    ``perf_budget.json`` holds the JAX package's TPU numbers and is not
    read. Missing file -> {} (every budget check off)."""
    path = os.environ.get("FRTTS2_PERF_BUDGET") or DEFAULT_BUDGET
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)
