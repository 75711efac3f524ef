"""Performance budget of the port.

Counterpart of ``fireredtts2_tpu/runtime/perf.py: load_perf_budget`` and
its matmul parameter count (the training FLOP count), plus the kernel
launch counts the server's ``/stats`` reports. The rest of that module
(the jitted LM timing, the roofline accounting, the ``jax.profiler``
hooks) has no port yet.
"""

from __future__ import annotations

import json
import os
from typing import Any

from fireredtts2_tpu_torch.config import TransformerConfig

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


def kernel_launches() -> dict[str, int]:
    """Each serving kernel wrapper's launch count in this process (A, C,
    D and F by their wrappers' names, B, E)."""
    from fireredtts2_tpu_torch.ops import depth_chain, flash_decode, int4

    counts = flash_decode.launch_counts()
    counts["fused_depth_decode"] = depth_chain.fused_depth_decode.launches
    counts["int4_matmul"] = int4.int4_matmul.launches
    return counts


def transformer_layer_params(cfg: TransformerConfig) -> int:
    """Matmul parameters of one layer (norms and biases excluded)."""
    D, I = cfg.embed_dim, cfg.intermediate_dim
    attn = D * (cfg.num_heads * cfg.head_dim) * 2 \
        + D * (cfg.num_kv_heads * cfg.head_dim) * 2
    return attn + 3 * D * I


def transformer_matmul_params(cfg: TransformerConfig) -> int:
    return cfg.num_layers * transformer_layer_params(cfg)
