"""Parameter trees: the bridge from the JAX package, and random weights.

Both packages store parameters in the same layout (nested dicts of arrays:
stacked (L, ...) layer weights, (in, out) matmuls), so bridging is a
leaf-by-leaf copy through numpy. Random initialisation draws every leaf
from one ``torch.Generator`` on the target device, so a full-width model
is made on the card without JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from fireredtts2_tpu_torch.config import EngineConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: "cuda" unless the caller names
    one. Without a CUDA device only an explicit CPU device is accepted."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "to run its plain PyTorch versions on the CPU")
    return dev


def from_jax(tree: Any, device=None) -> Any:
    """Copy a parameter tree (nested dicts) whose leaves are JAX or numpy
    arrays into torch tensors of the same layout and dtype (int8 leaves of
    quantised trees and the leaves of a fused-depth bundle included)."""
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    a = np.array(tree)               # a writable host copy
    if a.dtype.name == "bfloat16":   # ml_dtypes bfloat16: reinterpret bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def init_random(config: EngineConfig, seed: int = 0, device=None
                ) -> tuple[dict, dict]:
    """(lm_params, codec_params) of random weights at the config's widths,
    drawn on `device` ("cuda" by default; "cpu" only when asked for) from a
    generator seeded with `seed`. The codec tree holds the decode side
    only."""
    from fireredtts2_tpu_torch.models.codec.model import init_codec_params
    from fireredtts2_tpu_torch.models.lm.model import init_lm_params

    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    lm = init_lm_params(gen, config.llm, dtype_of(config.llm.dtype), device)
    codec = init_codec_params(gen, config.codec, dtype_of(config.codec.dtype),
                              device)
    return lm, codec
