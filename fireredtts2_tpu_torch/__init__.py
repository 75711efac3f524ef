"""FireRedTTS2 on PyTorch and CUDA: the port of ``fireredtts2_tpu`` to one
NVIDIA H100.

The JAX package is the reference; this package mirrors its layout so that
each module's counterpart is found by path, and keeps its parameter trees
in the JAX layout (stacked ``(L, ...)`` layer weights, ``(in, out)``
matmuls, merged ``(L, B, T, Hkv*Dh)`` KV slabs) so weights bridge by a
plain copy (``weights.from_jax``).

Plain tensor code is PyTorch. Each Pallas kernel the JAX package runs on
the main path is a hand-written CUDA C++ kernel under ``csrc/``, built
with ``nvcc`` on first CUDA use (``ops/cuda_build.py``). On CPU tensors
the kernel wrappers run their plain PyTorch versions; on CUDA tensors they
launch the kernel or raise.

This package never imports ``jax``.
"""

__version__ = "0.1.0"

from fireredtts2_tpu_torch.config import (  # noqa: F401
    LLMConfig,
    TransformerConfig,
    CodecConfig,
    EngineConfig,
    FLAVORS,
)
