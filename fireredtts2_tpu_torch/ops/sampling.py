"""Token sampling with the exponential-race trick, noise passed in.

Counterpart of ``fireredtts2_tpu/ops/sampling.py``. The JAX package draws
q ~ Exp(1) from a PRNG key inside the sampler; here q is a tensor argument
of the logits' shape, so a caller (or a parity test) decides where the
noise comes from. argmax(probs / q) is an exact categorical sample.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def topk_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask logits below the k-th largest to -1e30."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, _NEG_INF), logits)


def exponential_race_sample(probs: torch.Tensor, noise: torch.Tensor
                            ) -> torch.Tensor:
    """argmax(probs / noise) with noise ~ Exp(1) of probs' shape; int32."""
    return torch.argmax(probs.to(torch.float32) / noise.to(torch.float32),
                        dim=-1).to(torch.int32)


def sample_topk(logits: torch.Tensor, k: int, temperature: float,
                noise: torch.Tensor) -> torch.Tensor:
    """Temperature + top-k sampling -> int32 (...,) token ids. With k=1
    the result is the argmax whatever the noise."""
    logits = logits.to(torch.float32) / temperature
    probs = torch.softmax(topk_filter(logits, k), dim=-1)
    return exponential_race_sample(probs, noise)
