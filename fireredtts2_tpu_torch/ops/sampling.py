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


def topk_filter_dynamic(logits: torch.Tensor, k, k_cap: int = 64
                        ) -> torch.Tensor:
    """Mask logits below the k-th largest, k a tensor (one per leading row,
    or one for all) clamped to [1, k_cap]: the continuous batcher's
    per-request top-k inside one batched step."""
    k_cap = min(k_cap, logits.shape[-1])
    vals = torch.topk(logits, k_cap, dim=-1).values          # sorted desc
    k = torch.as_tensor(k, device=logits.device).to(torch.int64)
    idx = (k.clamp(1, k_cap) - 1).expand(logits.shape[:-1])[..., None]
    kth = torch.gather(vals, -1, idx)
    return torch.where(logits < kth, torch.full_like(logits, _NEG_INF), logits)


def exponential_race_sample(probs: torch.Tensor, noise: torch.Tensor
                            ) -> torch.Tensor:
    """argmax(probs / noise) with noise ~ Exp(1) of probs' shape; int32."""
    return torch.argmax(probs.to(torch.float32) / noise.to(torch.float32),
                        dim=-1).to(torch.int32)


def sample_topk(logits: torch.Tensor, k, temperature,
                noise: torch.Tensor) -> torch.Tensor:
    """Temperature + top-k sampling -> int32 (...,) token ids. With k=1
    the result is the argmax whatever the noise.

    k: a Python int (one filter for every row) or an int tensor, one k
    per row (``topk_filter_dynamic``); temperature: a float or a tensor
    broadcast against the logits, e.g. (B, 1) per row."""
    logits = logits.to(torch.float32) / temperature
    filtered = (topk_filter(logits, k) if isinstance(k, int)
                else topk_filter_dynamic(logits, k))
    return exponential_race_sample(torch.softmax(filtered, dim=-1), noise)
