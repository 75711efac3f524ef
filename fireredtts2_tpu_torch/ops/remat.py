"""Per-layer rematerialization for the stacked-layer loops of training.

Counterpart of ``fireredtts2_tpu/ops/remat.py``. Used by the LM
transformer's and the codec's whisper stacks' stateless forwards: the layer
body runs under ``torch.utils.checkpoint`` so the backward pass recomputes
it instead of keeping its intermediates alive across the stack. Values are
unchanged; only what the backward pass keeps differs.
"""

from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

# the weight matmuls: x @ W on (B*S, D) rows lowers to these; attention's
# batched products lower to aten.bmm and are recomputed
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_layer(body, mode: str):
    """Wrap a layer body for training memory.

    Modes:
    - "full": save nothing inside the layer (recompute it all on the
      backward pass);
    - "dots": keep the weight-matmul outputs (``aten.mm`` / ``aten.addmm``)
      and recompute attention (``aten.bmm``) and the elementwise ops, as
      JAX's ``dots_with_no_batch_dims_saveable``.
    """
    if mode == "full":
        return partial(checkpoint, body, use_reentrant=False)
    if mode == "dots":
        return partial(checkpoint, body, use_reentrant=False,
                       context_fn=partial(create_selective_checkpoint_contexts,
                                          _dots_policy))
    raise ValueError(f"remat mode {mode!r} not in ('full', 'dots')")
