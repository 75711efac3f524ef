"""One training step of the dual-transformer LM, on one card.

Counterpart of ``fireredtts2_tpu/train/step.py`` (its single-device part;
the sharded step makers and ZeRO-1 wait for multi-GPU). The optimizer is
this module's own transcription of the JAX package's optax chain,
``clip_by_global_norm`` then ``adamw`` with the warmup-decay schedule,
over the parameter tree:

- the global norm is taken over every gradient leaf in fp32, and the
  gradients are scaled by max/norm (divide, then multiply) only when the
  norm is not below max, with no epsilon;
- Adam's moments get bias correction; eps = 1e-8 is added outside the
  square root; weight decay applies to every leaf;
- the schedule is evaluated at the count of earlier updates, so with
  warmup the first update has lr 0.

Parameters are fp32 masters. With ``compute_dtype`` the forward and
backward run on copies of the fp32 leaves cast inside the graph, so the
gradients reach the masters through the cast; norms and logits stay fp32
inside ``lm_loss``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from fireredtts2_tpu_torch.config import LLMConfig
from fireredtts2_tpu_torch.models.lm.model import lm_loss

Params = dict[str, Any]


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """fn over matching leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unflatten(like: Any, leaves: Sequence) -> Any:
    """A tree shaped as `like` holding `leaves` in tree_leaves' order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in leaves))


def warmup_decay_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                          decay_type: str = "linear"):
    """The reference's WarmupDecayLR: linear warmup to peak_lr, then a
    linear, constant, exponential (0.1 at the end) or cosine decay.
    Returns step -> lr, computed in fp32 as the JAX schedule is."""
    if decay_type not in ("linear", "constant", "exponential", "cosine"):
        raise ValueError(decay_type)

    def sched(step) -> float:
        f32 = torch.float32
        step = torch.as_tensor(step, dtype=f32)
        warm = step / max(warmup_steps, 1)
        span = max(total_steps - warmup_steps, 1)
        frac = (step - warmup_steps) / span
        if decay_type == "linear":
            dec = (total_steps - step) / span
        elif decay_type == "constant":
            dec = torch.ones_like(step)
        elif decay_type == "exponential":
            dec = torch.tensor(0.1, dtype=f32) ** frac
        else:
            dec = 0.5 * (1 + torch.cos(math.pi * frac))
        return float(peak_lr * torch.where(step < warmup_steps, warm, dec))
    return sched


@dataclass
class AdamW:
    """clip_by_global_norm(max_grad_norm) then AdamW over a parameter tree,
    optax's arithmetic (b1 0.9, eps 1e-8 outside the square root). The
    state is {"count": int, "mu": tree, "nu": tree}; `step` updates the
    parameters in place and returns the new state and the gradients'
    global norm before clipping."""
    schedule: Any
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    b2: float = 0.999
    b1 = 0.9
    eps = 1e-8

    def init(self, params: Params) -> dict:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def step(self, params: Params, grads: Params, state: dict
             ) -> tuple[dict, torch.Tensor]:
        """One update: params change in place -> (the new state, whose
        moment tensors are updated in place too; the global norm of
        `grads`)."""
        ps, gs = tree_leaves(params), tree_leaves(grads)
        mus, nus = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        norm = global_norm(gs)
        keep = norm < self.max_grad_norm
        one = torch.ones_like(norm)
        div = torch.where(keep, one, norm)
        mul = torch.where(keep, one, torch.full_like(norm, self.max_grad_norm))
        count = state["count"] + 1
        f32 = torch.float32
        bc1 = float(1 - torch.tensor(self.b1, dtype=f32) ** count)
        bc2 = float(1 - torch.tensor(self.b2, dtype=f32) ** count)
        lr = self.schedule(state["count"])
        for p, g, mu, nu in zip(ps, gs, mus, nus):
            g = g.to(f32) / div * mul
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (mu / bc1) / ((nu / bc2).sqrt_().add_(self.eps))
            u.add_(p, alpha=self.weight_decay)
            p.add_(u.to(p.dtype), alpha=-lr)
        return {"count": count, "mu": state["mu"], "nu": state["nu"]}, norm


def make_optimizer(peak_lr: float = 3e-4, warmup_steps: int = 1000,
                   total_steps: int = 100_000, weight_decay: float = 0.01,
                   max_grad_norm: float = 1.0, b2: float = 0.999) -> AdamW:
    return AdamW(warmup_decay_schedule(peak_lr, warmup_steps, total_steps),
                 weight_decay=weight_decay, max_grad_norm=max_grad_norm, b2=b2)


@dataclass
class TrainState:
    params: Params      # fp32 masters, leaves requiring grad
    opt_state: dict
    step: int


def init_train_state(params: Params, optimizer: AdamW) -> TrainState:
    """Masters: fp32 copies of the leaves (the caller's tensors are never
    updated) that require grad; fresh moments; step 0."""
    masters = tree_map(lambda p: p.detach().to(torch.float32, copy=True)
                       .requires_grad_(True), params)
    return TrainState(masters, optimizer.init(masters), 0)


def depth_generator(seed: int, step: int, device, micro: int = 0
                    ) -> torch.Generator:
    """The generator of a micro-batch's depth subset draw, seeded by
    (seed, step, micro): a resumed run draws what an unbroken one does."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + step) * 64 + micro)
    return gen


def cast_compute(params: Params, compute_dtype) -> Params:
    """fp32 leaves cast to compute_dtype inside the graph; others as they
    are."""
    if compute_dtype is None:
        return params
    return tree_map(lambda p: p.to(compute_dtype)
                    if p.dtype == torch.float32 else p, params)


def train_step(state: TrainState, tokens: torch.Tensor,
               tokens_mask: torch.Tensor, *, cfg: LLMConfig,
               optimizer: AdamW, seed: int = 0, compute_dtype=None,
               grad_accum: int = 1,
               depth_indices: Optional[Sequence[torch.Tensor]] = None,
               ) -> tuple[TrainState, dict]:
    """One fp32-master step -> (the state, updated in place and with its
    step advanced, and the metrics as 0-d tensors).

    grad_accum=k splits the batch into k micro-batches and averages their
    gradients into one update (activation memory of one micro-batch);
    micro-batch i draws its depth subset from depth_generator(seed, step,
    i). depth_indices: one (N,) tensor per micro-batch replacing the
    draws. grad_norm is the norm of the averaged gradients before
    clipping."""
    leaves = tree_leaves(state.params)
    B = tokens.shape[0]
    if B % grad_accum:
        raise ValueError(f"batch {B} not divisible by grad_accum {grad_accum}")
    mb = B // grad_accum
    g_sum, m_sum = None, {}
    for i in range(grad_accum):
        sl = slice(i * mb, (i + 1) * mb)
        gen = depth_generator(seed, state.step, tokens.device, i)
        out = lm_loss(cast_compute(state.params, compute_dtype), cfg,
                      tokens[sl], tokens_mask[sl], gen,
                      depth_indices=None if depth_indices is None
                      else depth_indices[i])
        grads = torch.autograd.grad(out["loss"], leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        g_sum = grads if g_sum is None else [a + g for a, g in zip(g_sum, grads)]
        for k, v in out.items():
            m_sum[k] = m_sum.get(k, 0.0) + v.detach()
    inv = 1.0 / grad_accum
    grads = [g * inv for g in g_sum] if grad_accum > 1 else g_sum
    metrics = {k: v * inv for k, v in m_sum.items()} if grad_accum > 1 else m_sum
    state.opt_state, metrics["grad_norm"] = optimizer.step(
        state.params, tree_unflatten(state.params, grads), state.opt_state)
    state.step += 1
    return state, metrics


@torch.no_grad()
def eval_step(params: Params, tokens: torch.Tensor, tokens_mask: torch.Tensor,
              gen: Optional[torch.Generator] = None, *, cfg: LLMConfig,
              compute_dtype=None) -> dict:
    """Loss-only forward (no gradients)."""
    return lm_loss(cast_compute(params, compute_dtype), cfg, tokens,
                   tokens_mask, gen)
