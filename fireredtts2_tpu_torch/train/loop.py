"""LM training loop with checkpoint and resume, on one card.

Counterpart of ``fireredtts2_tpu/train/loop.py``: batches of interleaved
frames (jsonl token shards or synthetic ones), the train step of
``train.step`` and checkpoints every N steps with resume. The JAX package
checkpoints with Orbax; the port writes ``step_XXXXXXXX/`` directories of
``torch.save``d tensor trees (``params.pt``, ``opt_state.pt``, ``step.pt``)
that load with ``weights_only=True``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from fireredtts2_tpu_torch.config import LLMConfig
from fireredtts2_tpu_torch.models.lm.model import init_lm_params
from fireredtts2_tpu_torch.train.step import (
    TrainState, depth_generator, eval_step, init_train_state, make_optimizer,
    train_step, tree_leaves, tree_map,
)
from fireredtts2_tpu_torch.weights import host_to_device, resolve_device


class MetricsLogger:
    """Append-only jsonl metrics stream (None: off)."""

    def __init__(self, path: Optional[str]):
        self._f = open(path, "a") if path else None

    def log(self, step: int, kind: str, metrics: dict) -> None:
        if self._f is None:
            return
        row = {"step": step, "kind": kind, "time": time.time()}
        row.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()


def evaluate(eval_fn, params, data, n_batches: int, seed: int = 1,
             device=None) -> dict:
    """Mean losses over n_batches of held-out data, without gradients:
    eval_fn(params, *batch, depth_generator(seed, i)) for batch i, its
    arrays moved to `device` (the LM's (tokens, mask), the codec's
    (audio, lengths, target))."""
    sums: dict[str, float] = {}
    n = 0
    with torch.no_grad():
        for i, batch in enumerate(data):
            if i >= n_batches:
                break
            out = eval_fn(params, *(host_to_device(np.asarray(a), device)
                                    for a in batch),
                          depth_generator(seed, i, device))
            for k, v in out.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
    return {f"eval_{k}": v / max(n, 1) for k, v in sums.items()}


@dataclass
class TrainConfig:
    batch_size: int = 8
    seq_len: int = 256
    peak_lr: float = 3e-4
    warmup_steps: int = 1000
    total_steps: int = 100_000
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    checkpoint_every: int = 1000
    checkpoint_dir: Optional[str] = None
    log_every: int = 50
    # Mixed precision: fp32 master params, bf16 forward/backward.
    mixed_precision: bool = False
    # Per-layer rematerialization: "" (off), "full" or "dots" (ops.remat).
    remat: str = ""
    # In-step gradient accumulation: k micro-batches of batch_size/k per
    # optimizer update.
    grad_accum: int = 1
    # Eval cadence: eval_batches of held-out data every eval_every steps
    # (0 = off); metrics stream to metrics_path as jsonl if set.
    eval_every: int = 0
    eval_batches: int = 8
    metrics_path: Optional[str] = None


def synthetic_batches(cfg: LLMConfig, tcfg: TrainConfig, seed: int = 0
                      ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Random interleaved text+audio frame batches (dev/smoke)."""
    rng = np.random.default_rng(seed)
    B, S, C = tcfg.batch_size, tcfg.seq_len, cfg.num_columns
    while True:
        tokens = np.zeros((B, S, C), np.int32)
        mask = np.zeros((B, S, C), bool)
        for b in range(B):
            n_text = int(rng.integers(S // 8, S // 2))
            tokens[b, :n_text, -1] = rng.integers(1, cfg.text_vocab_size, n_text)
            mask[b, :n_text, -1] = True
            tokens[b, n_text:, :-1] = rng.integers(
                0, cfg.audio_vocab_size, (S - n_text, cfg.audio_num_codebooks))
            mask[b, n_text:, :-1] = True
        yield tokens, mask


def jsonl_batches(path: str, cfg: LLMConfig, tcfg: TrainConfig
                  ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Token-shard reader: each jsonl line holds {"text_tokens": [...],
    "audio_tokens": [[...x ncb]...]}; text first, then the audio frames
    and one EOS frame (audio mask only), padded to seq_len."""
    B, S, C = tcfg.batch_size, tcfg.seq_len, cfg.num_columns
    buf_t, buf_m = [], []
    while True:  # loop epochs
        with open(path) as f:
            for line in f:
                d = json.loads(line)
                text = d.get("text_tokens", [])
                audio = d.get("audio_tokens", [])
                tokens = np.zeros((S, C), np.int32)
                mask = np.zeros((S, C), bool)
                nt = min(len(text), S)
                tokens[:nt, -1] = text[:nt]
                mask[:nt, -1] = True
                na = min(len(audio), S - nt - 1)
                if na > 0:
                    tokens[nt:nt + na, :-1] = np.asarray(audio[:na], np.int32)
                    mask[nt:nt + na + 1, :-1] = True  # +1 = EOS frame
                buf_t.append(tokens)
                buf_m.append(mask)
                if len(buf_t) == B:
                    yield np.stack(buf_t), np.stack(buf_m)
                    buf_t, buf_m = [], []


# ---------------------------------------------------------------------------
# Checkpoints: step_XXXXXXXX/ directories of torch.save'd trees
# ---------------------------------------------------------------------------


def save_tree_dir(path: str, trees: dict) -> str:
    """Write each tree as ``path/<name>.pt``. The files go to a sibling
    temporary directory first, which then replaces `path`, so a reader
    never sees a half-written step."""
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    for name, tree in trees.items():
        torch.save(tree, os.path.join(tmp, name + ".pt"))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def load_tree(path: str, name: str, device=None):
    """One tree of a step directory, its tensors on `device`."""
    return torch.load(os.path.join(path, name + ".pt"),
                      map_location=device or "cpu", weights_only=True)


def opt_state_tree(opt_state: dict) -> dict:
    return {"count": torch.tensor(opt_state["count"], dtype=torch.int64),
            "mu": opt_state["mu"], "nu": opt_state["nu"]}


def opt_state_from_tree(tree: dict) -> dict:
    return {"count": int(tree["count"]), "mu": tree["mu"], "nu": tree["nu"]}


def save_checkpoint(ckpt_dir: str, state: TrainState) -> str:
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{state.step:08d}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return save_tree_dir(path, {
        "params": tree_map(torch.Tensor.detach, state.params),
        "opt_state": opt_state_tree(state.opt_state),
        "step": torch.tensor(state.step, dtype=torch.int64)})


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    return os.path.join(os.path.abspath(ckpt_dir), steps[-1]) if steps else None


def restore_checkpoint(path: str, like: TrainState) -> TrainState:
    """The saved state on the device of `like`'s parameters (masters that
    require grad, as :func:`init_train_state` makes them)."""
    dev = tree_leaves(like.params)[0].device
    params = tree_map(lambda p: p.requires_grad_(True),
                      load_tree(path, "params", dev))
    opt = opt_state_from_tree(load_tree(path, "opt_state", dev))
    return TrainState(params, opt, int(load_tree(path, "step")))


def train(cfg: LLMConfig, tcfg: TrainConfig, data=None, num_steps: int = 100,
          seed: int = 0, log=print, eval_data=None, device=None) -> TrainState:
    """Run `num_steps` of training on `device` ("cuda" unless the caller
    names one); resumes from tcfg.checkpoint_dir."""
    device = resolve_device(device)
    if tcfg.remat:
        cfg = dataclasses.replace(cfg, train_remat=tcfg.remat)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    optimizer = make_optimizer(tcfg.peak_lr, tcfg.warmup_steps,
                               tcfg.total_steps, tcfg.weight_decay,
                               tcfg.max_grad_norm)
    state = init_train_state(init_lm_params(gen, cfg, torch.float32, device),
                             optimizer)
    compute_dtype = torch.bfloat16 if tcfg.mixed_precision else None

    def eval_fn(params, tokens, mask, g):
        return eval_step(params, tokens, mask, g, cfg=cfg,
                         compute_dtype=compute_dtype)

    if tcfg.checkpoint_dir:
        latest = latest_checkpoint(tcfg.checkpoint_dir)
        if latest:
            state = restore_checkpoint(latest, state)
            log(f"resumed from {latest} at step {state.step}")

    if data is None:
        data = synthetic_batches(cfg, tcfg, seed)

    metrics_log = MetricsLogger(tcfg.metrics_path)
    t0 = time.perf_counter()
    try:
        for i, (tokens, mask) in enumerate(data):
            if i >= num_steps:
                break
            state, metrics = train_step(
                state, host_to_device(tokens, device),
                host_to_device(mask, device), cfg=cfg, optimizer=optimizer,
                seed=seed, compute_dtype=compute_dtype,
                grad_accum=tcfg.grad_accum)
            step = state.step
            if step % tcfg.log_every == 0 or i == num_steps - 1:
                dt = time.perf_counter() - t0
                log(f"step {step}: loss {float(metrics['loss']):.4f} "
                    f"(c0 {float(metrics['c0_loss']):.3f} "
                    f"depth {float(metrics['depth_loss']):.3f} "
                    f"text {float(metrics['text_loss']):.3f} "
                    f"gnorm {float(metrics['grad_norm']):.2f}) "
                    f"{(i + 1) / dt:.2f} steps/s")
                metrics_log.log(step, "train", metrics)
            if tcfg.eval_every and step % tcfg.eval_every == 0:
                ev = evaluate(eval_fn, state.params,
                              eval_data or synthetic_batches(cfg, tcfg, seed + 1),
                              tcfg.eval_batches, device=device)
                log(f"step {step}: " + " ".join(
                    f"{k} {v:.4f}" for k, v in ev.items()))
                metrics_log.log(step, "eval", ev)
            if tcfg.checkpoint_dir and step % tcfg.checkpoint_every == 0:
                save_checkpoint(tcfg.checkpoint_dir, state)
        if tcfg.checkpoint_dir:
            save_checkpoint(tcfg.checkpoint_dir, state)
    finally:
        metrics_log.close()
    return state
