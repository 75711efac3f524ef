"""Codec training loop with checkpoint and resume, on one card.

Counterpart of ``fireredtts2_tpu/train/codec_loop.py``: aligned 16/24 kHz
windows from a wav directory (or synthetic noise windows), the step of
``train.codec_step``, and ``step_XXXXXXXX/`` checkpoint directories
(``params.pt``, ``frozen.pt``, ``opt_state.pt``, ``step.pt``; the frozen
teacher is saved beside the trained leaves, so a resumed run needs no
other source).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from fireredtts2_tpu_torch.config import CodecConfig
from fireredtts2_tpu_torch.models.codec.model import init_codec_params
from fireredtts2_tpu_torch.train.codec_step import (
    CodecTrainState, codec_train_forward, codec_train_step,
    init_codec_train_state, make_codec_optimizer,
)
from fireredtts2_tpu_torch.train.loop import (
    MetricsLogger, evaluate, latest_checkpoint, load_tree,
    opt_state_from_tree, opt_state_tree, save_tree_dir,
)
from fireredtts2_tpu_torch.train.step import tree_leaves, tree_map
from fireredtts2_tpu_torch.weights import host_to_device, resolve_device


@dataclass
class CodecTrainConfig:
    batch_size: int = 8
    # One 12.5 Hz RVQ token spans 1280 samples @16 kHz (160-hop mel, /2
    # whisper conv, /4 down); windows must be a multiple of that.
    window_samples: int = 32_000          # 2.0 s @16 kHz = 25 tokens
    peak_lr: float = 2e-4
    warmup_steps: int = 1000
    total_steps: int = 200_000
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    checkpoint_every: int = 1000
    checkpoint_dir: Optional[str] = None
    log_every: int = 50
    # Eval cadence: eval_batches of held-out windows every eval_every steps
    # (0 = off); metrics stream as jsonl.
    eval_every: int = 0
    eval_batches: int = 8
    metrics_path: Optional[str] = None
    # Per-layer remat of the trained whisper stacks ("", "full", "dots").
    remat: str = ""

    # samples per RVQ token at the input rate
    TOKEN_SAMPLES = 1280

    def __post_init__(self):
        if self.window_samples % self.TOKEN_SAMPLES:
            raise ValueError(
                f"window_samples must be a multiple of {self.TOKEN_SAMPLES} "
                f"(one 12.5 Hz token @16 kHz), got {self.window_samples}")


def synthetic_audio_batches(tcfg: CodecTrainConfig, seed: int = 0
                            ) -> Iterator[tuple]:
    """Random (audio16k, lengths, target24k) windows (dev/smoke)."""
    rng = np.random.default_rng(seed)
    B, T16 = tcfg.batch_size, tcfg.window_samples
    while True:
        audio = (rng.standard_normal((B, T16)) * 0.1).astype(np.float32)
        lengths = np.full((B,), T16, np.int32)
        target = (rng.standard_normal((B, T16 * 3 // 2)) * 0.1
                  ).astype(np.float32)
        yield audio, lengths, target


def wav_dir_batches(path: str, tcfg: CodecTrainConfig, seed: int = 0,
                    loop: bool = True) -> Iterator[tuple]:
    """Aligned 16/24 kHz training windows from a directory of wavs.

    Each wav is resampled once to both rates; windows are cut on token
    boundaries so input[i*1280:(i+k)*1280] @16k lines up with
    target[i*1920:(i+k)*1920] @24k. Short files are zero-padded into one
    window with `lengths` marking the valid prefix. With loop=False the
    last partial batch is yielded too."""
    from fireredtts2_tpu_torch.utils.audio_io import load_wav_mono, resample

    files = sorted(f for f in os.listdir(path) if f.endswith(".wav"))
    if not files:
        raise FileNotFoundError(f"no .wav files under {path}")
    rng = np.random.default_rng(seed)
    tok = CodecTrainConfig.TOKEN_SAMPLES
    T16 = tcfg.window_samples
    T24 = T16 * 3 // 2
    buf: list[tuple] = []
    while True:  # loop epochs
        for name in files:
            wav, sr = load_wav_mono(os.path.join(path, name))
            a16 = resample(wav, sr, 16_000)
            a24 = resample(wav, sr, 24_000)
            n_tok = max(len(a16) // tok, 1)
            n_win = max(n_tok * tok // T16, 1)
            for _ in range(n_win):
                if len(a16) <= T16:
                    x = np.zeros(T16, np.float32)
                    y = np.zeros(T24, np.float32)
                    x[:len(a16)] = a16
                    y[:min(len(a24), T24)] = a24[:T24]
                    length = len(a16)
                else:
                    t0 = int(rng.integers(0, (len(a16) - T16) // tok + 1))
                    i16 = t0 * tok
                    i24 = i16 * 3 // 2
                    x = a16[i16:i16 + T16].astype(np.float32)
                    y = np.zeros(T24, np.float32)
                    seg = a24[i24:i24 + T24]
                    y[:len(seg)] = seg
                    length = T16
                buf.append((x, length, y))
                if len(buf) == tcfg.batch_size:
                    xs, ls, ys = zip(*buf)
                    yield (np.stack(xs), np.asarray(ls, np.int32),
                           np.stack(ys))
                    buf = []
        if not loop:
            if buf:
                xs, ls, ys = zip(*buf)
                yield (np.stack(xs), np.asarray(ls, np.int32), np.stack(ys))
            return


def save_codec_checkpoint(ckpt_dir: str, state: CodecTrainState) -> str:
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{state.step:08d}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return save_tree_dir(path, {
        "params": tree_map(torch.Tensor.detach, state.params),
        "frozen": state.frozen,
        "opt_state": opt_state_tree(state.opt_state),
        "step": torch.tensor(state.step, dtype=torch.int64)})


latest_codec_checkpoint = latest_checkpoint


def restore_codec_checkpoint(path: str, like: CodecTrainState
                             ) -> CodecTrainState:
    dev = tree_leaves(like.params)[0].device
    params = tree_map(lambda p: p.requires_grad_(True),
                      load_tree(path, "params", dev))
    opt = opt_state_from_tree(load_tree(path, "opt_state", dev))
    return CodecTrainState(params, load_tree(path, "frozen", dev), opt,
                           int(load_tree(path, "step")))


def _batch(batch, device) -> tuple:
    return tuple(host_to_device(np.asarray(a), device) for a in batch)


def train_codec(cfg: CodecConfig, tcfg: CodecTrainConfig, data=None,
                num_steps: int = 100, seed: int = 0, log=print,
                eval_data=None, init_params=None, device=None
                ) -> CodecTrainState:
    """Run `num_steps` of codec training on `device` ("cuda" unless the
    caller names one); resumes from tcfg.checkpoint_dir.

    init_params: a full codec tree (e.g. converted from a checkpoint with
    the real SSL teacher); random from `seed` when None."""
    device = resolve_device(device)
    if init_params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        init_params = init_codec_params(gen, cfg, torch.float32, device,
                                        semantic_head=True)
    optimizer = make_codec_optimizer(tcfg.peak_lr, tcfg.warmup_steps,
                                     tcfg.total_steps, tcfg.weight_decay,
                                     tcfg.max_grad_norm)
    state = init_codec_train_state(init_params, optimizer)
    remat = tcfg.remat or None

    if tcfg.checkpoint_dir:
        latest = latest_codec_checkpoint(tcfg.checkpoint_dir)
        if latest:
            state = restore_codec_checkpoint(latest, state)
            log(f"resumed from {latest} at step {state.step}")

    if data is None:
        data = synthetic_audio_batches(tcfg, seed)

    metrics_log = MetricsLogger(tcfg.metrics_path)
    t0 = time.perf_counter()
    try:
        for i, batch in enumerate(data):
            if i >= num_steps:
                break
            audio, lengths, target = _batch(batch, device)
            state, metrics = codec_train_step(
                state, audio, lengths, target, cfg=cfg, optimizer=optimizer,
                remat=remat)
            step = state.step
            if step % tcfg.log_every == 0 or i == num_steps - 1:
                dt = time.perf_counter() - t0
                log(f"step {step}: loss {float(metrics['loss']):.4f} "
                    f"(mel {float(metrics['mel_loss']):.3f} "
                    f"wave {float(metrics['wave_loss']):.3f} "
                    f"sem {float(metrics['semantic_loss']):.3f} "
                    f"commit {float(metrics['commit_loss']):.3f} "
                    f"gnorm {float(metrics['grad_norm']):.2f}) "
                    f"{(i + 1) / dt:.2f} steps/s")
                metrics_log.log(step, "train", metrics)
            if tcfg.eval_every and step % tcfg.eval_every == 0:
                ev = evaluate(
                    lambda p, audio, lengths, target, _gen:
                    codec_train_forward(p, cfg, audio, lengths, target),
                    {**state.params, **state.frozen},
                    eval_data or synthetic_audio_batches(tcfg, seed + 1),
                    tcfg.eval_batches, device=device)
                log(f"step {step}: " + " ".join(
                    f"{k} {v:.4f}" for k, v in ev.items()))
                metrics_log.log(step, "eval", ev)
            if tcfg.checkpoint_dir and step % tcfg.checkpoint_every == 0:
                save_codec_checkpoint(tcfg.checkpoint_dir, state)
        if tcfg.checkpoint_dir:
            save_codec_checkpoint(tcfg.checkpoint_dir, state)
    finally:
        metrics_log.close()
    return state
