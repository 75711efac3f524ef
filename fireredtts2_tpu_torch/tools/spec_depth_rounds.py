"""Speculative (Jacobi) depth decode: rounds and ms a frame beside the
sequential loop and kernel B.

Counterpart of the JAX package's ``tools/spec_depth_rounds.py``.
``models/lm/model.py: depth_decode_jacobi`` returns the sequential chain's
tokens; its cost is `rounds` parallel 16-position forwards of the depth
decoder, each reading its weights once, against 15 single-position steps.
Random weights sit near the worst case (every position a top-k coin flip,
rounds ~ 15); trained weights are the interesting measurement
(``tools/trained_loop.py``, or ``--ckpt`` on a converted checkpoint).

For each batch size B, on the same last_h, c0 and per-frame noise:
- Jacobi: `frames` frames, ms a frame, rounds (mean, maximum), and its
  frames equal to the sequential loop's;
- the sequential plain loop (``_depth_decode`` without the flag);
- kernel B with the serving preset's plan (on the CPU its plain version).
Frames are queued back to back and timed with CUDA events (the Jacobi loop
reads its stop condition on the host once a round, so its time includes
those reads); on the CPU with the host's clock.

    python -m fireredtts2_tpu_torch.tools.spec_depth_rounds [--tiny]
        [--ckpt DIR] [--frames N] [--device cpu] [B ...]

--tiny: the tiny dev config (mechanism check, on the CPU too); --ckpt DIR:
the LM tree of DIR/torch/llm_posttrain.pt. Default: flagship widths
(qwen-200m depth decoder, 16 codebooks of 2051, backbone width 1536),
bf16 random weights from a seed; B defaults to 1 and 8. One JSON line a B.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from fireredtts2_tpu_torch.config import LLMConfig, tiny_engine_config
from fireredtts2_tpu_torch.models.lm import model as lm_model
from fireredtts2_tpu_torch.models.lm.transformer import init_transformer_params
from fireredtts2_tpu_torch.ops.depth_chain import (
    fused_depth_decode, prepare_depth_chain,
)
from fireredtts2_tpu_torch.tools._common import card_line
from fireredtts2_tpu_torch.weights import resolve_device

PRESET = "gate=r8,up=s8,down=s8"
DEPTH_KEYS = ("decoder", "projection", "audio_embeddings", "audio_head",
              "depth_draft")


def depth_params(cfg: LLMConfig, dtype, device, seed: int = 0) -> dict:
    """The depth decoder's part of a random LM tree (decoder, projection,
    audio embeddings and heads), as ``init_lm_params`` draws them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    Db, Dd = cfg.backbone.embed_dim, cfg.decoder.embed_dim
    ncb, V = cfg.audio_num_codebooks, cfg.audio_vocab_size

    def uni(*shape, fan_in):
        u = torch.rand(shape, generator=gen, device=device)
        return ((u * 2 - 1) / fan_in ** 0.5).to(dtype)

    return {
        "decoder": init_transformer_params(gen, cfg.decoder, dtype, device),
        "projection": uni(Db, Dd, fan_in=Db),
        "audio_embeddings": (torch.randn((ncb * V, Db), generator=gen,
                                         device=device) * 0.02).to(dtype),
        "audio_head": uni(ncb - 1, Dd, V, fan_in=Dd),
    }


def _timer(dev: torch.device):
    """fn -> ms of one call: CUDA events on the card, the host's clock on
    the CPU."""
    def run(fn):
        if dev.type != "cuda":
            t0 = time.perf_counter()
            out = fn()
            return out, (time.perf_counter() - t0) * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(dev)
        return out, start.elapsed_time(end)
    return run


def measure_batch(params: dict, cfg: LLMConfig, B: int, frames: int = 16,
                  seed: int = 1, bundle: dict | None = None,
                  depth_topk: int = 10, depth_temperature: float = 0.75
                  ) -> dict:
    """One batch size: Jacobi, the sequential loop and kernel B (when
    `bundle` is given, for the preset plan) over the same inputs, `frames`
    frames each, after one warm-up frame of each."""
    dev = params["projection"].device
    dtype = params["projection"].dtype
    gen = torch.Generator(device=dev).manual_seed(seed)
    ncb, V = cfg.audio_num_codebooks, cfg.audio_vocab_size
    last_h = torch.randn((B, cfg.backbone.embed_dim), generator=gen,
                         device=dev).to(dtype)
    c0 = torch.randint(0, V, (B,), generator=gen, device=dev, dtype=torch.int32)
    noise = [torch.empty((B, ncb, V), device=dev).exponential_(generator=gen)
             for _ in range(frames)]
    seq_cfg = dataclasses.replace(cfg, speculative_depth=False,
                                  fused_depth_plan="")
    kw = dict(depth_topk=depth_topk, depth_temperature=depth_temperature)
    timer = _timer(dev)

    def jacobi():
        return [lm_model.depth_decode_jacobi(params, cfg, last_h, c0, n, **kw)
                for n in noise]

    def sequential():
        return [lm_model._depth_decode(params, seq_cfg, last_h, c0, n, **kw)
                for n in noise]

    def kernel_b():
        return [fused_depth_decode(bundle, cfg, last_h, c0, n, plan=PRESET,
                                   **kw) for n in noise]

    lm_model.depth_decode_jacobi(params, cfg, last_h, c0, noise[0], **kw)
    lm_model._depth_decode(params, seq_cfg, last_h, c0, noise[0], **kw)
    jac, jac_ms = timer(jacobi)
    seq, seq_ms = timer(sequential)
    rounds = [r for _, r in jac]
    out = dict(B=B, frames=frames, jacobi_ms_per_frame=jac_ms / frames,
               rounds_mean=sum(rounds) / frames, rounds_max=max(rounds),
               rounds=rounds, worst_case=ncb - 1,
               frames_equal_sequential=sum(
                   bool(torch.equal(s, j)) for s, (j, _) in zip(seq, jac)),
               sequential_ms_per_frame=seq_ms / frames)
    if bundle is not None:
        fused_depth_decode(bundle, cfg, last_h, c0, noise[0], plan=PRESET, **kw)
        kb, kb_ms = timer(kernel_b)
        out["kernel_b_ms_per_frame"] = kb_ms / frames
        out["kernel_b_frames_equal_sequential"] = sum(
            bool(torch.equal(s, k)) for s, k in zip(seq, kb))
    return out


def load_depth_params(ckpt_dir: str, dtype, device) -> dict:
    """The depth part of DIR/torch/llm_posttrain.pt."""
    from fireredtts2_tpu_torch.runtime import checkpoint as ckpt

    tree = ckpt.load_converted_lm(ckpt.converted_path(ckpt_dir, "llm_posttrain"),
                                  dtype, device)
    return {k: v for k, v in tree.items() if k in DEPTH_KEYS}


def run(batches=(1, 8), frames: int = 16, tiny: bool = False,
        ckpt_dir: str | None = None, device="cuda", log=print) -> list[dict]:
    """Every batch size's row (``measure_batch``), each also printed."""
    dev = resolve_device(device)
    if tiny:
        cfg = dataclasses.replace(tiny_engine_config().llm, dtype="float32")
        dtype = torch.float32
    else:
        cfg = LLMConfig()
        dtype = torch.bfloat16
    cfg = dataclasses.replace(cfg, speculative_depth=True)
    params = (load_depth_params(ckpt_dir, dtype, dev) if ckpt_dir
              else depth_params(cfg, dtype, dev))
    bundle = None
    if dev.type == "cpu" or not tiny:     # kernel B takes the flagship widths
        bundle = prepare_depth_chain(params, cfg, PRESET)
    rows = []
    for B in batches:
        r = measure_batch(params, cfg, B, frames, bundle=bundle)
        r["card"] = card_line() if dev.type == "cuda" else "cpu"
        log(f"B={B:2d} jacobi {r['jacobi_ms_per_frame']:8.3f} ms/frame (rounds "
            f"mean {r['rounds_mean']:.2f} max {r['rounds_max']} of "
            f"{r['worst_case']}; {r['frames_equal_sequential']}/{frames} frames "
            f"as the sequential loop's) | sequential "
            f"{r['sequential_ms_per_frame']:8.3f} ms/frame | kernel B "
            + (f"{r['kernel_b_ms_per_frame']:8.3f} ms/frame"
               if "kernel_b_ms_per_frame" in r else "n/a")
            + f"  [{r['card']}]")
        log(json.dumps({"spec_depth_rounds": {k: v for k, v in r.items()
                                              if k != "rounds"}}))
        rows.append(r)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batches", nargs="*", type=int, default=[1, 8])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt", default=None, metavar="DIR")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with torch.inference_mode():
        run(args.batches, args.frames, args.tiny, args.ckpt, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
