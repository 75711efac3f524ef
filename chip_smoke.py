#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fireredtts2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
1. the card: nvidia-smi's name and power limit, torch's device name; no
   CUDA device -> exit 2;
2. build every CUDA kernel of the port from csrc/ (one nvcc per source, in
   parallel) and report the build time;
3. kernel A (flash_decode_gqa1) against its plain PyTorch version at the
   flagship LM slab (28, B, 3584, 256) bf16, B in {1, 8}, ragged windows
   with live lengths near 200 and near 3000;
4. kernel C (flash_decode_update_bounded) against its plain version at the
   flagship vocoder slab (12, B, 3008, 1024) bf16, S in {8, 32, 128} (stream
   blocks of 1, 4 and 16 frames) and 64 (generate's vocoder passes), plus
   writes that overshoot the slab; the written rows must be identical and
   the attention close; kernel C's read-only mode (D) once with lower
   bounds;
5. kernel B (fused_depth_decode) against its plain version at the
   flagship depth decoder (qwen-200m, 16 codebooks of 2051), B in {1, 8},
   plans gate=r8,up=s8,down=s8 (the serving preset), gate=r4,... and
   gate=r8a8,up=s8a8,...: logits with the same tokens forced into both,
   then free sampling (equal up to a counted near-tie);
6. kernel E (int4_matmul) at every qwen-200m depth matrix, M in
   {1, 2, 8, 16}, beside torch._weight_int4pack_mm on the same int4
   weights and a bf16 torch.matmul on the dequantised weight;
7. kernel F (pallas_decode_attention, on kernel A's code) over unmerged
   slabs with left-padded windows;
7b. kernel P (the GEMV probes, csrc/gemv_probe.cu) against its plain
   version in every mode (bf16, int8, int4, s8s8, s8s8q), load path (direct,
   staged) and M tile (5, 16, 32), with a warp owning one row or several
   (every tile height), inputs in shared or in global memory; then the
   probes P1-P4 at the JAX tools' sizes through the tools'
   own functions (fireredtts2_tpu_torch/tools/), every timed probe also
   checked against the plain version on its own matrices and inputs (y
   form of one step and the timed sum): the L2-residency sweep (8 to
   120 MB, warm and cold), int8 and int4 reuse, int8 streamed direct and
   staged, bf16 / int8 / s8s8 at D = 896 and 1536, kernel B's MLP schedule
   in four modes at M = 8, 16, 32, the grid barrier's cost (slope over 19,
   304, 3040 barriers) and an empty cooperative launch; kernel B built with
   FRT_ABL=0 must equal the serving build bit for bit (samples and logits)
   and its logits the plain version's within kernel B's tolerance, and
   every ablation build (half, tiny, noload, noattn, nosample, nosync)
   is timed at B = 1 and 8. One line {"probes": ...} carries the numbers;
8. a small-width model through the kernels on the card against the same
   weights on the CPU in float32 (LM layers and the streaming vocoder);
9. the main paths at flagship width with random weights, each run with
   every launch count set to 0 just before it and read just after: the
   serving preset (int8 backbone + kernel B, quantize_backbone=True,
   fused_depth_plan="gate=r8,up=s8,down=s8"), generate_stream and generate
   of 50 frames, kernel B once per LM frame; the bf16 path of EngineConfig()
   (25 frames); an int4 depth decoder (quantize_depth_bits=4, generate of 10
   frames, kernel E launched). Audio must be finite and one 1920-sample
   chunk per frame, stream and generate must sample the same frames, and
   kernels A and C must have launched in every run.

Bounds are the larger of the bytes a call must move (each input read once,
each output written once) over 3.35 TB/s and its operations over the bf16
(or int8) peak of the card's data sheet. `library_ms` times one PyTorch
call computing the same function where there is one, and the port never
calls it: F.scaled_dot_product_attention over the same window with a mask
for A, C, D and F, torch._weight_int4pack_mm for E; for the probes, one
call per matrix and step summed (torch.matmul, torch._weight_int8pack_mm,
torch._weight_int4pack_mm, torch._int_mm), or null with the reason.

Tolerance of a kernel against its plain version (bf16 in, bf16 out, fp32
inside both): |kernel - plain| <= 1e-2 + 2e-2 * |plain| elementwise. Both
round their output to bf16 (one ulp is 2^-8 relative) and round the
softmax probabilities to bf16 at different points (the kernel per KV
split or tile before normalising, the plain version after).

Kernel P's sum form (an fp32 sum over steps, matrices and outputs, with
atomics across blocks) must lie within 1e-4 of the sum of |y|; its y form
within the tolerance above.

Kernel times are taken in turns (plain, kernel, kernel, plain) in this one
process after warm-up: the device time of the CUDA kernels a call
launches (torch.profiler), the CUDA-event time per call of calls queued
behind a device-side spin (device time while the host keeps ahead; the
kernels line falls back to it, marked "queued", where the profiler's trace
lost a kernel launched from the port's own libraries), and the CUDA-event
time per call, which also counts the host's launch gaps. Timed calls of kernels A and C walk the
slab's layers in turn, as the model does, so each layer's K/V comes from
device memory and not from the 50 MB L2 cache (the LM slab is ~100 MB at
B=1, the vocoder slab ~150 MB). After the main path, one short generate
call is traced to give the device's busy share and its largest kernels.
Each number is printed with the card's name and power limit; details go
to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

ATOL, RTOL = 1e-2, 2e-2          # kernel vs plain, bf16 (see the docstring)
REF_TOL = 0.1                    # small model on the card vs CPU fp32, of peak
B_TOL = 5e-2                     # kernel B logits vs plain, of the plain peak
P_SUM_TOL = 1e-4                 # kernel P's sum form, of the sum of |y|
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}
PRESET = "gate=r8,up=s8,down=s8"
TOPK, TEMP = 10, 0.75            # the engine's depth sampling defaults
TEXT = "Hello from the PyTorch port of FireRedTTS2 on one GPU."
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")

FLAGSHIP = dict(
    lm=dict(L=28, T=3584, Hkv=2, G=6, Dh=128, reps=50),
    voc=dict(L=12, T=3008, H=16, Dh=64, reps=30),
)


def log(msg: str = "") -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return res.stdout.strip().splitlines()[0] if res.stdout.strip() \
            else f"nvidia-smi gave nothing (exit {res.returncode})"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def device_ms(fn, reps: int):
    """Mean device time (ms) of the CUDA kernels one call of fn launches,
    from a torch.profiler trace; None when the trace shows no device time
    (the reason is logged)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        # CUDA activity only: recording the CPU ops too costs minutes over
        # the plain versions' thousands of launches.
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        us = sum(e.time_range.elapsed_us() for e in events
                 if e.device_type == DeviceType.CUDA)
    except Exception as e:   # the profiler is optional here
        log(f"profiler unavailable: {e!r}")
        return None
    if us <= 0:
        names = sorted({e.name for e in events})[:12]
        log(f"profiler: no device time in {len(events)} events {names}")
        return None
    return us / reps / 1e3


def event_ms(fn, reps: int, warmup: int = 3) -> float:
    """CUDA-event time per call of fn, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int, warmup: int = 3) -> float:
    """CUDA-event time per call of fn with the calls queued behind a ~25 ms
    device-side spin: while the queue lasts the card runs them back to back,
    so for calls the host enqueues faster than the card runs them this is
    device time without the host's launch gaps."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float, kind: str = "bf16") -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_ms(fn, reps: int):
    """CUDA-event time of one PyTorch library call (a yardstick the port
    never calls); None when this PyTorch lacks the call or its options."""
    try:
        fn()
    except (AttributeError, TypeError, RuntimeError) as e:
        log(f"library call unavailable: {e!r}")
        return None
    return event_ms(fn, reps)


def int4pack_weights(packed, scales):
    """Kernel E's int4 weights for torch._weight_int4pack_mm (tinygemm: bf16
    x, int4 weights, scales per group of input rows, fp32 sums), which
    dequantises code u as (u - 8) * scale + zero: u = q + 8 with zero 0,
    the scales rounded to bf16. Returns (packed weights, group, scales and
    zeros), or None (logged) when this PyTorch lacks the op."""
    import torch
    p = packed.to(torch.int16)
    q = torch.cat([((p & 15) ^ 8) - 8, p >> 4], dim=0)            # (K, O)
    u = (q + 8).T.contiguous().to(torch.int32)                      # (O, K)
    sz = torch.stack([scales, torch.zeros_like(scales)], dim=-1)
    try:
        w = torch._convert_weight_to_int4pack(
            (u[:, ::2] << 4 | u[:, 1::2]).to(torch.uint8), 8)
    except (AttributeError, TypeError, RuntimeError) as e:
        log(f"library call unavailable: {e!r}")
        return None
    return w, q.shape[0] // scales.shape[0], sz.to(torch.bfloat16).contiguous()


def sdpa_call(q, k, v, mask):
    """One F.scaled_dot_product_attention over (B, Hq, S, D) queries and
    (B, Hkv, W, D) keys/values with a boolean mask (B, 1, S, W)."""
    import torch.nn.functional as F
    kw = {"enable_gqa": True} if q.shape[1] != k.shape[1] else {}
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, **kw)


def time_pair(kernel, plain, reps: int, warmup: int = 3) -> dict:
    """Per call, kernel vs plain, in turns P K K P: `ms`/`plain_ms` are the
    device time of the launched CUDA kernels (profiler; None where the
    trace held none), `queued_ms`/`plain_queued_ms` the CUDA-event time of
    calls queued behind a device-side spin, `wall_ms`/`plain_wall_ms` the
    CUDA-event time per call including the host's launch gaps."""
    mean = (lambda a, b: None if a is None or b is None else (a + b) / 2)
    out = {}
    for key, how in (("wall_ms", lambda f: event_ms(f, reps, warmup)),
                     ("queued_ms", lambda f: queued_ms(f, reps, warmup)),
                     ("ms", lambda f: device_ms(f, reps))):
        p1, k1, k2, p2 = how(plain), how(kernel), how(kernel), how(plain)
        out[key], out["plain_" + key] = mean(k1, k2), mean(p1, p2)
    return out


def fmt_times(r: dict) -> str:
    def f(x):
        return "n/a" if x is None else f"{x:.4f}"
    return (f"device ms: kernel {f(r.get('ms'))}, plain {f(r.get('plain_ms'))}; "
            f"queued ms: kernel {f(r.get('queued_ms'))}, "
            f"plain {f(r.get('plain_queued_ms'))}; "
            f"per-call wall ms: kernel {f(r.get('wall_ms'))}, "
            f"plain {f(r.get('plain_wall_ms'))}; bound {f(r.get('bound_ms'))} "
            f"({r.get('bound_by')}); library {f(r.get('library_ms'))}")


def _rnd(gen, *shape):
    """bf16 normal draws on the generator's device."""
    import torch
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).to(torch.bfloat16)


def _compare(out, ref) -> tuple[float, bool]:
    import torch
    o, r = out.float(), ref.float()
    err = float((o - r).abs().max())
    ok = bool(torch.isfinite(o).all()) and bool(
        torch.allclose(o, r, atol=ATOL, rtol=RTOL))
    return err, ok


# ---------------------------------------------------------------------------
# Kernel checks (also callable on the CPU at small sizes, where both sides
# are the plain version, to rehearse shapes and arguments)
# ---------------------------------------------------------------------------


def check_kernel_a(dev, L, T, Hkv, G, Dh, reps, cases=None, timed=True):
    import torch
    from fireredtts2_tpu_torch.ops import flash_decode as fd

    rng = np.random.default_rng(0)
    cases = cases or [(1, 200), (1, 3000), (8, 200), (8, 3000)]
    results = []
    for B, live in cases:
        gen = torch.Generator(device=dev).manual_seed(B * 7919 + live)
        q = _rnd(gen, B, Hkv * G, Dh)
        k4, v4 = _rnd(gen, L, B, T, Hkv * Dh), _rnd(gen, L, B, T, Hkv * Dh)
        # ragged windows: left padding up to 40 slots, ends near `live`;
        # stream 0 ends on a chunk edge when the window is long
        q_start = rng.integers(0, 40, B)
        q_end = np.minimum(live + rng.integers(-20, 20, B), T)
        if live > 1000:
            q_end[0] = min(T, (live // 512) * 512)
        qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
        qe = torch.tensor(q_end, dtype=torch.int32, device=dev)
        lo = torch.tensor(int(q_start.min()), dtype=torch.int32, device=dev)
        hi = torch.tensor(int(q_end.max()), dtype=torch.int32, device=dev)
        layer = L - 1
        out = fd.flash_decode_gqa1(q, k4, v4, layer, qs, qe, lo, hi)
        ref = fd.flash_decode_gqa1_plain(q, k4, v4, layer, qs, qe, lo, hi)
        err, ok = _compare(out, ref)
        live_slots = int((q_end - q_start).sum())
        bnd, by = bound_ms(4 * B * Hkv * G * Dh + live_slots * Hkv * Dh * 4,
                           4 * Hkv * G * Dh * live_slots)
        times = {}
        if timed:
            step = itertools.count()
            times = time_pair(
                lambda: fd.flash_decode_gqa1(q, k4, v4, next(step) % L, qs, qe,
                                             lo, hi),
                lambda: fd.flash_decode_gqa1_plain(q, k4, v4, next(step) % L,
                                                   qs, qe, lo, hi), reps)
            w0, w1 = int(q_start.min()), int(q_end.max())
            kv = [t[layer, :, w0:w1].view(B, w1 - w0, Hkv, Dh).transpose(1, 2)
                  for t in (k4, v4)]
            slot = torch.arange(w0, w1, device=dev)
            mask = ((slot >= qs[:, None]) & (slot < qe[:, None]))[:, None, None]
            times["library_ms"] = library_ms(
                sdpa_call(q[:, :, None], kv[0], kv[1], mask), reps)
        results.append(dict(B=B, live=live, max_abs_err=err, ok=ok,
                            bound_ms=bnd, bound_by=by, **times))
        del q, k4, v4
    return results


def check_kernel_c(dev, L, T, H, Dh, reps, cases=None, timed=True):
    import torch
    from fireredtts2_tpu_torch.ops import flash_decode as fd

    D = H * Dh
    cases = cases or [(B, S, live) for B in (1, 8) for S in (8, 32, 64, 128)
                      for live in (200, 2900)]
    cases = list(cases) + [("overshoot", 64, T)]
    results = []
    for B, S, live in cases:
        overshoot = B == "overshoot"
        if overshoot:
            B = 2
            pos = np.array([T - 8, T + 8])      # past the slab: writes clamp
        else:
            base = (live - S) // 8 * 8
            pos = np.maximum(base - 8 * np.arange(B), 0)
        gen = torch.Generator(device=dev).manual_seed(B * 31 + S + live)
        q = _rnd(gen, B, S, H, Dh)
        nk, nv = _rnd(gen, B, S, D), _rnd(gen, B, S, D)
        k4, v4 = _rnd(gen, L, B, T, D), _rnd(gen, L, B, T, D)
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        q_end = pos_t[:, None] + 8 * (torch.arange(S, device=dev,
                                                   dtype=torch.int32)[None] // 8 + 1)
        live_hi = pos_t.max() + S
        layer = L // 2
        kk, vk, kp, vp = k4.clone(), v4.clone(), k4, v4
        out = fd.flash_decode_update_bounded(q, nk, nv, kk, vk, layer, pos_t,
                                             q_end, live_hi)
        ref = fd.flash_decode_update_bounded_plain(q, nk, nv, kp, vp, layer,
                                                   pos_t, q_end, live_hi)
        err, ok = _compare(out, ref)
        rows_ok = bool(torch.equal(kk, kp)) and bool(torch.equal(vk, vp))
        read = int(q_end.max(dim=1).values.sum())      # slab rows attended
        bnd, by = bound_ms(2 * (2 * B * S * D) + 2 * 2 * B * S * D
                           + read * D * 4, 4 * D * int(q_end.sum()))
        times = {}
        if timed:
            step = itertools.count()
            times = time_pair(
                lambda: fd.flash_decode_update_bounded(
                    q, nk, nv, kk, vk, next(step) % L, pos_t, q_end, live_hi),
                lambda: fd.flash_decode_update_bounded_plain(
                    q, nk, nv, kp, vp, next(step) % L, pos_t, q_end, live_hi),
                reps)
            hi = min(int(live_hi), T)
            kv = [t[layer, :, :hi].view(B, hi, H, Dh).transpose(1, 2)
                  for t in (kk, vk)]
            slot = torch.arange(hi, device=dev)
            mask = (slot[None, None] < q_end[:, :, None])[:, None]
            times["library_ms"] = library_ms(
                sdpa_call(q.transpose(1, 2), kv[0], kv[1], mask), reps)
        results.append(dict(B=B, S=S, live=live, overshoot=overshoot,
                            max_abs_err=err, ok=ok and rows_ok,
                            rows_identical=rows_ok, bound_ms=bnd, bound_by=by,
                            **times))
        del q, nk, nv, k4, v4, kk, vk
    return results


def check_kernel_d(dev, T, H, Dh, reps=30, timed=True):
    """Kernel C's read-only mode with per-query lower bounds."""
    import torch
    from fireredtts2_tpu_torch.ops import flash_decode as fd
    from fireredtts2_tpu_torch.ops.attention import gqa_attention_bounded

    gen = torch.Generator(device=dev).manual_seed(5)
    B, S = 2, 32
    q = _rnd(gen, B, S, H, Dh)
    k, v = _rnd(gen, B, T, H * Dh), _rnd(gen, B, T, H * Dh)
    q_end = torch.tensor([[T // 2], [T - 5]], dtype=torch.int32,
                         device=dev).expand(B, S).contiguous()
    q_start = torch.tensor([[100], [T // 3]], dtype=torch.int32,
                           device=dev).expand(B, S).contiguous()
    def kernel():
        return fd.flash_decode_bounded(q, k, v, q_end, T - 5, q_start=q_start,
                                       live_lo=100)

    def plain():
        return gqa_attention_bounded(q, k, v, q_end, T - 5, q_start=q_start,
                                     live_lo=100)

    fd.flash_decode_bounded.launches = 0
    err, ok = _compare(kernel(), plain())
    launches = fd.flash_decode_bounded.launches
    rows = int((q_end - q_start)[:, 0].sum())
    bnd, by = bound_ms(2 * 2 * B * S * H * Dh + rows * H * Dh * 4,
                       4 * H * Dh * S * rows)
    times = time_pair(kernel, plain, reps) if timed else {}
    if timed:
        kv = [t[:, 100:T - 5].view(B, T - 105, H, Dh).transpose(1, 2)
              for t in (k, v)]
        slot = torch.arange(100, T - 5, device=dev)
        mask = ((slot >= q_start[:, :, None]) & (slot < q_end[:, :, None]))[:, None]
        times["library_ms"] = library_ms(
            sdpa_call(q.transpose(1, 2), kv[0], kv[1], mask), reps)
    return dict(max_abs_err=err, ok=ok, launches=launches, bound_ms=bnd,
                bound_by=by, **times)


def depth_bundle(dev, plan: str, seed: int = 0):
    """Kernel B's bundle at the flagship depth decoder (qwen-200m, 16
    codebooks of 2051, backbone width 1536) from random bf16 weights drawn
    on `dev`: (cfg, bundle, generator)."""
    from fireredtts2_tpu_torch.tools.ablate_depth import random_depth_bundle
    return random_depth_bundle(dev, plan, seed)


def depth_bytes_ops(bundle, cfg, B: int, plan: str) -> tuple[float, float, str]:
    """Kernel B's bytes (every input read once, the samples written once)
    and operations (two per weight per stream per micro-step)."""
    from fireredtts2_tpu_torch.ops.depth_chain import parse_plan

    modes = parse_plan(plan)
    ncb, V = cfg.audio_num_codebooks, cfg.audio_vocab_size
    Db, Dd = cfg.backbone.embed_dim, cfg.decoder.embed_dim
    nbytes = sum(t.numel() * t.element_size() for k, t in bundle.items()
                 if k != "emb_rows")
    nbytes += (ncb - 1) * B * Db * 2                 # the embedding rows used
    nbytes += B * Db * 2 + B * 4 + B * ncb * V * 4 + B * ncb * 4
    layer_w = sum(bundle[k][0].numel() * (2 if modes.get(k) == "r4" else 1)
                  for k in ("wqkv", "wo", "w_gate", "w_up", "w_down"))
    per_step = cfg.decoder.num_layers * layer_w + Db * Dd
    ops = 2 * B * (ncb * per_step + (ncb - 1) * Dd * V)
    kind = "int8" if all(m in ("r8a8", "s8a8") for m in modes.values()) else "bf16"
    return nbytes, ops, kind


def race_gap(logits, noise, topk: int, temp: float):
    """(B, ncb) relative gap of the top two exponential-race scores, from
    fp32 logits, as the sampler computes them."""
    import torch
    from fireredtts2_tpu_torch.ops.sampling import topk_filter

    pr = torch.softmax(topk_filter(logits / temp, topk), dim=-1)
    top2 = torch.topk(pr / noise, 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) / top2[..., 0].clamp(min=1e-30)


def check_kernel_b(dev, plans=(PRESET, "gate=r4,up=s8,down=s8",
                               "gate=r8a8,up=s8a8,down=s8"),
                   batches=(1, 8), reps=20, timed=True, bundle_fn=None):
    """Kernel B vs its plain version. With the plain version's samples
    forced into both, the fp32 logits of every micro-step agree to B_TOL of
    the plain peak, and a sample may differ only at a near-tie: where the
    plain version's top two race scores lie closer than that step's logit
    error can move them. Sampling freely, each stream follows the plain
    version up to its first such tie. The ties are counted."""
    import torch
    from fireredtts2_tpu_torch.ops import depth_chain as dc

    results = []
    for plan in plans:
        cfg, bundle, gen = (bundle_fn or depth_bundle)(dev, plan)
        ncb, V = cfg.audio_num_codebooks, cfg.audio_vocab_size
        for B in batches:
            last_h = _rnd(gen, B, cfg.backbone.embed_dim)
            c0 = torch.randint(0, V, (B,), generator=gen, device=dev,
                               dtype=torch.int32)
            noise = torch.empty((B, ncb, V), device=dev).exponential_(generator=gen)
            ref, ref_logits = dc.fused_depth_decode_plain(bundle, cfg, last_h,
                                                          c0, noise, plan=plan)
            forced, logits = dc.fused_depth_decode(bundle, cfg, last_h, c0,
                                                   noise, plan=plan, forced=ref,
                                                   return_logits=True)
            free = dc.fused_depth_decode(bundle, cfg, last_h, c0, noise, plan=plan)
            if torch.device(dev).type == "cuda":
                torch.cuda.synchronize()
            err_bp = (logits - ref_logits).abs().amax(dim=-1)      # (B, ncb)
            err = float(err_bp.max())
            peak = float(ref_logits.abs().max())
            # With the same prefix forced, a sample may differ only where a
            # logit error of err_bp can change the plain version's decision:
            # its top two race scores lie within a factor exp(2 err_bp / T)
            # (race), or the kernel's token could enter the top k or the
            # plain version's token leave it (top-k), both within 2 err_bp
            # of the boundary between the k-th and (k+1)-th logits.
            gap = race_gap(ref_logits, noise, TOPK, TEMP)
            top = torch.topk(ref_logits, TOPK + 1, dim=-1).values
            flips = []
            for b, p in (forced != ref).nonzero().tolist():
                e, lg = float(err_bp[b, p]), ref_logits[b, p]
                kt, rt = int(forced[b, p]), int(ref[b, p])
                rank_k, rank_r = (int((lg > lg[t]).sum()) for t in (kt, rt))
                enters = rank_k >= TOPK and float(top[b, p, TOPK - 1] - lg[kt]) <= 2 * e
                leaves = rank_r < TOPK and float(lg[rt] - top[b, p, TOPK]) <= 2 * e
                why = ("race" if float(gap[b, p]) <= 1 - math.exp(-2 * e / TEMP)
                       else "top-k" if enters or leaves else "none")
                flips.append((b, p, float(gap[b, p]), e, why, rank_k, rank_r))
            tokens_ok = all(p > 0 and why != "none"
                            for b, p, _, _, why, *_ in flips)
            # Sampling freely, each stream follows the plain version up to
            # its first forced-run flip.
            for b in range(B):
                fb = [p for bb, p, *_ in flips if bb == b]
                d = (free[b] != ref[b]).nonzero()
                tokens_ok &= (int(d[0]) if len(d) else None) == (fb[0] if fb else None)
            ties = len(flips)
            ok = (bool(torch.isfinite(logits).all()) and err <= B_TOL * peak
                  and tokens_ok and bool(torch.equal(free[:, 0], c0)))
            nbytes, ops, kind = depth_bytes_ops(bundle, cfg, B, plan)
            bnd, by = bound_ms(nbytes, ops, kind)
            times = {}
            if timed:
                times = time_pair(
                    lambda: dc.fused_depth_decode(bundle, cfg, last_h, c0, noise,
                                                  plan=plan),
                    lambda: dc.fused_depth_decode_plain(bundle, cfg, last_h, c0,
                                                        noise, plan=plan),
                    reps)
                # Each micro-step re-reads the decoder: the floor of a
                # kernel that streams the weights from device memory at
                # every step, beside the contract's read-once bound.
                times["streamed_floor_ms"] = (
                    (nbytes - sum(t.numel() * t.element_size() for k, t in
                                  bundle.items() if k == "head_t"))
                    * ncb / HBM_BYTES_PER_S * 1e3)
            results.append(dict(plan=plan, B=B, max_abs_err=err, peak=peak,
                                ok=ok, ties=ties, flips=flips[:8],
                                tokens_ok=tokens_ok,
                                bound_ms=bnd, bound_by=by, library_ms=None,
                                **times))
        del bundle
    return results


def int4_shapes():
    """(name, K, O) of every depth-decoder matrix of qwen-200m."""
    return [("wq", 1536, 1536), ("wk", 1536, 256), ("wv", 1536, 256),
            ("wo", 1536, 1536), ("w_gate", 1536, 8960), ("w_up", 1536, 8960),
            ("w_down", 8960, 1536)]


def check_kernel_e(dev, shapes=None, ms=(1, 2, 8, 16), reps=50, timed=True):
    """Kernel E vs its plain version at the int4 depth path's shapes. Timed
    beside it, as yardsticks the port never calls: torch._weight_int4pack_mm
    on the same int4 weights (`library_ms`; its largest difference from
    the plain version, from its bf16 scales and output, as `library_err`)
    and a bf16 torch.matmul on the dequantised weight."""
    import torch
    from fireredtts2_tpu_torch.models.lm.transformer import quantize_transformer_int4
    from fireredtts2_tpu_torch.ops import int4 as i4

    results = []
    for name, K, O in shapes or int4_shapes():
        gen = torch.Generator(device=dev).manual_seed(K + O)
        w = torch.randn((1, K, O), generator=gen, device=dev) * 0.02
        q = quantize_transformer_int4({"w_gate": w})
        packed, scales = q["w_gate"][0], q["w_gate_scale4"][0]
        pt, st = i4.output_major_int4(packed, scales)
        wd = i4.unpack_int4(packed, scales).to(torch.bfloat16)
        lib = int4pack_weights(packed, scales) if timed else None
        for M in ms:
            x = _rnd(gen, M, K)
            out = i4.int4_matmul(x, packed, scales, pt, st)
            ref = i4.int4_matmul_plain(x, packed, scales)
            err, ok = _compare(out, ref)
            bnd, by = bound_ms(packed.numel() + scales.numel() * 4
                               + 2 * M * (K + O), 2 * M * K * O)
            times = {}
            if timed:
                times = time_pair(lambda: i4.int4_matmul(x, packed, scales, pt, st),
                                  lambda: i4.int4_matmul_plain(x, packed, scales),
                                  reps)
                times["bf16_matmul_ms"] = event_ms(lambda: x @ wd, reps)
                times["library_ms"] = times["library_err"] = None
                if lib is not None:
                    def tinygemm():
                        return torch._weight_int4pack_mm(x, *lib)
                    times["library_ms"] = library_ms(tinygemm, reps)
                    if times["library_ms"] is not None:
                        times["library_err"] = float(
                            (tinygemm().float() - ref.float()).abs().max())
            results.append(dict(name=name, K=K, O=O, M=M, max_abs_err=err,
                                ok=ok, bound_ms=bnd, bound_by=by, **times))
        del w, wd
    return results


def check_kernel_f(dev, T=4096, Hkv=2, G=6, Dh=128, reps=50, timed=True,
                   cases=((1, 200), (1, 3000), (8, 200), (8, 3000))):
    """Kernel F (pallas_decode_attention on kernel A's code) vs its plain
    version over unmerged (B, T, Hkv, Dh) slabs, left-padded windows."""
    import torch
    from fireredtts2_tpu_torch.ops import flash_decode as fd

    rng = np.random.default_rng(3)
    launches = 0
    results = []
    for B, live in cases:
        gen = torch.Generator(device=dev).manual_seed(B * 13 + live)
        q = _rnd(gen, B, Hkv * G, Dh)
        k, v = _rnd(gen, B, T, Hkv, Dh), _rnd(gen, B, T, Hkv, Dh)
        start = rng.integers(0, 60, B)
        end = np.minimum(start + live + rng.integers(-20, 20, B), T)
        st = torch.tensor(start, dtype=torch.int32, device=dev)
        en = torch.tensor(end, dtype=torch.int32, device=dev)
        before = fd.pallas_decode_attention.launches
        out = fd.pallas_decode_attention(q, k, v, st, en)
        launches += fd.pallas_decode_attention.launches - before
        err, ok = _compare(out, fd.pallas_decode_attention_plain(q, k, v, st, en))
        slots = int((end - start).sum())
        bnd, by = bound_ms(4 * B * Hkv * G * Dh + slots * Hkv * Dh * 4,
                           4 * Hkv * G * Dh * slots)
        times = {}
        if timed:
            times = time_pair(
                lambda: fd.pallas_decode_attention(q, k, v, st, en),
                lambda: fd.pallas_decode_attention_plain(q, k, v, st, en), reps)
            w0, w1 = int(start.min()), int(end.max())
            kv = [t[:, w0:w1].transpose(1, 2) for t in (k, v)]
            slot = torch.arange(w0, w1, device=dev)
            mask = ((slot >= st[:, None]) & (slot < en[:, None]))[:, None, None]
            times["library_ms"] = library_ms(
                sdpa_call(q[:, :, None], kv[0], kv[1], mask), reps)
        results.append(dict(B=B, live=live, max_abs_err=err, ok=ok,
                            bound_ms=bnd, bound_by=by, **times))
    return results, launches


def check_probe(spec, load="direct", sync="none") -> dict:
    """Kernel P on one probe's own matrices, inputs and load path against
    gemv_probe_plain: one step in the y form, every output row within
    ATOL + RTOL x |plain|, and for a probe of the sum form its whole call,
    all steps, within P_SUM_TOL x the sum of |y| over its steps (fp32 sums
    in other orders, and across blocks by atomics)."""
    import torch
    from fireredtts2_tpu_torch.ops import gemv_probe as gp

    ys = gp.probe_products(spec.mats, spec.xs, spec.mode)
    y = gp.gemv_probe(spec.mats, spec.xs, spec.mode, 1, "y", sync, load,
                      spec.qgroup)
    err, ok = _compare(y, torch.cat(ys, dim=1).to(torch.bfloat16))
    r = dict(max_abs_err=err)
    if spec.form == "sum":
        got = gp.gemv_probe(spec.mats, spec.xs, spec.mode, spec.steps, "sum",
                            sync, load, spec.qgroup)
        scale = spec.steps * sum(float(t.abs().sum(dim=1).max()) for t in ys)
        r.update(sum_err=float((got - spec.plain()).abs().max()), sum_scale=scale)
        ok = (ok and bool(torch.isfinite(got).all())
              and r["sum_err"] <= P_SUM_TOL * scale)
    r["ok"] = ok
    return r


def check_kernel_p(dev, ms=(5, 16, 32), K=256, large=True, modes=None,
                   loads=None):
    """Kernel P (the GEMV probes) against gemv_probe_plain in every mode,
    load path and M tile (R = 4, 2, 1 rows a warp at M = 5, 16, 32):
    - "small": two matrices on one input and a third on another, 3 steps
      with a barrier after each matrix, inputs in shared memory: a warp
      holds at most one row of each matrix;
    - "tiles" (`large`): three matrices of thousands of rows, sized from the
      call's grid so that a warp owns R + 1 ... 2R - 1 rows of them: its
      tiles run with R rows and then with every count below;
    - "global x" (`large`, not the s8s8 modes, which quantise in shared
      memory): inputs of more than 240 KB, too large for shared memory,
      read from global memory as the capacity sweep and P4a's bf16 and int8
      probes at M = 32 read them (on the card the case fails unless the
      call really left them there).
    Each case in the y form and the sum form (``check_probe``), with a grid
    barrier after each matrix."""
    import torch
    from fireredtts2_tpu_torch.ops import gemv_probe as gp
    from fireredtts2_tpu_torch.tools._common import Spec, rand_weights

    def rows_for(M, mode, load, xs, R):
        """Row counts giving a warp R + 1 .. 2R - 1 rows (R + 1 at R = 1)."""
        if dev == "cpu":
            return [64 * R + j for j in range(1, max(R, 2))]
        probe = gp.ProbeCall([], xs, mode, 0, "sum", "none", load)
        warps = probe.grid * 16
        return [warps * (R + j) - 7 * j for j in range(1, max(R, 2))]

    results = []
    for mode in modes or gp.MODES:
        wmode = "int8" if mode.startswith("s8") else mode
        for M in ms:
            R = 4 if M <= 8 else 2 if M <= 16 else 1
            gen = torch.Generator(device=dev).manual_seed(M)
            x = [(torch.randn((M, k), generator=gen, device=dev) * 0.01
                  ).to(torch.bfloat16) for k in (K, 2 * K)]
            cases = {"small": Spec("small", mode, [
                rand_weights(wmode, 96, K, gen), rand_weights(wmode, 40, K, gen),
                rand_weights(wmode, 72, 2 * K, gen)._replace(x=1)], x, 3, qgroup=2)}
            for load in loads or gp.LOADS:
                if large:
                    cases["tiles"] = Spec("tiles", mode, [
                        rand_weights(wmode, o, K, gen)
                        for o in rows_for(M, mode, load, x[:1], R)], x[:1], 2,
                        qgroup=1)
                if large and not mode.startswith("s8"):
                    kg = -(-(240 << 10) // (2 * M * 256)) * 256
                    xg = [(torch.randn((M, kg), generator=gen, device=dev) * 0.01
                           ).to(torch.bfloat16)]
                    cases["global x"] = Spec("global x", mode, [
                        rand_weights(wmode, 200, kg, gen),
                        rand_weights(wmode, 72, kg, gen)], xg, 2)
                for case, spec in cases.items():
                    r = check_probe(spec, load, "matrix")
                    if dev != "cpu":
                        r["x_staged"] = spec.call(load).x_staged
                        r["ok"] &= r["x_staged"] == (case != "global x")
                    results.append(dict(case=case, mode=mode, load=load, M=M, **r))
    return results


def probe_library_ms(spec):
    """(ms, call, reason) of PyTorch library calls computing the products
    of one probe call: one call per matrix per step, summed (the probe's
    sum over outputs is not counted). bf16: torch.matmul; int8:
    torch._weight_int8pack_mm with unit scales; int4:
    torch._weight_int4pack_mm; s8s8: torch._int_mm, which takes M > 16
    only. ms is None, with the reason, where the call is refused."""
    import torch
    from fireredtts2_tpu_torch.ops import gemv_probe as gp
    from fireredtts2_tpu_torch.tools._common import library_call_ms

    mode, x0 = spec.mode, spec.xs[0]
    M = x0.shape[0]
    if mode in ("s8s8", "s8s8q") and M <= 16:
        return None, "torch._int_mm", "torch._int_mm takes M > 16 rows only"
    times: dict = {}
    for m in spec.mats:
        key = (m.w.data_ptr(), m.x)
        if key in times:
            continue
        x = spec.xs[m.x]
        if mode == "bf16":
            name, fn = "torch.matmul", (lambda x=x, w=m.w: torch.matmul(x, w.T))
        elif mode == "int8":
            ones = torch.ones(m.w.shape[0], dtype=torch.bfloat16, device=x.device)
            name = "torch._weight_int8pack_mm"
            fn = (lambda x=x, w=m.w, s=ones: torch._weight_int8pack_mm(x, w, s))
        elif mode == "int4":
            name = "torch._weight_int4pack_mm"
            lib = int4pack_weights(m.w.T.contiguous(), m.scales.T.contiguous())
            if lib is None:
                return None, name, "torch._convert_weight_to_int4pack refused"
            fn = (lambda x=x, lib=lib: torch._weight_int4pack_mm(x, *lib))
        else:
            name = "torch._int_mm"
            xq = gp.quantize_rows(x)[0].to(torch.int8)
            fn = (lambda xq=xq, w=m.w: torch._int_mm(xq, w.T))
        ms, why = library_call_ms(fn)
        if ms is None:
            return None, name, why
        times[key] = ms
    per_step = sum(times[(m.w.data_ptr(), m.x)] for m in spec.mats)
    return per_step * spec.steps, name, None


def probe_extra(spec, load) -> dict:
    """What chip_smoke adds to each probe row the tools measure: the check
    against the plain version at the probe's own shapes (``check_probe``),
    the plain version's time, the bound and streamed floor, and the library
    calls' time."""
    r = check_probe(spec, load)
    r["plain_ms"] = queued_ms(spec.plain, 3, 1)
    r["bound_ms"], r["bound_by"] = bound_ms(
        spec.io_bytes(), spec.ops(), "int8" if spec.mode.startswith("s8") else "bf16")
    r["streamed_floor_ms"] = spec.streamed_floor_ms()
    r["library_ms"], r["library_call"], r["library_note"] = probe_library_ms(spec)
    return r


def probe_rows(tree):
    """Every row of a tool's result tree (the dicts that carry "ok")."""
    if isinstance(tree, dict):
        if "ok" in tree and "ms" in tree:
            yield tree
            return
        for v in tree.values():
            yield from probe_rows(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from probe_rows(v)


def run_probes(dev, card: str) -> dict:
    """The probes P1-P4 through the tools of fireredtts2_tpu_torch/tools/ at
    the JAX tools' sizes, each row checked against the plain version and
    given its bound, plain and library times (``probe_extra``); the grid
    barrier and the cooperative launch; kernel B's ablation builds (P2,
    P4b). The tools print their numbers; the card is printed beside them."""
    from fireredtts2_tpu_torch.ops.gemv_probe import ProbeCall, grid_blocks
    from fireredtts2_tpu_torch.tools import ablate_depth as ad
    from fireredtts2_tpu_torch.tools import probe_depth_kernel as p1
    from fireredtts2_tpu_torch.tools import probe_dequant as p3
    from fireredtts2_tpu_torch.tools import probe_s8_chunked as p4
    from fireredtts2_tpu_torch.tools._common import host_ms

    log(f"probes on {card}:")
    out: dict = dict(p1=p1.main(dev, extra=probe_extra),
                     p3=p3.main(dev, extra=probe_extra),
                     p4a=p4.main(dev, extra=probe_extra))
    rows = [r for k in ("p1", "p3", "p4a") for r in probe_rows(out[k])]
    bad = [(r["name"], r["load"]) for r in rows if not r["ok"]]
    log(f"probe rows vs plain at their own shapes: {len(rows)} rows, y form "
        f"max_abs_err {max(r['max_abs_err'] for r in rows):.3e}, sum form max "
        f"err / sum|y| {max(r.get('sum_err', 0) / r.get('sum_scale', 1) for r in rows):.3e}"
        f"; failing: {bad}  [{card}]")
    # the grid barrier and the cooperative launch
    bar = {}
    for n in (19, 304, 3040):
        call = ProbeCall([], [], "int8", steps=n, sync="step")
        bar[n] = queued_ms(lambda: call.launch(zero=False), 10)
    empty = ProbeCall([], [], "int8", steps=0)
    out["barrier"] = dict(
        grid_blocks=grid_blocks(), ms=bar,
        us_per_barrier=(bar[3040] - bar[19]) / (3040 - 19) * 1e3,
        empty_launch_host_ms=host_ms(lambda: empty.launch(zero=False), 50),
        empty_launch_device_ms=queued_ms(lambda: empty.launch(zero=False), 50))
    b = out["barrier"]
    log(f"barrier: {b['us_per_barrier']:.3f} us per grid_sync at "
        f"{b['grid_blocks']} blocks ({bar}); empty cooperative launch: host "
        f"{b['empty_launch_host_ms'] * 1e3:.2f} us, device "
        f"{b['empty_launch_device_ms'] * 1e3:.2f} us  [{card}]")
    # P2 / P4b: kernel B's ablation builds, preset plan, B = 1 and 8
    out["p2"] = ad.main(dev)
    abl0 = out["p2"]["abl0"]
    for c in abl0.values():
        c["ok"] = (c["samples_equal"] and c["forced_equal"] and c["logits_equal"]
                   and c["plain_max_abs_err"] <= B_TOL * c["plain_peak"])
    out["ok"] = (not bad and all(c["ok"] for c in abl0.values())
                 and all(math.isfinite(r["ms"]) for B in (1, 8)
                         for r in out["p2"][B].values()))
    return out


def probe_summary(probes: dict) -> dict:
    """The probes line: each probe's numbers, floats to 5 significant
    digits, without the labels its key repeats (every value is in
    chiprun_out/chip_smoke.json)."""
    drop = ("name", "mode", "load", "sync", "cold", "M", "steps", "weight_mb",
            "library_call", "library_note", "bound_by", "bits", "ok", "sum_err",
            "sum_scale", "grid", "x_staged", "streamed_floor_ms", "s_per_byte_eq")

    def rnd(v):
        if isinstance(v, dict):
            return {str(k): rnd(x) for k, x in v.items() if k not in drop}
        if isinstance(v, list):
            return [rnd(x) for x in v]
        if isinstance(v, float):
            return float(f"{v:.5g}")
        return v
    return rnd(probes)


def check_small_model(dev):
    """Small widths the kernels take (LM Dh=128, vocoder Dh=64): bf16 on
    `dev` through the kernels vs the same (bf16-rounded) weights in fp32 on
    the CPU through the plain versions. Returns peak-relative errors."""
    import torch
    from fireredtts2_tpu_torch.config import (
        AcousticDecoderConfig, TransformerConfig,
    )
    from fireredtts2_tpu_torch.models.codec.decoder import (
        init_acoustic_decoder, stream_decode_scan,
    )
    from fireredtts2_tpu_torch.models.lm.transformer import (
        init_kv_cache, init_transformer_params, transformer_forward,
    )

    def tree(t, device, dtype):
        if isinstance(t, dict):
            return {k: tree(v, device, dtype) for k, v in t.items()}
        return t.to(device=device, dtype=dtype)

    def rel(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        return float((a - b).abs().max() / b.abs().max())

    gen = torch.Generator().manual_seed(1)
    tc = TransformerConfig(vocab_size=64, num_layers=2, num_heads=2,
                           num_kv_heads=1, embed_dim=256, intermediate_dim=512,
                           max_seq_len=512)
    p32 = tree(init_transformer_params(gen, tc), "cpu", torch.bfloat16)
    out = {}
    hs = []
    for device, dtype in ((dev, torch.bfloat16), ("cpu", torch.float32)):
        p = tree(p32, device, dtype)
        cache = init_kv_cache(tc, 1, 512, dtype, device)
        g2 = torch.Generator().manual_seed(2)
        h = torch.randn((1, 16, 256), generator=g2).to(device=device, dtype=dtype)
        pos = torch.arange(16, dtype=torch.int32, device=device)[None]
        mask = pos[:, :, None] >= torch.arange(512, device=device)[None, None]
        o, _ = transformer_forward(p, tc, h, pos, mask, cache,
                                   torch.zeros(1, dtype=torch.int32, device=device))
        outs = [o]
        for t in range(16, 20):
            h1 = torch.randn((1, 1, 256), generator=g2).to(device=device,
                                                           dtype=dtype)
            p_t = torch.full((1,), t, dtype=torch.int32, device=device)
            o, _ = transformer_forward(
                p, tc, h1, p_t[:, None], None, cache, p_t,
                live_window=(torch.zeros_like(p_t), p_t + 1))
            outs.append(o)
        hs.append(torch.cat(outs, dim=1))
    out["lm_rel_err"] = rel(hs[0], hs[1])

    acfg = AcousticDecoderConfig(embed_dim=128, num_layers=2, num_heads=2,
                                 hop_length=240, causal=True,
                                 max_stream_latents=256)
    c32 = tree(init_acoustic_decoder(gen, acfg), "cpu", torch.bfloat16)
    lat = torch.randn((1, 64, 128), generator=torch.Generator().manual_seed(3))
    res = []
    for device, dtype in ((dev, torch.bfloat16), ("cpu", torch.float32)):
        m, t = stream_decode_scan(tree(c32, device, dtype), acfg,
                                  lat.to(torch.bfloat16).to(device=device,
                                                            dtype=dtype))
        res.append((m, t))
    out["voc_middles_rel_err"] = rel(res[0][0], res[1][0])
    out["voc_tails_rel_err"] = rel(res[0][1], res[1][1])
    out["ok"] = all(v <= REF_TOL for k, v in out.items())
    return out


# ---------------------------------------------------------------------------
# The main path at flagship width
# ---------------------------------------------------------------------------


def trace_generate(eng, dev, max_ms: float = 800.0) -> dict:
    """Trace one short generate call: wall time, summed device kernel time
    (busy share = device / wall) and the largest kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if torch.device(dev).type != "cuda":
        return {}
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.generate("Profile this.", "[S1]", max_audio_length_ms=max_ms,
                         utt_seed=3)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name: dict = {}
        n = 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
                n += 1
    except Exception as e:   # the profiler is optional here
        log(f"profiler unavailable: {e!r}")
        return {}
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(wall_s=wall, device_s=busy, busy_share=busy / wall,
                kernel_launches=n, frames=eng.last_stats.get("frames"),
                top=[(name[:90], us / 1e3) for name, us in top])


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    from fireredtts2_tpu_torch.ops import depth_chain as dc
    from fireredtts2_tpu_torch.ops import flash_decode as fd
    from fireredtts2_tpu_torch.ops import int4 as i4
    from fireredtts2_tpu_torch.ops import gemv_probe as gp
    fd.reset_launch_counts()
    dc.fused_depth_decode.launches = 0
    i4.int4_matmul.launches = 0
    gp.gemv_probe.launches = 0


def read_counts() -> dict:
    from fireredtts2_tpu_torch.ops import depth_chain as dc
    from fireredtts2_tpu_torch.ops import flash_decode as fd
    from fireredtts2_tpu_torch.ops import int4 as i4
    counts = fd.launch_counts()
    counts["fused_depth_decode"] = dc.fused_depth_decode.launches
    from fireredtts2_tpu_torch.ops import gemv_probe as gp
    counts["int4_matmul"] = i4.int4_matmul.launches
    counts["gemv_probe"] = gp.gemv_probe.launches
    return counts


def stream_lm_frames(max_len: int, cap: int) -> int:
    """LM frames generate_stream decodes for max_len frames without EOS:
    the prefill's frame, then blocks of 1, 4, 16, ... (capped) frames."""
    total, g, block = 1, 0, 1
    while g < max_len:
        total += block
        g += block
        block = min(block * 4, cap)
    return total


def run_engine(dev, card: str, config=None, max_ms: float = 4000.0,
               stream: bool = True, must_launch=("flash_decode_gqa1",
                                                  "flash_decode_update_bounded"),
               per_frame=(), trace: bool = True):
    """The engine at `config` (default: the flagship EngineConfig()) on one
    text and one utterance seed: generate_stream (when `stream`), then
    generate, each with every launch count set to 0 just before it and read
    just after. Kernels in `must_launch` must have launched in each run;
    those in `per_frame` exactly once per LM frame decoded."""
    import torch
    from fireredtts2_tpu_torch.config import EngineConfig
    from fireredtts2_tpu_torch.engine import FireRedTTS2Engine

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()

    config = config or EngineConfig()
    t0 = time.perf_counter()
    eng = FireRedTTS2Engine(config, seed=0, device=dev)
    sync()
    init_s = time.perf_counter() - t0
    log(f"engine: random weights on {dev} in {init_s:.1f} s")
    list(eng.generate_stream("Warm up.", "[S1]", max_audio_length_ms=400,
                             utt_seed=1))                    # warm-up
    sync()
    sr = eng.output_sample_rate
    seed = 2024
    cap = int(max_ms / 80)
    checks = {}
    result = dict(card=card, init_s=init_s)

    if stream:
        reset_counts()
        t0 = time.perf_counter()
        chunks = list(eng.generate_stream(TEXT, "[S1]", max_audio_length_ms=max_ms,
                                          utt_seed=seed))
        sync()
        stream_wall = time.perf_counter() - t0
        stream_counts = read_counts()
        fpl = eng._first_packet_s
        stream_audio = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
        stream_tokens = eng.last_tokens
        checks["stream_finite"] = bool(np.isfinite(stream_audio).all())
        checks["stream_len"] = len(stream_audio) == len(stream_tokens) * 1920 > 0
        for k in must_launch:
            checks[f"stream_{k}_launched"] = stream_counts[k] > 0
        if len(stream_tokens) == cap:
            want = stream_lm_frames(cap, config.stream_block_cap)
            for k in per_frame:
                checks[f"stream_{k}_once_per_frame"] = stream_counts[k] == want
        result["stream"] = dict(
            wall_s=stream_wall, first_packet_ms=fpl * 1e3 if fpl else None,
            audio_s=len(stream_audio) / sr,
            rtf=len(stream_audio) / sr / stream_wall, launches=stream_counts)

    reset_counts()
    t0 = time.perf_counter()
    audio = eng.generate(TEXT, "[S1]", max_audio_length_ms=max_ms, utt_seed=seed)
    sync()
    gen_wall = time.perf_counter() - t0
    gen_counts = read_counts()
    stats = dict(eng.last_stats)
    gen_tokens = eng.last_tokens
    frames = stats["frames"]
    checks["generate_finite"] = bool(np.isfinite(audio).all())
    checks["generate_len"] = len(audio) == frames * 1920 > 0
    for k in must_launch:
        checks[f"generate_{k}_launched"] = gen_counts[k] > 0
    for k in per_frame:        # an early EOS decodes one frame more
        checks[f"generate_{k}_once_per_frame"] = \
            gen_counts[k] == frames + (frames < cap)
    wave_err = None
    if stream:
        checks["same_frames"] = stream_tokens.shape == gen_tokens.shape \
            and bool(np.array_equal(stream_tokens, gen_tokens))
        if len(stream_audio) == len(audio) > 0:
            wave_err = float(np.abs(stream_audio - audio).max()
                             / max(np.abs(audio).max(), 1e-9))
    result.update(
        frames=frames, profile=trace_generate(eng, dev) if trace else {},
        generate=dict(wall_s=gen_wall, audio_s=len(audio) / sr,
                      rtf=len(audio) / sr / gen_wall,
                      lm_ms_per_frame=stats["lm_s"] / max(frames, 1) * 1e3,
                      vocode_s=stats["vocode_s"], launches=gen_counts),
        stream_vs_generate_rel_err=wave_err, checks=checks,
        ok=all(checks.values()))
    del eng
    torch.cuda.empty_cache() if torch.device(dev).type == "cuda" else None
    return result


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    try:
        from fireredtts2_tpu_torch.ops import cuda_build
        from fireredtts2_tpu_torch.ops import flash_decode as fd
    except ImportError as e:
        print(f"chip_smoke: the fireredtts2_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    report: dict = {}

    # 1. the card
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device 0: "
        f"{torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}")
    report["card"] = card

    # 2. build
    t0 = time.perf_counter()
    from fireredtts2_tpu_torch.tools.ablate_depth import build_jobs
    default = sorted(p.stem for p in cuda_build.CSRC_DIR.glob("*.cu"))
    libs = cuda_build.build(default + build_jobs())
    build_s = time.perf_counter() - t0
    log(f"build: {len(libs)} kernel libraries in {build_s:.1f} s "
        f"({', '.join(sorted(libs))})")
    for name, text in cuda_build.build_logs.items():
        lines = [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
        if name in ("fused_depth_decode", "gemv_probe") or "[" in name:
            # kernel B's variants and kernel P's 24 instantiations: a summary
            spills = [int(n) for ln in lines
                      for n in re.findall(r"(\d+) bytes spill stores", ln)] + [0]
            lines = [f"{len(lines) // 2} kernels, at most {max(spills)} bytes "
                     f"of spill stores"] + lines[:2]
        for line in lines:
            log(f"  ptxas {name}: {line}")
    report["build_s"] = build_s

    ok = True
    log(f"kernel vs plain tolerance: |kernel - plain| <= {ATOL} + {RTOL} * |plain|")
    # 3. kernel A
    lm = FLAGSHIP["lm"]
    res_a = check_kernel_a(dev, lm["L"], lm["T"], lm["Hkv"], lm["G"], lm["Dh"],
                           lm["reps"])
    for r in res_a:
        log(f"kernel A B={r['B']} live~{r['live']}: max_abs_err "
            f"{r['max_abs_err']:.3e} ok={r['ok']}  {fmt_times(r)}  [{card}]")
        ok &= r["ok"]
    report["kernel_a"] = res_a

    # 4. kernel C (and D)
    voc = FLAGSHIP["voc"]
    res_c = check_kernel_c(dev, voc["L"], voc["T"], voc["H"], voc["Dh"],
                           voc["reps"])
    for r in res_c:
        log(f"kernel C B={r['B']} S={r['S']} live~{r['live']}"
            f"{' overshoot' if r['overshoot'] else ''}: max_abs_err "
            f"{r['max_abs_err']:.3e} rows_identical={r['rows_identical']} "
            f"ok={r['ok']}  {fmt_times(r)}  [{card}]")
        ok &= r["ok"]
    report["kernel_c"] = res_c
    res_d = check_kernel_d(dev, voc["T"], voc["H"], voc["Dh"])
    log(f"kernel C read-only (D) B=2 S=32 with lower bounds: max_abs_err "
        f"{res_d['max_abs_err']:.3e} ok={res_d['ok']}  {fmt_times(res_d)}  [{card}]")
    ok &= res_d["ok"]
    report["kernel_d"] = res_d

    # 5. kernel B (fused depth chain), flagship qwen-200m depth decoder
    log(f"kernel B tolerance: logits with the same tokens forced, max |kernel - "
        f"plain| <= {B_TOL} * max |plain|; a sample may differ only where the "
        f"plain version's top two race scores are within 1 - exp(-2 err / T) "
        f"of each other, or its k-th and (k+1)-th logits within 2 err (err: "
        f"that step's logit error, T: temperature, k: top-k)")
    res_b = check_kernel_b(dev)
    for r in res_b:
        log(f"kernel B {r['plan']} B={r['B']}: logits max_abs_err "
            f"{r['max_abs_err']:.3e} (peak {r['peak']:.3f}), near-ties "
            f"{r['ties']} {r['flips']}, ok={r['ok']}  {fmt_times(r)}; streamed floor "
            f"{r.get('streamed_floor_ms', 0):.4f} ms  [{card}]")
        ok &= r["ok"]
    report["kernel_b"] = res_b
    torch.cuda.empty_cache()

    # 6. kernel E (int4 matmul) at the depth decoder's matrices
    res_e = check_kernel_e(dev)
    for r in res_e:
        log(f"kernel E {r['name']} {r['K']}x{r['O']} M={r['M']}: max_abs_err "
            f"{r['max_abs_err']:.3e} ok={r['ok']}  {fmt_times(r)} (library: "
            f"torch._weight_int4pack_mm, max |library - plain| "
            f"{r.get('library_err')}); bf16 torch.matmul on the dequantised "
            f"weight {r.get('bf16_matmul_ms', 0):.4f} ms  [{card}]")
        ok &= r["ok"]
    report["kernel_e"] = res_e

    # 7. kernel F (decode attention over unmerged slabs, kernel A's code)
    res_f, f_launches = check_kernel_f(dev)
    for r in res_f:
        log(f"kernel F B={r['B']} live~{r['live']}: max_abs_err "
            f"{r['max_abs_err']:.3e} ok={r['ok']}  {fmt_times(r)}  [{card}]")
        ok &= r["ok"]
    report["kernel_f"] = res_f

    # 7b. kernel P against its plain version, then the probes P1-P4
    t0 = time.perf_counter()
    res_p = check_kernel_p(dev)
    bad = [r for r in res_p if not r["ok"]]
    log(f"kernel P (gemv_probe) vs plain, {len(res_p)} cases (5 modes x 2 loads "
        f"x M in 5/16/32 x small / tiles / global x): y form max_abs_err "
        f"{max(r['max_abs_err'] for r in res_p):.3e} (tolerance {ATOL} + {RTOL} "
        f"* |plain|), sum form max err / sum|y| "
        f"{max(r['sum_err'] / r['sum_scale'] for r in res_p):.3e} (tolerance "
        f"{P_SUM_TOL}); failing: {bad}  [{card}]")
    ok &= not bad
    report["kernel_p"] = res_p
    probes = run_probes(dev, card)
    log(f"probe phase: {time.perf_counter() - t0:.1f} s")
    ok &= probes["ok"]
    report["probes"] = probes
    torch.cuda.empty_cache()

    # 8. small model vs CPU fp32
    small = check_small_model(dev)
    log(f"small model on the card vs CPU fp32 (of peak, limit {REF_TOL}): "
        f"lm {small['lm_rel_err']:.3e}, vocoder middles "
        f"{small['voc_middles_rel_err']:.3e}, tails "
        f"{small['voc_tails_rel_err']:.3e} ok={small['ok']}")
    ok &= small["ok"]
    report["small_model"] = small
    torch.cuda.empty_cache()

    # 9. the main paths at flagship width: the serving preset, the bf16
    # path of slice 1, the int4 depth decoder
    import dataclasses
    from fireredtts2_tpu_torch.config import EngineConfig

    base = EngineConfig()
    runs = {
        "preset": dict(config=dataclasses.replace(base, llm=dataclasses.replace(
            base.llm, quantize_backbone=True, fused_depth_plan=PRESET)),
            max_ms=4000.0, per_frame=("fused_depth_decode",)),
        "bf16": dict(config=base, max_ms=2000.0, trace=False),
        "int4_depth": dict(config=dataclasses.replace(base, llm=dataclasses.replace(
            base.llm, quantize_depth=True, quantize_depth_bits=4)),
            max_ms=800.0, stream=False, trace=False,
            must_launch=("flash_decode_gqa1", "flash_decode_update_bounded",
                         "int4_matmul")),
    }
    main_launches: dict = {}
    for label, kw in runs.items():
        eng = run_engine(dev, card, **kw)
        g = eng["generate"]
        for part in ("stream", "generate"):
            for k, n in eng.get(part, {}).get("launches", {}).items():
                main_launches[k] = main_launches.get(k, 0) + n
        if "stream" in eng:
            s = eng["stream"]
            log(f"[{label}] generate_stream: first packet {s['first_packet_ms']} "
                f"ms, RTF {s['rtf']:.3f} ({s['audio_s']:.2f} s audio), launches "
                f"{s['launches']}  [{card}]")
        log(f"[{label}] generate: {eng['frames']} frames, RTF {g['rtf']:.3f}, LM "
            f"{g['lm_ms_per_frame']:.2f} ms/frame, vocoder "
            f"{g['vocode_s'] * 1e3:.1f} ms, launches {g['launches']}  [{card}]")
        log(f"[{label}] stream vs generate audio (of peak): "
            f"{eng['stream_vs_generate_rel_err']}")
        pr = eng["profile"]
        if pr:
            log(f"[{label}] traced generate: {pr['frames']} frames, wall "
                f"{pr['wall_s']:.3f} s, device {pr['device_s']:.3f} s, busy share "
                f"{pr['busy_share']:.3f}, {pr['kernel_launches']} CUDA kernel "
                f"launches ({pr['kernel_launches'] / max(pr['frames'] or 1, 1):.0f}"
                f" per frame)  [{card}]")
            for name, ms in pr["top"]:
                log(f"  {ms:9.3f} ms  {name}")
        log(f"[{label}] engine checks: {eng['checks']}")
        ok &= eng["ok"]
        report[f"engine_{label}"] = eng
        torch.cuda.empty_cache()

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    if not ok:
        log("chip_smoke: FAILED (see the lines above)")
        return 1

    def pick(rows, **want):
        return next(r for r in rows if all(r[k] == v for k, v in want.items()))

    def entry(name, source, replaces, launches, rows, main, **extra):
        """`ms`/`plain_ms`: device time from the profiler ("device"), or
        where the trace held none the CUDA-event time of calls queued
        behind a device-side spin ("queued"); `ms_kind`/`plain_ms_kind`
        say which."""
        def timed(key):
            if main[key] is not None:
                return main[key], "device"
            return main[key.replace("ms", "queued_ms")], "queued"
        (ms, ms_kind), (plain_ms, plain_kind) = timed("ms"), timed("plain_ms")
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, ok=all(r["ok"] for r in rows),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=ms, ms_kind=ms_kind, plain_ms=plain_ms, plain_ms_kind=plain_kind,
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main.get("library_ms"), **extra)

    csrc = "fireredtts2_tpu_torch/csrc/"
    kernels = [
        entry("flash_decode_gqa1", csrc + "flash_decode_gqa1.cu",
              "fireredtts2_tpu/ops/pallas_flash.py:600",
              main_launches["flash_decode_gqa1"], res_a,
              pick(res_a, B=1, live=3000)),
        entry("fused_depth_decode", csrc + "fused_depth_decode.cu",
              "fireredtts2_tpu/ops/pallas_depth.py:749",
              main_launches["fused_depth_decode"], res_b,
              pick(res_b, plan=PRESET, B=1)),
        entry("flash_decode_update_bounded", csrc + "flash_decode_update.cu",
              "fireredtts2_tpu/ops/pallas_flash.py:352",
              main_launches["flash_decode_update_bounded"], res_c,
              pick(res_c, B=1, S=64, live=2900)),
        entry("flash_decode_bounded", csrc + "flash_decode_update.cu",
              "fireredtts2_tpu/ops/pallas_flash.py:323",
              res_d["launches"], [res_d], res_d, launched_in="check",
              served_by="flash_decode_update_bounded"),
        entry("int4_matmul", csrc + "int4_matmul.cu",
              "fireredtts2_tpu/ops/pallas_int4.py:74",
              main_launches["int4_matmul"], res_e,
              pick(res_e, name="w_gate", M=1)),
        entry("pallas_decode_attention", csrc + "flash_decode_gqa1.cu",
              "fireredtts2_tpu/ops/pallas_attention.py:176", f_launches, res_f,
              pick(res_f, B=1, live=3000), launched_in="check",
              served_by="flash_decode_gqa1"),
    ]

    def p_entry(name, replaces, row, rows, **extra):
        """A probe's entry: kernel P in the probe phase, 0 launches on the
        main paths; `ok` and `max_abs_err` (y form, against the plain
        version) over `rows`: its tool's probes, each checked at its own
        shapes. Times are CUDA-event times of calls queued on the card."""
        return dict(
            name=name, route="cuda", source=csrc + "gemv_probe.cu",
            replaces=replaces, launches=main_launches.get("gemv_probe", 0),
            launched_in="probe", ok=all(r["ok"] for r in rows),
            max_abs_err=max(r["max_abs_err"] for r in rows), ms=row["ms"],
            ms_kind="queued", plain_ms=row["plain_ms"], plain_ms_kind="queued",
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], library_call=row["library_call"],
            library_note=row["library_note"],
            streamed_floor_ms=row["streamed_floor_ms"], **extra)

    b1 = pick(res_b, plan=PRESET, B=1)
    abl0 = probes["p2"]["abl0"]
    kernels += [
        p_entry("gemv_probe:probe_depth_kernel", "tools/probe_depth_kernel.py:74",
                probes["p1"]["int8_reuse"][64], list(probe_rows(probes["p1"])),
                shape="int8 reuse, (8, 1536) x 64 MB, 15 steps",
                library_calls="15 x one per step"),
        dict(name="fused_depth_decode[FRT_ABL]:ablate_depth", route="cuda",
             source=csrc + "fused_depth_decode.cu",
             replaces="tools/_ablate_depth_kernel.py:714",
             launches=0, launched_in="probe",
             ok=all(c["ok"] for c in abl0.values()),
             # the FRT_ABL=0 build's logits against the plain version's
             max_abs_err=max(c["plain_max_abs_err"] for c in abl0.values()),
             ms=probes["p2"][1]["none"]["ms"], ms_kind="queued",
             plain_ms=b1["plain_ms"] or b1["plain_queued_ms"],
             plain_ms_kind="device" if b1["plain_ms"] else "queued",
             bound_ms=b1["bound_ms"], bound_by=b1["bound_by"], library_ms=None,
             library_note="no single PyTorch call",
             shape="preset plan, B=1, FRT_ABL=0 (the serving code); every "
                   "ablation in the probes line",
             serves="tools/probe_s8_chunked.py:158 (probe_step)"),
        p_entry("gemv_probe:probe_dequant", "tools/probe_dequant.py:55",
                probes["p3"][896]["int8"], list(probe_rows(probes["p3"])),
                shape="int8 convert+dot, (8, 896) x 48 MB, 15 steps",
                library_calls="15 x one per step"),
        p_entry("gemv_probe:probe_s8_chunked", "tools/probe_s8_chunked.py:64",
                probes["p4a"]["s8s8 M=32"], list(probe_rows(probes["p4a"])),
                shape="s8s8, M=32, kernel B's MLP schedule, 16 steps",
                library_calls="16 x 24 matrices a step"),
    ]
    log(json.dumps({"probes": probe_summary(probes)}))
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
