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
5. a small-width model through the kernels on the card against the same
   weights on the CPU in float32 (LM layers and the streaming vocoder);
6. the flagship EngineConfig() with random weights: generate_stream and
   generate on one text and one utterance seed, ~4 s of audio each, with
   every launch count set to 0 just before each run and read just after.
   Audio must be finite and one 1920-sample chunk per frame, both runs
   must sample the same frames, and both kernels must have launched.

Tolerance of a kernel against its plain version (bf16 in, bf16 out, fp32
inside both): |kernel - plain| <= 1e-2 + 2e-2 * |plain| elementwise. Both
round their output to bf16 (one ulp is 2^-8 relative) and round the
softmax probabilities to bf16 at different points (the kernel per KV
split or tile before normalising, the plain version after).

Kernel times are taken in turns (plain, kernel, kernel, plain) in this one
process after warm-up: the device time of the CUDA kernels a call
launches (torch.profiler), and the CUDA-event time per call, which also
counts the host's launch gaps. Timed calls of kernels A and C walk the
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
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ATOL, RTOL = 1e-2, 2e-2          # kernel vs plain, bf16 (see the docstring)
REF_TOL = 0.1                    # small model on the card vs CPU fp32, of peak
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
    from a torch.profiler trace; None when the trace shows no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
    except Exception as e:   # the profiler is optional here
        log(f"profiler unavailable: {e!r}")
        return None
    return us / reps / 1e3 if us > 0 else None


def time_pair(kernel, plain, reps: int, warmup: int = 3) -> dict:
    """Per call, kernel vs plain, in turns P K K P: `ms`/`plain_ms` are the
    device time of the launched CUDA kernels (profiler), `wall_ms`/
    `plain_wall_ms` CUDA-event time per call including the host's launch
    gaps."""
    import torch

    def events(fn):
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

    p1, k1, k2, p2 = events(plain), events(kernel), events(kernel), events(plain)
    pd1, kd1, kd2, pd2 = (device_ms(plain, reps), device_ms(kernel, reps),
                          device_ms(kernel, reps), device_ms(plain, reps))
    mean = (lambda a, b: None if a is None or b is None else (a + b) / 2)
    return dict(ms=mean(kd1, kd2), plain_ms=mean(pd1, pd2),
                wall_ms=(k1 + k2) / 2, plain_wall_ms=(p1 + p2) / 2)


def fmt_times(r: dict) -> str:
    def f(x):
        return "n/a" if x is None else f"{x:.4f}"
    return (f"device ms: kernel {f(r.get('ms'))}, plain {f(r.get('plain_ms'))}; "
            f"per-call wall ms: kernel {f(r.get('wall_ms'))}, "
            f"plain {f(r.get('plain_wall_ms'))}")


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
        times = {}
        if timed:
            step = itertools.count()
            times = time_pair(
                lambda: fd.flash_decode_gqa1(q, k4, v4, next(step) % L, qs, qe,
                                             lo, hi),
                lambda: fd.flash_decode_gqa1_plain(q, k4, v4, next(step) % L,
                                                   qs, qe, lo, hi), reps)
        results.append(dict(B=B, live=live, max_abs_err=err, ok=ok, **times))
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
        times = {}
        if timed:
            step = itertools.count()
            times = time_pair(
                lambda: fd.flash_decode_update_bounded(
                    q, nk, nv, kk, vk, next(step) % L, pos_t, q_end, live_hi),
                lambda: fd.flash_decode_update_bounded_plain(
                    q, nk, nv, kp, vp, next(step) % L, pos_t, q_end, live_hi),
                reps)
        results.append(dict(B=B, S=S, live=live, overshoot=overshoot,
                            max_abs_err=err, ok=ok and rows_ok,
                            rows_identical=rows_ok, **times))
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

    err, ok = _compare(kernel(), plain())
    times = time_pair(kernel, plain, reps) if timed else {}
    return dict(max_abs_err=err, ok=ok, **times)


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


def run_engine(dev, card: str, config=None, max_ms: float = 4000.0):
    import torch
    from fireredtts2_tpu_torch.config import EngineConfig
    from fireredtts2_tpu_torch.engine import FireRedTTS2Engine
    from fireredtts2_tpu_torch.ops import flash_decode as fd

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    eng = FireRedTTS2Engine(config or EngineConfig(), seed=0, device=dev)
    sync()
    init_s = time.perf_counter() - t0
    log(f"engine: random weights on {dev} in {init_s:.1f} s")
    list(eng.generate_stream("Warm up.", "[S1]", max_audio_length_ms=400,
                             utt_seed=1))                    # warm-up
    sync()
    sr = eng.output_sample_rate
    seed = 2024

    fd.reset_launch_counts()
    t0 = time.perf_counter()
    chunks = list(eng.generate_stream(TEXT, "[S1]", max_audio_length_ms=max_ms,
                                      utt_seed=seed))
    sync()
    stream_wall = time.perf_counter() - t0
    stream_counts = fd.launch_counts()
    fpl = eng._first_packet_s
    stream_audio = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    stream_tokens = eng.last_tokens

    fd.reset_launch_counts()
    t0 = time.perf_counter()
    audio = eng.generate(TEXT, "[S1]", max_audio_length_ms=max_ms, utt_seed=seed)
    sync()
    gen_wall = time.perf_counter() - t0
    gen_counts = fd.launch_counts()
    stats = dict(eng.last_stats)
    gen_tokens = eng.last_tokens

    frames = stats["frames"]
    checks = {
        "stream_finite": bool(np.isfinite(stream_audio).all()),
        "generate_finite": bool(np.isfinite(audio).all()),
        "stream_len": len(stream_audio) == len(stream_tokens) * 1920 > 0,
        "generate_len": len(audio) == frames * 1920 > 0,
        "same_frames": stream_tokens.shape == gen_tokens.shape
        and bool(np.array_equal(stream_tokens, gen_tokens)),
    }
    for name, counts in (("stream", stream_counts), ("generate", gen_counts)):
        for k in ("flash_decode_gqa1", "flash_decode_update_bounded"):
            checks[f"{name}_{k}_launched"] = counts[k] > 0
    wave_err = None
    if len(stream_audio) == len(audio) > 0:
        wave_err = float(np.abs(stream_audio - audio).max()
                         / max(np.abs(audio).max(), 1e-9))
    profile = trace_generate(eng, dev)
    result = dict(
        card=card, init_s=init_s, frames=frames, profile=profile,
        stream=dict(wall_s=stream_wall, first_packet_ms=fpl * 1e3 if fpl else None,
                    audio_s=len(stream_audio) / sr,
                    rtf=len(stream_audio) / sr / stream_wall,
                    launches=stream_counts),
        generate=dict(wall_s=gen_wall, audio_s=len(audio) / sr,
                      rtf=len(audio) / sr / gen_wall,
                      lm_ms_per_frame=stats["lm_s"] / max(frames, 1) * 1e3,
                      vocode_s=stats["vocode_s"], launches=gen_counts),
        stream_vs_generate_rel_err=wave_err, checks=checks,
        ok=all(checks.values()))
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
    libs = cuda_build.build()
    build_s = time.perf_counter() - t0
    log(f"build: {len(libs)} kernel libraries in {build_s:.1f} s "
        f"({', '.join(sorted(libs))})")
    for name, text in cuda_build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")
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

    # 5. small model vs CPU fp32
    small = check_small_model(dev)
    log(f"small model on the card vs CPU fp32 (of peak, limit {REF_TOL}): "
        f"lm {small['lm_rel_err']:.3e}, vocoder middles "
        f"{small['voc_middles_rel_err']:.3e}, tails "
        f"{small['voc_tails_rel_err']:.3e} ok={small['ok']}")
    ok &= small["ok"]
    report["small_model"] = small

    # 6. the main path at flagship width
    eng = run_engine(dev, card)
    s, g = eng["stream"], eng["generate"]
    log(f"generate_stream: first packet {s['first_packet_ms']} ms, RTF "
        f"{s['rtf']:.3f} ({s['audio_s']:.2f} s audio), launches "
        f"{s['launches']}  [{card}]")
    log(f"generate: {eng['frames']} frames, RTF {g['rtf']:.3f}, LM "
        f"{g['lm_ms_per_frame']:.2f} ms/frame, "
        f"vocoder {g['vocode_s'] * 1e3:.1f} ms, launches {g['launches']}  [{card}]")
    log(f"stream vs generate audio (of peak): {eng['stream_vs_generate_rel_err']}")
    pr = eng["profile"]
    if pr:
        log(f"traced generate: {pr['frames']} frames, wall {pr['wall_s']:.3f} s, "
            f"device {pr['device_s']:.3f} s, busy share {pr['busy_share']:.3f}, "
            f"{pr['kernel_launches']} kernel launches  [{card}]")
        for name, ms in pr["top"]:
            log(f"  {ms:9.3f} ms  {name}")
    log(f"engine checks: {eng['checks']}")
    ok &= eng["ok"]
    report["engine"] = eng

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    if not ok:
        log("chip_smoke: FAILED (see the lines above)")
        return 1

    def pick(rows, **want):
        return next(r for r in rows if all(r[k] == v for k, v in want.items()))

    a_main = pick(res_a, B=1, live=3000)
    c_main = pick(res_c, B=1, S=64, live=2900)
    launches = {k: s["launches"][k] + g["launches"][k] for k in s["launches"]}
    kernels = [
        dict(name="flash_decode_gqa1", route="cuda",
             source="fireredtts2_tpu_torch/csrc/flash_decode_gqa1.cu",
             replaces="fireredtts2_tpu/ops/pallas_flash.py:600",
             launches=launches["flash_decode_gqa1"],
             ok=all(r["ok"] for r in res_a),
             max_abs_err=max(r["max_abs_err"] for r in res_a),
             ms=a_main["ms"] or a_main["wall_ms"],
             plain_ms=a_main["plain_ms"] or a_main["plain_wall_ms"]),
        dict(name="flash_decode_update_bounded", route="cuda",
             source="fireredtts2_tpu_torch/csrc/flash_decode_update.cu",
             replaces="fireredtts2_tpu/ops/pallas_flash.py:352",
             launches=launches["flash_decode_update_bounded"],
             ok=all(r["ok"] for r in res_c) and res_d["ok"],
             max_abs_err=max(r["max_abs_err"] for r in res_c),
             ms=c_main["ms"] or c_main["wall_ms"],
             plain_ms=c_main["plain_ms"] or c_main["plain_wall_ms"]),
    ]
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
