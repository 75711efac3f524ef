"""Kernel A's split size swept on the card: the serving plan beside builds
with a fixed split.

    python -m fireredtts2_tpu_torch.tools.sweep_gqa1 [--splits 32,64,128,256]
        [--out chiprun_out/sweep_gqa1.json]

Kernel A (``csrc/flash_decode_gqa1.cu``) takes its split from the
library's plan (``frt_gqa1_plan``): the fewest waves of resident blocks over
the whole slab. A build with ``FRT_GQA1_SPLIT=<slots>`` fixes the split
instead. Fewer, longer splits pull more bytes through each SM; more,
shorter ones leave more partials for the last block to merge. This tool
builds every variant (one nvcc each, in parallel; with ``--nogrow`` each
split also as ``FRT_GQA1_NOGROW``, whose shared memory does not grow to
hold the merge's partials) and, at the flagship LM
slab (28, B, 3584, 256) bf16 with B in {1, 8} and live windows near 16,
200, 1000 and 3000 slots, checks each build against the plain version and
times it by CUDA events over calls queued on the card, the calls walking
the slab's 28 layers so that K/V come from device memory, in turns (plan,
variants..., variants reversed, plan). Prints one line per case and the
intercept and slope of each build's time over the live length at B=1
(its fixed cost and its stream rate). Needs a CUDA device.

With ``--trace`` it also builds ``FRT_GQA1_TRACE`` variants, in which
thread 0 of each live block of stream 0, kv head 0 stamps the device clock
at its phase edges, and splits one call at B=1 (~200, ~1000 and ~3000
live) and at B=8 (~3000; stream 0's blocks) (the last of three, each on
another layer) into the blocks' phases (mean us over the live blocks: copy
issue, K's landing, scores and P with V's landing, P V, partials and the
merge count) and the merging block's (first chunk's landing, its sums,
output), beside the whole call's span from the first block's start.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os

import numpy as np
import torch

from fireredtts2_tpu_torch.ops import cuda_build
from fireredtts2_tpu_torch.ops import flash_decode as fd
from fireredtts2_tpu_torch.tools._common import card_line, cuda_device, queued_ms

ATOL, RTOL = 1e-2, 2e-2        # kernel vs plain, bf16 (chip_smoke.py's)
L, T, HKV, G, DH = 28, 3584, 2, 6, 128
CASES = [(1, 16), (1, 200), (1, 1000), (1, 3000), (8, 200), (8, 3000)]


def inputs(dev, B: int, live: int, seed: int = 0):
    """Queries, a bf16 slab pair and per-stream windows near `live`."""
    gen = torch.Generator(device=dev).manual_seed(B * 7919 + live)
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q = rnd(B, HKV * G, DH)
    k4, v4 = rnd(L, B, T, HKV * DH), rnd(L, B, T, HKV * DH)
    pad = min(40, max(live // 4, 1))
    q_start = rng.integers(0, pad, B)
    q_end = np.minimum(live + rng.integers(-min(20, pad), min(20, pad), B), T)
    qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
    qe = torch.tensor(q_end, dtype=torch.int32, device=dev)
    lo = qs.min()
    hi = qe.max()
    return q, k4, v4, qs, qe, lo, hi


def name(defines: tuple[str, ...]) -> str:
    return "+".join(defines) or "plan"


def sweep(dev, splits=(32, 64, 128, 256), reps: int = 56,
          nogrow: bool = False) -> list[dict]:
    variants = [()] + [(f"FRT_GQA1_SPLIT={s}",) for s in splits]
    if nogrow:
        variants += [(f"FRT_GQA1_SPLIT={s}", "FRT_GQA1_NOGROW") for s in splits]
    cuda_build.build([("flash_decode_gqa1", d) for d in variants])
    rows = []
    for B, live in CASES:
        q, k4, v4, qs, qe, lo, hi = inputs(dev, B, live)
        ref = fd.flash_decode_gqa1_plain(q, k4, v4, L - 1, qs, qe, lo, hi)
        row = dict(B=B, live=live, plan_split=fd.gqa1_plan(
            B, HKV, G, T, DH, dev.index or 0)[0], ms={}, ok={})
        for d in variants:
            out = fd._gqa1_launch(q, k4[L - 1], v4[L - 1], qs, qe, lo, hi, d)
            o, r = out.float(), ref.float()
            row["ok"][name(d)] = bool(torch.isfinite(o).all()) \
                and bool(torch.allclose(o, r, atol=ATOL, rtol=RTOL))
        order = variants + variants[::-1]
        times: dict = {}
        for d in order:
            step = itertools.count()

            def call(d=d):
                layer = next(step) % L
                return fd._gqa1_launch(q, k4[layer], v4[layer], qs, qe, lo,
                                       hi, d)
            times.setdefault(d, []).append(queued_ms(call, reps, warmup=3))
        for d, ts in times.items():
            row["ms"][name(d)] = sum(ts) / len(ts)
        rows.append(row)
        del q, k4, v4
        torch.cuda.empty_cache()
    return rows


def fit(rows: list[dict]) -> dict:
    """Per build, least squares of queued ms on the live length at B=1:
    the intercept (fixed cost, ms) and the slope (ms per 1000 slots)."""
    b1 = [r for r in rows if r["B"] == 1]
    x = np.array([r["live"] for r in b1], dtype=float)
    out = {}
    for name in b1[0]["ms"]:
        y = np.array([r["ms"][name] for r in b1])
        slope, icpt = np.polyfit(x, y, 1)
        out[name] = dict(fixed_ms=float(icpt), ms_per_1000_slots=float(slope * 1e3))
    return out


BLOCK_PHASES = ("issue", "k_landed", "scores_p_v_landed", "pv",
                "partials_counted")
MERGE_PHASES = ("chunk_landed", "sums", "output")


def trace(dev, B: int, live: int, split: int) -> dict:
    """One call of a trace build split into phases (us)."""
    d = ("FRT_GQA1_TRACE", f"FRT_GQA1_SPLIT={split}")
    lib = fd._gqa1_lib(d)
    lib.frt_gqa1_trace.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.frt_gqa1_trace.restype = ctypes.c_int
    q, k4, v4, qs, qe, lo, hi = inputs(dev, B, live)
    buf = (ctypes.c_ulonglong * 4096)()
    shape = (ctypes.c_int * 2)()
    for layer in range(3):
        torch.cuda.synchronize()
        assert lib.frt_gqa1_trace(buf, shape) == 0      # clear the stamps
        fd._gqa1_launch(q, k4[layer], v4[layer], qs, qe, lo, hi, d)
    torch.cuda.synchronize()
    assert lib.frt_gqa1_trace(buf, shape) == 0
    st = np.array(buf[:shape[0] * shape[1]], dtype=np.int64).reshape(
        shape[0], shape[1])
    live_rows = st[st[:, 0] > 0]
    t0 = live_rows[:, 0].min()
    us = (live_rows - t0) / 1e3
    blocks = {name: float(np.mean(us[:, i + 1] - us[:, i]))
              for i, name in enumerate(BLOCK_PHASES) if (us[:, i + 1] > 0).all()}
    merger = live_rows[live_rows[:, 6] > 0]
    merge = {}
    if len(merger):
        m = (merger[0] - t0) / 1e3
        merge = {name: float(m[6 + i] - m[5 + i]) for i, name in
                 enumerate(MERGE_PHASES)}
    end = (live_rows[:, 8].max() - t0) / 1e3
    return dict(B=B, live=live, split=split, blocks_live=len(live_rows),
                start_spread_us=float(us[:, 0].max()), block_us=blocks,
                merge_us=merge, span_us=float(end))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splits", default="32,64,128,256")
    ap.add_argument("--out", default="chiprun_out/sweep_gqa1.json")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--nogrow", action="store_true",
                    help="also each split built with FRT_GQA1_NOGROW")
    args = ap.parse_args(argv)
    dev = cuda_device()
    card = card_line()
    rows = sweep(dev, tuple(int(s) for s in args.splits.split(",")),
                 nogrow=args.nogrow)
    ok = True
    for r in rows:
        ok &= all(r["ok"].values())
        cells = ", ".join(f"{k} {v:.4f}" for k, v in r["ms"].items())
        print(f"kernel A B={r['B']} live~{r['live']} (plan split "
              f"{r['plan_split']}): queued ms {cells}; ok {r['ok']}  [{card}]")
    fits = fit(rows)
    for name, f in fits.items():
        print(f"kernel A {name}, B=1: fixed {f['fixed_ms']:.4f} ms + "
              f"{f['ms_per_1000_slots']:.4f} ms per 1000 live slots  [{card}]")
    traces = []
    if args.trace:
        splits = tuple(int(s) for s in args.splits.split(","))
        cuda_build.build([("flash_decode_gqa1", ("FRT_GQA1_TRACE",
                                                 f"FRT_GQA1_SPLIT={s}"))
                          for s in splits])
        for B, live in ((1, 200), (1, 1000), (1, 3000), (8, 3000)):
            for split in splits:
                tr = trace(dev, B, live, split)
                traces.append(tr)
                blk = ", ".join(f"{k} {v:.2f}" for k, v in tr["block_us"].items())
                mrg = ", ".join(f"{k} {v:.2f}" for k, v in tr["merge_us"].items())
                print(f"trace B={B} live~{live} split {split}: {tr['blocks_live']} "
                      f"live blocks, starts within {tr['start_spread_us']:.2f} us; "
                      f"block us: {blk}; merge us: {mrg or 'none'}; span "
                      f"{tr['span_us']:.2f} us  [{card}]", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, rows=rows, fit=fits, traces=traces), f,
                  indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
