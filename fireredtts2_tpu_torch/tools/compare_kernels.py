"""Times of kernels A-F from two checkouts on one card, in turns.

    python -m fireredtts2_tpu_torch.tools.compare_kernels [OTHER_DIR]
        [--kernels a,b,c,d,e,f] [--out chiprun_out/compare_kernels.json]

Runs ``chip_smoke.py``'s ``check_kernel_a`` (the flagship LM slab at B = 1
and 8, ~200 and ~3000 live, and whatever further cases that checkout's
check has, e.g. the B=1 live sweep), ``check_kernel_b`` (the preset, r4
and a8 plans at B = 1 and 8, checked against the plain version and timed
alone by queued CUDA events), ``check_kernel_c``, ``check_kernel_d``,
``check_kernel_e`` and ``check_kernel_f`` (every case at the flagship
shapes, checked against the plain version, timed beside the library call)
of OTHER_DIR -- another checkout of the repo, e.g. an earlier commit
unpacked with ``git archive`` -- and of this checkout, each in a process
of its own that builds its own kernels, in the order other, this, this,
other. Without OTHER_DIR it runs this checkout once. Prints one line per
case (cases matched by their shape keys; a case one checkout lacks shows
n/a) with the device time of each run (kernel B: the CUDA-event time of
calls queued on the card, since the profiler loses some of its launches)
and writes every result to ``--out``. Needs a CUDA device.

    python -m fireredtts2_tpu_torch.tools.compare_kernels OTHER --kernels b
    (kernel B alone: ~1 min a run)
    python -m fireredtts2_tpu_torch.tools.compare_kernels OTHER --kernels a,f
    (kernels A and F: the LM's decode attention)

``generate`` among ``--kernels`` (not in the default) also traces the
serving preset's ``generate`` of 10 frames at flagship width (random
weights, after a warm-up call) in each run: CUDA launches, device time, and
kernel A's time and launches by name (``gqa1``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_RUN = r"""
import json, sys
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kernels = sys.argv[1].split(",")
lm, voc = cs.FLAGSHIP["lm"], cs.FLAGSHIP["voc"]
out = {"card": cs.card_line()}
if "a" in kernels:
    out["a"] = cs.check_kernel_a("cuda", lm["L"], lm["T"], lm["Hkv"], lm["G"],
                                 lm["Dh"], lm["reps"])
if "b" in kernels:
    # checked as chip_smoke checks it, timed here alone: queued CUDA events
    # of the kernel (the plain version's time is chip_smoke's to report)
    from fireredtts2_tpu_torch.ops import depth_chain as dc
    out["b"] = cs.check_kernel_b("cuda", timed=False)
    bundles = {}
    for r in out["b"]:
        if r["plan"] not in bundles:
            bundles[r["plan"]] = cs.depth_bundle("cuda", r["plan"])
        cfg, bundle, gen = bundles[r["plan"]]
        B, ncb, V = r["B"], cfg.audio_num_codebooks, cfg.audio_vocab_size
        last_h = cs._rnd(gen, B, cfg.backbone.embed_dim)
        c0 = torch.randint(0, V, (B,), generator=gen, device="cuda",
                           dtype=torch.int32)
        noise = torch.empty((B, ncb, V), device="cuda").exponential_(generator=gen)
        r["queued_ms"] = cs.queued_ms(lambda: dc.fused_depth_decode(
            bundle, cfg, last_h, c0, noise, plan=r["plan"]), 20)
    del bundles
if "c" in kernels:
    out["c"] = cs.check_kernel_c("cuda", voc["L"], voc["T"], voc["H"],
                                 voc["Dh"], voc["reps"])
if "d" in kernels:
    out["d"] = [cs.check_kernel_d("cuda", voc["T"], voc["H"], voc["Dh"])]
if "e" in kernels:
    out["e"] = cs.check_kernel_e("cuda", ms=(1, 2, 8, 16, 32))
if "f" in kernels:
    out["f"] = cs.check_kernel_f("cuda")[0]
if "generate" in kernels:
    # the preset's generate of 10 frames traced, kernel A's kernels by name
    import dataclasses, time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from fireredtts2_tpu_torch.config import EngineConfig
    from fireredtts2_tpu_torch.engine import FireRedTTS2Engine
    base = EngineConfig()
    eng = FireRedTTS2Engine(dataclasses.replace(base, llm=dataclasses.replace(
        base.llm, quantize_backbone=True, fused_depth_plan=cs.PRESET)), seed=0,
        device="cuda")
    eng.generate("Warm up.", "[S1]", max_audio_length_ms=400, utt_seed=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate("Profile this.", "[S1]", max_audio_length_ms=800, utt_seed=3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    a = [e for e in ev if "gqa1" in e.name]
    frames = eng.last_stats["frames"]
    device_ms = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    out["generate"] = [dict(
        ok=True, frames=frames, wall_ms=wall * 1e3, device_ms=device_ms,
        launches=len(ev), kernel_a_launches=len(a),
        ms=sum(e.time_range.elapsed_us() for e in a) / 1e3)]
    out["generate"][0]["kernel_a_share"] = out["generate"][0]["ms"] / device_ms
    del eng
print("RESULT " + json.dumps(out, default=str), flush=True)
"""

_KEYS = {"a": ("B", "live"), "b": ("plan", "B"),
         "c": ("B", "S", "live", "overshoot"), "d": (), "e": ("name", "M"),
         "f": ("B", "live"), "generate": ()}
_TIME = {"b": "queued_ms"}     # kernel B: queued CUDA events, else device


def _key(kernel: str, case: dict) -> tuple:
    """A case's shape key, which matches it across checkouts."""
    return tuple((f, case.get(f)) for f in _KEYS[kernel])


def run(root: str, kernels: str) -> dict:
    """One process in `root`: the checks' results, by kernel."""
    proc = subprocess.run([sys.executable, "-c", _RUN, kernels], cwd=root,
                          capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{root}: exit {proc.returncode}\n{proc.stdout[-4000:]}"
                       f"\n{proc.stderr[-4000:]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", help="another checkout of the repo")
    ap.add_argument("--kernels", default="a,b,c,d,e,f")
    ap.add_argument("--out", default="chiprun_out/compare_kernels.json")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    order = [("this", here)]
    if args.other:
        other = os.path.abspath(args.other)
        order = [("other", other), ("this", here), ("this", here),
                 ("other", other)]
    runs = []
    for label, root in order:
        res = run(root, args.kernels)
        runs.append((label, res))
        print(f"{label} run done: {res['card']}", flush=True)
    ok = True
    for k in args.kernels.split(","):
        keys = list(dict.fromkeys(_key(k, c) for _, res in runs for c in res[k]))
        for want in keys:
            row, last = [], None
            for label, res in runs:
                r = next((c for c in res[k] if _key(k, c) == want), None)
                if r is None:
                    row.append(f"{label} n/a")
                    continue
                ok &= bool(r["ok"])
                ms = r.get(_TIME.get(k, "ms"))
                if ms is None:
                    ms = r.get("queued_ms")
                row.append(f"{label} {ms} (ok={r['ok']})")
                last = r
            if k == "generate":
                print("preset generate traced: " + "; ".join(
                    f"{label} kernel A {r['ms']:.3f} ms of {r['device_ms']:.3f} "
                    f"device ms ({r['kernel_a_share']:.4f}) in "
                    f"{r['kernel_a_launches']} launches, {r['launches']} CUDA "
                    f"launches over {r['frames']} frames"
                    for label, res in runs for r in res[k]), flush=True)
                continue
            print(f"kernel {k.upper()} {dict(want)}: " + "; ".join(row)
                  + f"; bound {last.get('bound_ms')}; library "
                  f"{last.get('library_ms')}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump([{"run": label, **res} for label, res in runs], f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
