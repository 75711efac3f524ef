"""Kernel B's frame time, split by ablation builds (P2 and P4b).

Counterpart of the JAX package's ``tools/_ablate_depth_kernel.py`` (ABL =
halfdma | tinydma | dmas: the fused depth kernel with its streamed chunks
halved, cut to 128 columns, or its DMAs skipped) and of
``tools/probe_s8_chunked.py: probe_step`` (the step with and without
attention and sampling). On the card these are compile-time bits of
``csrc/fused_depth_decode.cu`` (``FRT_ABL``), each a separate library built
beside the serving one:

  half     : the MLP matrices (gate, up, down) stream half of each row
             (halfdma)
  tiny     : ... one ring chunk (448 bytes) of each row (tinydma)
  noload   : no weight copies: the producer releases the ring's stages
             unfilled; conversion and products kept (dmas)
  noattn   : no QKV, attention or wo phases (probe_step without attn)
  nosample : no logits or sampling phases (probe_step without samp)
  nosync   : the grid barrier becomes a block barrier (no TPU twin: the
             TPU's grid ran in order)
  noattncore: QKV, wo and their barriers kept, the attention core replaced
             by o = the fresh v (splits noattn into the core and the rest)

The numbers are garbage under every bit; the time is honest. Against
``none`` (the serving code, built as the variant FRT_ABL=0), the deltas
split a frame into weight bytes (half, tiny), per-byte conversion and
arithmetic (noload), attention and sampling, and barriers. The serving
wrapper (``ops/depth_chain.py: fused_depth_decode``) never loads these
builds; only this tool and ``chip_smoke.py`` do.

Repeat counts: one call is one frame (16 micro-steps), as the model runs
it; each time is the CUDA-event mean of calls queued on the card, beside
the host's time to issue one call.

A further build, ``trace`` (FRT_ABL_TRACE), ablates nothing: its numbers
are the serving build's, and thread 0 of blocks 0, G/2 and G-1 of the
grid stamps the device clock (globaltimer, ns) where it enters and leaves
each grid barrier, each phase's staging of its inputs, each tile (the wait
for its ring stages, the products and the epilogue), the attention core and
the logits barrier whose last block samples (``trace_frame``). The time
between consecutive stamps, summed by kind over one frame, splits a block's
frame into barrier waits, staging round trips, tiles, attention, sampling
and the rest; each stamp costs a timer read and a store.

    python -m fireredtts2_tpu_torch.tools.ablate_depth
"""

from __future__ import annotations

import ctypes

import torch

from fireredtts2_tpu_torch.config import LLMConfig
from fireredtts2_tpu_torch.models.lm.transformer import init_transformer_params
from fireredtts2_tpu_torch.ops import depth_chain as dc
from fireredtts2_tpu_torch.tools._common import (
    card_line, cuda_device, host_ms, queued_ms,
)

PRESET = "gate=r8,up=s8,down=s8"
BITS = {"half": 1, "tiny": 2, "noload": 4, "noattn": 8, "nosample": 16,
        "nosync": 32, "noattncore": 64}
VARIANTS = {"none": 0, **BITS}
TRACE = 128                     # FRT_ABL_TRACE: stamps, the numbers kept
EVENTS = ("bar_in", "bar_out", "stage_in", "stage_out", "tile_in", "tile_out",
          "attn_in", "attn_out", "samp_in", "samp_out")    # codes 1..10
SPANS = {"bar_in -> bar_out": "barrier", "stage_in -> stage_out": "staging",
         "tile_in -> tile_out": "tiles", "attn_in -> attn_out": "attention",
         "samp_in -> samp_out": "sampling"}


def build_jobs(variants=VARIANTS) -> list:
    """cuda_build.build jobs of kernel B's variants (FRT_ABL=0 included)
    and of its trace build."""
    return [("fused_depth_decode", (f"FRT_ABL={v}",))
            for v in (*variants.values(), TRACE)]


def random_depth_bundle(dev, plan: str = PRESET, seed: int = 0):
    """Kernel B's bundle at the flagship depth decoder (qwen-200m, 16
    codebooks of 2051, backbone width 1536) from random bf16 weights drawn
    on `dev`: (cfg, bundle, generator)."""
    cfg = LLMConfig(fused_depth_plan=plan)
    gen = torch.Generator(device=dev).manual_seed(seed)
    Db, Dd = cfg.backbone.embed_dim, cfg.decoder.embed_dim
    ncb, V = cfg.audio_num_codebooks, cfg.audio_vocab_size

    def uni(*shape, fan_in):
        u = torch.rand(shape, generator=gen, device=dev)
        return ((u * 2 - 1) / fan_in ** 0.5).to(torch.bfloat16)

    params = {
        "decoder": init_transformer_params(gen, cfg.decoder, torch.bfloat16, dev),
        "projection": uni(Db, Dd, fan_in=Db),
        "audio_embeddings": torch.randn((ncb * V, Db), generator=gen, device=dev
                                        ).to(torch.bfloat16) * 0.02,
        "audio_head": uni(ncb - 1, Dd, V, fan_in=Dd),
    }
    return cfg, dc.prepare_depth_chain(params, cfg, plan), gen


def frame_inputs(cfg, B: int, gen):
    """(last_h, c0, noise) of one frame for B streams."""
    dev = gen.device
    ncb, V = cfg.audio_num_codebooks, cfg.audio_vocab_size
    last_h = torch.randn((B, cfg.backbone.embed_dim), generator=gen,
                         device=dev).to(torch.bfloat16)
    c0 = torch.randint(0, V, (B,), generator=gen, device=dev, dtype=torch.int32)
    noise = torch.empty((B, ncb, V), device=dev).exponential_(generator=gen)
    return last_h, c0, noise


def run_variant(abl: int | None, bundle, cfg, inputs, plan: str = PRESET,
                **kw):
    """Kernel B through the build FRT_ABL=abl (None: the serving build)."""
    return dc.run_chain(dc.load_library(abl), bundle, cfg, *inputs, plan=plan,
                        **kw)


def abl0_matches_serving(bundle, cfg, inputs, plan: str = PRESET) -> dict:
    """The FRT_ABL=0 build against the serving build: samples, and with the
    same tokens forced the logits, must be identical bit for bit. Beside
    that, the build's logits against the plain version's with the same
    tokens forced: the largest difference and the plain version's peak."""
    ref, ref_logits = run_variant(None, bundle, cfg, inputs, plan,
                                  return_logits=True)
    s0 = run_variant(0, bundle, cfg, inputs, plan)
    f0, l0 = run_variant(0, bundle, cfg, inputs, plan, forced=ref,
                         return_logits=True)
    _, plain = dc.fused_depth_decode_plain(bundle, cfg, *inputs, plan=plan,
                                           forced=ref)
    torch.cuda.synchronize()
    return dict(samples_equal=bool(torch.equal(s0, ref)),
                forced_equal=bool(torch.equal(f0, ref)),
                logits_equal=bool(torch.equal(l0, ref_logits)),
                plain_max_abs_err=float((l0 - plain).abs().max()),
                plain_peak=float(plain.abs().max()))


def time_variants(bundle, cfg, B: int, gen, variants=VARIANTS,
                  plan: str = PRESET, reps: int = 10) -> dict:
    """ms per frame of each variant at B streams (queued CUDA events), the
    host's ms to issue one call, and the change from `none`."""
    inputs = frame_inputs(cfg, B, gen)
    out = {}
    for name, bits in variants.items():
        lib = dc.load_library(bits)

        def call():
            return dc.run_chain(lib, bundle, cfg, *inputs, plan=plan)
        out[name] = dict(bits=bits, ms=queued_ms(call, reps),
                         host_ms=host_ms(call, reps))
    base = out.get("none", {}).get("ms")
    for r in out.values():
        r["delta_ms"] = None if base is None else r["ms"] - base
    return out


def read_trace(lib) -> list[list[tuple[int, str]]]:
    """The trace build's stamps of its last launch, per traced block: (ns,
    event) in order."""
    shape = (ctypes.c_int * 2)()
    lib.frt_depth_chain_trace_shape(shape)
    slots, cap = shape
    buf = (ctypes.c_ulonglong * (slots * cap))()
    counts = (ctypes.c_int * slots)()
    err = lib.frt_depth_chain_trace(buf, counts)
    if err:
        raise RuntimeError(f"frt_depth_chain_trace: CUDA error {err}")
    return [[(buf[s * cap + i] >> 4, EVENTS[(buf[s * cap + i] & 15) - 1])
             for i in range(counts[s])] for s in range(slots)]


def split_trace(events: list[tuple[int, str]]) -> dict:
    """One block's frame: the stamps of each event, and the us between
    consecutive stamps summed by (from, to) pair and by kind (SPANS; every
    other pair is "between")."""
    pairs: dict[str, float] = {}
    for (t0, a), (t1, b) in zip(events, events[1:]):
        key = f"{a} -> {b}"
        pairs[key] = pairs.get(key, 0.0) + (t1 - t0) / 1e3
    split = dict.fromkeys((*SPANS.values(), "between"), 0.0)
    for key, us in pairs.items():
        split[SPANS.get(key, "between")] += us
    counts = dict.fromkeys(EVENTS, 0)
    for _, e in events:
        counts[e] += 1
    return dict(events=len(events), counts=counts,
                span_us=(events[-1][0] - events[0][0]) / 1e3 if events else 0.0,
                split_us=split,
                pairs_us=dict(sorted(pairs.items(), key=lambda kv: -kv[1])))


def trace_frame(bundle, cfg, B: int, gen, plan: str = PRESET) -> dict:
    """One frame of B streams through the trace build, after two warm-up
    frames: each traced block's split, and whether its samples equal the
    serving build's."""
    inputs = frame_inputs(cfg, B, gen)
    ref = run_variant(None, bundle, cfg, inputs, plan)
    lib = dc.load_library(TRACE)
    for _ in range(3):
        got = dc.run_chain(lib, bundle, cfg, *inputs, plan=plan)
    grid = dc.fused_depth_decode.last_layout["grid"]
    blocks = [split_trace(ev) for ev in read_trace(lib)]
    return dict(samples_equal=bool(torch.equal(got, ref)),
                block_ids=[0, grid // 2, grid - 1], blocks=blocks)


def main(dev="cuda", batches=(1, 8)) -> dict:
    dev = cuda_device(dev)
    print(f"{card_line()}; device {torch.cuda.get_device_name(dev)}", flush=True)
    cfg, bundle, gen = random_depth_bundle(dev)
    out = dict(abl0={})
    for B in batches:
        check = out["abl0"][B] = abl0_matches_serving(
            bundle, cfg, frame_inputs(cfg, B, gen))
        print(f"FRT_ABL=0 build vs the serving build, B={B}: {check}", flush=True)
    for B in batches:
        res = out[B] = time_variants(bundle, cfg, B, gen)
        for name, r in res.items():
            print(f"ABL={name:8s} B={B}: {r['ms']:.4f} ms/frame (change "
                  f"{r['delta_ms']:+.4f}), host issue {r['host_ms']:.4f} ms",
                  flush=True)
    out["trace"] = {}
    for B in batches:
        tr = out["trace"][B] = trace_frame(bundle, cfg, B, gen)
        for blk, r in zip(tr["block_ids"], tr["blocks"]):
            split = ", ".join(f"{k} {v:.1f}" for k, v in r["split_us"].items())
            print(f"trace B={B} block {blk}: {r['events']} stamps over "
                  f"{r['span_us']:.1f} us: {split} us; samples equal the "
                  f"serving build's: {tr['samples_equal']}", flush=True)
    return out


if __name__ == "__main__":
    main()
