#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fireredtts2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
1. the card: nvidia-smi's name and power limit, torch's device name; no
   CUDA device -> exit 2;
2. build every CUDA kernel of the port from csrc/ (one nvcc per source, in
   parallel) and report the build time;
3. kernel A (flash_decode_gqa1) against its plain PyTorch version at the
   flagship LM slab (28, B, 3584, 256) bf16, B in {1, 8, 16}, ragged
   windows with live lengths near 200 and near 3000, at B=1 near 16 and
   1000 too, and at B=16 windows whose ends pass the slab's end (idle pool
   slots): the live sweep's intercept (the fixed cost) and slope; each
   case's split size (the library's plan) and its CUDA launches per call
   (profiler);
4. kernel C (flash_decode_update_bounded) against its plain version at the
   flagship vocoder slab (12, B, 3008, 1024) bf16, B in {1, 8}, S in {8, 32,
   128} (stream blocks of 1, 4 and 16 frames) and 64 (generate's vocoder
   passes), B=16 at S in {8, 32} (the 16-slot pool's grouped passes), live
   ~200 and ~2900, plus writes that overshoot the slab (B=2 at T - 8 and
   T + 8) and the offline decode's first pass past a full slab (B=1, S=64
   at pos T): rows written at min(pos, T - S), as the JAX kernel writes
   them; the written rows must be identical and the attention close; each case's
   split size and its CUDA launches per call (profiler); kernel C's
   read-only mode (D) once with lower bounds;
5. kernel B (fused_depth_decode) against its plain version at the
   flagship depth decoder (qwen-200m, 16 codebooks of 2051), B in {1, 8}
   (and 16 for the preset: two launches of 8 streams),
   plans gate=r8,up=s8,down=s8 (the serving preset), gate=r4,... and
   gate=r8a8,up=s8a8,...: logits with the same tokens forced into both,
   then free sampling (equal up to a counted near-tie); each case's grid
   barriers a frame (counted in the barrier words, which must match
   ops/depth_chain.py: barriers_per_frame) and the ring's stages the
   launch used; the preset timed, the other two plans checked untimed;
6. kernel E (int4_matmul) at every qwen-200m depth matrix, M in
   {1, 2, 8, 16, 32}, beside torch._weight_int4pack_mm on the same int4
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
   every ablation build (half, tiny, noload, noattn, nosample, nosync,
   noattncore) is timed at B = 1 and 8; the trace build must sample as the
   serving build does, and its per-phase split of three blocks' frame is
   printed. One line {"probes": ...} carries the numbers;
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
   kernels A and C must have launched in every run;
10. voice cloning and dialogue: first an fp32 codec of narrow depth at the
   flagship widths encodes two prompts on the card, with PyTorch's
   process-wide TF32 flags on, and on the CPU: the codes must be equal, a
   flip allowed only where the CPU's best-vs-second distance gap is below
   1e-5 relative (counted); then the serving preset at flagship width with
   the full codec: two prompt wavs of 3.2 s and 7.4 s made from the seed
   (encode_prompt_tokens: ceil(n / 1280) + 1 tokens, one encode each, wall
   and device ms cold, warm and as a cache hit; device ms of each stage of
   a 6 s window and the encoders' attention's share; the bf16 codec's
   tokens against fp32 weights of the same draws), a clone streamed three
   times (plain path, voice state built, cache hit: one build) whose
   generate gives the stream's frames, and a 3-turn dialogue over both
   prompts, generate_dialogue then generate_dialogue_stream on the same
   seeds (turn 0's frames equal; the streamed audio of each turn is what
   re-entered, its encode cached; the wait between streamed turns and the
   offline decode that feeding that back instead would add; kernels A, B
   and C launched in each; LM ms/frame, prefill ms and kernel A's live
   window per turn); kernel A is
   held against its plain version over the last turn's live window of the
   dialogue's KV slab;
11. serving pools (runtime.batcher.ContinuousBatcher) over phase 10's
   engine: for pools of 16 and 8 streams the warm-up ladder's seconds, a
   burst of one ~60-character request per slot (50 frames; half of them
   identical greedy requests on one utterance seed, which must give
   identical frames; the rest sampled at mixed temperature and top-k):
   each stream's first packet (median, max), the aggregate RTF (audio
   seconds over wall seconds), the block sizes the policy chose,
   host_stats per frame, kernels A, B and C's launches (each > 0) and
   the greedy stream's common prefix with generate_stream at B=1 (printed,
   not bounded: near-tie flips between bf16 routes of different B);
   staggered arrivals (half the pool admitted while the other half
   decodes); a traced burst for CUDA kernels per pool step and the busy
   share; the LM's ms per batched frame. Through the 8-slot pool a batched
   clone and a 2-turn dialogue over phase 10's prompts, then a hot reload
   of a second seed's trees (saved with save_params under a temporary
   DIR/torch/ inside the checkout) while two streams are live: prepare,
   drain and apply seconds, the live streams whole, the engine's leaves
   equal to the saved ones, a request after the swap finite. A bounded
   pool (seq_capacity=1024, max_frames_cap=128) with an idle slot stepping
   past its slab's end beside a 50-frame neighbour; an engine loaded at
   full width from DIR (JSON configs of the flagship) and its load time;
11b. Whisper ASR (fireredtts2_tpu_torch.asr), no kernel of its own, at
   whisper-large-v3's full width and depth (32 + 32 layers, 1280 wide,
   vocabulary 51,866; ~1.54 B fp32 parameters from a seed): (a) a 10 s
   voiced clip through the temperature-fallback ladder and a 45 s one
   greedy in two 30 s windows (the second's prompt conditioned on the
   first's tokens), at most 32 tokens a window; the language detected
   (probabilities summing to 1 within 1e-5); the 10 s clip again with
   int8 weights; every transcript non-empty, every token id in the
   vocabulary, no "transcription failed" logged; (b) one S > 1 forward
   over the prompt and the greedy tokens, its argmax equal to the steps'
   tokens up to the first top-2 logit gap under 1e-3; (c) a 2 + 2-layer
   model at full width transcribing on the card and on the CPU in fp32:
   equal tokens; (e) encoder ms per 30 s window and decoder ms per token
   (CUDA events), a decoder step's device ms and CUDA launches (profiler),
   the greedy loop's ms per token, each clip's wall and RTF, peak memory;
   an HF whisper dir written from (a)'s weights by the port's own writer
   (all 448 decoder positions), read back and timed, for 12(b);
11c. the rest of transcription on 11b's model (no second init), the 10 s
   clip, 32 tokens a window: (a) beam search at W=5 on the T = 0 rung
   (token ids in the vocabulary, at most W finished, the winner's sum of
   log-probabilities within 1e-3 relative of a teacher-forced forward's,
   the EOT's term included when it finished) and best-of-5 at T = 0.5
   (the winner equal to the best row of a plain batch of 5 identical
   rows, each encoded, decoded with the same draws), then both through
   the service's ladder; (b) word timestamps of a greedy transcript
   (starts monotonic, 0 <= start <= end <= the clip's length, every token
   in some word); (c) a 2 + 2-layer model at full width, beam W=3 on the
   card and on the CPU: tokens, n_tokens and n_finished equal; (d)
   StreamingWhisperASR over the clip in 0.5 s chunks (the ladder off:
   random weights run every rung to its budget): results, no kept
   exception; (e) one RealtimeASRServer session (start, the clip's PCM16
   in 100 ms frames, end; interim passes off), over localhost sockets
   where websockets imports, else through an in-process connection into
   its handler: a final transcript, no error message; (f) ms per token of
   beam and best-of (the host loop's wall; a decoder step at W rows by
   CUDA events), the slab gather's bytes a token, the alignment forward
   (320 heads) and the DTW, streaming push-to-result and realtime
   end-to-final seconds, peak memory;
12. the serving front end over sockets on that engine: (a) the port's
   server in this process (WebSocketTTSServer with max_streams=8 and
   HealthHTTPServer on free localhost ports) driven by the port's client,
   launch counts set to 0 before its requests and read after (kernels A,
   B and C each launched): /health; /stats with the card's memory and the
   batcher's telemetry; the server's first request (block policy cold);
   a burst of 8 identical greedy chunked streams admitted as one (identical
   bytes; each one's first PCM byte, the aggregate RTF against phase 11's
   pool of 8); a greedy /api/v1/tts/generate within 1 LSB of the same
   request through ContinuousBatcher.submit alone (both on the fitted
   policy: the streamed audio depends on the block sizes the policy picks);
   the burst again under the profiler (CUDA kernels per pool step);
   /v1/audio/speech (RIFF wav); a voice made from phase 10's prompt and a
   clone in it (finite, RMS > 0); a conversation turn; an admin reload to
   the same DIR with two live streams (both whole, the greedy request after
   it within 1 LSB of the one before); the WebSocket stream within 1 LSB of
   REST (where websockets imports; otherwise a line says it is absent); a
   server with require_auth (401 without a token); the service worker on
   the card's default stream; the LM's ms per batched frame with the
   server up; the block policy's fitted frame cost. (b) `python -m
   fireredtts2_tpu_torch --pretrained-dir DIR --quantize-backbone
   --fused-depth-plan gate=r8,up=s8,down=s8 serve --max-streams 8` as a
   subprocess (log: chiprun_out/phase12_serve.log): /health within 300 s,
   /stats naming the card, its first (cold) and third (fitted) greedy
   request within 1 LSB of (a)'s cold and fitted ones; with `--asr
   --asr-dir` phase 11b's dir and `--asr-max-new-tokens 32` (random
   weights seldom emit EOT, so each rung of the server's six-rung ladder
   decodes its whole budget: 32 tokens a rung, as in 11b(a), in place of
   224): a /v1/audio/speech request of 4 s (kernels
   A, B and C launched in the server, by /stats' kernel_launches), then
   its wav through client.transcribe (200, non-empty text), the round
   trip's wall; then terminated;
13. training (``fireredtts2_tpu_torch.train``), no kernel of its own: (a)
   the flagship LM (EngineConfig().llm, ~2.1 B parameters) from random
   weights on the card, fp32 masters, bf16 compute, B=4 x S=512, remat
   "dots", synthetic batches of seed 0, warmup 2, peak lr 1e-4: 2 steps,
   then 8 timed with CUDA events (median and min step ms, positions/s,
   peak memory, MFU = model FLOPs a step / step time / 989 TFLOP/s with
   the formula printed: the attention's products counted, remat's
   recompute not); every loss and gradient norm finite; on one batch from
   one state an fp32-compute loss within 2% of the bf16 one, and remat
   "none", "full" and "dots" with bitwise-equal losses and gradient norms
   within 1e-3 relative; (b) the flagship codec (CodecConfig()) at B=2 x
   2 s windows, fp32, remat "dots": 1 + 4 timed steps, losses finite, the
   SSL teacher and mel filters bitwise unchanged; (c) (a)'s state saved
   with save_checkpoint (~25 GB, a temporary dir in the checkout), exported
   with phase 11's DIR as the config dir (its codec tree copied), an
   engine loaded from the export with the serving preset, a 10-frame
   greedy generate: kernels A, B and C launched, audio finite, the
   engine's unquantised leaves equal to the exported masters in its dtype;
14. the convert drill at the flagship's widths (EngineConfig()'s LM and
   codec, seeded weights): a reference-layout dir in a temporary
   `.convert_drill_*/` in the checkout (removed at the end whatever
   fails) with config_llm.json, config_codec.json and the reference's
   pickles llm_posttrain.pt and codec.pt (tools/ref_checkpoint.py); (a)
   run_convert(DIR, fidelity=True) in process, launch counts set to 0
   before it and read after: goldens recorded, kernels A and C launched
   and B not (the checkpoint's own config: bf16, no fused depth plan),
   wer and cer finite; (b) `python -m fireredtts2_tpu_torch
   --pretrained-dir DIR convert` as a subprocess (log:
   chiprun_out/phase14_convert_cli.log): exit 0, every golden "ok"; (c)
   pickle write, conversion, goldens, fidelity (generate, transcribe) and
   the CLI's wall seconds;
15. speculative (Jacobi) depth and the one-token vocoder at EngineConfig()'s
   widths and depth, random weights of seed 0 shared by every engine: (a)
   the bf16 backbone and the int8 backbone with speculative_depth=True:
   generate_stream (first packet) and generate of ~12 frames, launch and
   round counts set to 0 just before each (LM ms/frame, rounds a frame mean
   and max, kernels A and C launched, B not, one Jacobi call a frame), a
   traced 6-frame generate (CUDA launches a frame, busy share), then the
   same generate on the plain 15-step loop with every depth call recorded:
   its frames against the speculative ones, and Jacobi run on each
   recorded call's inputs, a row differing only at a near-tie of the two
   forwards' logits (check_kernel_b's rule; counted); (b) kernel E at M in
   {16, 128, 256} (16 rows a stream at B = 1, 8, 16) on every qwen-200m
   matrix against its plain version (device ms, bound,
   torch._weight_int4pack_mm), then int4 depth as in (a) (kernel E
   launched); (c) a burst of 8 sampled requests of 10 frames through a
   ContinuousBatcher pool with speculative depth (aggregate RTF, rounds a
   pool step), then
   the same burst on the plain loop, recorded and verified as in (a), each
   stream's frames against it; each stream's common prefix with its lone
   request at B=1 (printed, not bounded: bf16 routes of other B flip
   near-ties, phase 11); (d) tools/spec_depth_rounds.py at B in {1, 8}
   (Jacobi, the plain loop and kernel B's preset on the same inputs, 16
   frames queued, CUDA events) and tools/trained_loop.py on its "kernel"
   config (qwen-200m backbone and depth decoder, 4 codebooks; SPEC_LOOP_STEPS
   training steps), its summary line; (e) stream_decode_step over 48 tokens
   of the flagship codec in bf16 (kernel C at S=8, once a layer a token)
   against codec_decode and codec_decode_chunks (the engine's grouped S=64
   passes) of the same tokens, each pair's gap within STREAM_GAP_TOL of the
   peak; kernel C fed the same 64 rows as one S=64 pass and as eight S=8
   passes: rows identical, outputs within 4 x 2e-2 of the peak. Phase 9's
   stream-vs-generate audio and phase 12's cold-vs-fitted request are held
   to STREAM_GAP_TOL of the peak and STREAM_GAP_LSB, from these gaps.
16. serving on a (dp, tp) mesh (parallel/mesh.py): (a) kernel A's kv-head
   window at the flagship LM slab, tp 2 and 4 (6 and 3 query heads a rank),
   B in {1, 8}, live ~200 and ~3000: every rank's flash_decode_gqa1_shard
   against its plain version with the same window, the ranks' outputs
   concatenated against the unsharded kernel A; (b) kernel C's tp route at
   the flagship vocoder slab, tp=2 (8 heads, 512 columns a rank), B in
   {1, 8}, S in {32, 64}: each rank against its plain version, outputs and
   written columns against the unsharded call; (c) two gloo ranks on the
   one card (parallel.mesh.Ranks) build the preset at full width and depth
   at tp=2 and generate MESH_FRAMES frames, their launches counted from 0
   around the call; their tokens must equal each other, the first frame's
   codebook-0 logits lie within MESH_LOGIT_TOL of the peak of the one-rank
   engine's (same seeds), and the tokens equal its or part at a near-tie
   explained as in phase 5 (codebook 0 from the recorded logits, a depth
   codebook from the plain chain's logits of both runs' last_h plus B_TOL);
   no collective moves a quarter of the LM slab; (d) the same ranks at
   dp=2: a burst of MESH_POOL through a pool of blocks of 4 (4 slots a
   rank), each stream against the one-rank pool's, flips explained alike;
   (e) `torchrun --nproc-per-node 2 -m fireredtts2_tpu_torch
   --pretrained-dir DIR --tp 2 ... serve` (booting while (c) and (d) run)
   answers one request of MESH_CLI_FRAMES through the client (log:
   chiprun_out/phase16_serve_tp2.log); DIR (stash_mesh_dir,
   write_mesh_dir): phase 11's flagship codec, the flagship depth decoder
   and a 4-layer qwen-200m backbone of the flagship's width, random
   weights of MESH_SEED.

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
call is traced to give the device's busy share, its largest kernels and
kernel A's time and CUDA launches in it.
Each number is printed with the card's name and power limit; details go
to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import atexit
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import traceback
import urllib.error

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


def under_profiler(fn, cpu: bool = False) -> tuple[object, list | None]:
    """One call of fn under torch.profiler (CUDA activity, and the CPU's
    with cpu=True); -> (fn's result, the trace's CUDA events, or None when
    the profiler could not start or be read; the reason is logged). fn's
    own failure propagates: only the profiler is optional."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    prof = None
    try:
        prof = profile(activities=acts)
        prof.start()
    except Exception as e:  # noqa: BLE001 -- the profiler is optional here
        log(f"profiler unavailable: {e!r}")
        prof = None
    events = None
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        if prof is not None:
            try:
                prof.stop()
                events = [e for e in prof.events()
                          if e.device_type == DeviceType.CUDA]
            except Exception as e:  # noqa: BLE001
                log(f"profiler trace unreadable: {e!r}")
    return out, events


def device_ms(fn, reps: int):
    """Mean device time (ms) of the CUDA kernels one call of fn launches,
    from a torch.profiler trace; None when the trace shows no device time
    (the reason is logged)."""
    def repeated():
        for _ in range(reps):
            fn()

    # CUDA activity only: recording the CPU ops too costs minutes over the
    # plain versions' thousands of launches.
    _, events = under_profiler(repeated)
    if events is None:
        return None
    us = sum(e.time_range.elapsed_us() for e in events)
    if us <= 0:
        log(f"profiler: no device time in {len(events)} CUDA events")
        return None
    return us / reps / 1e3


def cuda_launches(fn):
    """CUDA kernels one call of fn launches, counted in a torch.profiler
    trace (None when the trace holds no device activity)."""
    import torch

    fn()
    torch.cuda.synchronize()
    _, events = under_profiler(fn)
    if events is None:
        return None
    n = sum(1 for e in events if "memcpy" not in e.name.lower()
            and "memset" not in e.name.lower())
    return n or None


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
    # the main path's shapes, then B=1 at ~16 and ~1000 live: with ~200 and
    # ~3000 a live sweep whose intercept is the fixed cost (launch, merge)
    # and whose slope the stream rate
    # the serving pool's B=16, and at B=16 windows whose ends pass the
    # slab's end (idle pool slots stepping on): the kernel reads [lo, T)
    cases = cases or [(1, 200), (1, 3000), (8, 200), (8, 3000), (1, 16),
                      (1, 1000), (16, 200), (16, 3000), (16, T + 64)]
    results = []
    for B, live in cases:
        gen = torch.Generator(device=dev).manual_seed(B * 7919 + live)
        q = _rnd(gen, B, Hkv * G, Dh)
        k4, v4 = _rnd(gen, L, B, T, Hkv * Dh), _rnd(gen, L, B, T, Hkv * Dh)
        # ragged windows: left padding up to 40 slots (a quarter of a short
        # window), ends near `live`; stream 0 ends on a chunk edge when the
        # window is long
        pad = min(40, max(live // 4, 1))
        q_start = rng.integers(0, pad, B)
        q_end = live + rng.integers(-min(20, pad), min(20, pad), B)
        if live <= T:
            q_end = np.minimum(q_end, T)
        if 1000 < live <= T:
            q_end[0] = min(T, (live // 512) * 512)
        qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
        qe = torch.tensor(q_end, dtype=torch.int32, device=dev)
        lo = torch.tensor(int(q_start.min()), dtype=torch.int32, device=dev)
        hi = torch.tensor(int(q_end.max()), dtype=torch.int32, device=dev)
        layer = L - 1
        out = fd.flash_decode_gqa1(q, k4, v4, layer, qs, qe, lo, hi)
        ref = fd.flash_decode_gqa1_plain(q, k4, v4, layer, qs, qe, lo, hi)
        err, ok = _compare(out, ref)
        live_slots = int((np.minimum(q_end, T) - q_start).sum())
        bnd, by = bound_ms(4 * B * Hkv * G * Dh + live_slots * Hkv * Dh * 4,
                           4 * Hkv * G * Dh * live_slots)
        launches = None
        if torch.device(dev).type == "cuda":
            launches = cuda_launches(lambda: fd.flash_decode_gqa1(
                q, k4, v4, layer, qs, qe, lo, hi))
        times = {}
        if timed:
            step = itertools.count()
            times = time_pair(
                lambda: fd.flash_decode_gqa1(q, k4, v4, next(step) % L, qs, qe,
                                             lo, hi),
                lambda: fd.flash_decode_gqa1_plain(q, k4, v4, next(step) % L,
                                                   qs, qe, lo, hi), reps)
            w0, w1 = int(q_start.min()), min(int(q_end.max()), T)
            kv = [t[layer, :, w0:w1].view(B, w1 - w0, Hkv, Dh).transpose(1, 2)
                  for t in (k4, v4)]
            slot = torch.arange(w0, w1, device=dev)
            mask = ((slot >= qs[:, None]) & (slot < qe[:, None]))[:, None, None]
            times["library_ms"] = library_ms(
                sdpa_call(q[:, :, None], kv[0], kv[1], mask), reps)
        split = None
        if torch.device(dev).type == "cuda":
            split = fd.gqa1_plan(B, Hkv, G, T, Dh,
                                 torch.device(dev).index or 0)[0]
        results.append(dict(B=B, live=live, past_end=live > T,
                            max_abs_err=err, ok=ok,
                            bound_ms=bnd, bound_by=by, split=split,
                            cuda_launches_per_call=launches, **times))
        del q, k4, v4
    return results


def live_sweep(rows, key: str = "ms") -> dict | None:
    """Least squares of kernel A's time on the live length over the B=1
    cases: the intercept (fixed cost: launch, copies' latency, merge) and
    the slope (ms per 1000 live slots). None without three timed cases."""
    pts = [(r["live"], r.get(key)) for r in rows if r["B"] == 1]
    pts = [(x, y) for x, y in pts if y is not None]
    if len(pts) < 3:
        return None
    slope, icpt = np.polyfit([x for x, _ in pts], [y for _, y in pts], 1)
    return dict(fixed_ms=float(icpt), ms_per_1000_slots=float(slope * 1e3),
                points=len(pts), timed_by=key)


def check_kernel_c(dev, L, T, H, Dh, reps, cases=None, timed=True):
    import torch
    from fireredtts2_tpu_torch.ops import flash_decode as fd

    D = H * Dh
    # B=16: the 16-slot pool's grouped passes, G = min(K, 64 // 16) <= 4
    # tokens, so S = 8 (K=1) or 32
    cases = cases or ([(B, S, live) for B in (1, 8) for S in (8, 32, 64, 128)
                       for live in (200, 2900)]
                      + [(16, S, live) for S in (8, 32) for live in (200, 2900)])
    # past the slab: writes at min(pos, T - S), as JAX's chip route does;
    # "past_slab" is the offline decode's first 8-token pass beyond a full
    # slab (codec_decode_chunks: pos = T)
    cases = list(cases) + [("overshoot", 64, T), ("past_slab", 64, T)]
    results = []
    for B, S, live in cases:
        overshoot, past_slab = B == "overshoot", B == "past_slab"
        if overshoot:
            B = 2
            pos = np.array([T - 8, T + 8])
        elif past_slab:
            B = 1
            pos = np.array([T])
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
        launches = None
        if torch.device(dev).type == "cuda":
            launches = cuda_launches(lambda: fd.flash_decode_update_bounded(
                q, nk, nv, kk, vk, layer, pos_t, q_end, live_hi))
        # slab rows attended: a query past the slab reads its T rows only
        qe = q_end.clamp(max=T)
        read = int(qe.max(dim=1).values.sum())
        bnd, by = bound_ms(2 * (2 * B * S * D) + 2 * 2 * B * S * D
                           + read * D * 4, 4 * D * int(qe.sum()))
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
                            past_slab=past_slab, max_abs_err=err, ok=ok and rows_ok,
                            rows_identical=rows_ok, bound_ms=bnd, bound_by=by,
                            split=fd.bounded_split(T, B, H),
                            cuda_launches_per_call=launches, **times))
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
                   batches=(1, 8), reps=20, timed=True, bundle_fn=None,
                   wide=(16,)):
    """Kernel B vs its plain version. With the plain version's samples
    forced into both, the fp32 logits of every micro-step agree to B_TOL of
    the plain peak, and a sample may differ only at a near-tie: where the
    plain version's top two race scores lie closer than that step's logit
    error can move them. Sampling freely, each stream follows the plain
    version up to its first such tie. The ties are counted. On the card the
    free launch's grid barriers (word 3 of the barrier words) must be
    barriers_per_frame's count; each case also reports the ring's stages
    that launch used. `wide`: batches run for the first plan (the serving
    preset) only, e.g. the 16-slot pool's B=16, which the wrapper splits
    into launches of at most 8 streams (one barrier count per launch)."""
    import torch
    from fireredtts2_tpu_torch.ops import depth_chain as dc

    results = []
    for plan in plans:
        cfg, bundle, gen = (bundle_fn or depth_bundle)(dev, plan)
        ncb, V = cfg.audio_num_codebooks, cfg.audio_vocab_size
        for B in tuple(batches) + (tuple(wide) if plan == plans[0] else ()):
            last_h = _rnd(gen, B, cfg.backbone.embed_dim)
            c0 = torch.randint(0, V, (B,), generator=gen, device=dev,
                               dtype=torch.int32)
            noise = torch.empty((B, ncb, V), device=dev).exponential_(generator=gen)
            ref, ref_logits = dc.fused_depth_decode_plain(bundle, cfg, last_h,
                                                          c0, noise, plan=plan)
            forced, logits = dc.fused_depth_decode(bundle, cfg, last_h, c0,
                                                   noise, plan=plan, forced=ref,
                                                   return_logits=True)
            on_card = torch.device(dev).type == "cuda"
            if on_card:                   # the barrier words count them
                bar = dc._barrier(last_h.device)
                torch.cuda.synchronize()
                passed = int(bar[3])
            free = dc.fused_depth_decode(bundle, cfg, last_h, c0, noise, plan=plan)
            barriers = stages = None
            if on_card:                   # what the free launch used
                torch.cuda.synchronize()
                barriers = (int(bar[3]) - passed) % 2 ** 32
                stages = dc.fused_depth_decode.last_layout["stages"]
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
                  and tokens_ok and bool(torch.equal(free[:, 0], c0))
                  and barriers in (None, dc.barriers_per_frame(cfg)
                                   * -(-B // 8)))
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
                                tokens_ok=tokens_ok, barriers_per_frame=barriers,
                                ring_stages=stages,
                                bound_ms=bnd, bound_by=by, library_ms=None,
                                **times))
        del bundle
    return results


def int4_shapes():
    """(name, K, O) of every depth-decoder matrix of qwen-200m."""
    return [("wq", 1536, 1536), ("wk", 1536, 256), ("wv", 1536, 256),
            ("wo", 1536, 1536), ("w_gate", 1536, 8960), ("w_up", 1536, 8960),
            ("w_down", 8960, 1536)]


def check_kernel_e(dev, shapes=None, ms=(1, 2, 8, 16, 32), reps=50, timed=True):
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
                         for r in out["p2"][B].values())
                 and all(t["samples_equal"] for t in out["p2"]["trace"].values()))
    return out


def probe_summary(probes: dict) -> dict:
    """The probes line: each probe's numbers, floats to 5 significant
    digits, without the labels its key repeats (every value is in
    chiprun_out/chip_smoke.json)."""
    drop = ("name", "mode", "load", "sync", "cold", "M", "steps", "weight_mb",
            "library_call", "library_note", "bound_by", "bits", "ok", "sum_err",
            "sum_scale", "grid", "x_staged", "streamed_floor_ms", "s_per_byte_eq",
            "pairs_us")

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


def trace_call(fn, dev, top_n: int = 10, cpu: bool = True
               ) -> tuple[object, dict]:
    """One call of fn under the profiler (``under_profiler``; the CPU's
    activity too unless `cpu` is False, which keeps a trace of tens of
    thousands of launches cheap to read); -> (fn's result, the trace: wall
    time, summed device kernel time (busy share = device / wall), the
    largest kernels by device time (with their launch counts); "by_name"
    holds every kernel's (us, launches)). The trace is {} on the CPU or
    without a profiler."""
    import torch

    if torch.device(dev).type != "cuda":
        return fn(), {}

    def timed():
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    (out, wall), events = under_profiler(timed, cpu=cpu)
    if events is None:
        return out, {}
    by_name: dict = {}
    for e in events:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy = sum(us for us, _ in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    return out, dict(wall_s=wall, device_s=busy, busy_share=busy / wall,
                     kernel_launches=sum(n for _, n in by_name.values()),
                     top=[(name[:90], us / 1e3, n) for name, (us, n) in top],
                     by_name=by_name)


def trace_generate(eng, dev, max_ms: float = 800.0) -> dict:
    """Trace one short generate call (``trace_call``), with kernel A's
    time and launches."""
    _, tr = trace_call(lambda: eng.generate("Profile this.", "[S1]",
                                            max_audio_length_ms=max_ms,
                                            utt_seed=3), dev)
    if not tr:
        return {}
    by_name = tr.pop("by_name")
    gqa1 = [name for name in by_name if "gqa1" in name]     # kernel A
    return dict(tr, frames=eng.last_stats.get("frames"),
                kernel_a_ms=sum(by_name[k][0] for k in gqa1) / 1e3,
                kernel_a_launches=sum(by_name[k][1] for k in gqa1))


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
        # the same frames through the vocoder's bf16 passes of other shapes
        checks["stream_vs_generate_bounded"] = (
            wave_err is not None and wave_err <= STREAM_GAP_TOL)
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


# ---------------------------------------------------------------------------
# Voice cloning and dialogue at flagship width
# ---------------------------------------------------------------------------

PROMPTS = (("[S1]Here is how I sound when I read a short line.", 3.2),
           ("[S2]And this is my voice, a little longer, over two of the "
            "encoder's six second windows.", 7.4))
DIALOGUE = ["[S1]Did you hear the news this morning?",
            "[S2]I did, and I still can not believe it.",
            "[S1]Neither can I, let us talk it over."]
CLONE_TEXT = "This sentence is spoken in the cloned voice."
NEAR_TIE = 1e-5          # relative distance gap of an allowed fp32 code flip


def voiced(n: int, seed: int, sr: int = 16_000) -> np.ndarray:
    """A prompt-like waveform from the seed: harmonics of a gliding pitch
    under a syllable-rate envelope, plus a little noise; float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f0 = 120 + 40 * np.sin(2 * np.pi * 0.7 * t) + rng.uniform(0, 60)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(k * phase) / k for k in range(1, 6))
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * 2.5 * t) ** 2
    x += 0.02 * rng.standard_normal(n)
    return (0.3 * x / np.abs(x).max()).astype(np.float32)


def window_batch(audios, win: int):
    """Prompts cut into zero-padded windows as codec_encode cuts them ->
    ((n_windows, win) float32, valid samples per window)."""
    rows = []
    for a in audios:
        n_win = max(1, -(-len(a) // win))
        padded = np.zeros(n_win * win, np.float32)
        padded[:len(a)] = a
        rows += [padded[i * win:(i + 1) * win] for i in range(n_win)]
    return np.stack(rows), np.full(len(rows), win, np.int32)


def profiled(fn, dev) -> tuple:
    """One call of fn -> (its result, {wall_ms: host clock, synced;
    device_ms: the CUDA kernels' summed time in a torch.profiler trace;
    kernels: how many ran}); on the CPU the wall time only."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if torch.device(dev).type != "cuda":
        t0 = time.perf_counter()
        result = fn()
        return result, dict(wall_ms=(time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return result, dict(wall_ms=wall, kernels=len(ev), device_ms=sum(
        e.time_range.elapsed_us() for e in ev) / 1e3)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def check_fp32_encode(dev, config=None) -> dict:
    """An fp32 codec of narrow depth at the flagship widths (SSL 2 x 1280,
    adaptor 1 x 768, acoustic encoder 2 x 768, the full RVQ), weights drawn
    on the CPU and copied to `dev`, encodes the two prompts (three 6 s
    windows) on both, with PyTorch's process-wide TF32 flags turned ON:
    the codes must be equal, a flip allowed only where the CPU's own
    best-vs-second distance gap is below NEAR_TIE relative (counted). Also
    shows the hazard the policy removes: the STFT power's error on `dev`
    with a plain TF32 conv against the policy's."""
    import dataclasses
    import torch
    import torch.nn.functional as F
    from fireredtts2_tpu_torch.config import CodecConfig
    from fireredtts2_tpu_torch.models.codec.model import (
        encode_features, encode_window, init_codec_params,
    )
    from fireredtts2_tpu_torch.models.codec.rvq import (
        code_gaps, code_mismatches, rvq_encode,
    )
    from fireredtts2_tpu_torch.ops import stft

    base = config or CodecConfig()
    cfg = dataclasses.replace(
        base, dtype="float32",
        ssl=dataclasses.replace(base.ssl, num_layers=min(2, base.ssl.num_layers)),
        ssl_adaptor=dataclasses.replace(base.ssl_adaptor, num_layers=1),
        acoustic_encoder=dataclasses.replace(
            base.acoustic_encoder, num_layers=min(2, base.acoustic_encoder.num_layers)),
        acoustic_decoder=dataclasses.replace(base.acoustic_decoder, num_layers=1))
    cpu = init_codec_params(torch.Generator().manual_seed(21), cfg)
    card = _tree_to(cpu, dev)
    win = cfg.encode_chunk_seconds * cfg.input_sample_rate
    audio, lengths = window_batch(
        [voiced(int(s * 16_000), 11 + i) for i, (_, s) in enumerate(PROMPTS)], win)
    with torch.inference_mode():
        feats = encode_features(cpu, cfg, torch.from_numpy(audio),
                                torch.from_numpy(lengths))
        want = rvq_encode(cpu["rvq"], cfg.rvq, feats)
        gaps = code_gaps(cpu["rvq"], cfg.rvq, feats, want)
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got = encode_window(card, cfg, torch.from_numpy(audio).to(dev),
                                torch.from_numpy(lengths).to(dev))
            # the hazard: the same STFT power through a plain (TF32) conv
            x = torch.from_numpy(audio[:1]).to(dev)
            ref = stft.stft_power(torch.from_numpy(audio[:1]), cfg.mel.n_fft,
                                  cfg.mel.hop_length)
            pad = cfg.mel.n_fft // 2
            filt = torch.from_numpy(np.concatenate(
                stft._stft_basis_np(cfg.mel.n_fft))[:, None, :]).to(dev)
            y = F.conv1d(F.pad(x[:, None], (pad, pad), mode="reflect"), filt,
                         stride=cfg.mel.hop_length)
            nf = cfg.mel.n_fft // 2 + 1
            tf32 = (y[:, :nf] ** 2 + y[:, nf:] ** 2).cpu()
            policy = stft.stft_power(x, cfg.mel.n_fft, cfg.mel.hop_length).cpu()
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    diff, bad = code_mismatches(want.numpy(), got.cpu().numpy(), gaps.numpy(),
                                NEAR_TIE)
    peak = float(ref.abs().max())
    return dict(windows=int(audio.shape[0]), frames=int(want.shape[2] * want.shape[1]),
                codes=int(want.numel()), frames_differing=diff, near_ties=diff - bad,
                not_near_ties=bad,
                min_gap=float(gaps.min()),
                stft_rel_err_tf32_conv=float((tf32 - ref).abs().max()) / peak,
                stft_rel_err_policy=float((policy - ref).abs().max()) / peak,
                ok=bad == 0)


def encode_stages(eng, audio16k: np.ndarray) -> dict:
    """Device ms (profiler, mean of 3) of each stage of one 6 s window's
    encode at B=1 on the engine's codec: mel, SSL encoder, adaptor,
    acoustic encoder, downsample, RVQ and the whole window; and the
    encoders' attention alone (mha_attention at each stack's shape, times
    its layer count), its share of the window. The stages are composed
    here as encode_features composes them; `stages_equal_window` says
    whether their codes are encode_window's."""
    import torch
    from fireredtts2_tpu_torch.models.codec.encoder import (
        down_conv_forward, ssl_adaptor_forward,
    )
    from fireredtts2_tpu_torch.models.codec.model import _mel, encode_window
    from fireredtts2_tpu_torch.models.codec.rvq import rvq_encode
    from fireredtts2_tpu_torch.models.codec.whisper_nn import (
        whisper_encoder_forward,
    )
    from fireredtts2_tpu_torch.ops.attention import mha_attention

    if eng.device.type != "cuda":
        return {}
    p, cfg, dev = eng.codec_params, eng.config.codec, eng.device
    win = cfg.encode_chunk_seconds * cfg.input_sample_rate
    a = torch.from_numpy(window_batch([audio16k[:win]], win)[0]).to(dev)
    lens = torch.full((1,), win, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        mel, ml = _mel(p, cfg, a, lens)
        ssl, sl = whisper_encoder_forward(p["ssl"], cfg.ssl.num_heads, mel, ml)
        sem, _ = ssl_adaptor_forward(p["ssl_adaptor"], cfg.ssl_adaptor, ssl, sl)
        aco, al = whisper_encoder_forward(p["acoustic_encoder"],
                                          cfg.acoustic_encoder.num_heads, mel, ml)
        feats = torch.cat([sem, aco], dim=-1)
        down, _ = down_conv_forward(p["downsample"], cfg.downsample_factor,
                                    feats, al)
        stages = {
            "mel": lambda: _mel(p, cfg, a, lens),
            "ssl": lambda: whisper_encoder_forward(p["ssl"], cfg.ssl.num_heads,
                                                   mel, ml),
            "ssl_adaptor": lambda: ssl_adaptor_forward(
                p["ssl_adaptor"], cfg.ssl_adaptor, ssl, sl),
            "acoustic_encoder": lambda: whisper_encoder_forward(
                p["acoustic_encoder"], cfg.acoustic_encoder.num_heads, mel, ml),
            "downsample": lambda: down_conv_forward(
                p["downsample"], cfg.downsample_factor, feats, al),
            "rvq": lambda: rvq_encode(p["rvq"], cfg.rvq, down),
            "window": lambda: encode_window(p, cfg, a, lens),
        }
        out = {k: device_ms(f, 3) for k, f in stages.items()}
        out["stages_equal_window"] = bool(torch.equal(
            rvq_encode(p["rvq"], cfg.rvq, down), encode_window(p, cfg, a, lens)))
        T = ssl.shape[1]
        mask = torch.ones((1, T, T), dtype=torch.bool, device=dev)
        attn = 0.0
        for D, H, L in ((cfg.ssl.embed_dim, cfg.ssl.num_heads, cfg.ssl.num_layers),
                        (cfg.ssl_adaptor.embed_dim, cfg.ssl_adaptor.num_heads,
                         cfg.ssl_adaptor.num_layers),
                        (cfg.acoustic_encoder.embed_dim,
                         cfg.acoustic_encoder.num_heads,
                         cfg.acoustic_encoder.num_layers)):
            q = torch.randn((1, T, H, D // H), device=dev)
            attn += (device_ms(lambda: mha_attention(q, q, q, mask), 3) or 0) * L
    out["attention"] = attn
    if out.get("window"):
        out["attention_share"] = attn / out["window"]
    return out


def run_clone_dialogue(dev, card: str, config=None, max_ms: float = 2000.0,
                       seed: int = 2024, keep: dict | None = None) -> dict:
    """Voice cloning and dialogue through the engine's entry points, on
    the serving preset at flagship width by default: two prompt wavs
    (3.2 s and 7.4 s, the second over two 6 s windows) written from the
    seed and read back by prepare_prompt; each prompt's encode (token
    count, wall and device ms cold, warm and as a cache hit, encode_calls);
    the bf16 codec's tokens against an fp32 codec's of the same draws; a
    clone streamed three times (plain path, voice state built, cache hit)
    and generated once with the same utterance seed; a 3-turn dialogue
    [S1] [S2] [S1] over both prompts, batch then streamed on the same
    seeds, the wait between streamed turns timed. Every run is counted with the launch counts set to 0 just
    before and read just after; kernel A is then held against its plain
    version over the last turn's live window of the dialogue's KV slab.
    keep: receives the engine ("engine") and the prompt segments
    ("segments") for the serving phase."""
    import dataclasses
    import tempfile

    import torch
    from scipy.io import wavfile
    from fireredtts2_tpu_torch.config import EngineConfig
    from fireredtts2_tpu_torch.engine import FireRedTTS2Engine
    from fireredtts2_tpu_torch.models.codec.model import codec_encode
    from fireredtts2_tpu_torch.ops import flash_decode as fd
    from fireredtts2_tpu_torch.utils.audio_io import resample
    from fireredtts2_tpu_torch.weights import init_random

    cuda = torch.device(dev).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    base = EngineConfig()
    config = config or dataclasses.replace(base, llm=dataclasses.replace(
        base.llm, quantize_backbone=True, fused_depth_plan=PRESET))
    t0 = time.perf_counter()
    eng = FireRedTTS2Engine(config, seed=0, device=dev)
    sync()
    res: dict = dict(card=card, init_s=time.perf_counter() - t0)
    list(eng.generate_stream("Warm up.", "[S1]", max_audio_length_ms=400,
                             utt_seed=1))                    # warm-up
    checks: dict = {}
    runs: dict = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, (_, secs) in enumerate(PROMPTS):
            paths.append(os.path.join(tmp, f"prompt{i}.wav"))
            wavfile.write(paths[-1], 16_000, (voiced(int(secs * 16_000), 11 + i)
                                              * 32767).astype(np.int16))
        segs = [eng.prepare_prompt(text, text[:4], path)
                for (text, _), path in zip(PROMPTS, paths)]

        # encode: cold (first call, a cache miss), a cache hit, and warm
        # (the same encode again, past the cache)
        enc = []
        for i, seg in enumerate(segs):
            calls = eng.encode_calls
            (frames, _), cold = profiled(
                lambda: eng.encode_prompt_tokens(seg.audio), dev)
            _, hit = profiled(lambda: eng.encode_prompt_tokens(seg.audio.copy()),
                              dev)
            (codes, tlen), warm = profiled(lambda: codec_encode(
                eng.codec_params, eng.config.codec, seg.audio[None]), dev)
            checks[f"prompt{i}_encode_repeats"] = bool(np.array_equal(
                codes[0, :, :tlen[0]].T, frames[:-1, :-1]))
            n = len(seg.audio)
            enc.append(dict(samples=n, tokens=len(frames), cold=cold,
                            cache_hit=hit, warm=warm,
                            encode_calls=eng.encode_calls - calls))
            checks[f"prompt{i}_tokens"] = len(frames) == -(-n // 1280) + 1
            checks[f"prompt{i}_encoded_once"] = eng.encode_calls - calls == 1
        res["encode"] = enc
        res["encode_stages"] = encode_stages(eng, segs[1].audio)
        if cuda:
            checks["encode_stages_equal_window"] = \
                res["encode_stages"]["stages_equal_window"]

        # the bf16 codec against fp32 weights of the same draws
        cfg32 = dataclasses.replace(config, codec=dataclasses.replace(
            config.codec, dtype="float32"))
        _, codec32 = init_random(cfg32, 0, dev)
        equal = total = 0
        with torch.inference_mode():
            for seg in segs:
                want = eng.encode_prompt_tokens(seg.audio)[0][:-1, :-1].T
                got, _ = codec_encode(codec32, cfg32.codec, seg.audio[None])
                equal += int((got[0] == want).sum())
                total += want.size
        del codec32
        res["bf16_vs_fp32_token_share"] = equal / total

        # clone: plain path, voice state built, cache hit; then generate
        clone = []
        for k in range(3):
            reset_counts()
            t0 = time.perf_counter()
            chunks = list(eng.generate_stream(CLONE_TEXT, "[S1]", [segs[0]],
                                              max_audio_length_ms=max_ms,
                                              utt_seed=seed))
            sync()
            wall = time.perf_counter() - t0
            runs[f"clone_stream{k}"] = read_counts()
            audio = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
            clone.append(dict(first_packet_ms=(eng._first_packet_s or 0) * 1e3,
                              wall_s=wall, frames=len(eng.last_tokens),
                              voice_state_builds=eng.voice_state_builds,
                              finite=bool(np.isfinite(audio).all()),
                              len_ok=len(audio) == len(eng.last_tokens) * 1920 > 0))
        stream_tokens = eng.last_tokens
        reset_counts()
        audio = eng.generate(CLONE_TEXT, "[S1]", [segs[0]],
                             max_audio_length_ms=max_ms, utt_seed=seed)
        sync()
        runs["clone_generate"] = read_counts()
        checks["clone_voice_state_built_once"] = eng.voice_state_builds == 1
        checks["clone_audio"] = all(c["finite"] and c["len_ok"] for c in clone) \
            and bool(np.isfinite(audio).all()) \
            and len(audio) == len(eng.last_tokens) * 1920 > 0
        checks["clone_generate_equals_stream"] = bool(
            np.array_equal(eng.last_tokens, stream_tokens))
        res["clone"] = clone

        # dialogue: batch (incremental KV), then streamed on the same seeds
        kw = dict(prompt_wav_list=paths,
                  prompt_text_list=[t for t, _ in PROMPTS],
                  max_utterance_ms=max_ms, utt_seed=seed)
        reset_counts()
        t0 = time.perf_counter()
        audio = eng.generate_dialogue(list(DIALOGUE), **kw)
        sync()
        wall = time.perf_counter() - t0
        runs["dialogue"] = read_counts()
        turns = [dict(frames=s["frames"],
                      lm_ms_per_frame=s["lm_s"] / max(s["frames"], 1) * 1e3,
                      prefill_ms=s["prefill_s"] * 1e3,
                      live=s["live_end"] - s["live_start"])
                 for s in eng.last_turn_stats]
        batch_tokens = list(eng.last_turn_tokens)
        # every turn's re-encode a cache miss, as in a new conversation
        # (the prompts stay cached)
        eng._audio_token_cache.clear()
        for seg in segs:
            eng.encode_prompt_tokens(seg.audio)
        reset_counts()
        t0 = time.perf_counter()
        pieces, at = [], []
        for i, chunk in eng.generate_dialogue_stream(list(DIALOGUE), **kw):
            at.append((i, time.perf_counter()))
            pieces.append((i, chunk))
        sync()
        stream_wall = time.perf_counter() - t0
        runs["dialogue_stream"] = read_counts()
        stream_audio = np.concatenate([c for _, c in pieces])
        # the wait between turns: a turn's last piece to the next one's first
        turn_gaps = [(min(t for j, t in at if j == i + 1)
                      - max(t for j, t in at if j == i)) * 1e3
                     for i in range(len(DIALOGUE) - 1)]
        # what re-entered after each turn was its streamed audio: its
        # encode is cached
        calls = eng.encode_calls
        for i in range(len(DIALOGUE) - 1):
            heard = np.concatenate([c for j, c in pieces if j == i])
            eng.encode_prompt_tokens(resample(heard, eng.output_sample_rate,
                                              eng.sample_rate))
        checks["dialogue_stream_feeds_back_its_audio"] = eng.encode_calls == calls
        # what feeding back the offline decode instead would add: one
        # vocoder pass over the turn
        offline_ms = []
        for frames in eng.last_turn_tokens[:-1]:
            sync()
            t0 = time.perf_counter()
            eng._decode_tokens([frames])
            sync()
            offline_ms.append((time.perf_counter() - t0) * 1e3)
        checks["dialogue_audio"] = bool(np.isfinite(audio).all()) \
            and len(audio) == sum(len(t) for t in batch_tokens) * 1920 > 0 \
            and bool(np.isfinite(stream_audio).all())
        # turn 0 is the same computation; later turns re-encode audio that
        # the streamed and offline bf16 decodes round differently
        equal_turns = [bool(np.array_equal(a, b)) for a, b in
                       zip(eng.last_turn_tokens, batch_tokens)]
        checks["dialogue_stream_turn0_equals_batch"] = \
            len(equal_turns) == len(batch_tokens) == len(DIALOGUE) \
            and equal_turns[0]
        for k in ("flash_decode_gqa1", "fused_depth_decode",
                  "flash_decode_update_bounded"):
            if k == "fused_depth_decode" and not config.llm.fused_depth_plan:
                continue
            checks[f"dialogue_{k}_launched"] = \
                runs["dialogue"][k] > 0 and runs["dialogue_stream"][k] > 0
        res["dialogue"] = dict(wall_s=wall, stream_wall_s=stream_wall,
                               audio_s=len(audio) / eng.output_sample_rate,
                               turns=turns,
                               first_packet_ms=(eng._first_packet_s or 0) * 1e3,
                               stream_turn_frames=[len(t) for t in
                                                   eng.last_turn_tokens],
                               stream_turns_equal=equal_turns,
                               turn_gaps_ms=turn_gaps,
                               offline_decode_ms=offline_ms)

    # kernel A over the last turn's live window of the dialogue's slab
    last = eng.last_turn_stats[-1]
    state, bb = eng.last_lm_state, eng.config.llm.backbone
    lo, hi = last["live_start"], last["live_end"]
    q = _rnd(torch.Generator(device=dev).manual_seed(5), 1, bb.num_heads,
             bb.head_dim)
    ints = [torch.tensor(v, dtype=torch.int32, device=dev) for v in
            ([lo], [hi], lo, hi)]
    layer = bb.num_layers - 1
    with torch.inference_mode():
        out = fd.flash_decode_gqa1(q, state.cache_k, state.cache_v, layer, *ints)
        ref = fd.flash_decode_gqa1_plain(q, state.cache_k, state.cache_v,
                                         layer, *ints)
        err, ok = _compare(out, ref)
        times = {}
        if cuda:
            step = itertools.count()
            times = time_pair(
                lambda: fd.flash_decode_gqa1(q, state.cache_k, state.cache_v,
                                             next(step) % bb.num_layers, *ints),
                lambda: fd.flash_decode_gqa1_plain(
                    q, state.cache_k, state.cache_v, next(step) % bb.num_layers,
                    *ints), 30)
    Hkv, Dh = bb.num_kv_heads, bb.head_dim
    if cuda:
        kv = [t[layer, :, lo:hi].view(1, hi - lo, Hkv, Dh).transpose(1, 2)
              for t in (state.cache_k, state.cache_v)]
        times["library_ms"] = library_ms(sdpa_call(
            q[:, :, None], kv[0], kv[1],
            torch.ones((1, 1, 1, hi - lo), dtype=torch.bool, device=dev)), 30)
    bnd, by = bound_ms(4 * bb.num_heads * Dh + (hi - lo) * Hkv * Dh * 4,
                       4 * bb.num_heads * Dh * (hi - lo))
    res["kernel_a_at_dialogue"] = dict(B=1, live=hi - lo, live_start=lo,
                                       max_abs_err=err, ok=ok, bound_ms=bnd,
                                       bound_by=by, **times)
    checks["dialogue_kernel_a_matches_plain"] = ok
    res.update(phase_s=time.perf_counter() - t_phase, checks=checks,
               launches=runs, ok=all(checks.values()))
    if keep is not None:
        keep.update(engine=eng, segments=segs)
    del eng, state
    if cuda:
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Serving pools at flagship width (the continuous batcher)
# ---------------------------------------------------------------------------

SERVE_TEXTS = [
    "Good morning, and welcome to the first episode of our show.",
    "The weather today is mild, with a light breeze from the west.",
    "Please remember to bring your ticket to the front desk early.",
    "Our next guest has spent ten years building small sailboats.",
    "Turn left at the second light and the station is on your right.",
    "She opened the letter slowly and read it twice before smiling.",
    "The library will close an hour early on the last day of May.",
    "We tested the new recipe with fresh basil and a little lemon.",
    "Thank you for calling, your request has been placed in queue.",
    "Every evening the old clock in the hall chimes exactly seven.",
    "The train to the coast leaves at noon from platform number four.",
    "Water the plants twice a week and keep them out of direct sun.",
    "He said the meeting was moved to Thursday after the long lunch.",
    "Kids love the museum because they can touch almost everything.",
    "The forecast calls for snow in the hills by the end of the week.",
    "Let me read the summary once more before we make a final call.",
]
POOLS = (16, 8)
GREEDY_SEED = 5
SERVE_SAMPLING = ((0.7, 5), (0.8, 10), (0.9, 20), (1.0, 40))


def _sync() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _consume(handles) -> list:
    """Drain each handle (its error raised) -> list of audio arrays."""
    return [np.concatenate(list(h)) for h in handles]


def common_prefix(a: np.ndarray, b: np.ndarray) -> int:
    """Frames two token streams share from their start."""
    n = min(len(a), len(b))
    d = np.nonzero((a[:n] != b[:n]).any(axis=1))[0]
    return int(d[0]) if len(d) else n


def lm_step_ms(eng, B: int, dev, reps: int = 10) -> float:
    """CUDA-event ms of one batched LM frame (backbone S=1 with kernel A,
    kernel B) at B streams, per-row sampling tensors as the pool passes
    them, on a fresh state after a 128-slot prefill."""
    import torch
    from fireredtts2_tpu_torch.models.lm.model import (
        build_step_frame, lm_generate_frame,
    )
    cfg = eng.config.llm
    ncb, V = cfg.audio_num_codebooks, cfg.audio_vocab_size
    noise = torch.ones((B, ncb, V), device=dev)
    temp = torch.full((B, 1), 0.9, device=dev)
    topk = torch.full((B,), 20, dtype=torch.int32, device=dev)
    state = eng._new_lm_state(B)
    tokens = torch.zeros((B, 128, cfg.num_columns), dtype=torch.int32, device=dev)
    mask = torch.zeros_like(tokens, dtype=torch.bool)
    mask[..., -1] = True
    with torch.inference_mode():
        state, frame = lm_generate_frame(eng.lm_params, cfg, state, tokens, mask,
                                         torch.ones((B, 128), dtype=torch.bool,
                                                    device=dev), noise, temp, topk)
        valid = torch.ones((B, 1), dtype=torch.bool, device=dev)

        def step():
            nonlocal state, frame
            t, m = build_step_frame(cfg, frame)
            state, frame = lm_generate_frame(eng.lm_params, cfg, state, t, m,
                                             valid, noise, temp, topk)
        return event_ms(step, reps)


def profile_pool(b, dev, texts, max_ms: float) -> tuple:
    """A burst of len(texts) requests traced by the profiler: CUDA kernels
    per pool step (one batched frame) and per stream frame, and the
    device's busy share over the burst. The burst is the pool's own work
    and fails the phase like any other; only the profiler is optional
    (without it the trace's numbers are left out). -> (result, checks)."""
    n0 = len([e for e in b.timeline if e["ev"] == "block"])

    def burst():
        t0 = time.perf_counter()
        with b.burst():
            hs = [b.submit(t, "[S1]", max_audio_length_ms=max_ms)
                  for t in texts]
        audios = _consume(hs)               # raises a handle's error
        _sync()
        return hs, audios, time.perf_counter() - t0

    (hs, audios, wall), kernels = under_profiler(burst)
    checks = {"traced_ok": all(h.error is None for h in hs) and all(
        len(a) == len(h.tokens) * 1920 > 0 and np.isfinite(a).all()
        for a, h in zip(audios, hs))}
    res = dict(wall_s=wall)
    if kernels is not None:
        blocks = [e for e in b.timeline if e["ev"] == "block"][n0:]
        steps = sum(e["K"] for e in blocks)
        stream_frames = sum(e["K"] * e["n"] for e in blocks)
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
        res.update(cuda_kernels=len(kernels), pool_steps=steps,
                   cuda_kernels_per_step=len(kernels) / max(steps, 1),
                   cuda_kernels_per_stream_frame=(len(kernels)
                                                  / max(stream_frames, 1)),
                   device_s=busy, busy_share=busy / wall)
    return res, checks


def serve_burst(b, eng, pool: int, max_ms: float, ref_tokens) -> tuple:
    """One request per slot, submitted together: pool // 2 identical
    greedy requests (top-k 1 for codebook 0; one utterance seed, as the
    depth chain samples at the engine's depth top-k) of SERVE_TEXTS[0] and
    the rest sampled with mixed temperature and top-k. Launch counts set to 0 just before and
    read just after. -> (result, checks)."""
    import collections
    import torch

    n_greedy = pool // 2
    reqs = [(SERVE_TEXTS[0], 1.0, 1, GREEDY_SEED)] * n_greedy + [
        (SERVE_TEXTS[1 + i], *SERVE_SAMPLING[i % len(SERVE_SAMPLING)], None)
        for i in range(pool - n_greedy)]
    b.reset_host_stats()
    b.timeline.clear()
    _sync()
    reset_counts()
    t0 = time.perf_counter()
    with b.burst():                       # one admission for the burst
        hs = [b.submit(t, "[S1]", temperature=tp, topk=k,
                       max_audio_length_ms=max_ms, utt_seed=seed)
              for t, tp, k, seed in reqs]
    audios = _consume(hs)
    _sync()
    wall = time.perf_counter() - t0
    counts = read_counts()
    sr = eng.output_sample_rate
    audio_s = sum(len(a) for a in audios) / sr
    fpl = sorted(h.first_packet_s * 1e3 for h in hs)
    ks = collections.Counter(e["K"] for e in b.timeline if e["ev"] == "block")
    blocks = [e for e in b.timeline if e["ev"] == "block"]
    greedy = [h.tokens for h in hs[:n_greedy]]
    checks = {
        "finite": all(np.isfinite(a).all() for a in audios),
        "len": all(len(a) == len(h.tokens) * 1920 > 0 for a, h in zip(audios, hs)),
        "greedy_identical": all(np.array_equal(g, greedy[0]) for g in greedy),
    }
    for k in ("flash_decode_gqa1", "fused_depth_decode",
              "flash_decode_update_bounded"):
        checks[f"{k}_launched"] = counts[k] > 0
    res = dict(
        wall_s=wall, audio_s=audio_s, aggregate_rtf=audio_s / wall,
        first_packet_ms=dict(median=float(np.median(fpl)), max=fpl[-1],
                             all=fpl),
        frames=[len(h.tokens) for h in hs], policy_k=dict(ks),
        block_wall_ms_per_step=(sum(e["wall_ms"] for e in blocks)
                                / max(sum(e["K"] for e in blocks), 1)),
        host_stats=b.host_stats(), launches=counts,
        greedy_common_prefix_with_b1=common_prefix(greedy[0], ref_tokens),
        greedy_frames=len(greedy[0]), b1_frames=len(ref_tokens))
    return res, checks


def serve_staggered(b, pool: int, max_ms: float) -> tuple:
    """Half the pool admitted while the other half decodes: pool // 2
    requests, their first packets awaited, then pool // 2 more."""
    import torch
    half = pool // 2
    _sync()
    reset_counts()
    t0 = time.perf_counter()
    with b.burst():
        first = [b.submit(SERVE_TEXTS[-1 - i], "[S1]", max_audio_length_ms=max_ms)
                 for i in range(half)]
    heads = [h.chunks.get(timeout=600) for h in first]
    with b.burst():
        later = [b.submit(SERVE_TEXTS[i + 1], "[S1]", topk=10,
                          max_audio_length_ms=max_ms) for i in range(half)]
    audios = [np.concatenate([c] + list(h)) for c, h in zip(heads, first)]
    audios += _consume(later)
    _sync()
    wall = time.perf_counter() - t0
    counts = read_counts()
    live = [h for h in first if h.finished_s and h.finished_s > max(
        x.first_packet_s for x in later)]
    checks = {"staggered_finite": all(np.isfinite(a).all() and len(a) > 0
                                      for a in audios),
              "staggered_admitted_while_decoding": len(live) > 0}
    for k in ("flash_decode_gqa1", "fused_depth_decode",
              "flash_decode_update_bounded"):
        checks[f"staggered_{k}_launched"] = counts[k] > 0
    return dict(wall_s=wall, later_first_packet_ms=sorted(
        h.first_packet_s * 1e3 for h in later), launches=counts), checks


def write_serving_dir(d: str, config) -> None:
    """config_llm.json / config_codec.json of `config`'s LM and codec (the
    flagship's: the codec JSON's empty sections mean its defaults)."""
    llm = config.llm
    with open(os.path.join(d, "config_llm.json"), "w") as f:
        json.dump({"llm_models": dict(
            backbone_flavor=llm.backbone_flavor,
            decoder_flavor=llm.decoder_flavor,
            text_vocab_size=llm.text_vocab_size,
            audio_vocab_size=llm.audio_vocab_size,
            audio_num_codebooks=llm.audio_num_codebooks,
            decoder_loss_weight=llm.decoder_loss_weight)}, f)
    with open(os.path.join(d, "config_codec.json"), "w") as f:
        json.dump({"codec": {}}, f)


def run_serving(dev, card: str, keep: dict, max_ms: float = 4000.0,
                load_overrides: dict | None = None) -> dict:
    """Phase 11: the continuous batcher over the serving preset's engine at
    flagship width. For pools of 16 and 8: the warm-up ladder, a burst of
    one request per slot (serve_burst), staggered arrivals, a traced
    burst (CUDA kernels per step, busy share) and the LM's ms per batched
    frame. Through the 8-slot pool also a batched clone and a 2-turn
    dialogue over phase 10's prompts, and a hot reload of a second seed's
    trees (saved with save_params under DIR/torch/) while two streams are
    live; then a bounded pool (seq_capacity=1024, max_frames_cap=128) with
    an idle slot stepping past its slab's end, and an engine loaded at
    full width from DIR (JSON configs of the flagship). keep: phase 10's
    engine and prompt segments, taken out of it so that the engine is freed
    before the load; on return it holds the loaded "engine", "dir" and the
    first prompt's audio ("prompt_audio") for phase 12, which removes DIR
    (here it is removed only when this phase raises). load_overrides: the loaded engine's llm_overrides
    (default: the serving preset's). On the CPU (a rehearsal at a small
    config) the LM timing and the trace are skipped and the launch checks
    fail, by design."""
    import dataclasses
    import shutil
    import tempfile
    import threading

    import torch
    from fireredtts2_tpu_torch.config import CodecConfig
    from fireredtts2_tpu_torch.engine import FireRedTTS2Engine
    from fireredtts2_tpu_torch.runtime import checkpoint as ckpt
    from fireredtts2_tpu_torch.runtime.batcher import ContinuousBatcher
    from fireredtts2_tpu_torch.weights import init_random

    eng, segs = keep.pop("engine"), keep.pop("segments")
    t_phase = time.perf_counter()
    checks: dict = {}
    launches: dict = {}
    res: dict = dict(card=card, pools={})
    list(eng.generate_stream(SERVE_TEXTS[0], "[S1]", max_audio_length_ms=max_ms,
                             temperature=1.0, topk=1, utt_seed=GREEDY_SEED))
    ref_tokens = eng.last_tokens           # the greedy request at B=1

    b8 = None
    for pool in POOLS:
        b = ContinuousBatcher(eng, max_streams=pool)
        b.start()
        checks[f"pool{pool}_ready"] = b.wait_ready(timeout=900)
        r: dict = dict(warmup_s=b.warmup_s)
        r["burst"], c = serve_burst(b, eng, pool, max_ms, ref_tokens)
        checks.update({f"pool{pool}_{k}": v for k, v in c.items()})
        launches[f"pool{pool}_burst"] = r["burst"]["launches"]
        r["staggered"], c = serve_staggered(b, pool, max_ms)
        checks.update({f"pool{pool}_{k}": v for k, v in c.items()})
        launches[f"pool{pool}_staggered"] = r["staggered"]["launches"]
        cuda = torch.device(dev).type == "cuda"
        r["profile"], c = profile_pool(b, dev, SERVE_TEXTS[:pool], 1200.0)
        checks.update({f"pool{pool}_{k}": v for k, v in c.items()})
        r["lm_ms_per_step"] = lm_step_ms(eng, pool, dev) if cuda else None
        r["lm_ms_per_step_b1"] = (lm_step_ms(eng, 1, dev)
                                  if cuda and pool == POOLS[0] else None)
        res["pools"][pool] = r
        if pool == POOLS[-1]:           # the 8-slot pool serves on below
            b8 = b
        else:
            b.stop()
        del b

    # batched clone and a 2-turn dialogue through the 8-slot pool
    reset_counts()
    t0 = time.perf_counter()
    clone = b8.generate_monologue_clone(
        CLONE_TEXT, prompt_text=PROMPTS[0][0][4:], prompt_audio=segs[0].audio,
        max_frames=50)
    _sync()
    res["clone"] = dict(wall_s=time.perf_counter() - t0,
                        audio_s=len(clone) / eng.output_sample_rate,
                        launches=read_counts())
    launches["pool8_clone"] = res["clone"]["launches"]
    checks["clone_finite"] = len(clone) > 0 and bool(np.isfinite(clone).all())
    reset_counts()
    t0 = time.perf_counter()
    turns: dict = {}
    for i, c in b8.run_dialogue(DIALOGUE[:2], prompt_segments=segs,
                                max_utterance_ms=2000):
        turns.setdefault(i, []).append(c)
    _sync()
    res["dialogue"] = dict(wall_s=time.perf_counter() - t0,
                           turn_samples=[sum(len(c) for c in turns[i])
                                         for i in sorted(turns)],
                           launches=read_counts())
    launches["pool8_dialogue"] = res["dialogue"]["launches"]
    checks["dialogue_two_turns"] = sorted(turns) == [0, 1] and all(
        np.isfinite(np.concatenate(turns[i])).all() for i in turns)
    for run in ("clone", "dialogue"):
        for k in ("flash_decode_gqa1", "fused_depth_decode",
                  "flash_decode_update_bounded"):
            checks[f"{run}_{k}_launched"] = res[run]["launches"][k] > 0

    # hot reload of a second seed's trees while two streams are live
    root = os.path.dirname(os.path.abspath(__file__))
    d = tempfile.mkdtemp(prefix=".serving_ckpt_", dir=root)
    # removed by phase 13, or at exit whatever phase fails before it
    atexit.register(shutil.rmtree, d, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        lm2, codec2 = init_random(eng.config, seed=1, device=dev)
        ckpt.save_params(ckpt.converted_path(d, "llm_posttrain"), lm2)
        ckpt.save_params(ckpt.converted_path(d, "codec"), codec2)
        write_serving_dir(d, eng.config)
        res["save_s"] = time.perf_counter() - t0
        res["ckpt_gb"] = sum(os.path.getsize(os.path.join(d, "torch", f))
                             for f in os.listdir(os.path.join(d, "torch"))) / 1e9
        live = [b8.submit(SERVE_TEXTS[3 + i], "[S1]", max_audio_length_ms=max_ms)
                for i in range(2)]
        heads = [h.chunks.get(timeout=600) for h in live]
        err: list = []

        def reload():
            try:
                b8.reload(d, timeout_s=600.0)
            except Exception as e:  # noqa: BLE001
                err.append(e)
        th = threading.Thread(target=reload)
        th.start()
        audios = [np.concatenate([c] + list(h)) for c, h in zip(heads, live)]
        th.join(timeout=900)
        res["reload"] = dict(b8.last_reload or {}, error=repr(err) if err else None,
                             live_frames=[len(h.tokens) for h in live])
        checks["reload_ok"] = not err and not th.is_alive()
        checks["reload_live_streams_whole"] = all(
            h.error is None and len(a) == len(h.tokens) * 1920 > 0
            and np.isfinite(a).all() for a, h in zip(audios, live))
        checks["reload_leaves_equal_saved"] = all(
            torch.equal(eng.lm_params[k], lm2[k].to(eng.lm_params[k].dtype))
            for k in ("text_embeddings", "audio_embeddings", "codebook0_head")
        ) and torch.equal(eng.codec_params["upsample"]["up_conv_w"],
                          codec2["upsample"]["up_conv_w"])
        after = np.concatenate(list(b8.submit(SERVE_TEXTS[5], "[S1]",
                                              max_audio_length_ms=800)))
        checks["reload_serves_after"] = len(after) > 0 and bool(
            np.isfinite(after).all())
        b8.stop()
        del b8, lm2, codec2
        torch.cuda.empty_cache()

        # a bounded pool: an idle slot (slot 0, placed at T - 8) steps past
        # its slab's end while a neighbour streams 50 frames; slot 1, placed
        # at T, writes no row at all, nor does slot 0 below T - 8
        bb = ContinuousBatcher(eng, max_streams=8, seq_capacity=1024,
                               max_frames_cap=128)
        bb.start()
        checks["bounded_ready"] = bb.wait_ready(timeout=900)
        T = bb.lm_state.cache_k.shape[2]
        pos = bb.lm_state.pos.clone()
        pos[0], pos[1] = T - 8, T
        bb.lm_state = dataclasses.replace(bb.lm_state, pos=pos)
        st = bb.lm_state
        before = [c[:, 0, :T - 8].clone() for c in (st.cache_k, st.cache_v)] + [
            c[:, 1].clone() for c in (st.cache_k, st.cache_v)]
        reset_counts()
        h = bb.submit(SERVE_TEXTS[0], "[S1]", temperature=1.0, topk=1,
                      max_audio_length_ms=max_ms, utt_seed=GREEDY_SEED)
        a = np.concatenate(list(h))
        _sync()
        res["bounded"] = dict(slab=T, idle_pos_after=int(bb.lm_state.pos[0]),
                              frames=len(h.tokens), launches=read_counts())
        launches["bounded"] = res["bounded"]["launches"]
        checks["bounded_idle_slot_past_slab"] = int(bb.lm_state.pos[0]) > T
        st = bb.lm_state
        after = [c[:, 0, :T - 8] for c in (st.cache_k, st.cache_v)] + [
            c[:, 1] for c in (st.cache_k, st.cache_v)]
        checks["bounded_idle_rows_unchanged"] = all(
            torch.equal(x, y) for x, y in zip(before, after))
        checks["bounded_finite"] = len(a) == len(h.tokens) * 1920 > 0 and bool(
            np.isfinite(a).all())
        bb.stop()
        del bb

        # an engine loaded at full width from DIR (DIR/torch/ trees)
        eng_config = eng.config
        del eng
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        codec_cfg = eng_config.codec     # the JSON holds the flagship's
        eng2 = FireRedTTS2Engine(
            pretrained_dir=d, device=dev,
            llm_overrides=(dict(quantize_backbone=True, fused_depth_plan=PRESET)
                           if load_overrides is None else load_overrides),
            codec_overrides=None if codec_cfg == CodecConfig() else {
                f.name: getattr(codec_cfg, f.name)
                for f in dataclasses.fields(codec_cfg)})
        _sync()
        res["load_s"] = time.perf_counter() - t0
        # a server's start: load, warm up (a prefill per bucket and a short
        # stream through kernels A, B and C), serve
        reset_counts()
        res["engine_warmup_s"] = eng2.warmup()
        res["engine_warmup_launches"] = read_counts()
        launches["engine_warmup"] = res["engine_warmup_launches"]
        for k in ("flash_decode_gqa1", "fused_depth_decode",
                  "flash_decode_update_bounded"):
            checks[f"engine_warmup_{k}_launched"] = \
                res["engine_warmup_launches"][k] > 0
        a = eng2.generate(TEXT, "[S1]", max_audio_length_ms=800, utt_seed=3)
        checks["loaded_engine_serves"] = len(a) > 0 and bool(np.isfinite(a).all())
    except BaseException:
        shutil.rmtree(d, ignore_errors=True)
        raise
    # the server phase serves this engine and this DIR, phase 13 exports
    # with its configs and codec tree (and removes it)
    keep.update(engine=eng2, dir=d, prompt_audio=segs[0].audio)
    torch.cuda.empty_cache()
    res.update(launches=launches, checks=checks, ok=all(checks.values()),
               phase_s=time.perf_counter() - t_phase)
    return res


# ---------------------------------------------------------------------------
# The server over sockets at flagship width
# ---------------------------------------------------------------------------

SERVER_MAX_STREAMS = 8          # the JAX server's default (serve/server.py:130)
SERVER_TIMEOUT_S = 600


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class LiveServer:
    """The port's WebSocketTTSServer + HealthHTTPServer on free localhost
    ports, the WebSocket server (when `websockets` imports) on an event
    loop of its own thread."""

    def __init__(self, eng, max_streams: int, voice_dir=None, security=None,
                 reload_root=None):
        import asyncio
        import threading
        from fireredtts2_tpu_torch.serve import server as srv

        self.ws = srv.WebSocketTTSServer(eng, host="127.0.0.1",
                                         port=free_port(),
                                         max_streams=max_streams,
                                         security=security)
        batcher = getattr(self.ws.service, "batcher", None)
        self.ready = batcher.wait_ready(900) if batcher is not None else True
        self.http = srv.HealthHTTPServer(self.ws, host="127.0.0.1",
                                         port=free_port(), voice_dir=voice_dir,
                                         reload_root=reload_root)
        self.http.start()
        self.port = self.http.httpd.server_port
        self.base = f"http://127.0.0.1:{self.port}"
        self.ws_url = f"ws://127.0.0.1:{self.ws.port}"
        try:
            import websockets  # noqa: F401
            self.has_ws = True
        except ImportError:
            self.has_ws = False
        self.loop = None
        if self.has_ws:
            self.loop = asyncio.new_event_loop()
            self._t = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
            self._t.start()
            asyncio.run_coroutine_threadsafe(self.ws.start(),
                                             self.loop).result(60)

    def close(self) -> None:
        import asyncio
        self.http.stop()
        if self.loop is not None:
            asyncio.run_coroutine_threadsafe(self.ws.stop(),
                                             self.loop).result(60)
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._t.join(timeout=10)
        else:
            self.ws.service.shutdown()


def pcm_of(audio: np.ndarray) -> np.ndarray:
    """The client's float32 (int16 / 32768) back to int16 values."""
    return np.round(np.asarray(audio, np.float64) * 32768).astype(np.int32)


def lsb_gap(a: np.ndarray, b: np.ndarray):
    """Max |a - b| in LSB of two PCM16 arrays, None when their lengths
    differ (or both are empty)."""
    if len(a) != len(b) or len(a) == 0:
        return None
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def chunked_request(port: int, body: dict, out: dict, gate=None) -> None:
    """POST one chunked-stream request: out gets the seconds to its first
    PCM byte and to its end, and the bytes. With `gate` (a Barrier) it is
    sent when the gate opens."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=SERVER_TIMEOUT_S)
    if gate is not None:
        gate.wait()
    t0 = time.perf_counter()
    conn.request("POST", "/api/v1/tts/generate-streaming",
                 body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    first = resp.read(2)                  # blocks until the first chunk
    out["first_byte_s"] = time.perf_counter() - t0
    rest = resp.read()                    # raises on a cut chunked body
    out["end_s"] = time.perf_counter() - t0
    out["data"] = first + rest
    out["status"] = resp.status
    conn.close()


def stream_burst(live, body: dict, n: int, hold=None) -> tuple:
    """n chunked streams sent together (threads released by one barrier).
    hold: a batcher whose burst() is held until all n are queued, so the
    pool admits them as one. -> (per-request dicts, wall seconds)."""
    import threading
    outs = [dict() for _ in range(n)]
    gate = threading.Barrier(n + 1)
    ths = [threading.Thread(target=chunked_request,
                            args=(live.port, body, outs[i], gate))
           for i in range(n)]
    for t in ths:
        t.start()
    ctx = hold.burst() if hold is not None else None
    if ctx is not None:
        ctx.__enter__()
    try:
        gate.wait()
        t0 = time.perf_counter()
        if hold is not None:
            deadline = time.monotonic() + 60
            while hold.pending.qsize() < n and time.monotonic() < deadline:
                time.sleep(0.001)
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
    for t in ths:
        t.join(timeout=SERVER_TIMEOUT_S)
    return outs, time.perf_counter() - t0


def timed(fn, *a, **kw):
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    return out, time.perf_counter() - t0


def run_server(dev, card: str, keep: dict, direct_rtf=None,
               direct_lm_ms=None, max_ms: float = 4000.0) -> dict:
    """Phase 12: the serving front end at flagship width on the engine that
    phase 11 loaded from DIR (the serving preset). (a) In process: the
    port's server (WebSocketTTSServer, max_streams=8, and
    HealthHTTPServer) on free localhost ports, driven over its sockets by
    the port's client, every kernel launch count set to 0 just before its
    requests and read just after: /health, /stats (the card's memory, the
    batcher's telemetry), a greedy /api/v1/tts/generate against the same
    request through ContinuousBatcher.submit alone (within 1 LSB), a burst
    of 8 identical greedy chunked streams (identical bytes; their first
    bytes and the aggregate RTF), a traced burst (CUDA kernels per pool
    step), /v1/audio/speech, a voice made from phase 10's prompt and a
    clone in it, a conversation turn, an admin reload to the same DIR
    with two live streams (none dropped, the greedy request after equal to
    the one before), a server with require_auth (401 without a token), the
    WebSocket stream against REST (where websockets imports), the
    service thread's CUDA stream. (b) `python -m fireredtts2_tpu_torch
    --pretrained-dir DIR ... serve` as a subprocess (its log in
    chiprun_out/): /health within a bound, /stats naming the card, the
    same greedy request within 1 LSB of (a)'s. keep: phase 11's "engine",
    "dir" (left for phase 13, which removes it) and "prompt_audio"."""
    import shutil
    import tempfile
    import torch
    from fireredtts2_tpu_torch.client import FireRedTTSClient
    from fireredtts2_tpu_torch.serve.monitor import reset_performance_monitor
    from fireredtts2_tpu_torch.serve.security import create_security_system
    from fireredtts2_tpu_torch.utils.audio_io import f32_to_pcm16

    eng, prompt = keep.pop("engine"), keep.pop("prompt_audio")
    d = keep["dir"]
    t_phase = time.perf_counter()
    checks: dict = {}
    walls: dict = {}
    res: dict = dict(card=card)
    greedy = dict(temperature=1.0, top_k=1, max_audio_length_ms=max_ms,
                  seed=GREEDY_SEED)
    live = None
    try:
        reset_performance_monitor()
        live = LiveServer(eng, SERVER_MAX_STREAMS,
                          voice_dir=tempfile.mkdtemp(dir=d), reload_root=d)
        b = live.ws.service.batcher
        checks["server_ready"] = live.ready
        res["websockets"] = live.has_ws
        c = FireRedTTSClient(live.base, ws_url=live.ws_url,
                             timeout=SERVER_TIMEOUT_S)
        _sync()
        reset_counts()
        h, walls["health"] = timed(c.health)
        checks["health"] = h.get("status") == "healthy"
        st, walls["stats"] = timed(c.stats)
        devst = st.get("device", {})
        checks["stats_card_memory"] = (
            devst.get("kind") == torch.cuda.get_device_name(0)
            and devst.get("bytes_limit", 0) > 0
            and devst.get("bytes_in_use", 0) > 0)
        checks["stats_batcher_telemetry"] = all(
            k in st for k in ("active_streams", "queue_depth", "chunk_drops",
                              "block_policy", "host"))
        checks["worker_on_default_stream"] = (
            b.cuda_stream is not None and b.cuda_stream.cuda_stream
            == torch.cuda.default_stream(eng.device).cuda_stream)

        # the server's first request (the block policy cold), then a burst
        # of 8 identical greedy chunked streams admitted as one (the policy
        # is fitted by then: at B=8 it picks the largest K, as every later
        # request sees it)
        (a, sr), walls["generate_cold"] = timed(c.synthesize, SERVE_TEXTS[0],
                                                **greedy)
        cold_pcm = pcm_of(a)
        b.reset_host_stats()
        b.timeline.clear()
        body = dict(greedy, text=SERVE_TEXTS[0])
        outs, wall = stream_burst(live, body, SERVER_MAX_STREAMS, hold=b)
        walls["stream_burst"] = wall
        datas = [o.get("data", b"") for o in outs]
        checks["burst_identical"] = (
            all(o.get("status") == 200 for o in outs)
            and len(datas[0]) > 0 and all(x == datas[0] for x in datas))
        audio_s = sum(len(x) // 2 for x in datas) / sr
        blocks = [e for e in b.timeline if e["ev"] == "block"]
        res["burst"] = dict(
            first_byte_ms=sorted(o["first_byte_s"] * 1e3 for o in outs),
            end_ms=sorted(o["end_s"] * 1e3 for o in outs), wall_s=wall,
            audio_s=audio_s, aggregate_rtf=audio_s / wall,
            direct_pool8_rtf=direct_rtf,
            block_wall_ms_per_step=(sum(e["wall_ms"] for e in blocks)
                                    / max(sum(e["K"] for e in blocks), 1)),
            host_stats=b.host_stats(), blocks=blocks)

        # a greedy request: REST against ContinuousBatcher.submit alone,
        # both on the fitted policy
        (a, _), walls["generate"] = timed(c.synthesize, SERVE_TEXTS[0], **greedy)
        rest_pcm = pcm_of(a)
        h = b.submit(SERVE_TEXTS[0], "[S1]", temperature=1.0, topk=1,
                     max_audio_length_ms=max_ms, utt_seed=GREEDY_SEED)
        direct = np.concatenate(list(h))
        direct_pcm = np.frombuffer(f32_to_pcm16(direct), "<i2")
        res["generate_vs_submit_lsb"] = lsb_gap(rest_pcm, direct_pcm)
        checks["generate_equals_submit"] = (
            res["generate_vs_submit_lsb"] is not None
            and res["generate_vs_submit_lsb"] <= 1)
        res["greedy_frames"] = len(h.tokens)
        # the cold request ran other block sizes (the vocoder's bf16 passes
        # of other shapes): a bound; the burst's prefill ran 8 rows where a
        # lone request's has 1 (a token may flip): a reading
        res["cold_vs_warm_lsb"] = lsb_gap(cold_pcm, rest_pcm)
        # the same greedy frames through other block sizes: bounded
        checks["cold_vs_warm_bounded"] = (
            res["cold_vs_warm_lsb"] is not None
            and res["cold_vs_warm_lsb"] <= STREAM_GAP_LSB)
        res["burst_vs_generate_lsb"] = lsb_gap(
            np.frombuffer(datas[0], "<i2"), rest_pcm)

        # the same burst traced: CUDA kernels per pool step
        res["traced"] = server_trace(live, b, dict(body, max_audio_length_ms=1200))
        checks["server_traced_ok"] = res["traced"]["ok"]

        # the OpenAI route, a voice and a clone, a conversation turn
        wav, walls["speech"] = timed(c.speech, SERVE_TEXTS[1], seed=11,
                                     max_audio_length_ms=2000)
        checks["speech_riff"] = (wav[:4] == b"RIFF" and wav[8:12] == b"WAVE"
                                 and len(wav) > 44)
        pid, walls["voice_create"] = timed(c.create_voice, "phase10",
                                           PROMPTS[0][0][4:], prompt)
        (cl, _), walls["clone"] = timed(c.clone_speech, CLONE_TEXT, pid,
                                        seed=12, max_audio_length_ms=4000)
        checks["clone_audio"] = (len(cl) > 0 and bool(np.isfinite(cl).all())
                                 and float(np.sqrt(np.mean(cl ** 2))) > 0)
        sid = c.start_conversation()
        turn, walls["conversation_turn"] = timed(
            c.conversation_turn, sid, "Hello, how are you?",
            max_audio_length_ms=2000, seed=13)
        checks["conversation_audio"] = (bool(turn.get("response_text"))
                                        and len(turn.get("data", "")) > 0)

        # reload to the same DIR with two live streams
        reload_check(live, c, d, greedy, rest_pcm, checks, res, walls)

        # the WebSocket stream against REST
        if live.has_ws:
            w, walls["ws_stream"] = timed(lambda: np.concatenate(list(
                c.stream_ws(SERVE_TEXTS[0], **greedy))))
            res["ws_vs_rest_lsb"] = lsb_gap(pcm_of(w), rest_pcm)
            checks["ws_equals_rest"] = res["ws_vs_rest_lsb"] in (0, 1)
        _sync()
        res["launches"] = read_counts()
        for k in ("flash_decode_gqa1", "fused_depth_decode",
                  "flash_decode_update_bounded"):
            checks[f"{k}_launched"] = res["launches"][k] > 0

        # a server with require_auth: 401 without a token
        sec = LiveServer(eng, 1, security=create_security_system(
            require_auth=True))
        try:
            FireRedTTSClient(sec.base).synthesize("no token", **greedy)
            checks["auth_401"] = False
        except urllib.error.HTTPError as e:
            checks["auth_401"] = e.code == 401
        finally:
            sec.close()

        # the LM's ms per batched frame with the server up (idle)
        res["lm_ms_per_step"] = lm_step_ms(eng, SERVER_MAX_STREAMS, dev)
        res["direct_lm_ms_per_step"] = direct_lm_ms
        st = c.stats()
        res["block_policy"] = st.get("block_policy")
        res["block_frame_cost_ms"] = (st.get("block_policy") or {}).get(
            "frame_cost_ms")
        res["recommendations"] = [r["code"] for r in st.get("recommendations", [])]
        res["stats_device"] = st.get("device")
        live.close()
        live = None

        # (b) the normal entry point, a process of its own
        res["cli"] = run_cli_server(d, dict(cold=cold_pcm, warm=rest_pcm),
                                    greedy, checks, keep.get("asr_dir"))
    finally:
        if live is not None:
            live.close()
        del eng
        torch.cuda.empty_cache()
    res.update(walls_s=walls, checks=checks, ok=all(checks.values()),
               phase_s=time.perf_counter() - t_phase)
    return res


def server_trace(live, b, body: dict) -> dict:
    """The 8-stream burst once more under torch.profiler: CUDA kernels per
    pool step and per stream frame, and the busy share (left out when the
    profiler is unavailable)."""
    n0 = len([e for e in b.timeline if e["ev"] == "block"])
    (outs, wall), kernels = under_profiler(lambda: stream_burst(
        live, body, SERVER_MAX_STREAMS, hold=b))
    out = dict(wall_s=wall, ok=all(o.get("status") == 200 and "end_s" in o
                                   and len(o.get("data", b"")) > 0
                                   for o in outs),
               first_byte_ms=sorted(o["first_byte_s"] * 1e3 for o in outs))
    if kernels:
        blocks = [e for e in b.timeline if e["ev"] == "block"][n0:]
        steps = sum(e["K"] for e in blocks)
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
        out.update(cuda_kernels=len(kernels), pool_steps=steps,
                   cuda_kernels_per_step=len(kernels) / max(steps, 1),
                   cuda_kernels_per_stream_frame=len(kernels) / max(
                       sum(e["K"] * e["n"] for e in blocks), 1),
                   busy_share=busy / wall)
    return out


def reload_check(live, c, d: str, greedy: dict, before, checks: dict,
                 res: dict, walls: dict) -> None:
    """POST /api/v1/admin/reload to the same DIR while two chunked streams
    are live: both end whole (no cut chunked body), and the greedy request
    after the swap equals the one before within 1 LSB."""
    import threading
    outs = [dict(), dict()]
    ths = [threading.Thread(target=chunked_request, args=(
        live.port, dict(greedy, text=SERVE_TEXTS[3 + i], seed=20 + i),
        outs[i])) for i in range(2)]
    for t in ths:
        t.start()
    deadline = time.monotonic() + 300
    while (not all("first_byte_s" in o for o in outs)
           and time.monotonic() < deadline):
        time.sleep(0.01)
    out, walls["admin_reload"] = timed(c.admin_reload, d, 600.0)
    for t in ths:
        t.join(timeout=SERVER_TIMEOUT_S)
    res["reload"] = dict(out, streams_bytes=[len(o.get("data", b""))
                                             for o in outs],
                         batcher=live.ws.service.batcher.last_reload)
    checks["reload_ok"] = out.get("reloaded") == d
    checks["reload_streams_whole"] = all(
        o.get("status") == 200 and len(o.get("data", b"")) > 0
        and "end_s" in o for o in outs)
    (a, _), walls["generate_after_reload"] = timed(
        c.synthesize, SERVE_TEXTS[0], **greedy)
    res["after_reload_lsb"] = lsb_gap(pcm_of(a), before)
    checks["reload_same_greedy"] = res["after_reload_lsb"] in (0, 1)


def run_cli_server(d: str, want_pcm: dict, greedy: dict, checks: dict,
                   asr_dir: str | None = None) -> dict:
    """`python -m fireredtts2_tpu_torch --pretrained-dir DIR
    --quantize-backbone --fused-depth-plan PRESET serve --max-streams 8`
    as a subprocess (log: chiprun_out/phase12_serve.log): /health within
    300 s, /stats naming the card, the greedy request within 1 LSB of the
    in-process server's, as its first request (block policy cold) and
    once the policy's fit exists (its third): want_pcm {"cold", "warm"}.
    With asr_dir (the ASR phase's HF whisper dir) the server also runs
    `--asr --asr-dir asr_dir --asr-max-new-tokens ASR_MAX_NEW`: a
    /v1/audio/speech request (kernels A, B
    and C launched in it, by /stats' kernel_launches), then that wav
    through client.transcribe (200, text). The process is terminated at
    the end."""
    import torch
    from fireredtts2_tpu_torch.client import FireRedTTSClient

    os.makedirs(OUT_DIR, exist_ok=True)
    log_path = os.path.join(OUT_DIR, "phase12_serve.log")
    http_port, ws_port = free_port(), free_port()
    cmd = [sys.executable, "-m", "fireredtts2_tpu_torch", "--pretrained-dir", d,
           "--quantize-backbone", "--fused-depth-plan", PRESET, "serve",
           "--max-streams", str(SERVER_MAX_STREAMS), "--http-port",
           str(http_port), "--ws-port", str(ws_port)]
    if asr_dir:
        cmd += ["--asr", "--asr-dir", asr_dir,
                "--asr-max-new-tokens", str(ASR_MAX_NEW)]
    out: dict = dict(cmd=" ".join(cmd[1:]))
    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                                stdout=logf, stderr=subprocess.STDOUT)
        try:
            c = FireRedTTSClient(f"http://127.0.0.1:{http_port}",
                                 ws_url=f"ws://127.0.0.1:{ws_port}",
                                 timeout=SERVER_TIMEOUT_S)
            healthy = False
            while time.perf_counter() - t0 < 300 and proc.poll() is None:
                try:
                    healthy = c.health().get("status") == "healthy"
                    break
                except OSError:
                    time.sleep(0.25)
            out["ready_s"] = time.perf_counter() - t0
            checks["cli_health"] = healthy
            if healthy:
                st = c.stats()
                out["stats_device"] = st.get("device")
                checks["cli_stats_card"] = (st.get("device", {}).get("kind")
                                            == torch.cuda.get_device_name(0))
                # its first request (policy cold); a second, after which
                # the policy's fit exists at the first block; the same
                # request on the fitted policy: the first and the third
                # against (a)'s
                for label in ("cold", "fit", "warm"):
                    (a, _), out[f"generate_{label}_s"] = timed(
                        c.synthesize, SERVE_TEXTS[0], **greedy)
                    if label in want_pcm:
                        gap = lsb_gap(pcm_of(a), want_pcm[label])
                        out[f"{label}_vs_in_process_lsb"] = gap
                        checks[f"cli_{label}_equals_in_process"] = gap in (0, 1)
                if asr_dir:
                    out["asr"] = served_transcription(c, checks)
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=60)
    out["exit_code"] = proc.returncode
    text = open(log_path).read()
    out["log_tail"] = text[-2000:]
    m = re.search(r"ASR from .*: loaded in ([\d.]+) s, warmed up in ([\d.]+) s",
                  text)
    if m:
        out["asr_load_s"], out["asr_warmup_s"] = float(m[1]), float(m[2])
    if asr_dir:
        checks["cli_no_transcription_failure"] = (
            m is not None and "transcription failed" not in text)
    return out


# ---------------------------------------------------------------------------
# Whisper ASR at whisper-large-v3's full width
# ---------------------------------------------------------------------------

ASR_SEED = 17
ASR_MAX_NEW = 32            # tokens a window: random weights seldom emit EOT
ASR_PREV = 16               # the long-form run's <|startofprev|> window
ASR_FALLBACK = (0.5,)       # the ladder's rungs above T = 0
ASR_NARROW = 2              # (c)'s encoder and decoder depth
ASR_CLIPS_S = (10.0, 45.0)
LANG_SUM_TOL = 1e-5         # |sum of the language probabilities - 1|
TOP2_GAP = 1e-3             # (b): positions past the first closer call are not held
# the fields an HF config.json gives (asr.convert.asr_config_from_hf)
HF_FIELDS = ("n_mels", "vocab_size", "encoder_layers", "decoder_layers",
             "num_heads", "embed_dim", "ffn_dim", "max_source_positions",
             "max_target_positions", "sot_id", "eot_id")


class FailureLog:
    """Collects the ASR service's logged failures ("transcription failed")
    while it is attached."""

    def __init__(self):
        import logging

        self.records: list = []
        outer = self

        class _H(logging.Handler):
            def emit(self, record):
                if "transcription failed" in record.getMessage():
                    outer.records.append(record.getMessage())
        self.handler = _H()
        self.logger = logging.getLogger("fireredtts2_tpu_torch.asr.asr")

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def asr_ids(res) -> list:
    return [t for seg in res.segments for t in seg["tokens"]]


def transcript_ok(res, vocab: int) -> bool:
    """A non-silent clip's transcript: text, and every token id in the
    vocabulary."""
    ids = asr_ids(res)
    return bool(res.text.strip()) and bool(ids) and all(
        0 <= t < vocab for t in ids)


def teacher_forced(asr, audio: np.ndarray) -> dict:
    """(b): one S > 1 forward over the prompt and the step-by-step greedy
    tokens of the clip's first window; its argmax at each position must be
    the token the steps chose, up to the first position whose top-2 logit
    gap is under TOP2_GAP."""
    import torch
    from fireredtts2_tpu_torch.asr import model as am

    cfg, dev = asr.model_cfg, asr.device
    mel, mel_len = asr._mel(audio[: asr._n_samples])
    prompt = torch.from_numpy(asr._prompt_ids(None)[0]).to(dev)
    ctx = am.encoder_context(asr.params, cfg, mel, mel_len)
    res = am._sample_loop(asr.params, cfg, *ctx,
                          am.init_asr_decode_state(cfg, 1, torch.float32, dev),
                          prompt, ASR_MAX_NEW)
    n = int(res.n_tokens[0])
    ids = res.tokens[0, :n].long()
    full = torch.cat([prompt[0], ids])[None]
    state = am.init_asr_decode_state(cfg, 1, torch.float32, dev)
    logits, _ = am.asr_decoder_forward(asr.params, cfg, full, state, *ctx)
    P = prompt.shape[1]
    pred = logits[0, P - 1: P - 1 + n]          # position P-1+i predicts ids[i]
    top2 = pred.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu()
    close = [i for i in range(n) if gap[i] < TOP2_GAP]
    held = close[0] if close else n
    equal = bool((pred.argmax(-1)[:held] == ids[:held]).all())
    return dict(tokens=n, held=held, equal=equal,
                min_top2_gap=float(gap.min()) if n else None)


def asr_step_numbers(asr, audio: np.ndarray) -> dict:
    """Encoder ms per 30 s window and decoder ms per token (CUDA events),
    the greedy loop's wall per token (one host read of `done` a token), a
    decoder step's device ms and CUDA launches (profiler)."""
    import torch
    from fireredtts2_tpu_torch.asr import model as am

    cfg, p, dev = asr.model_cfg, asr.params, asr.device
    mel, mel_len = asr._mel(audio[: asr._n_samples])
    out = dict(encoder_ms=event_ms(lambda: am.asr_encode(p, cfg, mel, mel_len),
                                   reps=5, warmup=1),
               context_ms=event_ms(lambda: am.encoder_context(p, cfg, mel,
                                                              mel_len),
                                   reps=3, warmup=1))
    ctx = am.encoder_context(p, cfg, mel, mel_len)
    prompt = torch.from_numpy(asr._prompt_ids(None)[0]).to(dev)
    layers = am.decoder_layer_views(p)
    state = am.init_asr_decode_state(cfg, 1, torch.float32, dev)
    logits, state = am.asr_decoder_forward(p, cfg, prompt, state, *ctx, layers)
    tok = logits[:, -1].argmax(-1, keepdim=True)

    def step():
        return am.asr_decoder_forward(p, cfg, tok, state, *ctx, layers)

    out["decoder_ms_per_token"] = event_ms(step, reps=20)
    out["decoder_device_ms_per_token"] = device_ms(step, reps=5)
    out["cuda_launches_per_token"] = cuda_launches(step)
    _sync()
    t0 = time.perf_counter()
    res = am._sample_loop(p, cfg, *ctx,
                          am.init_asr_decode_state(cfg, 1, torch.float32, dev),
                          prompt, ASR_MAX_NEW)
    n_calls = int(res.n_tokens[0]) + 1
    _sync()
    out["loop_ms_per_token"] = (time.perf_counter() - t0) * 1e3 / n_calls
    return out


def run_asr(dev, card: str, keep: dict, config=None) -> dict:
    """Whisper at whisper-large-v3's full width and depth (32 + 32 layers,
    1280 wide, vocabulary 51,866), fp32 random weights from ASR_SEED:
    (a) a 10 s and a 45 s voiced clip transcribed (the ladder; the long one
    greedy in two windows, the second conditioned on the first), the
    language detected, the 10 s clip again with int8 weights; (b) the
    teacher-forced check; (c) a 2 + 2-layer model at full width on the
    card and on the CPU, tokens equal; the numbers of (e); and a served
    HF dir written from (a)'s weights for phase 12's subprocess
    (keep["asr_dir"]): its header and config checked here. config: another model config (a CPU
    rehearsal's tiny one)."""
    import dataclasses
    import tempfile

    import torch
    from fireredtts2_tpu_torch.asr import (
        ASRConfig, WhisperASR, WhisperASRModelConfig, init_asr_params,
        write_hf_whisper_dir,
    )
    from fireredtts2_tpu_torch.asr import model as am
    from fireredtts2_tpu_torch.asr.convert import (
        _HFConfig, asr_config_from_hf, hf_whisper_state_dict,
    )

    t_phase = time.perf_counter()
    checks: dict = {}
    res: dict = dict(card=card)
    cfg = config or WhisperASRModelConfig()
    V = cfg.vocab_size
    _sync()
    on_card = torch.device(dev).type == "cuda"
    base_gb = torch.cuda.memory_allocated() / 1e9 if on_card else float("nan")
    reset_peak(dev)
    gen = torch.Generator(device=dev).manual_seed(ASR_SEED)
    t0 = time.perf_counter()
    params = init_asr_params(gen, cfg, device=dev)
    _sync()
    res["init_s"] = time.perf_counter() - t0
    res["params"] = sum(t.numel() for _, t in _leaves(params))
    ladder = ASRConfig(max_new_tokens=ASR_MAX_NEW,
                       fallback_temperatures=ASR_FALLBACK)
    long_form = ASRConfig(max_new_tokens=ASR_MAX_NEW, prev_window=ASR_PREV,
                          fallback_temperatures=())
    clips = {s: voiced(int(s * 16_000), ASR_SEED + i)
             for i, s in enumerate(ASR_CLIPS_S)}
    short, long_ = clips[ASR_CLIPS_S[0]], clips[ASR_CLIPS_S[1]]
    with FailureLog() as failures:
        asr = WhisperASR(config=ladder, params=params, model_cfg=cfg,
                         warmup=False, device=dev)
        asr.config = long_form
        asr.transcribe(short[:16_000])                 # warm-up, greedy
        # (a) the 10 s clip through the ladder
        asr.config = ladder
        calls = asr.decode_calls
        _sync()
        r10, wall10 = timed(asr.transcribe, short)
        _sync()
        res["short"] = dict(wall_s=wall10, rtf=ASR_CLIPS_S[0] / wall10,
                            decode_calls=asr.decode_calls - calls,
                            temperature=r10.segments[0]["temperature"]
                            if r10.segments else None,
                            tokens=len(asr_ids(r10)), text=r10.text[:120])
        checks["asr_short_transcript"] = transcript_ok(r10, V)
        # (a) the 45 s clip, greedy, in two windows
        asr.config = long_form
        sots: list = []
        prompt_ids = asr._prompt_ids

        def spy(*a):
            out = prompt_ids(*a)
            sots.append(out[1])
            return out
        asr._prompt_ids = spy
        _sync()
        r45, wall45 = timed(asr.transcribe, long_)
        _sync()
        del asr._prompt_ids
        res["long"] = dict(wall_s=wall45, rtf=ASR_CLIPS_S[1] / wall45,
                           windows=len(r45.segments), sot_indices=sots,
                           tokens=len(asr_ids(r45)))
        checks["asr_long_transcript"] = transcript_ok(r45, V)
        checks["asr_long_two_windows_conditioned"] = (
            len(r45.segments) == 2 and sots[-1] == ASR_PREV + 1)
        # (a) the language
        mel, mel_len = asr._mel(short[: asr._n_samples])
        probs = am.asr_detect_language(params, cfg, mel, mel_len)[0]
        res["language"] = asr.detect_language(short)["language"]
        res["language_prob_sum_err"] = abs(float(probs.double().sum()) - 1.0)
        checks["asr_language_probs_sum_to_1"] = (
            res["language_prob_sum_err"] <= LANG_SUM_TOL
            and probs.shape == (cfg.num_languages,))
        # (b) teacher-forced against the steps
        res["teacher_forced"] = teacher_forced(asr, short)
        checks["asr_teacher_forced_equals_steps"] = (
            res["teacher_forced"]["equal"] and res["teacher_forced"]["tokens"] > 0)
        # (e) the numbers
        res["fp32"] = asr_step_numbers(asr, short)
        # (a) int8
        asr8 = WhisperASR(config=ladder, params=params, model_cfg=cfg,
                          warmup=False, quantize_int8=True, device=dev)
        asr8.config = long_form
        asr8.transcribe(short[:16_000])
        asr8.config = ladder
        _sync()
        r8, wall8 = timed(asr8.transcribe, short)
        _sync()
        ids8, ids32 = asr_ids(r8), asr_ids(r10)
        res["int8"] = dict(wall_s=wall8, rtf=ASR_CLIPS_S[0] / wall8,
                           tokens=len(ids8),
                           tokens_equal_fp32=sum(a == b for a, b in zip(ids8, ids32)),
                           **asr_step_numbers(asr8, short))
        checks["asr_int8_transcript"] = transcript_ok(r8, V)
        del asr8
        res["peak_gb"] = peak_gb(dev)
        res["peak_gb_over_base"] = res["peak_gb"] - base_gb

        # the served dir from (a)'s weights, read back
        d = tempfile.mkdtemp(prefix=".serving_ckpt_asr_",
                             dir=os.path.dirname(os.path.abspath(__file__)))
        atexit.register(shutil.rmtree, d, True)
        t0 = time.perf_counter()
        write_hf_whisper_dir(d, params, cfg)
        res["dir_write_s"] = time.perf_counter() - t0
        st_path = os.path.join(d, "model.safetensors")
        res["dir_gb"] = os.path.getsize(st_path) / 1e9
        # its header and config; 12(b)'s server loads the tensors
        with open(st_path, "rb") as f:
            header = json.loads(f.read(int.from_bytes(f.read(8), "little")))
        want = {k: list(t.shape) for k, t in hf_whisper_state_dict(params).items()}
        with open(os.path.join(d, "config.json")) as f:
            lcfg = asr_config_from_hf(_HFConfig(json.load(f)))
        checks["asr_dir_header_and_config"] = (
            {k: v["shape"] for k, v in header.items() if k != "__metadata__"}
            == want and all(v["dtype"] == "F32" for v in header.values())
            and all(getattr(lcfg, f) == getattr(cfg, f) for f in HF_FIELDS))
        del asr
        keep["asr_dir"] = d
        # phase 11c searches on these weights (no second init)
        keep["asr_model"] = dict(params=params, cfg=cfg, clip=short)
        del params

        # (c) narrow depth at full width: the card against the CPU
        ncfg = dataclasses.replace(cfg, encoder_layers=ASR_NARROW,
                                   decoder_layers=ASR_NARROW)
        cpu_params = init_asr_params(torch.Generator().manual_seed(ASR_SEED + 1),
                                     ncfg, device="cpu")
        on = {where: WhisperASR(config=long_form, params=cpu_params,
                                model_cfg=ncfg, warmup=False, device=where)
              for where in ("cpu", dev)}
        (rc, res["narrow_cpu_s"]), (rg, res["narrow_card_s"]) = (
            timed(on["cpu"].transcribe, short), timed(on[dev].transcribe, short))
        res["narrow_tokens"] = (len(asr_ids(rc)), len(asr_ids(rg)))
        checks["asr_narrow_card_equals_cpu"] = (
            asr_ids(rc) == asr_ids(rg) and bool(asr_ids(rc)))
        del on, cpu_params
        torch.cuda.empty_cache()
    res["failures"] = failures.records
    checks["asr_no_logged_failure"] = not failures.records
    res.update(checks=checks, ok=all(checks.values()),
               phase_s=time.perf_counter() - t_phase)
    return res


ASR_BEAM = 5                # 11c: beam width and best-of candidates
ASR_BEST_T = 0.5            # the best-of rung's temperature
ASR_SUM_TOL = 1e-3          # beam sum vs a teacher-forced forward, relative
ASR_NARROW_BEAM = 3         # (c)'s beam width
STREAM_CHUNK_S = 0.5        # (d)'s pushes
RT_FRAME_S = 0.1            # (e)'s PCM16 frames


def forced_logprob_sum(params, cfg, ctx, prompt, ids: list, max_new: int
                       ) -> float:
    """The log-probability of `ids` (and of EOT after them when fewer than
    max_new) under one teacher-forced S > 1 forward after `prompt`."""
    import torch
    from fireredtts2_tpu_torch.asr import model as am

    dev = prompt.device
    tail = ids + ([cfg.eot_id] if len(ids) < max_new else [])
    full = torch.cat([prompt[0], torch.tensor(tail, device=dev)])[None]
    state = am.init_asr_decode_state(cfg, 1, torch.float32, dev)
    logits, _ = am.asr_decoder_forward(params, cfg, full, state, *ctx)
    P = prompt.shape[1]
    lp = torch.log_softmax(logits[0, P - 1: P - 1 + len(tail)].double(), -1)
    return float(lp.gather(1, torch.tensor(tail, device=dev)[:, None]).sum())


class LocalConnection:
    """An in-process stand-in for a WebSocket connection to
    RealtimeASRServer._handle: an async iterator over `frames`, an async
    send that keeps each message with its arrival time."""

    def __init__(self, frames: list):
        self.frames = frames
        self.sent: list = []
        self.t_end = None

    def __aiter__(self):
        return self._frames()

    async def _frames(self):
        for f in self.frames:
            if isinstance(f, str) and '"end_session"' in f:
                self.t_end = time.perf_counter()
            yield f

    async def send(self, msg: str) -> None:
        self.sent.append((time.perf_counter(), json.loads(msg)))


def realtime_session(server, audio: np.ndarray) -> dict:
    """One session: start, the audio as PCM16 frames of RT_FRAME_S, end.
    Over localhost sockets where ``websockets`` imports, else through
    LocalConnection into the server's handler. -> the messages received,
    the route, and the seconds from end_session to the final transcript."""
    import asyncio

    from fireredtts2_tpu_torch.asr.realtime import RealtimeASRClient

    n = int(RT_FRAME_S * server.cfg.sample_rate)
    pcm = [(np.clip(audio[i:i + n], -1, 1) * 32767).astype("<i2").tobytes()
           for i in range(0, len(audio), n)]
    start, end = (json.dumps({"type": "start_session"}),
                  json.dumps({"type": "end_session"}))
    try:
        import websockets  # noqa: F401
    except ImportError:
        conn = LocalConnection([start] + pcm + [end])
        asyncio.run(server._handle(conn))
        msgs = [m for _, m in conn.sent]
        t_final = next((t for t, m in conn.sent if m["type"] == "transcription"
                        and m["is_final"] and t >= conn.t_end), None)
        return dict(route="in-process", messages=msgs,
                    end_to_final_s=None if t_final is None
                    else t_final - conn.t_end)

    async def scenario():
        await server.start()
        client = RealtimeASRClient(f"ws://127.0.0.1:{server.port}")
        msgs, t_final = [], None
        try:
            await client.connect()
            msgs.append(await client.start_session())
            for frame in pcm:
                await client.ws.send(frame)
            t_end = time.perf_counter()
            await client.end_session()
            while True:
                m = await client.recv(timeout=600)
                msgs.append(m)
                if (m["type"] == "transcription" and m["is_final"]
                        and t_final is None):
                    t_final = time.perf_counter()
                if m["type"] in ("session_ended", "error"):
                    break
        finally:
            await client.close()
            await server.stop()
        return dict(route="sockets", messages=msgs,
                    end_to_final_s=None if t_final is None
                    else t_final - t_end)
    server.port = free_port()
    server.host = "127.0.0.1"
    return asyncio.run(scenario())


def run_asr_search(dev, card: str, keep: dict) -> dict:
    """Phase 11c on phase 11b's weights (keep["asr_model"], freed here):
    (a) beam search at W=5 on the clip's T = 0 rung and best-of-5 at
    T = 0.5, by the model's functions (beam: token ids in the vocabulary,
    n_finished <= W, the winner's sum equal to a teacher-forced forward's;
    best-of: the winner equal to the best row of a plain batch of N rows
    decoded with the same draws) and through the service's ladder; (b)
    word timestamps of a greedy transcript; (c) a 2 + 2-layer model at
    full width, beam W=3 on the card and on the CPU; (d) the streaming
    service over the clip in 0.5 s chunks; (e) one realtime session; (f)
    the numbers: ms per token (CUDA events of a decoder step at W rows,
    and the host loop's wall), the alignment forward and the DTW,
    streaming and realtime latency, peak memory."""
    import dataclasses

    import torch
    from fireredtts2_tpu_torch.asr import (
        ASRConfig, StreamingWhisperASR, WhisperASR, init_asr_params,
        split_to_words,
    )
    from fireredtts2_tpu_torch.asr import model as am
    from fireredtts2_tpu_torch.asr.realtime import (
        RealtimeASRServer, StreamingConfig,
    )
    from fireredtts2_tpu_torch.asr.timestamps import dtw_path

    t_phase = time.perf_counter()
    checks: dict = {}
    model = keep.pop("asr_model")
    params, cfg, clip = model["params"], model["cfg"], model["clip"]
    V, W = cfg.vocab_size, ASR_BEAM
    clip_s = len(clip) / 16_000
    res: dict = dict(card=card, clip_s=clip_s)
    reset_peak(dev)

    def service(**kw):
        conf = dict(max_new_tokens=ASR_MAX_NEW, fallback_temperatures=())
        conf.update(kw)
        return WhisperASR(config=ASRConfig(**conf), params=params,
                          model_cfg=cfg, warmup=False, device=dev)

    with FailureLog() as failures:
        # (a) the searches by the model's functions, on the clip's window
        asr = service(beam_size=W, best_of=W, fallback_temperatures=(ASR_BEST_T,),
                      logprob_threshold=float("inf"))
        mel, mel_len = asr._mel(clip[: asr._n_samples])
        ctx = am.encoder_context(params, cfg, mel, mel_len)
        prompt = torch.from_numpy(asr._prompt_ids(None)[0]).to(dev)
        am._beam_loop(params, cfg, *ctx, prompt, 4, W)             # warm-up
        _sync()
        beam, beam_s = timed(am._beam_loop, params, cfg, *ctx, prompt,
                             ASR_MAX_NEW, W)
        _sync()
        n = int(beam.n_tokens[0])
        ids = beam.tokens[0, :n].tolist()
        forced = forced_logprob_sum(params, cfg, ctx, prompt, ids, ASR_MAX_NEW)
        got = float(beam.sum_logprob[0])
        res["beam"] = dict(W=W, tokens=n, n_finished=int(beam.n_finished[0]),
                           sum_logprob=got, forced_sum=forced,
                           steps=n + (n < ASR_MAX_NEW), wall_s=beam_s)
        checks["asr_beam_tokens_in_vocab"] = bool(ids) and all(
            0 <= t < V for t in ids)
        checks["asr_beam_pool_at_most_w"] = 0 <= int(beam.n_finished[0]) <= W
        checks["asr_beam_sum_equals_teacher_forced"] = (
            abs(got - forced) <= ASR_SUM_TOL * abs(forced))

        noise = asr.noise_fn(1, W)
        best, best_s = timed(am._best_of_loop, params, cfg, *ctx, prompt,
                             ASR_MAX_NEW, W, ASR_BEST_T, noise)
        _sync()
        # the plain batch: N identical rows, each encoded (no tiling)
        tcross, tlen = am.encoder_context(params, cfg, mel.repeat(W, 1, 1),
                                          mel_len.repeat(W))
        plain = am._sample_loop(
            params, cfg, tcross, tlen,
            am.init_asr_decode_state(cfg, W, torch.float32, dev),
            prompt.repeat_interleave(W, dim=0), ASR_MAX_NEW, ASR_BEST_T,
            noise)
        avg = plain.sum_logprob / (plain.n_tokens.float() + 1.0)
        w = int(avg.argmax())
        res["best_of"] = dict(N=W, temperature=ASR_BEST_T,
                              tokens=int(best.n_tokens[0]), winner_row=w,
                              rows_tokens=plain.n_tokens.tolist(), wall_s=best_s)
        checks["asr_best_of_equals_plain_batch"] = (
            int(best.n_tokens[0]) == int(plain.n_tokens[w])
            and torch.equal(best.tokens[0], plain.tokens[w]))
        del tcross, tlen, plain

        # (a) through the service: beam on the T = 0 rung, best-of at 0.5
        calls = asr.decode_calls
        _sync()
        r, wall = timed(asr.transcribe, clip)
        _sync()
        res["service"] = dict(wall_s=wall, rtf=clip_s / wall,
                              decode_calls=asr.decode_calls - calls,
                              temperature=r.segments[0]["temperature"]
                              if r.segments else None,
                              tokens=len(asr_ids(r)))
        checks["asr_service_beam_then_best_of"] = (
            transcript_ok(r, V) and asr.decode_calls - calls == 2)

        # (f) a decoder step at W rows (CUDA events) and the loops' wall
        tcross, tlen = am._tile_beams(*ctx, W)
        layers = am.decoder_layer_views(params)
        state = am.init_asr_decode_state(cfg, W, torch.float32, dev)
        logits, state = am.asr_decoder_forward(
            params, cfg, prompt.repeat_interleave(W, dim=0), state, tcross,
            tlen, layers)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        res["step_ms_w_rows"] = event_ms(
            lambda: am.asr_decoder_forward(params, cfg, tok, state, tcross,
                                           tlen, layers), reps=10)
        res["beam_loop_ms_per_token"] = beam_s * 1e3 / res["beam"]["steps"]
        res["best_of_loop_ms_per_token"] = best_s * 1e3 / (
            max(res["best_of"]["rows_tokens"]) + 1)
        slab = state.cache_k
        res["slab_gather_mb_per_token"] = 4 * slab.numel() * 4 / 1e6
        del tcross, tlen, state, slab

        # (b) word timestamps of a greedy transcript
        asr_w = service(word_timestamps=True)
        r_w = asr_w.transcribe(clip)
        words = [w_ for seg in r_w.segments for w_ in seg.get("words", [])]
        seg_ids = asr_ids(r_w)
        starts = [w_["start"] for w_ in words]
        _, counts = split_to_words(seg_ids, asr_w.detokenize)
        res["words"] = dict(n_words=len(words), tokens=len(seg_ids),
                            first=words[:3])
        checks["asr_words_monotonic_in_clip"] = bool(words) and all(
            a <= b for a, b in zip(starts, starts[1:])) and all(
            0.0 <= w_["start"] <= w_["end"] <= clip_s + 1e-6 for w_ in words)
        checks["asr_words_cover_every_token"] = (
            sum(counts) == len(seg_ids) and len(counts) == len(words))
        full = torch.cat([prompt[0], torch.tensor(seg_ids, device=dev)])[None]
        heads = asr_w.alignment_heads
        res["align_heads"] = len(heads)
        res["align_ms"] = event_ms(
            lambda: am._alignment_loop(params, cfg, *ctx, full, heads),
            reps=3, warmup=1)
        probs, _ = am._alignment_loop(params, cfg, *ctx, full, heads)
        res["align_maps_mb"] = probs.numel() * 4 / 1e6
        n_frames = max(len(clip) // 320, 1)
        mat = probs[0, :, prompt.shape[1]:, :n_frames].mean(0).cpu().numpy()
        t0 = time.perf_counter()
        dtw_path(-mat)
        res["dtw_ms"] = (time.perf_counter() - t0) * 1e3
        res["dtw_cells"] = list(mat.shape)
        del probs, asr_w

        # (c) 2 + 2 layers at full width: beam on the card and on the CPU
        ncfg = dataclasses.replace(cfg, encoder_layers=ASR_NARROW,
                                   decoder_layers=ASR_NARROW)
        cpu_params = init_asr_params(
            torch.Generator().manual_seed(ASR_SEED + 2), ncfg, device="cpu")
        outs = {}
        for where in ("cpu", dev):
            a = WhisperASR(params=cpu_params, model_cfg=ncfg, warmup=False,
                           device=where)
            m, ml = a._mel(clip[: a._n_samples])
            pr = torch.from_numpy(a._prompt_ids(None)[0]).to(where)
            outs[where] = am.asr_beam_decode(a.params, ncfg, m, ml, pr,
                                             ASR_MAX_NEW, ASR_NARROW_BEAM)
        oc, og = outs["cpu"], outs[dev]
        res["narrow_beam"] = dict(W=ASR_NARROW_BEAM,
                                  n_tokens=(int(oc.n_tokens[0]),
                                            int(og.n_tokens[0])),
                                  n_finished=(int(oc.n_finished[0]),
                                              int(og.n_finished[0])))
        checks["asr_narrow_beam_card_equals_cpu"] = all(
            torch.equal(getattr(og, f).cpu(), getattr(oc, f))
            for f in ("tokens", "n_tokens", "n_finished"))
        del outs, cpu_params

        # (d) streaming over the clip in 0.5 s chunks
        streaming = StreamingWhisperASR(service())
        step = int(STREAM_CHUNK_S * 16_000)
        expect = (len(clip) - streaming.chunk_size) // (
            streaming.chunk_size - streaming.overlap_size) + 1
        streaming.start_streaming()
        pushed, arrived = [], []
        for i in range(0, len(clip), step):
            streaming.add_audio_chunk(clip[i:i + step])
            pushed.append(time.perf_counter())
        deadline = time.perf_counter() + 120
        while len(arrived) < expect and time.perf_counter() < deadline:
            got_r = streaming.get_transcription_result(timeout=0.5)
            if got_r is not None:
                arrived.append(time.perf_counter())
        kept = None
        try:
            streaming.stop_streaming()
        except Exception as e:        # the thread's kept exception
            kept = repr(e)
        per = (streaming.chunk_size - streaming.overlap_size) // step
        first = streaming.chunk_size // step - 1
        lat = [t - pushed[min(first + k * per, len(pushed) - 1)]
               for k, t in enumerate(arrived)]
        res["streaming"] = dict(results=len(arrived), expected=expect,
                                push_to_result_s=lat, error=kept)
        checks["asr_streaming_results_no_error"] = bool(arrived) and kept is None

        # (e) one realtime session, interim passes off
        server = RealtimeASRServer(service(),
                                   StreamingConfig(interim_interval_s=3600.0))
        rt = realtime_session(server, clip)
        finals = [m for m in rt["messages"]
                  if m["type"] == "transcription" and m["is_final"]]
        errors = [m for m in rt["messages"] if m["type"] == "error"]
        res["realtime"] = dict(route=rt["route"], finals=len(finals),
                               errors=errors,
                               end_to_final_s=rt["end_to_final_s"],
                               text=finals[-1]["text"][:80] if finals else None)
        checks["asr_realtime_final_no_error"] = (
            bool(finals) and not errors and bool(finals[-1]["text"])
            and rt["end_to_final_s"] is not None)
    res["failures"] = failures.records
    checks["asr_search_no_logged_failure"] = not failures.records
    res["peak_gb"] = peak_gb(dev)
    del params, model, ctx, asr
    torch.cuda.empty_cache()
    res.update(checks=checks, ok=all(checks.values()),
               phase_s=time.perf_counter() - t_phase)
    return res


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def served_transcription(c, checks: dict) -> dict:
    """(d): a greedy /v1/audio/speech request of 4 s at most through the
    CLI server's kernels A, B and C, then its wav to
    /v1/audio/transcriptions through the client: 200 and text."""
    import io

    from scipy.io import wavfile

    k0 = c.stats()["kernel_launches"]
    wav, speech_s = timed(c.speech, SERVE_TEXTS[1], seed=11, temperature=1.0,
                          max_audio_length_ms=4000)
    k1 = c.stats()["kernel_launches"]
    launched = {k: k1[k] - k0[k] for k in k1}
    sr, pcm = wavfile.read(io.BytesIO(wav))
    audio = pcm.astype(np.float32) / 32768.0
    text, transcribe_s = timed(c.transcribe, audio, sr)
    checks["cli_speech_launches_a_b_c"] = all(
        launched[k] > 0 for k in ("flash_decode_gqa1", "fused_depth_decode",
                                  "flash_decode_update_bounded"))
    checks["cli_transcription_text"] = bool(text.strip())
    return dict(speech_s=speech_s, transcribe_s=transcribe_s,
                round_trip_s=speech_s + transcribe_s, audio_s=len(audio) / sr,
                launches=launched, text=text[:120])


# ---------------------------------------------------------------------------
# Training at flagship width, then train -> export -> serve
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 4, 512            # the LM's batch: 2048 positions
TRAIN_WARMUP, TRAIN_TIMED = 2, 8
CODEC_B, CODEC_WINDOW = 2, 32_000    # 2 s at 16 kHz
CODEC_WARMUP, CODEC_TIMED = 1, 4
LOSS_FP32_TOL = 0.02                 # fp32 vs bf16 compute, relative
GNORM_REMAT_TOL = 1e-3               # remat modes' gradient norms, relative
PEAK_BF16 = PEAK_OPS_PER_S["bf16"]


def lm_train_flops(cfg, B: int, S: int) -> tuple[float, str]:
    """Model FLOPs of one LM training step (forward + backward = 3 x the
    forward's 2 FLOPs per multiply-add), the attention's dense S x S
    products included, remat's recompute excluded. Returns (FLOPs, the
    formula)."""
    from fireredtts2_tpu_torch.runtime.perf import transformer_matmul_params

    bb, dec = cfg.backbone, cfg.decoder
    N = B * S                               # backbone positions
    n_sub = max(N // 8, 1)                  # depth decoder sequences
    ncb, Va, Vt = cfg.audio_num_codebooks, cfg.audio_vocab_size, cfg.text_vocab_size
    Nd = n_sub * ncb                        # depth decoder positions
    f = (6 * N * (transformer_matmul_params(bb) + bb.embed_dim * (Va + Vt))
         + 12 * bb.num_layers * bb.num_heads * bb.head_dim * S * N
         + 6 * Nd * (transformer_matmul_params(dec) + bb.embed_dim * dec.embed_dim)
         + 12 * dec.num_layers * dec.num_heads * dec.head_dim * ncb * Nd
         + 6 * n_sub * (ncb - 1) * dec.embed_dim * Va)
    formula = ("6*N*(P_backbone + D*(V_audio + V_text)) + 12*L*H*Dh*S*N "
               "+ 6*Nd*(P_decoder + D*D_dec) + 12*L_dec*H_dec*Dh_dec*ncb*Nd "
               "+ 6*n_sub*(ncb-1)*D_dec*V_audio; N = B*S, n_sub = N/8, "
               "Nd = 16*n_sub; P = matmul parameters (perf."
               "transformer_matmul_params)")
    return float(f), formula


def loss_and_gnorm(params, cfg, tokens, mask, seed: int, compute_dtype):
    """One step's loss and gradient norm without the update."""
    import torch
    from fireredtts2_tpu_torch.models.lm.model import lm_loss
    from fireredtts2_tpu_torch.train import step as ts

    gen = ts.depth_generator(seed, 0, tokens.device)
    out = lm_loss(ts.cast_compute(params, compute_dtype), cfg, tokens, mask, gen)
    grads = torch.autograd.grad(out["loss"], ts.tree_leaves(params))
    loss, gnorm = float(out["loss"].detach()), float(ts.global_norm(grads))
    del out, grads
    return loss, gnorm


def step_times(step, n_warmup: int, n_timed: int, dev) -> tuple[list, list]:
    """Run step() n_warmup times, then n_timed times each between CUDA
    events (the host clock in a CPU rehearsal); -> (per-step ms, the
    metrics of every step)."""
    import torch

    metrics = [step() for _ in range(n_warmup)]
    ms = []
    for _ in range(n_timed):
        if torch.device(dev).type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            metrics.append(step())
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            metrics.append(step())
            ms.append((time.perf_counter() - t0) * 1e3)
    return ms, metrics


def reset_peak(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def peak_gb(dev) -> float:
    import torch
    if torch.device(dev).type != "cuda":
        return float("nan")
    return torch.cuda.max_memory_allocated() / 1e9


def train_lm_flagship(dev, card: str, checks: dict, llm_cfg
                      ) -> tuple[dict, object]:
    """(a): the LM's train_step on the card; -> (results, the train
    state)."""
    import dataclasses
    import torch
    from fireredtts2_tpu_torch.models.lm.model import init_lm_params
    from fireredtts2_tpu_torch.train import loop as tl
    from fireredtts2_tpu_torch.train import step as ts

    cfg = dataclasses.replace(llm_cfg, train_remat="dots")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    opt = ts.make_optimizer(peak_lr=1e-4, warmup_steps=2, total_steps=1000)
    state = ts.init_train_state(init_lm_params(gen, cfg, torch.float32, dev), opt)
    n_params = sum(p.numel() for p in ts.tree_leaves(state.params))
    data = tl.synthetic_batches(cfg, tl.TrainConfig(batch_size=TRAIN_B,
                                                    seq_len=TRAIN_S), seed=0)
    batches = [tuple(torch.from_numpy(a).to(dev) for a in next(data))
               for _ in range(TRAIN_WARMUP + TRAIN_TIMED)]
    it = iter(batches)

    def step():
        tok, msk = next(it)
        _, m = ts.train_step(state, tok, msk, cfg=cfg, optimizer=opt,
                             compute_dtype=torch.bfloat16)
        return {k: float(v) for k, v in m.items()}

    reset_peak(dev)
    ms, metrics = step_times(step, TRAIN_WARMUP, TRAIN_TIMED, dev)
    peak = peak_gb(dev)
    it = iter(batches[-1:])
    traced_metrics, traced = trace_call(step, dev, top_n=12)
    metrics.append(traced_metrics)
    traced.pop("by_name", None)
    checks["lm_losses_finite"] = all(math.isfinite(m["loss"]) for m in metrics)
    checks["lm_grad_norms_finite"] = all(math.isfinite(m["grad_norm"])
                                         for m in metrics)
    flops, formula = lm_train_flops(cfg, TRAIN_B, TRAIN_S)
    med = float(np.median(ms))

    # one batch from one state: fp32 vs bf16 compute, and the remat modes
    tok, msk = batches[-1]
    bf16 = {}
    for mode in ("", "full", "dots"):
        bf16[mode or "none"] = loss_and_gnorm(
            state.params, dataclasses.replace(cfg, train_remat=mode), tok, msk,
            7, torch.bfloat16)
    fp32 = loss_and_gnorm(state.params, cfg, tok, msk, 7, None)
    base = bf16["none"]
    checks["lm_remat_losses_bitwise_equal"] = all(
        v[0] == base[0] for v in bf16.values())
    checks["lm_remat_grad_norms_close"] = all(
        abs(v[1] - base[1]) <= GNORM_REMAT_TOL * abs(base[1])
        for v in bf16.values())
    checks["lm_fp32_vs_bf16_loss"] = (
        abs(fp32[0] - bf16["dots"][0]) <= LOSS_FP32_TOL * abs(fp32[0]))
    res = dict(params=n_params, B=TRAIN_B, S=TRAIN_S, remat="dots",
               compute="bf16, fp32 masters", step_ms=ms, step_ms_median=med,
               step_ms_min=min(ms), tokens_per_s=TRAIN_B * TRAIN_S / (med / 1e3),
               peak_gb=peak, model_flops=flops, flops_formula=formula,
               mfu=flops / (med / 1e3) / PEAK_BF16,
               losses=[m["loss"] for m in metrics],
               grad_norms=[m["grad_norm"] for m in metrics],
               bf16_by_remat=bf16, fp32=fp32, traced_step=traced, card=card)
    return res, state


def train_codec_flagship(dev, card: str, checks: dict, cfg) -> dict:
    """(b): the codec's codec_train_step on the card, fp32."""
    import torch
    from fireredtts2_tpu_torch.models.codec.model import init_codec_params
    from fireredtts2_tpu_torch.train import codec_loop as cl
    from fireredtts2_tpu_torch.train import codec_step as cs
    from fireredtts2_tpu_torch.train.step import tree_leaves, tree_map

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    opt = cs.make_codec_optimizer(peak_lr=2e-4, warmup_steps=2, total_steps=1000)
    state = cs.init_codec_train_state(init_codec_params(
        gen, cfg, torch.float32, dev, semantic_head=True), opt)
    frozen0 = tree_map(torch.clone, state.frozen)
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    data = cl.synthetic_audio_batches(cl.CodecTrainConfig(
        batch_size=CODEC_B, window_samples=CODEC_WINDOW), seed=0)

    def step():
        audio, lengths, target = (torch.from_numpy(a).to(dev) for a in next(data))
        _, m = cs.codec_train_step(state, audio, lengths, target, cfg=cfg,
                                   optimizer=opt, remat="dots")
        return {k: float(v) for k, v in m.items()}

    reset_peak(dev)
    ms, metrics = step_times(step, CODEC_WARMUP, CODEC_TIMED, dev)
    checks["codec_losses_finite"] = all(
        math.isfinite(v) for m in metrics for v in m.values())
    checks["codec_frozen_bitwise_unchanged"] = all(
        torch.equal(a, b) for a, b in zip(tree_leaves(state.frozen),
                                          tree_leaves(frozen0)))
    return dict(trainable_params=n_params, B=CODEC_B, window=CODEC_WINDOW,
                remat="dots", compute="fp32", step_ms=ms,
                step_ms_median=float(np.median(ms)), step_ms_min=min(ms),
                peak_gb=peak_gb(dev), losses=[m["loss"] for m in metrics],
                card=card)


def run_training(dev, card: str, config_dir: str, config=None,
                 load_overrides=None) -> dict:
    """Phase 13. (a) The flagship LM trained on the card: random init,
    fp32 masters, bf16 compute, B=4, S=512, remat "dots", synthetic
    batches of seed 0, warmup 2, peak lr 1e-4; 2 steps, then 8 timed with
    CUDA events; on one batch from one state an fp32-compute step's loss
    within 2% of bf16's, and remat "none" / "full" / "dots" with equal
    losses and gradient norms within 1e-3. (b) The flagship codec:
    B=2 2 s windows, fp32, remat "dots", 1 + 4 timed steps, the SSL teacher
    and mel filters bitwise unchanged. (c) (a)'s state saved with
    save_checkpoint, exported with `config_dir` (phase 11's DIR: its
    configs, its codec tree copied) and served by an engine loaded from
    the export with the serving preset: a 10-frame greedy generate through
    kernels A, B and C, finite audio, the engine's unquantised leaves equal
    to the exported masters cast to its dtype. The checkpoint and the
    export are temporary dirs in the checkout, removed at the end.
    config: an EngineConfig (default the flagship's) and load_overrides
    the engine's (llm_overrides, codec_overrides) (default the serving
    preset), for a rehearsal on the CPU at small widths."""
    import tempfile
    import torch
    from fireredtts2_tpu_torch.engine import FireRedTTS2Engine
    from fireredtts2_tpu_torch.runtime import checkpoint as ckpt
    from fireredtts2_tpu_torch.runtime.convert import run_export
    from fireredtts2_tpu_torch.train import loop as tl

    from fireredtts2_tpu_torch.config import EngineConfig

    config = config or EngineConfig()
    llm_over, codec_over = load_overrides or (
        dict(quantize_backbone=True, fused_depth_plan=PRESET), None)
    t_phase = time.perf_counter()
    checks: dict = {}
    res: dict = dict(card=card)
    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix=".train_ckpt_", dir=root)
    try:
        lm, state = train_lm_flagship(dev, card, checks, config.llm)
        res["lm"] = lm
        t0 = time.perf_counter()
        path = tl.save_checkpoint(os.path.join(work, "lm"), state)
        res["save_s"] = time.perf_counter() - t0
        res["ckpt_gb"] = sum(os.path.getsize(os.path.join(path, f))
                             for f in os.listdir(path)) / 1e9
        del state
        torch.cuda.empty_cache()
        res["lm_phase_s"] = time.perf_counter() - t_phase

        res["codec"] = train_codec_flagship(dev, card, checks, config.codec)
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        out = os.path.join(work, "served")
        res["export"] = run_export(out, config_dir, lm_ckpt=path)
        res["export_s"] = time.perf_counter() - t0
        shutil.rmtree(path)
        t0 = time.perf_counter()
        eng = FireRedTTS2Engine(pretrained_dir=out, device=dev,
                                llm_overrides=llm_over,
                                codec_overrides=codec_over)
        _sync()
        res["load_s"] = time.perf_counter() - t0
        masters = ckpt.load_params(ckpt.converted_path(out, "llm_posttrain"))
        names = [k for k, v in eng.lm_params.items()
                 if torch.is_tensor(v) and k in masters]
        checks["served_leaves_equal_exported"] = bool(names) and all(
            torch.equal(eng.lm_params[k], masters[k].to(
                device=eng.lm_params[k].device, dtype=eng.lm_params[k].dtype))
            for k in names)
        res["leaves_compared"] = names
        del masters
        reset_counts()
        t0 = time.perf_counter()
        audio = eng.generate(TEXT, "[S1]", temperature=1.0, topk=1,
                             max_audio_length_ms=800, utt_seed=GREEDY_SEED)
        _sync()
        res["generate_s"] = time.perf_counter() - t0
        res["launches"] = read_counts()
        for k in ("flash_decode_gqa1", "fused_depth_decode",
                  "flash_decode_update_bounded"):
            checks[f"served_{k}_launched"] = res["launches"][k] > 0
        checks["served_audio_finite"] = len(audio) > 0 and bool(
            np.isfinite(audio).all())
        res["frames"] = len(audio) // 1920
        del eng
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res.update(checks=checks, ok=all(checks.values()),
               phase_s=time.perf_counter() - t_phase)
    return res


DRILL_SEED = 23
DRILL_CLI_TIMEOUT_S = 600
DRILL_KERNELS = ("flash_decode_gqa1", "flash_decode_update_bounded")


class StageTimer:
    """While attached, wraps callables (attributes of modules or classes,
    restored on exit) to add up their wall seconds under a name (`s`) and
    keep the clock at their first call (`first`)."""

    def __init__(self, *targets):
        self.targets = targets          # (owner, attribute, name)
        self.s: dict = {}
        self.first: dict = {}
        self._saved: list = []

    def __enter__(self):
        for owner, attr, name in self.targets:
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))

            def wrapped(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                self.first.setdefault(_name, t0)
                try:
                    return _fn(*a, **kw)
                finally:
                    _sync()
                    self.s[_name] = (self.s.get(_name, 0.0)
                                     + time.perf_counter() - t0)
            setattr(owner, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)


def run_convert_drill(dev, card: str, config=None) -> dict:
    """Phase 14, the convert drill at the flagship's widths (config:
    another, a CPU rehearsal's): a reference-layout dir written from seeded
    weights in a temporary dir inside the checkout (removed at the end,
    whatever fails): config_llm.json, config_codec.json, llm_posttrain.pt
    and codec.pt. (a) run_convert(DIR, fidelity=True) in process, launch
    counts zeroed before it: goldens recorded, kernels A and C launched
    and B not (the checkpoint's own config: bf16, no fused depth plan),
    wer and cer finite; (b) `python -m fireredtts2_tpu_torch
    --pretrained-dir DIR convert` as a subprocess: exit 0, every golden
    "ok"; (c) pickle write, conversion, goldens, fidelity (generate,
    transcribe) and the CLI's wall seconds."""
    import tempfile

    import torch
    from fireredtts2_tpu_torch.config import EngineConfig
    from fireredtts2_tpu_torch.engine import FireRedTTS2Engine
    from fireredtts2_tpu_torch.models.codec.model import init_codec_params
    from fireredtts2_tpu_torch.models.lm.model import init_lm_params
    from fireredtts2_tpu_torch.runtime import convert as conv
    from fireredtts2_tpu_torch.serve import qa
    from fireredtts2_tpu_torch.tools.ref_checkpoint import (
        write_reference_pickles,
    )
    from fireredtts2_tpu_torch.weights import dtype_of

    t_phase = time.perf_counter()
    config = config or EngineConfig()
    checks: dict = {}
    res: dict = dict(card=card)
    d = tempfile.mkdtemp(prefix=".convert_drill_",
                         dir=os.path.dirname(os.path.abspath(__file__)))
    atexit.register(shutil.rmtree, d, True)
    try:
        gen = torch.Generator(device=dev).manual_seed(DRILL_SEED)
        lm = init_lm_params(gen, config.llm, dtype_of(config.llm.dtype), dev)
        codec = init_codec_params(gen, config.codec,
                                  dtype_of(config.codec.dtype), dev,
                                  semantic_head=True)
        write_serving_dir(d, config)
        _sync()
        paths, res["pickle_write_s"] = timed(write_reference_pickles, d, lm,
                                             codec)
        res["pickle_gb"] = sum(os.path.getsize(p_) for p_ in paths) / 1e9
        del lm, codec
        torch.cuda.empty_cache()

        # (a) in process, with the fidelity report
        timer = StageTimer(
            (conv, "_golden_codec_tokens", "golden_codec"),
            (conv, "_golden_lm_frames", "golden_lm"),
            (FireRedTTS2Engine, "generate", "fidelity_generate"),
            (qa.FidelityHarness, "evaluate_utterance", "fidelity_harness"))
        reset_counts()
        t0 = time.perf_counter()
        with timer:
            summary = conv.run_convert(d, fidelity=True, device=dev)
        _sync()
        total = time.perf_counter() - t0
        launches = read_counts()
        st = timer.s
        goldens_s = st.get("golden_codec", 0.0) + st.get("golden_lm", 0.0)
        res["convert_s"] = timer.first.get("golden_codec", t0) - t0
        res["goldens_s"] = goldens_s
        res["golden_codec_s"] = st.get("golden_codec")
        res["golden_lm_s"] = st.get("golden_lm")
        res["fidelity_s"] = total - res["convert_s"] - goldens_s
        res["fidelity_generate_s"] = st.get("fidelity_generate")
        res["fidelity_transcribe_s"] = (st.get("fidelity_harness", 0.0)
                                        - st.get("fidelity_generate", 0.0))
        res["in_process_s"] = total
        res["launches"] = launches
        res["summary"] = summary
        fid = summary.get("fidelity", {})
        checks["drill_goldens_recorded"] = (
            summary["parity_ok"] and set(summary["parity"].values())
            == {"recorded"} and len(summary["parity"]) == 2)
        checks["drill_launches_a_and_c_not_b"] = (
            all(launches[k] > 0 for k in DRILL_KERNELS)
            and launches["fused_depth_decode"] == 0)
        checks["drill_fidelity_finite"] = all(
            isinstance(fid.get(k), float) and math.isfinite(fid[k])
            for k in ("wer", "cer")) and fid.get("speaker_sim", 0) is None
        torch.cuda.empty_cache()

        # (b) the CLI as a subprocess: every golden validates
        cmd = [sys.executable, "-m", "fireredtts2_tpu_torch",
               "--pretrained-dir", d, "convert"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=DRILL_CLI_TIMEOUT_S,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        res["cli_s"] = time.perf_counter() - t0
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "phase14_convert_cli.log"), "w") as f:
            f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        try:
            cli = json.loads(proc.stdout[proc.stdout.index("{"):])
        except ValueError:
            cli = {}
        res["cli"] = dict(cmd=" ".join(cmd[1:]), exit_code=proc.returncode,
                          parity=cli.get("parity"))
        checks["drill_cli_exit_0_all_ok"] = (
            proc.returncode == 0 and bool(cli.get("parity"))
            and set(cli["parity"].values()) == {"ok"})
    finally:
        shutil.rmtree(d, ignore_errors=True)
    res.update(checks=checks, ok=all(checks.values()),
               phase_s=time.perf_counter() - t_phase)
    return res


# ---------------------------------------------------------------------------
# Phase 15: speculative (Jacobi) depth and the one-token vocoder
# ---------------------------------------------------------------------------

SPEC_MS = 960.0                   # ~12 frames a generate
SPEC_POOL = 8
SPEC_POOL_MS = 800.0              # 10 frames
SPEC_LOOP_STEPS = (150, 10)       # trained loop: LM and codec steps
ONE_TOKEN_TOKENS = 48             # (e): 6 of the grouped decode's S=64 passes
E_SPEC_MS = (16, 128, 256)        # kernel E's rows: 16 x B at B = 1, 8, 16
STREAM_GAP_TOL = 0.05             # stream vs generate audio, of peak (phase 9)
STREAM_GAP_LSB = 200              # PCM16: the same frames, other block sizes


def depth_logits(params, cfg, last_h, tok, parallel: bool):
    """(B, ncb-1, V) fp32 logits of depth positions 1..ncb-1 with the chain
    `tok` (B, ncb) forced: one stateless 16-position forward (a Jacobi
    round), or the sequential loop's S=2 prefill and S=1 steps."""
    import torch
    from fireredtts2_tpu_torch.models.lm.model import embed_audio
    from fireredtts2_tpu_torch.models.lm.transformer import (
        init_kv_cache, transformer_forward,
    )
    from fireredtts2_tpu_torch.ops import masks as mask_ops

    ncb, V = cfg.audio_num_codebooks, cfg.audio_vocab_size
    B, dtype, dev = last_h.shape[0], last_h.dtype, last_h.device
    proj, heads = params["projection"], params["audio_head"].to(torch.float32)
    if parallel:
        offs = torch.arange(ncb - 1, device=dev) * V
        emb = params["audio_embeddings"][tok[:, :ncb - 1].long() + offs].to(dtype)
        x = torch.cat([last_h[:, None], emb], dim=1) @ proj
        pos = torch.arange(ncb, dtype=torch.int32, device=dev).expand(B, ncb)
        h, _ = transformer_forward(params["decoder"], cfg.decoder, x, pos,
                                   mask_ops.causal_mask(ncb, dev).expand(B, ncb, ncb))
        return torch.einsum("nsd,sdv->nsv", h[:, 1:].to(torch.float32), heads)
    cache = init_kv_cache(cfg.decoder, B, ncb, dtype, dev)
    e0 = embed_audio(params, cfg, 0, tok[:, 0]).to(dtype)
    pos = torch.arange(2, dtype=torch.int32, device=dev).expand(B, 2)
    h, cache = transformer_forward(params["decoder"], cfg.decoder,
                                   torch.stack([last_h, e0], 1) @ proj, pos,
                                   mask_ops.decode_step_mask(pos, ncb), cache, 0)
    out = [h[:, -1].to(torch.float32) @ heads[0]]
    for i in range(2, ncb):
        x = (embed_audio(params, cfg, i - 1, tok[:, i - 1]).to(dtype) @ proj)[:, None]
        pos = torch.full((B, 1), i, dtype=torch.int32, device=dev)
        h, cache = transformer_forward(params["decoder"], cfg.decoder, x, pos,
                                       mask_ops.decode_step_mask(pos, ncb),
                                       cache, i)
        out.append(h[:, -1].to(torch.float32) @ heads[i - 1])
    return torch.stack(out, dim=1)


def flip_reason(lg, noise_row, err: float, got: int, want: int, topk: int,
                temp: float) -> str:
    """Why a sample may differ from the plain version's where the logits
    (`lg`, the plain version's, V) move by up to `err`: "race" where its top
    two race scores lie within a factor exp(2 err / T), "top-k" where `got`
    could enter or `want` leave the top k (within 2 err of the k-th and
    (k+1)-th logits), else "none" (check_kernel_b's rule)."""
    import torch
    gap = float(race_gap(lg[None, None], noise_row[None, None], topk, temp)[0, 0])
    top = torch.topk(lg, topk + 1).values
    rank_g, rank_w = (int((lg > lg[t]).sum()) for t in (got, want))
    enters = rank_g >= topk and float(top[topk - 1] - lg[got]) <= 2 * err
    leaves = rank_w < topk and float(lg[want] - top[topk]) <= 2 * err
    if gap <= 1 - math.exp(-2 * err / temp):
        return "race"
    return "top-k" if enters or leaves else "none"


class DepthRecorder:
    """Records every ``_depth_decode`` call of ``lm_generate_frame`` in a
    with-block: its params, config, inputs and sampled chain."""

    def __enter__(self):
        from fireredtts2_tpu_torch.models.lm import model as lm
        self.calls, self._lm, self._orig = [], lm, lm._depth_decode

        def rec(params, cfg, last_h, c0, noise, topk, temp, spec_init=None):
            out = self._orig(params, cfg, last_h, c0, noise, topk, temp,
                             spec_init=spec_init)
            self.calls.append((params, cfg, last_h.clone(), c0.clone(),
                               noise.clone(), topk, temp, out.clone()))
            return out
        lm._depth_decode = rec
        return self

    def __exit__(self, *exc):
        self._lm._depth_decode = self._orig


def verify_jacobi(calls) -> dict:
    """Jacobi on every recorded plain-loop call's inputs against the chain
    the plain loop sampled there: rows equal, or their first difference a
    near-tie by ``flip_reason`` between the two forwards' logits (forced
    to the plain chain). -> counts, flips, rounds."""
    import dataclasses
    from fireredtts2_tpu_torch.models.lm.model import depth_decode_jacobi

    rows = differ = 0
    flips, rounds = [], []
    for i, (params, cfg, last_h, c0, noise, topk, temp, want) in enumerate(calls):
        spec = dataclasses.replace(cfg, speculative_depth=True)
        got, r = depth_decode_jacobi(params, spec, last_h, c0, noise, topk, temp)
        rounds.append(r)
        rows += got.shape[0]
        bad = (got != want).any(dim=1).nonzero()[:, 0].tolist()
        if not bad:
            continue
        differ += len(bad)
        seq = depth_logits(params, cfg, last_h, want, parallel=False)
        par = depth_logits(params, cfg, last_h, want, parallel=True)
        for b in bad:
            p = int((got[b] != want[b]).nonzero()[0])
            err = float((par[b, p - 1] - seq[b, p - 1]).abs().max())
            flips.append(dict(call=i, row=b, codebook=p, err=err, why=flip_reason(
                seq[b, p - 1], noise[b, p], err, int(got[b, p]), int(want[b, p]),
                topk, temp)))
    return dict(calls=len(calls), rows=rows, rows_differing=differ,
                flips=flips[:8], explained=all(f["why"] != "none" for f in flips),
                rounds_mean=sum(rounds) / max(len(rounds), 1),
                rounds_max=max(rounds, default=0))


def _jacobi_counts() -> dict:
    from fireredtts2_tpu_torch.models.lm.model import depth_decode_jacobi as j
    return dict(frames=j.calls, rounds=j.rounds, max_rounds=j.max_rounds,
                rounds_mean=j.rounds / max(j.calls, 1))


def spec_engine_run(eng, dev, must_launch) -> tuple[dict, dict]:
    """One engine with speculative depth on, after a short warm-up stream:
    generate_stream (first packet), then generate (LM ms/frame, rounds a
    frame), launch and round counts set to 0 just before each; a traced
    6-frame generate (CUDA launches a frame); then the same generate with
    the flag off (the plain 15-step loop, every depth call recorded): its
    frames against the speculative ones, and Jacobi run on every recorded
    call's inputs (``verify_jacobi``). -> (result, checks)."""
    import dataclasses
    from fireredtts2_tpu_torch.models.lm.model import reset_jacobi_counts

    seed, cap = 2024, int(SPEC_MS / 80)
    spec_cfg = eng.config
    res, checks = {}, {}
    list(eng.generate_stream("Warm up.", "[S1]", max_audio_length_ms=240,
                             utt_seed=1))
    reset_counts()
    reset_jacobi_counts()
    t0 = time.perf_counter()
    audio = np.concatenate(list(eng.generate_stream(
        TEXT, "[S1]", max_audio_length_ms=SPEC_MS, utt_seed=seed)))
    _sync()
    res["stream"] = dict(wall_s=time.perf_counter() - t0,
                         first_packet_ms=eng._first_packet_s * 1e3,
                         launches=read_counts(), jacobi=_jacobi_counts())
    stream_tokens = eng.last_tokens
    checks["stream_finite"] = bool(np.isfinite(audio).all())
    reset_counts()
    reset_jacobi_counts()
    t0 = time.perf_counter()
    audio = eng.generate(TEXT, "[S1]", max_audio_length_ms=SPEC_MS, utt_seed=seed)
    _sync()
    wall = time.perf_counter() - t0
    counts, jac, stats = read_counts(), _jacobi_counts(), dict(eng.last_stats)
    spec_tokens = eng.last_tokens
    frames = stats["frames"]
    res["generate"] = dict(
        wall_s=wall, frames=frames, lm_ms_per_frame=stats["lm_s"] / max(frames, 1) * 1e3,
        rtf=len(audio) / eng.output_sample_rate / wall, launches=counts, jacobi=jac)
    checks["generate_finite"] = bool(np.isfinite(audio).all())
    checks["generate_len"] = len(audio) == frames * 1920 > 0
    checks["jacobi_once_per_frame"] = jac["frames"] == frames + (frames < cap)
    checks["rounds_bounded"] = 1 <= jac["max_rounds"] <= \
        eng.config.llm.audio_num_codebooks - 1
    for k in must_launch:
        checks[f"{k}_launched"] = counts[k] > 0
    checks["fused_depth_decode_not_launched"] = counts["fused_depth_decode"] == 0
    checks["stream_same_frames"] = bool(np.array_equal(stream_tokens, spec_tokens))
    _, tr = trace_call(lambda: eng.generate("Profile this.", "[S1]",
                                            max_audio_length_ms=480,
                                            utt_seed=3), dev, cpu=False)
    if tr:
        tr.pop("by_name")
        n = eng.last_stats.get("frames") or 1
        res["trace"] = dict(tr, frames=n,
                            cuda_launches_per_frame=tr["kernel_launches"] / n)
    # the plain 15-step loop on the same engine and seed, recorded
    eng.config = dataclasses.replace(
        spec_cfg, llm=dataclasses.replace(spec_cfg.llm, speculative_depth=False))
    try:
        with DepthRecorder() as rec:
            t0 = time.perf_counter()
            eng.generate(TEXT, "[S1]", max_audio_length_ms=SPEC_MS, utt_seed=seed)
            _sync()
            plain_wall = time.perf_counter() - t0
        plain_tokens, plain_stats = eng.last_tokens, dict(eng.last_stats)
    finally:
        eng.config = spec_cfg
    ver = verify_jacobi(rec.calls)
    res["plain"] = dict(wall_s=plain_wall, lm_ms_per_frame=plain_stats["lm_s"]
                        / max(plain_stats["frames"], 1) * 1e3)
    res["verify"] = ver
    same = plain_tokens.shape == spec_tokens.shape and bool(
        np.array_equal(plain_tokens, spec_tokens))
    res["frames_equal_plain"] = same
    res["common_prefix_with_plain"] = common_prefix(spec_tokens, plain_tokens)
    checks["jacobi_flips_explained"] = ver["explained"]
    # equal frames unless a counted near-tie flipped a token
    checks["frames_equal_plain_or_near_tie"] = same or ver["rows_differing"] > 0
    return res, checks


def spec_pool_run(eng, dev) -> tuple[dict, dict]:
    """A burst of SPEC_POOL requests (sampled, one utterance seed each)
    through a ContinuousBatcher pool with speculative depth: aggregate RTF,
    rounds a pool step, kernel launches; then the same burst through a
    fresh pool on the plain loop (every depth call recorded): each
    stream's frames against the speculative run's, Jacobi verified on
    every recorded call; each stream's common prefix with its lone
    request (generate_stream at B=1: printed, not bounded, as phase 11's:
    bf16 routes of other B flip near-ties from the first frame)."""
    import dataclasses
    from fireredtts2_tpu_torch.models.lm.model import reset_jacobi_counts
    from fireredtts2_tpu_torch.runtime.batcher import ContinuousBatcher

    reqs = [(SERVE_TEXTS[i % len(SERVE_TEXTS)],
             *SERVE_SAMPLING[i % len(SERVE_SAMPLING)], 500 + i)
            for i in range(SPEC_POOL)]

    def burst(record: bool):
        b = ContinuousBatcher(eng, max_streams=SPEC_POOL, warmup_blocks=False)
        rec = DepthRecorder() if record else None
        try:
            if rec:
                rec.__enter__()
            with b.burst():
                hs = [b.submit(t, "[S1]", temperature=tp, topk=k,
                               max_audio_length_ms=SPEC_POOL_MS, utt_seed=s)
                      for t, tp, k, s in reqs]
            reset_counts()
            reset_jacobi_counts()
            t0 = time.perf_counter()
            b.start()
            audios = _consume(hs)
            _sync()
            wall = time.perf_counter() - t0
        finally:
            if rec:
                rec.__exit__()
            b.stop()
        return hs, audios, wall, read_counts(), _jacobi_counts(), rec

    spec_cfg = eng.config
    hs, audios, wall, counts, jac, _ = burst(False)
    audio_s = sum(len(a) for a in audios) / eng.output_sample_rate
    res = dict(B=SPEC_POOL, wall_s=wall, audio_s=audio_s,
               aggregate_rtf=audio_s / wall, launches=counts, jacobi=jac,
               frames=[len(h.tokens) for h in hs])
    eng.config = dataclasses.replace(
        spec_cfg, llm=dataclasses.replace(spec_cfg.llm, speculative_depth=False))
    try:
        phs, _, plain_wall, _, _, rec = burst(True)
    finally:
        eng.config = spec_cfg
    ver = verify_jacobi(rec.calls)
    prefixes = [common_prefix(h.tokens, p.tokens) for h, p in zip(hs, phs)]
    same = [bool(np.array_equal(h.tokens, p.tokens)) for h, p in zip(hs, phs)]
    lone = []
    for (t, tp, k, s), h in zip(reqs[:1], hs[:1]):
        list(eng.generate_stream(t, "[S1]", max_audio_length_ms=SPEC_POOL_MS,
                                 temperature=tp, topk=k, utt_seed=s))
        lone.append(common_prefix(h.tokens, eng.last_tokens))
    res.update(plain_wall_s=plain_wall, verify=ver, streams_equal_plain=sum(same),
               common_prefix_with_plain=prefixes,
               lone_common_prefix=lone)
    checks = {
        "finite": all(np.isfinite(a).all() for a in audios),
        "len": all(len(a) == len(h.tokens) * 1920 > 0 for a, h in zip(audios, hs)),
        "jacobi_flips_explained": ver["explained"],
        "streams_equal_plain_or_near_tie": all(same) or ver["rows_differing"] > 0,
        "flash_decode_gqa1_launched": counts["flash_decode_gqa1"] > 0,
        "flash_decode_update_bounded_launched":
            counts["flash_decode_update_bounded"] > 0,
        "rounds_counted": jac["frames"] > 0,
    }
    return res, checks


def check_kernel_c_s8_vs_s64(dev, L=12, T=3008, H=16, Dh=64, live=200):
    """Kernel C fed the same 64 rows as one S=64 pass and as eight S=8
    passes (the grouped decode's and the one-token route's shapes) over
    one copy of a slab each: the written rows, and each route's attention
    against the other's and against the plain version's."""
    import torch
    from fireredtts2_tpu_torch.ops import flash_decode as fd

    D = H * Dh
    gen = torch.Generator(device=dev).manual_seed(15)
    q = _rnd(gen, 1, 64, H, Dh)
    nk, nv = _rnd(gen, 1, 64, D), _rnd(gen, 1, 64, D)
    k4, v4 = _rnd(gen, L, 1, T, D), _rnd(gen, L, 1, T, D)
    pos = (live // 8) * 8
    ar = torch.arange(64, device=dev, dtype=torch.int32)
    q_end = (pos + 8 * (ar // 8 + 1))[None]
    pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
    layer = L // 2
    ka, va = k4.clone(), v4.clone()
    one = fd.flash_decode_update_bounded(q, nk, nv, ka, va, layer, pos_t, q_end,
                                         pos + 64)
    kb, vb = k4.clone(), v4.clone()
    eight = torch.cat([fd.flash_decode_update_bounded(
        q[:, 8 * j:8 * j + 8], nk[:, 8 * j:8 * j + 8], nv[:, 8 * j:8 * j + 8],
        kb, vb, layer, pos_t + 8 * j, q_end[:, 8 * j:8 * j + 8], pos + 8 * j + 8)
        for j in range(8)], dim=1)
    plain = fd.flash_decode_update_bounded_plain(q, nk, nv, k4, v4, layer, pos_t,
                                                 q_end, pos + 64)
    peak = float(plain.float().abs().max())

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()) / peak

    return dict(live=live, rows_identical=bool(torch.equal(ka, kb))
                and bool(torch.equal(va, vb)),
                s64_vs_s8=rel(one, eight), s64_vs_plain=rel(one, plain),
                s8_vs_plain=rel(eight, plain),
                bit_equal=bool(torch.equal(one, eight)))


def one_token_vocoder(dev, codec_params, codec_cfg) -> tuple[dict, dict]:
    """(e): stream_decode_step over ONE_TOKEN_TOKENS tokens (kernel C at
    S=8) against codec_decode (the batch decoder) and the engine's grouped
    route (codec_decode_chunks, S=64 passes, assembled) on the same
    tokens, each pair's gap as a share of the peak; launch counts set to 0
    just before the chain; kernel C at S=64 against eight S=8 passes."""
    import torch
    from fireredtts2_tpu_torch.models.codec.model import (
        assemble_chunks, codec_decode, codec_decode_chunks, stream_decode_init,
        stream_decode_step,
    )
    from fireredtts2_tpu_torch.weights import dtype_of

    L = ONE_TOKEN_TOKENS
    acfg = codec_cfg.acoustic_decoder
    gen = torch.Generator(device=dev).manual_seed(15)
    toks = torch.randint(0, codec_cfg.rvq.codebook_size,
                         (1, codec_cfg.rvq.num_quantizers, L), generator=gen,
                         device=dev, dtype=torch.int32)
    with torch.inference_mode():
        state = stream_decode_init(codec_cfg, 1, dtype_of(codec_cfg.dtype),
                                   device=dev)
        stream_decode_step(codec_params, codec_cfg, toks[:, :, :1],
                           stream_decode_init(codec_cfg, 1,
                                              dtype_of(codec_cfg.dtype),
                                              device=dev), True, False)
        _sync()
        reset_counts()
        pieces = []

        def chain():
            st = state
            for t in range(L):
                a, st = stream_decode_step(codec_params, codec_cfg,
                                           toks[:, :, t:t + 1], st,
                                           t == 0, t == L - 1)
                pieces.append(a)

        t0 = time.perf_counter()
        chain()
        _sync()
        wall = time.perf_counter() - t0
        counts = read_counts()
        ev_ms = None
        if torch.device(dev).type == "cuda":   # the chain again, queued
            state = stream_decode_init(codec_cfg, 1, dtype_of(codec_cfg.dtype),
                                       device=dev)
            pieces.clear()
            ev_ms = queued_ms(chain, 1, warmup=0) / L
        one = torch.cat(pieces, dim=1).float().cpu().numpy()[0]
        batch = codec_decode(codec_params, codec_cfg, toks).float().cpu().numpy()[0]
        mid, tails = codec_decode_chunks(codec_params, codec_cfg, toks)
        grouped = assemble_chunks(mid.float().cpu().numpy(),
                                  tails.float().cpu().numpy(), L,
                                  acfg.hop_length, acfg.n_fft)[0]

    def gap(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-9))

    kc = check_kernel_c_s8_vs_s64(dev)
    res = dict(tokens=L, wall_s=wall, ms_per_token=wall / L * 1e3,
               queued_ms_per_token=ev_ms, launches=counts,
               one_token_vs_grouped=gap(one, grouped),
               one_token_vs_batch=gap(one, batch),
               grouped_vs_batch=gap(grouped, batch), kernel_c_s8_vs_s64=kc)
    checks = {
        "finite": bool(np.isfinite(one).all()),
        "len": one.shape == grouped.shape == batch.shape == (L * 1920,),
        "kernel_c_once_a_layer_a_token":
            counts["flash_decode_update_bounded"] == L * acfg.num_layers,
        "kernel_c_rows_identical": kc["rows_identical"],
        "kernel_c_s8_vs_s64": kc["s64_vs_s8"] <= RTOL * 4,
        "one_token_vs_grouped": res["one_token_vs_grouped"] <= STREAM_GAP_TOL,
        "one_token_vs_batch": res["one_token_vs_batch"] <= STREAM_GAP_TOL,
    }
    return res, checks


def run_speculative(dev, card: str, config=None, loop_steps=SPEC_LOOP_STEPS,
                    depth_batches=(1, 8)) -> dict:
    """Phase 15 at `config`'s widths (default EngineConfig(): full widths
    and depth), random weights from seed 0 shared by every engine:
    (a) the bf16 backbone and the int8 backbone with speculative depth
    (``spec_engine_run``; kernels A and C launched, B not); (b) kernel E at
    16 x B rows on every qwen-200m matrix, then int4 depth with speculative
    depth (E launched); (c) a pool of SPEC_POOL (``spec_pool_run``); (d)
    tools/spec_depth_rounds.py at `depth_batches` and tools/trained_loop.py
    with `loop_steps`; (e) the one-token vocoder (``one_token_vocoder``)."""
    import dataclasses

    import torch
    from fireredtts2_tpu_torch.config import EngineConfig
    from fireredtts2_tpu_torch.engine import FireRedTTS2Engine
    from fireredtts2_tpu_torch.tools import spec_depth_rounds, trained_loop
    from fireredtts2_tpu_torch.weights import init_random

    t_phase = time.perf_counter()
    base = config or EngineConfig()
    checks: dict = {}
    res: dict = dict(card=card)
    lm_raw, codec_raw = init_random(base, seed=0, device=dev)
    variants = {
        "bf16": dict(),
        "int8_backbone": dict(quantize_backbone=True),
        "int4_depth": dict(quantize_depth=True, quantize_depth_bits=4),
    }
    launches: dict = {}
    part_s = res["part_s"] = {}
    t_part = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t_part
        part_s[name] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    lap("init")
    for label, over in variants.items():
        cfg = dataclasses.replace(base, llm=dataclasses.replace(
            base.llm, speculative_depth=True, **over))
        must = ["flash_decode_gqa1", "flash_decode_update_bounded"]
        if label == "int4_depth":
            must.append("int4_matmul")
            if torch.device(dev).type == "cuda":
                res["kernel_e"] = check_kernel_e(dev, ms=E_SPEC_MS, reps=10)
                checks["kernel_e"] = all(r["ok"] for r in res["kernel_e"])
                lap("kernel_e")
        eng = FireRedTTS2Engine(cfg, device=dev, lm_params=lm_raw,
                                codec_params=codec_raw)
        lap(f"{label}_init")
        r, c = spec_engine_run(eng, dev, must)
        lap(label)
        res[label] = r
        checks.update({f"{label}_{k}": v for k, v in c.items()})
        for run in ("stream", "generate"):
            for k, n in r.get(run, {}).get("launches", {}).items():
                launches[k] = launches.get(k, 0) + n
        if label == "bf16":
            r, c = spec_pool_run(eng, dev)
            lap("pool")
            res["pool"] = r
            checks.update({f"pool_{k}": v for k, v in c.items()})
            for k, n in r["launches"].items():
                launches[k] = launches.get(k, 0) + n
        del eng
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    del lm_raw

    # (d) the tools
    with torch.inference_mode():
        res["spec_depth_rounds"] = spec_depth_rounds.run(
            batches=depth_batches, frames=16, device=dev, log=log,
            tiny=torch.device(dev).type != "cuda")
    lap("spec_depth_rounds")
    checks["spec_depth_rounds_bounded"] = all(
        1 <= r["rounds_max"] <= r["worst_case"] for r in res["spec_depth_rounds"])
    t0 = time.perf_counter()
    loop = trained_loop.run(steps_lm=loop_steps[0], steps_codec=loop_steps[1],
                            device=dev, log=log)
    res["trained_loop"] = dict(loop, secs=time.perf_counter() - t0)
    checks["trained_loop_ran"] = loop["phase"] == "summary"
    lap("trained_loop")
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    # (e) the one-token vocoder on the flagship codec
    r, c = one_token_vocoder(dev, codec_raw, base.codec)
    lap("one_token")
    res["one_token"] = r
    checks.update({f"one_token_{k}": v for k, v in c.items()})
    for k, n in r["launches"].items():
        launches[k] = launches.get(k, 0) + n
    del codec_raw
    res["launches"] = launches
    res["checks"] = checks
    res["ok"] = all(checks.values())
    res["phase_s"] = time.perf_counter() - t_phase
    return res


# ---------------------------------------------------------------------------
# Phase 16: serving on a (dp, tp) mesh (parallel/mesh.py): kernel A's
# kv-head window and the tp routes of kernels A and C, two gloo ranks on
# the one card at tp=2 and at dp=2, and `serve --tp 2` under torchrun
# ---------------------------------------------------------------------------

MESH_SEED = 23
MESH_FRAMES = 20                  # (c): generate of 20 frames
MESH_POOL = 8                     # (d): a burst of 8 split 4/4 over dp=2
MESH_LOGIT_TOL = 5e-2             # (c): first frame's logits, of the peak
MESH_TIMEOUT_S = 420
MESH_CLI_FRAMES = 10              # (e): the served request


def _window_bound(B, hql, hkv, Dh, live_slots) -> tuple[float, str]:
    """Kernel A on one rank: q and out (B, hql, Dh), the window's K and V
    over the live slots; 4 Dh operations a query head a slot."""
    return bound_ms(4 * B * hql * Dh + live_slots * hkv * Dh * 4,
                    4 * hql * Dh * live_slots)


def check_kernel_a_window(dev, L, T, Hkv, G, Dh, reps, tps=(2, 4),
                          cases=((1, 200), (1, 3000), (8, 200), (8, 3000)),
                          timed=((2, 1, 3000), (4, 1, 3000), (4, 8, 3000))):
    """(a) Kernel A's tp route at the flagship's shapes: each tp rank's
    call (its Hq/tp query heads over its kv-head window of the whole slab,
    flash_decode_gqa1_shard) against the plain version with the same
    window, and the ranks' outputs concatenated over heads against the
    unsharded kernel A. In the `timed` (tp, B, live) cases the last rank (a
    window at a non-zero column) is timed against its plain version and
    SDPA over its heads."""
    import torch
    from fireredtts2_tpu_torch.ops import flash_decode as fd
    from fireredtts2_tpu_torch.parallel.mesh import Mesh

    Hq = Hkv * G
    rng = np.random.default_rng(16)
    results = []
    for tp in tps:
        hql = Hq // tp
        for B, live in cases:
            gen = torch.Generator(device=dev).manual_seed(tp * 131 + B * 7 + live)
            q = _rnd(gen, B, Hq, Dh)
            k4, v4 = _rnd(gen, L, B, T, Hkv * Dh), _rnd(gen, L, B, T, Hkv * Dh)
            pad = min(40, max(live // 4, 1))
            q_start = rng.integers(0, pad, B)
            q_end = np.minimum(live + rng.integers(-min(20, pad), min(20, pad), B), T)
            qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
            qe = torch.tensor(q_end, dtype=torch.int32, device=dev)
            lo = torch.tensor(int(q_start.min()), dtype=torch.int32, device=dev)
            hi = torch.tensor(int(q_end.max()), dtype=torch.int32, device=dev)
            layer = L - 1
            whole = fd.flash_decode_gqa1(q, k4, v4, layer, qs, qe, lo, hi)
            parts, rank_err, rank_ok = [], 0.0, True
            for t in range(tp):
                mesh = Mesh(dp=1, tp=tp, rank=t)
                ql = q[:, t * hql:(t + 1) * hql].contiguous()
                kv0, hkv = fd.gqa1_window(Hq, Hkv, tp, t)
                out = fd.flash_decode_gqa1_shard(mesh, ql, k4, v4, layer, qs,
                                                 qe, lo, hi)
                ref = fd.flash_decode_gqa1_plain(ql, k4, v4, layer, qs, qe,
                                                 lo, hi, kv_base=kv0, hkv=hkv)
                err, ok = _compare(out, ref)
                rank_err, rank_ok = max(rank_err, err), rank_ok and ok
                parts.append(out)
            cat_err, cat_ok = _compare(torch.cat(parts, dim=1), whole)
            t = tp - 1
            mesh = Mesh(dp=1, tp=tp, rank=t)
            ql = q[:, t * hql:(t + 1) * hql].contiguous()
            kv0, hkv = fd.gqa1_window(Hq, Hkv, tp, t)
            live_slots = int((q_end - q_start).sum())
            bnd, by = _window_bound(B, hql, hkv, Dh, live_slots)
            launches = None
            if torch.device(dev).type == "cuda":
                launches = cuda_launches(lambda: fd.flash_decode_gqa1_shard(
                    mesh, ql, k4, v4, layer, qs, qe, lo, hi))
            times = {}
            if (tp, B, live) in timed:
                step = itertools.count()
                times = time_pair(
                    lambda: fd.flash_decode_gqa1_shard(
                        mesh, ql, k4, v4, next(step) % L, qs, qe, lo, hi),
                    lambda: fd.flash_decode_gqa1_plain(
                        ql, k4, v4, next(step) % L, qs, qe, lo, hi,
                        kv_base=kv0, hkv=hkv), reps)
                w0, w1 = int(q_start.min()), int(q_end.max())
                kv = [x[layer, :, w0:w1].view(B, w1 - w0, Hkv, Dh)
                      [:, :, kv0:kv0 + hkv].transpose(1, 2) for x in (k4, v4)]
                slot = torch.arange(w0, w1, device=dev)
                mask = ((slot >= qs[:, None]) & (slot < qe[:, None]))[:, None, None]
                times["library_ms"] = library_ms(
                    sdpa_call(ql[:, :, None], kv[0], kv[1], mask), reps)
            results.append(dict(
                tp=tp, B=B, live=live, heads_a_rank=hql, kv_window=(kv0, hkv),
                max_abs_err=max(rank_err, cat_err), rank_max_abs_err=rank_err,
                concat_max_abs_err=cat_err, ok=rank_ok and cat_ok,
                bound_ms=bnd, bound_by=by, cuda_launches_per_call=launches,
                **times))
            del q, k4, v4
    return results


def check_kernel_c_shard(dev, L, T, H, Dh, reps, tp=2,
                         cases=((1, 32, 200), (1, 64, 2900), (8, 32, 200),
                                (8, 64, 2900)),
                         timed=((1, 64, 2900), (8, 64, 2900))):
    """(b) Kernel C's tp route at the flagship vocoder (H 16, Dh 64): each
    rank's call on its H/tp heads, fresh-row columns and slab columns
    (flash_decode_update_bounded_shard) against the plain version on copies
    of the same, and the ranks' outputs and slab columns assembled against
    the unsharded kernel C. In the `timed` (B, S, live) cases rank 0 is
    timed against its plain version and SDPA over its heads."""
    import torch
    from fireredtts2_tpu_torch.ops import flash_decode as fd
    from fireredtts2_tpu_torch.parallel.mesh import Mesh

    D, Hl = H * Dh, H // tp
    Dl = Hl * Dh
    results = []
    for B, S, live in cases:
        gen = torch.Generator(device=dev).manual_seed(B * 37 + S + live)
        q = _rnd(gen, B, S, H, Dh)
        nk, nv = _rnd(gen, B, S, D), _rnd(gen, B, S, D)
        k4, v4 = _rnd(gen, L, B, T, D), _rnd(gen, L, B, T, D)
        pos = torch.tensor(np.maximum((live - S) // 8 * 8 - 8 * np.arange(B), 0),
                           dtype=torch.int32, device=dev)
        q_end = pos[:, None] + 8 * (torch.arange(S, device=dev,
                                                 dtype=torch.int32)[None] // 8 + 1)
        live_hi = pos.max() + S
        layer = L // 2
        kk, vk = k4.clone(), v4.clone()
        whole = fd.flash_decode_update_bounded(q, nk, nv, kk, vk, layer, pos,
                                               q_end, live_hi)
        parts, rank_err, ok, rows_ok = [], 0.0, True, True
        shards = []
        for t in range(tp):
            c = slice(t * Dl, (t + 1) * Dl)
            args = (q[:, :, t * Hl:(t + 1) * Hl].contiguous(),
                    nk[..., c].contiguous(), nv[..., c].contiguous())
            kl, vl = k4[..., c].contiguous(), v4[..., c].contiguous()
            kp, vp = kl.clone(), vl.clone()
            out = fd.flash_decode_update_bounded_shard(
                Mesh(dp=1, tp=tp, rank=t), *args, kl, vl, layer, pos, q_end,
                live_hi)
            ref = fd.flash_decode_update_bounded_plain(*args, kp, vp, layer,
                                                       pos, q_end, live_hi)
            err, o = _compare(out, ref)
            rank_err, ok = max(rank_err, err), ok and o
            rows_ok &= (bool(torch.equal(kl, kp)) and bool(torch.equal(vl, vp))
                        and bool(torch.equal(kl, kk[..., c]))
                        and bool(torch.equal(vl, vk[..., c])))
            parts.append(out)
            shards.append((args, kl, vl, kp, vp))
        cat_err, cat_ok = _compare(torch.cat(parts, dim=2), whole)
        args, kl, vl, kp, vp = shards[0]
        mesh = Mesh(dp=1, tp=tp, rank=0)
        qe = q_end.clamp(max=T)
        read = int(qe.max(dim=1).values.sum())
        bnd, by = bound_ms(2 * (2 * B * S * Dl) + 2 * 2 * B * S * Dl
                           + read * Dl * 4, 4 * Dl * int(qe.sum()))
        launches = None
        if torch.device(dev).type == "cuda":
            launches = cuda_launches(lambda: fd.flash_decode_update_bounded_shard(
                mesh, *args, kl, vl, layer, pos, q_end, live_hi))
        times = {}
        if (B, S, live) in timed:
            step = itertools.count()
            times = time_pair(
                lambda: fd.flash_decode_update_bounded_shard(
                    mesh, *args, kl, vl, next(step) % L, pos, q_end, live_hi),
                lambda: fd.flash_decode_update_bounded_plain(
                    *args, kp, vp, next(step) % L, pos, q_end, live_hi), reps)
            hi = min(int(live_hi), T)
            kv = [x[layer, :, :hi].view(B, hi, Hl, Dh).transpose(1, 2)
                  for x in (kl, vl)]
            slot = torch.arange(hi, device=dev)
            mask = (slot[None, None] < q_end[:, :, None])[:, None]
            times["library_ms"] = library_ms(
                sdpa_call(args[0].transpose(1, 2), kv[0], kv[1], mask), reps)
        results.append(dict(
            tp=tp, B=B, S=S, live=live, heads_a_rank=Hl,
            max_abs_err=max(rank_err, cat_err), rank_max_abs_err=rank_err,
            concat_max_abs_err=cat_err, ok=ok and cat_ok and rows_ok,
            rows_identical=rows_ok, bound_ms=bnd, bound_by=by,
            cuda_launches_per_call=launches, **times))
        del q, nk, nv, k4, v4, kk, vk, shards, parts
    return results


class FrameRecorder:
    """In a with-block: every codebook-0 logits call of lm_generate_frame
    ((N, V) fp32, models/lm/model.py: _audio_logits) and every depth
    decode's last_h, in order, on the host."""

    def __enter__(self):
        from fireredtts2_tpu_torch.models.lm import model as lm
        self.logits, self.last_h = [], []
        self._lm = lm
        self._orig = (lm._audio_logits, lm._depth_decode)
        orig_logits, orig_depth = self._orig

        def logits(h, w, V):
            out = orig_logits(h, w, V)
            self.logits.append(out.float().cpu())
            return out

        def depth(params, cfg, last_h, *a, **k):
            self.last_h.append(last_h.float().cpu())
            return orig_depth(params, cfg, last_h, *a, **k)
        lm._audio_logits, lm._depth_decode = logits, depth
        return self

    def __exit__(self, *exc):
        self._lm._audio_logits, self._lm._depth_decode = self._orig


def _mesh_engine(mesh):
    from fireredtts2_tpu_torch.config import EngineConfig
    from fireredtts2_tpu_torch.engine import FireRedTTS2Engine
    return FireRedTTS2Engine(
        EngineConfig(), seed=MESH_SEED, device="cuda", mesh=mesh,
        llm_overrides={"quantize_backbone": True, "fused_depth_plan": PRESET})


def _fixed_pool(eng, B):
    """A pool whose blocks are always 4 frames (the policy's ladder held to
    one rung), so the one-rank and dp=2 pools step alike."""
    from fireredtts2_tpu_torch.runtime.batcher import ContinuousBatcher
    from fireredtts2_tpu_torch.runtime.policy import (
        AdaptiveBlockPolicy, BlockPolicyConfig,
    )
    return ContinuousBatcher(eng, max_streams=B, warmup_blocks=False,
                             policy=AdaptiveBlockPolicy(BlockPolicyConfig(
                                 ladder=(4,), start_block=4)))


def pool_row(s: int, t: int, B: int, rows: tuple[int, int]) -> int:
    """The row of request s (submit order) of one burst into an idle
    B-slot pool in the logits of its frame t, on a rank holding slots
    [r0, r1): admission gives request s slot B - 1 - s; the burst's prefill
    (t = 0) has the rank's requests in submit order, blocks (t >= 1) its
    slots in order."""
    r0, r1 = rows
    return s - (B - r1) if t == 0 else B - 1 - s - r0


def _pool_burst(b, eng) -> dict:
    """MESH_POOL requests as one burst; the recorder covers the burst's
    prefill and blocks (not the warm-up ladder)."""
    b.start()
    try:
        with FrameRecorder() as rec:
            with b.burst():
                hs = [b.submit(SERVE_TEXTS[i], "[S1]", utt_seed=MESH_SEED + i,
                               max_audio_length_ms=MESH_FRAMES * 80)
                      for i in range(MESH_POOL)]
            audio = _consume(hs)
    finally:
        b.stop()
    return dict(tokens=[h.tokens for h in hs], samples=[len(a) for a in audio],
                finite=all(bool(np.isfinite(a).all()) for a in audio),
                logits=rec.logits, last_h=rec.last_h)


def mesh_rank(rank: int, world: int) -> dict:
    """One of two gloo ranks on the one card: (c) the preset at tp=2,
    generate of MESH_FRAMES frames with its kernel launches counted from 0
    just before and read just after; (d) the preset at dp=2, a pool burst
    of MESH_POOL split 4/4 (rank 0 admits, rank 1 follows)."""
    import torch
    from fireredtts2_tpu_torch.parallel import mesh as pm

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out: dict = {}
    t0 = time.perf_counter()
    eng = _mesh_engine(pm.make_mesh(dp=1, tp=2))
    out["build_s"] = time.perf_counter() - t0
    out["wq_shape"] = tuple(eng.lm_params["backbone"]["wq"].shape)
    out["voc_slab_cols"] = eng._new_vstate(1).kv_k.shape[-1]
    with FrameRecorder() as rec:
        torch.cuda.synchronize()
        reset_counts()
        pm.reset_collective_stats()
        t0 = time.perf_counter()
        audio = eng.generate(TEXT, "[S1]", max_audio_length_ms=MESH_FRAMES * 80,
                             utt_seed=MESH_SEED)
        torch.cuda.synchronize()
        out["generate_s"] = time.perf_counter() - t0
        out["launches"] = read_counts()
    out.update(tokens=eng.last_tokens, audio_n=len(audio),
               finite=bool(np.isfinite(audio).all()), logits=rec.logits,
               last_h=rec.last_h, comm=pm.collective_stats(),
               lm_slab_bytes=eng._new_lm_state(1).cache_k.nbytes)
    del eng
    torch.cuda.empty_cache()

    eng = _mesh_engine(pm.make_mesh(dp=2, tp=1))
    b = _fixed_pool(eng, MESH_POOL)
    out["pool_rows"] = (b._r0, b._r1)
    if rank == 0:
        t0 = time.perf_counter()
        out["pool"] = _pool_burst(b, eng)
        out["pool"]["wall_s"] = time.perf_counter() - t0
    else:
        with FrameRecorder() as rec:
            b.follow()
        out["pool"] = dict(logits=rec.logits, last_h=rec.last_h)
    return out


_RAW_LM: dict = {}


def _raw_lm(eng):
    """The preset engine's LM tree before its serving transforms (the
    plain depth decoder, which kernel B's bundle replaces), drawn again
    from MESH_SEED."""
    if "lm" not in _RAW_LM:
        from fireredtts2_tpu_torch.weights import init_random
        _RAW_LM["lm"] = init_random(eng.config, MESH_SEED, eng.device)[0]
    return _RAW_LM["lm"]


def explain_flip(eng, lg_a, lg_b, lh_a, lh_b, frame_a, noise, i: int,
                 got: int, want: int, topk: int, temp: float,
                 depth_topk: int, depth_temp: float) -> str:
    """Why the mesh run sampled `got` where the one-rank run sampled `want`
    at codebook i of a frame both reached alike: codebook 0 from the two
    runs' recorded logits (the one-rank's, V, and their gap); a depth
    codebook from the plain depth chain's logits of the two runs' last_h
    (their gap plus kernel B's tolerance). "race", "top-k" or "none"
    (flip_reason)."""
    import torch
    if i == 0:
        err = float((lg_a - lg_b).abs().max())
        return flip_reason(lg_a, noise[0], err, got, want, topk, temp)
    dev = eng.device
    cfg = eng.config.llm
    params = _raw_lm(eng)
    dt = params["projection"].dtype
    tok = torch.as_tensor(frame_a, device=dev)[None].long()
    with torch.inference_mode():
        pa = depth_logits(params, cfg, lh_a.to(dev, dt)[None], tok,
                          False)[0, i - 1].float()
        pb = depth_logits(params, cfg, lh_b.to(dev, dt)[None], tok,
                          False)[0, i - 1].float()
    err = float((pa - pb).abs().max()) + B_TOL * float(pa.abs().max())
    return flip_reason(pa.cpu(), noise[i], err, got, want, depth_topk,
                       depth_temp)


def first_flip(a: np.ndarray, b: np.ndarray):
    """(frame, codebook) of the first token where two (T, ncb) streams
    differ, in sampling order, or None."""
    n = min(len(a), len(b))
    d = np.argwhere(a[:n] != b[:n])
    if len(d) == 0:
        return None if len(a) == len(b) else (n, 0)
    return int(d[0][0]), int(d[0][1])


def run_mesh(dev, card: str) -> dict:
    """(c) and (d): the two gloo ranks (mesh_rank) while this process runs
    the one-rank references: the preset's generate with the same seed and
    utterance seed, and the one-rank pool of MESH_POOL with the same
    requests. The ranks' tokens must equal each other's; against the
    one-rank runs every stream must equal or part at a near-tie that
    explain_flip explains; the first frame's logits within MESH_LOGIT_TOL
    of the peak."""
    import torch
    from fireredtts2_tpu_torch.parallel.mesh import Ranks

    t_phase = time.perf_counter()
    out: dict = {}
    checks: dict = {}
    ranks = Ranks(mesh_rank, 2, timeout_s=MESH_TIMEOUT_S, threads=4)
    try:
        eng = _mesh_engine(None)
        with FrameRecorder() as rec:
            audio = eng.generate(TEXT, "[S1]", max_audio_length_ms=MESH_FRAMES * 80,
                                 utt_seed=MESH_SEED)
        one = dict(tokens=eng.last_tokens, logits=rec.logits, last_h=rec.last_h,
                   audio_n=len(audio))
        one_pool = _pool_burst(_fixed_pool(eng, MESH_POOL), eng)
    finally:
        got = ranks.join()
    out["rank_build_s"] = [g["build_s"] for g in got]
    out["rank_generate_s"] = [g["generate_s"] for g in got]
    out["launches"] = [g["launches"] for g in got]
    out["comm"] = [g["comm"] for g in got]
    r0, r1 = got
    cfg = eng.config
    checks["tp_weights_split"] = (r0["wq_shape"][-1] * 2
                                  == eng.lm_params["backbone"]["wq"].shape[-1])
    checks["tp_voc_slab_split"] = r0["voc_slab_cols"] * 2 == \
        cfg.codec.acoustic_decoder.embed_dim
    checks["tp_ranks_equal"] = bool(np.array_equal(r0["tokens"], r1["tokens"]))
    checks["tp_finite"] = r0["finite"] and r1["finite"]
    lg0, lg1 = one["logits"][0], r0["logits"][0]
    gap = float((lg0 - lg1).abs().max() / lg0.abs().max())
    out["first_logits_gap_of_peak"] = gap
    checks["tp_first_logits"] = gap <= MESH_LOGIT_TOL
    for k in ("flash_decode_gqa1_shard", "flash_decode_update_bounded_shard",
              "flash_decode_gqa1", "flash_decode_update_bounded",
              "fused_depth_decode"):
        checks[f"tp_{k}_launched"] = all(g["launches"][k] > 0 for g in got)
    checks["tp_no_slab_collective"] = all(
        g["comm"]["max_bytes"] < g["lm_slab_bytes"] // 4 for g in got)
    noise_fn = eng.noise_fn
    flip = first_flip(one["tokens"], r0["tokens"])
    out["tp_common_prefix"] = common_prefix(one["tokens"], r0["tokens"])
    out["tp_first_flip"] = flip
    if flip is None:
        checks["tp_tokens_vs_one_rank"] = True
    else:
        t, i = flip
        why = explain_flip(eng, one["logits"][t][0], r0["logits"][t][0],
                           one["last_h"][t][0], r0["last_h"][t][0],
                           one["tokens"][t], noise_fn(MESH_SEED, 1)(t)[0].cpu(),
                           i, int(r0["tokens"][t][i]), int(one["tokens"][t][i]),
                           20, 0.9, cfg.depth_topk, cfg.depth_temperature)
        out["tp_flip_reason"] = why
        checks["tp_tokens_vs_one_rank"] = why != "none"

    # (d) dp=2 pool, slots [0, 4) on rank 0 and [4, 8) on rank 1
    pool = r0["pool"]
    checks["dp_rows"] = r0["pool_rows"] == (0, 4) and r1["pool_rows"] == (4, 8)
    checks["dp_finite"] = pool["finite"]
    reasons, prefixes = [], []
    for s in range(MESH_POOL):
        a, b = one_pool["tokens"][s], pool["tokens"][s]
        prefixes.append(common_prefix(a, b))
        f = first_flip(a, b)
        if f is None:
            reasons.append("equal")
            continue
        t, i = f
        # call 0 is the burst's prefill (frame 0), call t frame t; slots
        # [0, 4) are rank 0's, [4, 8) rank 1's
        half = MESH_POOL // 2
        rows = (0, half) if MESH_POOL - 1 - s < half else (half, MESH_POOL)
        rec = (r0 if rows[0] == 0 else r1)["pool"]
        ra = pool_row(s, t, MESH_POOL, (0, MESH_POOL))
        rb = pool_row(s, t, MESH_POOL, rows)
        if t >= len(rec["logits"]) or t >= len(one_pool["logits"]):
            reasons.append("none")
            continue
        reasons.append(explain_flip(
            eng, one_pool["logits"][t][ra], rec["logits"][t][rb],
            one_pool["last_h"][t][ra], rec["last_h"][t][rb], a[t],
            noise_fn(MESH_SEED + s, 1)(t)[0].cpu(), i, int(b[t][i]),
            int(a[t][i]), 20, cfg.default_temperature, cfg.depth_topk,
            cfg.depth_temperature))
    out["dp_streams"] = reasons
    out["dp_common_prefix"] = prefixes
    out["dp_pool_wall_s"] = pool["wall_s"]
    checks["dp_tokens_vs_one_rank"] = "none" not in reasons
    out["checks"] = checks
    out["ok"] = all(checks.values())
    out["phase_s"] = time.perf_counter() - t_phase
    del eng
    _RAW_LM.clear()
    torch.cuda.empty_cache()
    return out


def stash_mesh_dir(src: str) -> str:
    """(e)'s serving dir under the checkout (git-ignored, removed at exit
    at the latest), begun while phase 11's dir `src` exists: its flagship
    codec tree, hard-linked (no copy), for write_mesh_dir to complete."""
    import tempfile

    from fireredtts2_tpu_torch.runtime import checkpoint as ckpt

    root = os.path.dirname(os.path.abspath(__file__))
    d = tempfile.mkdtemp(prefix=".serving_ckpt_", dir=root)
    atexit.register(shutil.rmtree, d, ignore_errors=True)
    dst = ckpt.converted_path(d, "codec")
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    os.link(ckpt.converted_path(src, "codec"), dst)
    return d


def write_mesh_dir(d: str) -> str:
    """(e)'s serving dir completed (stash_mesh_dir began it with phase
    11's flagship codec): the flagship depth decoder with a qwen-200m
    backbone (4 layers of the flagship's width: the heads, head dims and
    vocabularies every kernel takes, a quarter of the loading and of the
    collectives a frame), random weights of MESH_SEED, as a DIR/torch/
    tree, and the JSON configs."""
    import dataclasses

    import torch
    from fireredtts2_tpu_torch.config import EngineConfig
    from fireredtts2_tpu_torch.models.lm.model import init_lm_params
    from fireredtts2_tpu_torch.runtime import checkpoint as ckpt
    from fireredtts2_tpu_torch.weights import dtype_of

    cfg = EngineConfig()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, backbone_flavor="qwen-200m"))
    lm = init_lm_params(torch.Generator(device="cuda").manual_seed(MESH_SEED),
                        cfg.llm, dtype_of(cfg.llm.dtype), "cuda")
    ckpt.save_params(ckpt.converted_path(d, "llm_posttrain"), lm)
    write_serving_dir(d, cfg)
    del lm
    torch.cuda.empty_cache()
    return d


def start_mesh_cli(d: str) -> dict:
    """(e), started: `torchrun --nproc-per-node 2 -m fireredtts2_tpu_torch
    --pretrained-dir DIR --tp 2 ... serve` (python -m
    torch.distributed.run; log: chiprun_out/phase16_serve_tp2.log), two
    gloo ranks on the one card, in a session of its own. It boots while
    (c) and (d) run; finish_mesh_cli asks and stops it."""
    os.makedirs(OUT_DIR, exist_ok=True)
    http_port, ws_port = free_port(), free_port()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           "2", "--master-port", str(free_port()), "-m",
           "fireredtts2_tpu_torch", "--pretrained-dir", d, "--tp", "2",
           "--quantize-backbone", "--fused-depth-plan", PRESET, "serve",
           "--max-streams", "2", "--http-port", str(http_port), "--ws-port",
           str(ws_port)]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    logf = open(os.path.join(OUT_DIR, "phase16_serve_tp2.log"), "w")
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=logf,
                            stderr=subprocess.STDOUT, start_new_session=True)
    return dict(cmd=" ".join(cmd[1:]), proc=proc, logf=logf, port=http_port,
                t0=time.perf_counter())


def finish_mesh_cli(run: dict) -> dict:
    """(e), finished: /health within 420 s of the start, then one request of
    MESH_CLI_FRAMES frames through the port's client (finite audio); the
    session's processes are then stopped (SIGTERM, SIGKILL after 60 s)."""
    import signal

    from fireredtts2_tpu_torch.client import FireRedTTSClient

    proc, t0 = run["proc"], run["t0"]
    out: dict = dict(cmd=run["cmd"])
    try:
        c = FireRedTTSClient(f"http://127.0.0.1:{run['port']}",
                             timeout=SERVER_TIMEOUT_S)
        healthy = False
        while time.perf_counter() - t0 < 420 and proc.poll() is None:
            try:
                healthy = c.health().get("status") == "healthy"
                break
            except OSError:
                time.sleep(0.5)
        out["ready_s"] = time.perf_counter() - t0
        out["healthy"] = healthy
        if healthy:
            (a, sr), out["request_s"] = timed(
                c.synthesize, SERVE_TEXTS[0], temperature=1.0, top_k=1,
                max_audio_length_ms=MESH_CLI_FRAMES * 80)
            a = np.asarray(a)
            out["samples"], out["sample_rate"] = int(a.size), sr
            out["answered"] = bool(a.size > 0 and np.isfinite(a).all())
    finally:
        try:
            os.killpg(proc.pid, signal.SIGTERM)
            proc.wait(timeout=60)
        except (subprocess.TimeoutExpired, ProcessLookupError):
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait(timeout=60)
        run["logf"].close()
    out["exit_code"] = proc.returncode
    text = open(os.path.join(OUT_DIR, "phase16_serve_tp2.log")).read()
    out["mesh_line"] = "[mesh] serving sharded: dp=1 tp=2" in text
    out["gloo_shared"] = "gloo (ranks share cuda:0)" in text
    m = re.search(r"serve: engine warm-up ([\d.]+) s", text)
    out["warmup_s"] = float(m[1]) if m else None
    out["log_tail"] = text[-2000:]
    out["ok"] = bool(out.get("answered")) and out["mesh_line"]
    out["phase_s"] = time.perf_counter() - t0
    return out


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
    t_start = time.perf_counter()
    phase_s: dict = {}

    def mark(phase: str) -> None:
        """Seconds since the start at the end of each phase (the script's
        time limit is the sum)."""
        phase_s[phase] = time.perf_counter() - t_start
        log(f"-- phase {phase} done at {phase_s[phase]:.1f} s")

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
    mark("2")
    # 3. kernel A
    lm = FLAGSHIP["lm"]
    res_a = check_kernel_a(dev, lm["L"], lm["T"], lm["Hkv"], lm["G"], lm["Dh"],
                           lm["reps"])
    for r in res_a:
        log(f"kernel A B={r['B']} live~{r['live']}: max_abs_err "
            f"{r['max_abs_err']:.3e} ok={r['ok']}  {fmt_times(r)}; split "
            f"{r['split']} slots, {r['cuda_launches_per_call']} CUDA launch(es) "
            f"a call  [{card}]")
        ok &= r["ok"]
    sweep_a = {k: live_sweep(res_a, k) for k in ("ms", "queued_ms")}
    for k, f in sweep_a.items():
        if f:
            log(f"kernel A live sweep at B=1 ({k}): fixed {f['fixed_ms']:.4f} ms "
                f"+ {f['ms_per_1000_slots']:.4f} ms per 1000 live slots  [{card}]")
    report["kernel_a"] = res_a
    report["kernel_a_live_sweep"] = sweep_a

    mark("3")
    # 4. kernel C (and D)
    voc = FLAGSHIP["voc"]
    res_c = check_kernel_c(dev, voc["L"], voc["T"], voc["H"], voc["Dh"],
                           voc["reps"])
    for r in res_c:
        log(f"kernel C B={r['B']} S={r['S']} live~{r['live']}"
            f"{' overshoot' if r['overshoot'] else ''}"
            f"{' past the slab (pos = T)' if r['past_slab'] else ''}: max_abs_err "
            f"{r['max_abs_err']:.3e} rows_identical={r['rows_identical']} "
            f"ok={r['ok']}  {fmt_times(r)}; split {r['split']} slots, "
            f"{r['cuda_launches_per_call']} CUDA launch(es) a call  [{card}]")
        ok &= r["ok"]
    report["kernel_c"] = res_c
    res_d = check_kernel_d(dev, voc["T"], voc["H"], voc["Dh"])
    log(f"kernel C read-only (D) B=2 S=32 with lower bounds: max_abs_err "
        f"{res_d['max_abs_err']:.3e} ok={res_d['ok']}  {fmt_times(res_d)}  [{card}]")
    ok &= res_d["ok"]
    report["kernel_d"] = res_d

    mark("4")
    # 5. kernel B (fused depth chain), flagship qwen-200m depth decoder
    log(f"kernel B tolerance: logits with the same tokens forced, max |kernel - "
        f"plain| <= {B_TOL} * max |plain|; a sample may differ only where the "
        f"plain version's top two race scores are within 1 - exp(-2 err / T) "
        f"of each other, or its k-th and (k+1)-th logits within 2 err (err: "
        f"that step's logit error, T: temperature, k: top-k)")
    # the serving preset checked and timed (the plain version's trace is
    # slow); the r4 and a8 plans, off the main path, checked untimed (their
    # times: PERF.md's kernel table, PR 6)
    res_b = check_kernel_b(dev, plans=(PRESET,), reps=3) + check_kernel_b(
        dev, plans=("gate=r4,up=s8,down=s8", "gate=r8a8,up=s8a8,down=s8"),
        timed=False, wide=())
    for r in res_b:
        log(f"kernel B {r['plan']} B={r['B']}: logits max_abs_err "
            f"{r['max_abs_err']:.3e} (peak {r['peak']:.3f}), near-ties "
            f"{r['ties']} {r['flips']}, ok={r['ok']}  {fmt_times(r)}; streamed floor "
            f"{r.get('streamed_floor_ms', 0):.4f} ms; {r['barriers_per_frame']} grid "
            f"barriers a frame, {r['ring_stages']} ring stages  [{card}]")
        ok &= r["ok"]
    report["kernel_b"] = res_b
    torch.cuda.empty_cache()

    mark("5")
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

    mark("6")
    # 7. kernel F (decode attention over unmerged slabs, kernel A's code)
    res_f, f_launches = check_kernel_f(dev)
    for r in res_f:
        log(f"kernel F B={r['B']} live~{r['live']}: max_abs_err "
            f"{r['max_abs_err']:.3e} ok={r['ok']}  {fmt_times(r)}  [{card}]")
        ok &= r["ok"]
    report["kernel_f"] = res_f

    mark("7")
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

    mark("7b")
    # 8. small model vs CPU fp32
    small = check_small_model(dev)
    log(f"small model on the card vs CPU fp32 (of peak, limit {REF_TOL}): "
        f"lm {small['lm_rel_err']:.3e}, vocoder middles "
        f"{small['voc_middles_rel_err']:.3e}, tails "
        f"{small['voc_tails_rel_err']:.3e} ok={small['ok']}")
    ok &= small["ok"]
    report["small_model"] = small
    torch.cuda.empty_cache()

    mark("8")
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
        log(f"[{label}] stream vs generate audio (of peak, bound "
            f"{STREAM_GAP_TOL}): {eng['stream_vs_generate_rel_err']}")
        pr = eng["profile"]
        if pr:
            log(f"[{label}] traced generate: {pr['frames']} frames, wall "
                f"{pr['wall_s']:.3f} s, device {pr['device_s']:.3f} s, busy share "
                f"{pr['busy_share']:.3f}, {pr['kernel_launches']} CUDA kernel "
                f"launches ({pr['kernel_launches'] / max(pr['frames'] or 1, 1):.0f}"
                f" per frame); kernel A {pr['kernel_a_ms']:.3f} ms in "
                f"{pr['kernel_a_launches']} CUDA launches  [{card}]")
            for name, ms, n in pr["top"]:
                log(f"  {ms:9.3f} ms {n:6d} x  {name}")
        log(f"[{label}] engine checks: {eng['checks']}")
        ok &= eng["ok"]
        report[f"engine_{label}"] = eng
        torch.cuda.empty_cache()

    mark("9")
    # 10. voice cloning and dialogue on the serving preset at flagship width
    fp32 = check_fp32_encode(dev)
    log(f"fp32 encode on the card (process-wide TF32 flags on) vs the CPU, "
        f"narrow depth at flagship widths, {fp32['windows']} windows: "
        f"{fp32['frames_differing']} of {fp32['frames']} frames differ, "
        f"{fp32['near_ties']} near-ties (gap < {NEAR_TIE} relative), "
        f"{fp32['not_near_ties']} others; smallest gap {fp32['min_gap']:.3e}; "
        f"STFT power vs CPU (of peak): plain TF32 conv "
        f"{fp32['stft_rel_err_tf32_conv']:.3e}, the policy's "
        f"{fp32['stft_rel_err_policy']:.3e}; ok={fp32['ok']}  [{card}]")
    ok &= fp32["ok"]
    report["fp32_encode"] = fp32
    keep: dict = {}
    cd = run_clone_dialogue(dev, card, keep=keep)
    for i, e in enumerate(cd["encode"]):
        log(f"[clone] prompt {i}: {e['samples'] / 16_000:.1f} s, {e['tokens']} "
            f"tokens; encode_prompt_tokens cold: wall {e['cold']['wall_ms']:.1f} "
            f"ms, device {e['cold']['device_ms']:.1f} ms; cache hit: wall "
            f"{e['cache_hit']['wall_ms']:.3f} ms, encodes {e['encode_calls']}; "
            f"warm codec_encode: wall {e['warm']['wall_ms']:.1f} ms, device "
            f"{e['warm']['device_ms']:.1f} ms ({e['warm']['kernels']} kernels)"
            f"  [{card}]")
    st = cd["encode_stages"]
    log(f"[clone] one 6 s window, device ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in st.items() if v is not None) + f"  [{card}]")
    log(f"[clone] bf16 codec vs fp32 weights of the same draws: "
        f"{cd['bf16_vs_fp32_token_share']:.4f} of tokens equal")
    for k, c in enumerate(cd["clone"]):
        log(f"[clone] generate_stream {('plain path', 'voice state built', 'cache hit')[k]}"
            f": first packet {c['first_packet_ms']:.2f} ms, {c['frames']} frames "
            f"in {c['wall_s']:.3f} s, voice_state_builds "
            f"{c['voice_state_builds']}  [{card}]")
    d = cd["dialogue"]
    for i, t in enumerate(d["turns"]):
        log(f"[dialogue] turn {i}: {t['frames']} frames, LM "
            f"{t['lm_ms_per_frame']:.2f} ms/frame, prefill {t['prefill_ms']:.2f} "
            f"ms, kernel A's live window {t['live']} slots  [{card}]")
    log(f"[dialogue] generate_dialogue {d['wall_s']:.2f} s for {d['audio_s']:.2f} "
        f"s of audio; generate_dialogue_stream {d['stream_wall_s']:.2f} s, first "
        f"packet {d['first_packet_ms']:.2f} ms, frames per turn "
        f"{d['stream_turn_frames']}, equal to the batch's per turn "
        f"{d['stream_turns_equal']}  [{card}]")
    log(f"[dialogue] wait between streamed turns (ms, a turn's last piece to "
        f"the next turn's first): " + ", ".join(
            f"{g:.2f}" for g in d["turn_gaps_ms"])
        + "; an offline decode of the turn (what feeding it back instead "
        "would add): " + ", ".join(f"{g:.2f}" for g in d["offline_decode_ms"])
        + f"  [{card}]")
    ka = cd["kernel_a_at_dialogue"]
    log(f"[dialogue] kernel A at the last turn's window ({ka['live']} live "
        f"from slot {ka['live_start']}): max_abs_err {ka['max_abs_err']:.3e} "
        f"ok={ka['ok']}  {fmt_times(ka)}  [{card}]")
    log(f"[clone+dialogue] launches per run: {cd['launches']}")
    log(f"[clone+dialogue] checks: {cd['checks']}; phase {cd['phase_s']:.1f} s")
    for counts in cd["launches"].values():
        for k, n in counts.items():
            main_launches[k] = main_launches.get(k, 0) + n
    ok &= cd["ok"]
    report["clone_dialogue"] = cd

    mark("10")
    # 11. serving pools through the continuous batcher on phase 10's engine
    sv = run_serving(dev, card, keep)
    for pool, r in sv["pools"].items():
        bu, st, pr = r["burst"], r["staggered"], r["profile"]
        log(f"[serve B={pool}] warm-up ladder {r['warmup_s']:.2f} s; burst of "
            f"{pool} ({pool // 2} greedy): first packet median "
            f"{bu['first_packet_ms']['median']:.1f} ms, max "
            f"{bu['first_packet_ms']['max']:.1f} ms; aggregate RTF "
            f"{bu['aggregate_rtf']:.3f} ({bu['audio_s']:.2f} s audio in "
            f"{bu['wall_s']:.2f} s); policy K {bu['policy_k']}; block wall "
            f"{bu['block_wall_ms_per_step']:.2f} ms per pool step  [{card}]")
        log(f"[serve B={pool}] host_stats per frame: " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in bu["host_stats"].items()) + f"  [{card}]")
        log(f"[serve B={pool}] launches in the burst: {bu['launches']}; LM "
            f"{r['lm_ms_per_step'] or float('nan'):.2f} ms per batched frame"
            + (f" (B=1 {r['lm_ms_per_step_b1']:.2f})"
               if r["lm_ms_per_step_b1"] else "") + f"  [{card}]")
        if "cuda_kernels" in pr:
            log(f"[serve B={pool}] traced burst: {pr['cuda_kernels_per_step']:.0f} "
                f"CUDA kernels per pool step, "
                f"{pr['cuda_kernels_per_stream_frame']:.0f} per stream frame, "
                f"busy share {pr['busy_share']:.3f}  [{card}]")
        log(f"[serve B={pool}] greedy stream vs generate_stream at B=1: common "
            f"prefix {bu['greedy_common_prefix_with_b1']} of "
            f"{bu['greedy_frames']} / {bu['b1_frames']} frames; staggered: later "
            f"half's first packets {[round(x, 1) for x in st['later_first_packet_ms']]} "
            f"ms  [{card}]")
    log(f"[serve B=8] batched clone {sv['clone']['audio_s']:.2f} s audio in "
        f"{sv['clone']['wall_s']:.2f} s; 2-turn dialogue {sv['dialogue']['wall_s']:.2f}"
        f" s, samples per turn {sv['dialogue']['turn_samples']}  [{card}]")
    rl = sv["reload"]
    log(f"[serve B=8] reload with two live streams: prepare "
        f"{rl.get('prepare_s', float('nan')):.2f} s, drain "
        f"{rl.get('drain_s', float('nan')):.2f} s, apply "
        f"{rl.get('apply_s', float('nan')):.4f} s; live streams' frames "
        f"{rl['live_frames']}; checkpoint {sv['ckpt_gb']:.2f} GB saved in "
        f"{sv['save_s']:.1f} s; full-width engine from DIR in "
        f"{sv['load_s']:.1f} s, its warmup() {sv['engine_warmup_s']:.2f} s  "
        f"[{card}]")
    log(f"[serve bounded] slab {sv['bounded']['slab']}, idle slot at pos "
        f"{sv['bounded']['idle_pos_after']} after a {sv['bounded']['frames']}"
        f"-frame neighbour  [{card}]")
    log(f"[serve] launches per run: {sv['launches']}")
    log(f"[serve] checks: {sv['checks']}; phase {sv['phase_s']:.1f} s")
    for counts in sv["launches"].values():
        for k, n in counts.items():
            main_launches[k] = main_launches.get(k, 0) + n
    ok &= sv["ok"]
    report["serving"] = sv

    mark("11")
    # 11b. Whisper ASR at whisper-large-v3's full width
    asr_res = run_asr(dev, card, keep)
    sh, lg, i8, f32 = (asr_res["short"], asr_res["long"], asr_res["int8"],
                       asr_res["fp32"])
    log(f"[asr] whisper-large-v3 widths, {asr_res['params'] / 1e9:.3f} B "
        f"parameters, fp32, random weights (seed {ASR_SEED}), made in "
        f"{asr_res['init_s']:.1f} s  [{card}]")
    log(f"[asr] {ASR_CLIPS_S[0]:.0f} s clip, ladder: wall {sh['wall_s']:.3f} s, "
        f"RTF {sh['rtf']:.3f}, {sh['decode_calls']} decodes (last at T="
        f"{sh['temperature']}), {sh['tokens']} tokens; {ASR_CLIPS_S[1]:.0f} s "
        f"clip, greedy: wall {lg['wall_s']:.3f} s, RTF {lg['rtf']:.3f}, "
        f"{lg['windows']} windows, SOT at {lg['sot_indices']}  [{card}]")
    for label, r in (("fp32", f32), ("int8", i8)):
        log(f"[asr {label}] encoder {r['encoder_ms']:.2f} ms per 30 s window "
            f"(+ cross K/V: {r['context_ms']:.2f}); decoder "
            f"{r['decoder_ms_per_token']:.2f} ms per token (CUDA events, "
            f"steps queued), device {r['decoder_device_ms_per_token']} ms, "
            f"{r['cuda_launches_per_token']} CUDA launches a token; the "
            f"greedy loop {r['loop_ms_per_token']:.2f} ms per token (one "
            f"host read a token)  [{card}]")
    log(f"[asr int8] {ASR_CLIPS_S[0]:.0f} s clip: wall {i8['wall_s']:.3f} s, "
        f"RTF {i8['rtf']:.3f}; {i8['tokens_equal_fp32']} of {i8['tokens']} "
        f"tokens as fp32's  [{card}]")
    tf = asr_res["teacher_forced"]
    log(f"[asr] language {asr_res['language']} (|sum p - 1| = "
        f"{asr_res['language_prob_sum_err']:.2e}); teacher-forced vs steps: "
        f"{tf['held']} of {tf['tokens']} positions held (top-2 gap >= "
        f"{TOP2_GAP}; smallest {tf['min_top2_gap']}), equal {tf['equal']}; "
        f"{ASR_NARROW}+{ASR_NARROW} layers card vs CPU: tokens "
        f"{asr_res['narrow_tokens']}, CPU {asr_res['narrow_cpu_s']:.2f} s, "
        f"card {asr_res['narrow_card_s']:.2f} s  [{card}]")
    log(f"[asr] peak memory {asr_res['peak_gb']:.2f} GB ({asr_res['peak_gb_over_base']:.2f} "
        f"above the phase's start); served dir {asr_res['dir_gb']:.2f} GB "
        f"written in {asr_res['dir_write_s']:.1f} s  [{card}]")
    log(f"[asr] checks: {asr_res['checks']}; phase {asr_res['phase_s']:.1f} s")
    ok &= asr_res["ok"]
    report["asr"] = asr_res
    torch.cuda.empty_cache()

    mark("11b")
    # 11c. beam search, best-of, words, streaming and realtime on 11b's model
    se = run_asr_search(dev, card, keep)
    bm, bo, sv_ = se["beam"], se["best_of"], se["service"]
    log(f"[asr search] beam W={bm['W']}: {bm['tokens']} tokens, "
        f"{bm['n_finished']} finished, sum {bm['sum_logprob']:.4f} (teacher-"
        f"forced {bm['forced_sum']:.4f}), {se['beam_loop_ms_per_token']:.2f} "
        f"ms per token (host loop wall); best-of N={bo['N']} at T="
        f"{bo['temperature']}: {se['best_of_loop_ms_per_token']:.2f} ms per "
        f"token, winner row {bo['winner_row']}; a decoder step at {bm['W']} "
        f"rows {se['step_ms_w_rows']:.2f} ms (CUDA events, steps queued); "
        f"slab gather {se['slab_gather_mb_per_token']:.1f} MB a token  [{card}]")
    log(f"[asr search] service (beam T=0, best-of T={ASR_BEST_T}) on the "
        f"{se['clip_s']:.0f} s clip: wall {sv_['wall_s']:.3f} s, RTF "
        f"{sv_['rtf']:.3f}, {sv_['decode_calls']} decodes; words "
        f"{se['words']['n_words']} for {se['words']['tokens']} tokens; "
        f"alignment forward ({se['align_heads']} heads, maps "
        f"{se['align_maps_mb']:.1f} MB) {se['align_ms']:.2f} ms, DTW "
        f"{se['dtw_ms']:.2f} ms over {se['dtw_cells']}  [{card}]")
    st_, rt_ = se["streaming"], se["realtime"]
    log(f"[asr search] {ASR_NARROW}+{ASR_NARROW} layers beam W="
        f"{ASR_NARROW_BEAM} card vs CPU: n_tokens {se['narrow_beam']['n_tokens']}"
        f", n_finished {se['narrow_beam']['n_finished']}; streaming "
        f"{st_['results']} of {st_['expected']} results, push to result s "
        f"{[round(x, 3) for x in st_['push_to_result_s']]}; realtime "
        f"({rt_['route']}) end_session to final {rt_['end_to_final_s']} s; "
        f"peak memory {se['peak_gb']:.2f} GB  [{card}]")
    log(f"[asr search] checks: {se['checks']}; phase {se['phase_s']:.1f} s")
    ok &= se["ok"]
    report["asr_search"] = se

    mark("11c")
    # 12. the serving front end over sockets on phase 11's loaded engine
    pool8 = sv["pools"].get(SERVER_MAX_STREAMS, {})
    srv = run_server(dev, card, keep,
                     direct_rtf=pool8.get("burst", {}).get("aggregate_rtf"),
                     direct_lm_ms=pool8.get("lm_ms_per_step"))
    ws_note = ("present" if srv["websockets"]
               else "absent: the WebSocket check is skipped")
    log(f"[server] websockets {ws_note}")
    log("[server] route wall ms: " + ", ".join(
        f"{k} {v * 1e3:.1f}" for k, v in srv["walls_s"].items()) + f"  [{card}]")
    bu = srv["burst"]
    log(f"[server] burst of {SERVER_MAX_STREAMS} greedy chunked streams: first "
        f"PCM byte ms {[round(x, 1) for x in bu['first_byte_ms']]}; aggregate "
        f"RTF {bu['aggregate_rtf']:.3f} ({bu['audio_s']:.2f} s audio in "
        f"{bu['wall_s']:.2f} s) against phase 11's direct pool of 8 "
        f"{bu['direct_pool8_rtf']}; block wall {bu['block_wall_ms_per_step']:.2f} "
        f"ms per pool step; host_stats dispatch "
        f"{bu['host_stats']['dispatch_ms_per_frame']:.3f} / fanout "
        f"{bu['host_stats']['fanout_ms_per_frame']:.3f} ms per stream frame  [{card}]")
    tr = srv["traced"]
    if "cuda_kernels_per_step" in tr:
        log(f"[server] traced burst: {tr['cuda_kernels_per_step']:.0f} CUDA "
            f"kernels per pool step, {tr['cuda_kernels_per_stream_frame']:.0f} "
            f"per stream frame, busy share {tr['busy_share']:.3f}  [{card}]")
    log(f"[server] LM {srv['lm_ms_per_step']:.2f} ms per batched frame at B="
        f"{SERVER_MAX_STREAMS} with the server up (phase 11, no server: "
        f"{srv['direct_lm_ms_per_step']}); block policy frame cost "
        f"block_frame_cost_ms {srv['block_frame_cost_ms']} (rtt "
        f"{(srv['block_policy'] or {}).get('rtt_ms')}); recommendations "
        f"{srv['recommendations']}  [{card}]")
    log(f"[server] greedy REST vs ContinuousBatcher.submit: "
        f"{srv['generate_vs_submit_lsb']} LSB ({srv['greedy_frames']} frames); "
        f"the cold first request vs a fitted one {srv['cold_vs_warm_lsb']} LSB; "
        f"burst vs lone request {srv['burst_vs_generate_lsb']} LSB; WS vs REST "
        f"{srv.get('ws_vs_rest_lsb')} LSB; after reload "
        f"{srv['after_reload_lsb']} LSB (reload {srv['reload']})  [{card}]")
    cl = srv["cli"]
    log(f"[server] CLI server ({cl['cmd']}): ready in {cl.get('ready_s', 0):.1f} s, "
        f"exit {cl['exit_code']}, device {cl.get('stats_device')}, greedy vs "
        f"in-process: cold {cl.get('cold_vs_in_process_lsb')} LSB, warm "
        f"{cl.get('warm_vs_in_process_lsb')} LSB  [{card}]")
    sa = cl.get("asr")
    if sa:
        log(f"[server] CLI server --asr: ASR loaded from the dir in "
            f"{cl.get('asr_load_s')} s, warmed up in {cl.get('asr_warmup_s')} s; "
            f"/v1/audio/speech {sa['speech_s']:.2f} s ({sa['audio_s']:.2f} s "
            f"audio, launches {sa['launches']}), its wav transcribed in "
            f"{sa['transcribe_s']:.2f} s; round trip {sa['round_trip_s']:.2f} s"
            f"  [{card}]")
    shutil.rmtree(keep.pop("asr_dir", ""), ignore_errors=True)
    log(f"[server] launches in (a): {srv['launches']}")
    log(f"[server] checks: {srv['checks']}; phase {srv['phase_s']:.1f} s")
    for k, n in srv["launches"].items():
        main_launches[k] = main_launches.get(k, 0) + n
    ok &= srv["ok"]
    report["server"] = srv

    mark("12")
    # 13. training at flagship width, then train -> export -> serve
    # phase 16(e)'s dir keeps phase 11's codec tree (a hard link)
    mesh_dir = stash_mesh_dir(keep["dir"])
    try:
        tr = run_training(dev, card, keep["dir"])
    finally:
        shutil.rmtree(keep.pop("dir"), ignore_errors=True)
    lm, cd = tr["lm"], tr["codec"]
    log(f"[train lm] {lm['params'] / 1e9:.3f} B parameters, B={lm['B']} "
        f"S={lm['S']}, {lm['compute']}, remat {lm['remat']}: step ms median "
        f"{lm['step_ms_median']:.2f}, min {lm['step_ms_min']:.2f} "
        f"({TRAIN_TIMED} timed after {TRAIN_WARMUP}); {lm['tokens_per_s']:.0f} "
        f"positions/s; peak memory {lm['peak_gb']:.2f} GB; MFU "
        f"{lm['mfu']:.4f} ({lm['model_flops']:.4e} model FLOPs a step / "
        f"median step / {PEAK_BF16:.4g} FLOP/s; FLOPs = {lm['flops_formula']})"
        f"  [{card}]")
    ts_ = lm["traced_step"]
    if ts_:
        log(f"[train lm] traced step: wall {ts_['wall_s'] * 1e3:.1f} ms, device "
            f"{ts_['device_s'] * 1e3:.1f} ms, busy share {ts_['busy_share']:.3f}, "
            f"{ts_['kernel_launches']} CUDA kernel launches  [{card}]")
        for name, k_ms, n in ts_["top"]:
            log(f"  {k_ms:9.3f} ms {n:6d} x  {name}")
    log(f"[train lm] losses {[round(x, 4) for x in lm['losses']]}; grad norms "
        f"{[round(x, 3) for x in lm['grad_norms']]}; one batch, bf16 (loss, "
        f"gnorm) by remat {lm['bf16_by_remat']}, fp32 {lm['fp32']}")
    log(f"[train codec] {cd['trainable_params'] / 1e9:.3f} B trainable, B="
        f"{cd['B']} x {cd['window']} samples, {cd['compute']}, remat "
        f"{cd['remat']}: step ms median {cd['step_ms_median']:.2f}, min "
        f"{cd['step_ms_min']:.2f}; peak memory {cd['peak_gb']:.2f} GB; losses "
        f"{[round(x, 3) for x in cd['losses']]}  [{card}]")
    log(f"[train->serve] checkpoint {tr['ckpt_gb']:.2f} GB saved in "
        f"{tr['save_s']:.1f} s; export {tr['export_s']:.1f} s "
        f"({tr['export']['exported']}); engine from the export in "
        f"{tr['load_s']:.1f} s; greedy generate of {tr['frames']} frames in "
        f"{tr['generate_s']:.2f} s, launches {tr['launches']}; leaves equal "
        f"to the masters: {tr['leaves_compared']}  [{card}]")
    log(f"[train] checks: {tr['checks']}; phase {tr['phase_s']:.1f} s")
    for k, n in tr["launches"].items():
        main_launches[k] = main_launches.get(k, 0) + n
    ok &= tr["ok"]
    report["training"] = tr

    mark("13")
    # 14. the convert drill at the flagship's widths (kernels A and C)
    dr = run_convert_drill(dev, card)
    fid = dr["summary"].get("fidelity", {})
    log(f"[drill] reference pickles {dr['pickle_gb']:.2f} GB written in "
        f"{dr['pickle_write_s']:.1f} s; run_convert: conversion "
        f"{dr['convert_s']:.1f} s, goldens {dr['goldens_s']:.1f} s (codec "
        f"{dr['golden_codec_s']:.2f}, LM {dr['golden_lm_s']:.2f}), fidelity "
        f"{dr['fidelity_s']:.1f} s (generate {dr['fidelity_generate_s']:.1f}, "
        f"transcribe {dr['fidelity_transcribe_s']:.2f}); wer {fid.get('wer')} "
        f"cer {fid.get('cer')}; parity {dr['summary']['parity']}; launches "
        f"{dr['launches']}; CLI `{dr['cli']['cmd']}` exit "
        f"{dr['cli']['exit_code']} in {dr['cli_s']:.1f} s, parity "
        f"{dr['cli']['parity']}  [{card}]")
    log(f"[drill] checks: {dr['checks']}; phase {dr['phase_s']:.1f} s")
    for k, n in dr["launches"].items():
        main_launches[k] = main_launches.get(k, 0) + n
    ok &= dr["ok"]
    report["drill"] = dr

    mark("14")
    # 15. speculative depth and the one-token vocoder
    sp = run_speculative(dev, card)
    for label in ("bf16", "int8_backbone", "int4_depth"):
        r = sp[label]
        g, v, st = r["generate"], r["verify"], r.get("stream", {})
        tr = r.get("trace", {})
        log(f"[spec {label}] generate: {g['frames']} frames, LM "
            f"{g['lm_ms_per_frame']:.2f} ms/frame (plain loop, recorded: "
            f"{r['plain']['lm_ms_per_frame']:.2f}), RTF {g['rtf']:.3f}; rounds a "
            f"frame mean {g['jacobi']['rounds_mean']:.2f} max "
            f"{g['jacobi']['max_rounds']}; FPL {st.get('first_packet_ms', 0):.1f} "
            f"ms; launches {g['launches']}; traced: "
            f"{tr.get('cuda_launches_per_frame', float('nan')):.0f} CUDA launches "
            f"a frame, busy {tr.get('busy_share', float('nan')):.3f}  [{card}]")
        log(f"[spec {label}] frames equal the plain loop's: "
            f"{r['frames_equal_plain']} (common prefix "
            f"{r['common_prefix_with_plain']}); Jacobi on the plain loop's "
            f"{v['calls']} depth calls: {v['rows_differing']} rows differ, "
            f"flips {v['flips']}, explained {v['explained']}")
    for row in sp.get("kernel_e", []):
        log(f"kernel E {row['name']} {row['K']}x{row['O']} M={row['M']}: "
            f"max_abs_err {row['max_abs_err']:.3e} ok={row['ok']}  "
            f"{fmt_times(row)}  [{card}]")
    po = sp["pool"]
    log(f"[spec pool B={po['B']}] burst: {po['audio_s']:.2f} s audio in "
        f"{po['wall_s']:.2f} s, aggregate RTF {po['aggregate_rtf']:.3f} (plain "
        f"loop {po['plain_wall_s']:.2f} s); rounds a pool step mean "
        f"{po['jacobi']['rounds_mean']:.2f} max {po['jacobi']['max_rounds']} "
        f"over {po['jacobi']['frames']} steps; streams equal the plain pool's "
        f"{po['streams_equal_plain']} of {po['B']} (common prefixes "
        f"{po['common_prefix_with_plain']}); Jacobi on {po['verify']['calls']} "
        f"recorded pool steps: {po['verify']['rows_differing']} rows differ, "
        f"explained {po['verify']['explained']}; lone request (B=1) common "
        f"prefix {po['lone_common_prefix']}  [{card}]")
    tl = sp["trained_loop"]
    log(f"[spec trained loop] {tl['config']} config, {tl['steps_lm']} + "
        f"{tl['steps_codec']} steps, {tl['secs']:.1f} s: token accuracy "
        f"{tl['token_acc_trained']}, rounds {tl['rounds']}, plan overlap "
        f"trained {tl['kernel_overlap_trained']} random "
        f"{tl['kernel_overlap_random']} ({tl['kernel_overlap_route']}), QA "
        f"{tl['qa_pass']}/{tl['qa_total']}  [{card}]")
    ot = sp["one_token"]
    log(f"[spec one-token vocoder] {ot['tokens']} tokens: "
        f"{ot['ms_per_token']:.2f} ms a token (host), queued "
        f"{ot['queued_ms_per_token']} ms; gaps of peak: one-token vs grouped "
        f"{ot['one_token_vs_grouped']:.4f}, one-token vs batch "
        f"{ot['one_token_vs_batch']:.4f}, grouped vs batch "
        f"{ot['grouped_vs_batch']:.4f}; kernel C S=64 vs 8 x S=8 on the same "
        f"rows: {ot['kernel_c_s8_vs_s64']}; launches {ot['launches']}  [{card}]")
    log(f"[spec] checks: {sp['checks']}; phase {sp['phase_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in sp["part_s"].items()) + ")")
    for k, n in sp["launches"].items():
        main_launches[k] = main_launches.get(k, 0) + n
    ok &= sp["ok"]
    report["speculative"] = sp

    mark("15")
    # 16. serving on a (dp, tp) mesh: (a) kernel A's kv-head window and tp
    # route, (b) kernel C's tp route, (c) tp=2 and (d) dp=2 over two gloo
    # ranks on the one card, (e) `serve --tp 2` under torchrun
    lm = FLAGSHIP["lm"]
    res_aw = check_kernel_a_window(dev, lm["L"], lm["T"], lm["Hkv"], lm["G"],
                                   lm["Dh"], lm["reps"])
    for r in res_aw:
        log(f"kernel A tp={r['tp']} ({r['heads_a_rank']} query heads a rank, "
            f"window {r['kv_window']}) B={r['B']} live~{r['live']}: max_abs_err "
            f"rank vs plain {r['rank_max_abs_err']:.3e}, ranks' concat vs "
            f"unsharded {r['concat_max_abs_err']:.3e} ok={r['ok']}  "
            f"{fmt_times(r)}  [{card}]")
        ok &= r["ok"]
    voc = FLAGSHIP["voc"]
    res_cs = check_kernel_c_shard(dev, voc["L"], voc["T"], voc["H"], voc["Dh"],
                                  voc["reps"])
    for r in res_cs:
        log(f"kernel C tp={r['tp']} ({r['heads_a_rank']} heads a rank) "
            f"B={r['B']} S={r['S']} live~{r['live']}: max_abs_err rank vs "
            f"plain {r['rank_max_abs_err']:.3e}, concat vs unsharded "
            f"{r['concat_max_abs_err']:.3e}, rows identical "
            f"{r['rows_identical']} ok={r['ok']}  {fmt_times(r)}  [{card}]")
        ok &= r["ok"]
    # (e) boots while (c) and (d) run
    mesh_cli = start_mesh_cli(write_mesh_dir(mesh_dir))
    try:
        ms_ = run_mesh(dev, card)
    finally:
        mc = finish_mesh_cli(mesh_cli)
        shutil.rmtree(mesh_dir, ignore_errors=True)
    log(f"[mesh 16c] tp=2, two gloo ranks on one card: engines built in "
        f"{ms_['rank_build_s']} s; generate of {MESH_FRAMES} frames "
        f"{ms_['rank_generate_s']} s; launches a rank {ms_['launches']}; "
        f"first frame's logits gap {ms_['first_logits_gap_of_peak']:.3e} of "
        f"the peak; common prefix with one rank {ms_['tp_common_prefix']} "
        f"frames, first flip {ms_['tp_first_flip']} "
        f"({ms_.get('tp_flip_reason', 'none: equal')}); collectives "
        f"{[(c['calls'], c['max_bytes']) for c in ms_['comm']]}  [{card}]")
    log(f"[mesh 16d] dp=2 pool of {MESH_POOL} (4 + 4): "
        f"{ms_['dp_pool_wall_s']:.2f} s; streams vs the one-rank pool "
        f"{ms_['dp_streams']}, common prefixes {ms_['dp_common_prefix']}  "
        f"[{card}]")
    log(f"[mesh 16e] `{mc['cmd']}`: healthy {mc.get('healthy')} in "
        f"{mc['ready_s']:.1f} s (engine warm-up {mc['warmup_s']} s); one "
        f"request {mc.get('request_s', 0):.2f} s, {mc.get('samples')} samples, "
        f"answered {mc.get('answered')}; mesh line {mc['mesh_line']}, gloo on "
        f"the shared card {mc['gloo_shared']}; exit {mc['exit_code']}  [{card}]")
    log(f"[mesh] checks: {ms_['checks']}; phase {ms_['phase_s']:.1f} s")
    ok &= ms_["ok"] and mc["ok"]
    report["mesh_cli"] = mc
    report["mesh"] = dict(kernel_a_window=res_aw, kernel_c_shard=res_cs, **ms_)

    mark("16")
    report["phase_s"] = phase_s
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

    def at(row):
        """A case's numbers beside an entry's (the 16-slot pool's shapes)."""
        keys = ("ms", "queued_ms", "plain_ms", "plain_queued_ms", "bound_ms",
                "bound_by", "library_ms", "max_abs_err", "ok")
        return {k: row.get(k) for k in keys}

    csrc = "fireredtts2_tpu_torch/csrc/"
    kernels = [
        entry("flash_decode_gqa1", csrc + "flash_decode_gqa1.cu",
              "fireredtts2_tpu/ops/pallas_flash.py:600",
              main_launches["flash_decode_gqa1"], res_a,
              pick(res_a, B=1, live=3000),
              cuda_launches_per_call=pick(res_a, B=1, live=3000)[
                  "cuda_launches_per_call"],
              live_sweep=sweep_a["ms"] or sweep_a["queued_ms"],
              b16=at(pick(res_a, B=16, live=3000)),
              b16_past_end=at(pick(res_a, B=16, past_end=True))),
        entry("fused_depth_decode", csrc + "fused_depth_decode.cu",
              "fireredtts2_tpu/ops/pallas_depth.py:749",
              main_launches["fused_depth_decode"], res_b,
              pick(res_b, plan=PRESET, B=1),
              barriers_per_frame=pick(res_b, plan=PRESET, B=1)["barriers_per_frame"],
              ring_stages=pick(res_b, plan=PRESET, B=1)["ring_stages"],
              b16=at(pick(res_b, plan=PRESET, B=16))),
        entry("flash_decode_update_bounded", csrc + "flash_decode_update.cu",
              "fireredtts2_tpu/ops/pallas_flash.py:352",
              main_launches["flash_decode_update_bounded"], res_c,
              pick(res_c, B=1, S=64, live=2900),
              cuda_launches_per_call=pick(res_c, B=1, S=64, live=2900)[
                  "cuda_launches_per_call"],
              b16=at(pick(res_c, B=16, S=32, live=2900)),
              past_slab=at(pick(res_c, past_slab=True))),
        entry("flash_decode_bounded", csrc + "flash_decode_update.cu",
              "fireredtts2_tpu/ops/pallas_flash.py:323",
              res_d["launches"], [res_d], res_d, launched_in="check",
              served_by="flash_decode_update_bounded"),
        entry("int4_matmul", csrc + "int4_matmul.cu",
              "fireredtts2_tpu/ops/pallas_int4.py:74",
              main_launches["int4_matmul"], res_e + sp["kernel_e"],
              pick(res_e, name="w_gate", M=1),
              speculative_rows={m: at(pick(sp["kernel_e"], name="w_gate", M=m))
                                for m in E_SPEC_MS}),
        entry("pallas_decode_attention", csrc + "flash_decode_gqa1.cu",
              "fireredtts2_tpu/ops/pallas_attention.py:176", f_launches, res_f,
              pick(res_f, B=1, live=3000), launched_in="check",
              served_by="flash_decode_gqa1"),
        # a rank's launches in phase 16(c)'s generate at tp=2
        entry("flash_decode_gqa1_shard", csrc + "flash_decode_gqa1.cu",
              "fireredtts2_tpu/ops/pallas_flash.py:700",
              ms_["launches"][0]["flash_decode_gqa1_shard"], res_aw,
              pick(res_aw, tp=4, B=1, live=3000), launched_in="16c",
              shape="tp=4: 3 query heads over kv head 1 of the (28, B, 3584, "
                    "256) slab, B=1, live ~3000",
              tp2=at(pick(res_aw, tp=2, B=1, live=3000)),
              b8=at(pick(res_aw, tp=4, B=8, live=3000))),
        entry("flash_decode_update_bounded_shard", csrc + "flash_decode_update.cu",
              "fireredtts2_tpu/ops/pallas_flash.py:406",
              ms_["launches"][0]["flash_decode_update_bounded_shard"], res_cs,
              pick(res_cs, B=1, S=64, live=2900), launched_in="16c",
              shape="tp=2: 8 heads, (12, B, 3008, 512) slab columns, B=1, S=64",
              b8=at(pick(res_cs, B=8, S=64, live=2900))),
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
