"""A small TRAINED checkpoint as the stand-in for real weights: speculative
depth rounds, the draft head and kernel B's plan modes measured on weights
that are not random.

Counterpart of the JAX package's ``tools/trained_loop.py``. No real
FireRedTTS-2 weights are in the repository, and random weights are the
worst case for every acceptance question (every depth position a top-k
coin flip). This trains a small model with the port's own trainers on a
learnable synthetic task:

- LM task: audio token (frame t, codebook q) = 1 + (7 t + 13 q + s) % 63,
  s = the first text token % 63: given by the text, and a lookup to learn,
  so a trained backbone and depth stack make the depth chain predictable
  (the regime of a real TTS checkpoint). Utterances are 16 frames, then
  EOS. The LM trains with the MTP draft head (``depth_draft``).
- Codec task: sine-class audio (the wav-dir pipeline).

Then: train LM and codec -> ``export`` into a serving dir ->
``FireRedTTS2Engine(pretrained_dir=...)`` -> measure on that engine:
1. greedy token accuracy against the ground-truth mapping (the small
   model's "WER"; random weights score ~1/63);
2. Jacobi rounds on teacher-forced backbone hiddens with the previous-frame
   init and with the trained draft's init, trained against random weights;
3. kernel B's plan modes (r8, r4 and a8) against the plain depth chain:
   token overlap on trained and on random weights (on the card through the
   kernel, on the CPU through its plain version);
4. the QA scenarios and the fidelity harness's wiring on the trained
   engine.

Configs: on the CPU the tiny dev config (the JAX tool's; kernels A and C
refuse its head widths), trained at a peak learning rate of 3e-3; on the
card "kernel", the smallest widths that every kernel of the path takes:
backbone and depth decoder qwen-200m (head dim 128), the tiny config's
vocabularies and codebooks, the tiny codec with a 128-wide acoustic
decoder (head dim 64), bf16 serving, trained in bf16 over fp32 masters at
1e-3.

    python -m fireredtts2_tpu_torch.tools.trained_loop [--steps-lm 2000]
        [--steps-codec 150] [--out DIR] [--device cpu]

Prints one JSON line a phase ("train_lm", "train_codec", "summary"). The
work dir (data, checkpoints, the serving dir) is a temporary one removed
at the end unless --out names one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

V_AUDIO = 64          # the tiny config's audio vocabulary
N_FRAMES = 16         # utterance length (teaches EOS at t = 16)
PLANS = ("gate=r8,up=s8,down=s8", "gate=r4,up=s8,down=s8",
         "gate=r8a8,up=s8a8,down=s8a8")


def gt_frame(s: int, t: int, ncb: int) -> np.ndarray:
    """Ground-truth audio frame at time t for first-token class s."""
    q = np.arange(ncb)
    return 1 + (7 * t + 13 * q + s) % (V_AUDIO - 1)


def make_jsonl(path: str, n: int, ncb: int, tvocab: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            nt = int(rng.integers(4, 9))
            text = rng.integers(1, tvocab, nt).tolist()
            s = int(text[0] % (V_AUDIO - 1))
            audio = [gt_frame(s, t, ncb).tolist() for t in range(N_FRAMES)]
            f.write(json.dumps({"text_tokens": text,
                                "audio_tokens": audio}) + "\n")


def make_wavs(d: str, n: int, seed: int) -> None:
    from scipy.io import wavfile
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    t = np.arange(16_000) / 16_000.0
    for i in range(n):
        f0 = float(rng.choice([220.0, 330.0, 440.0, 550.0]))
        x = 0.3 * np.sin(2 * np.pi * f0 * t) \
            + 0.05 * rng.standard_normal(t.shape)
        wavfile.write(os.path.join(d, f"sine_{i}.wav"), 16_000,
                      (np.clip(x, -1, 1) * 32767).astype(np.int16))


def loop_config(kernel: bool):
    """(EngineConfig, LLMConfig with the draft head): the "kernel" config,
    or the tiny one."""
    from fireredtts2_tpu_torch.config import tiny_engine_config

    cfg = tiny_engine_config()
    if kernel:
        c = cfg.codec
        width = 128                      # kernel C's head dim 64 at 2 heads
        cfg = dataclasses.replace(
            cfg,
            llm=dataclasses.replace(cfg.llm, backbone_flavor="qwen-200m",
                                    decoder_flavor="qwen-200m",
                                    dtype="bfloat16"),
            codec=dataclasses.replace(
                c, dtype="bfloat16", upsample_embed_dim=width,
                rvq=dataclasses.replace(c.rvq, output_dim=width),
                semantic_decoder=dataclasses.replace(c.semantic_decoder,
                                                     in_dim=width),
                acoustic_decoder=dataclasses.replace(c.acoustic_decoder,
                                                     embed_dim=width)))
    return cfg, dataclasses.replace(cfg.llm, depth_draft_head=True)


def build_sequence(cfg, text: list[int]) -> tuple[np.ndarray, np.ndarray, int]:
    """(1, S, C+1) tokens and mask: text rows, then N_FRAMES ground-truth
    audio rows, then the EOS frame (``train.loop.jsonl_batches``' layout)."""
    ncb = cfg.audio_num_codebooks
    C = ncb + 1
    nt = len(text)
    S = nt + N_FRAMES + 1
    s = int(text[0] % (V_AUDIO - 1))
    tokens = np.zeros((1, S, C), np.int32)
    mask = np.zeros((1, S, C), bool)
    tokens[0, :nt, -1] = text
    mask[0, :nt, -1] = True
    for t in range(N_FRAMES):
        tokens[0, nt + t, :-1] = gt_frame(s, t, ncb)
    mask[0, nt:, :-1] = True          # audio rows and the EOS frame
    return tokens, mask, nt


def backbone_hiddens(params, cfg, tokens, mask, device) -> torch.Tensor:
    """Teacher-forced backbone hiddens of a whole sequence (no cache)."""
    from fireredtts2_tpu_torch.models.lm.model import frame_hidden
    from fireredtts2_tpu_torch.models.lm.transformer import transformer_forward
    from fireredtts2_tpu_torch.ops import masks as mask_ops

    dtype = params["text_embeddings"].dtype
    h = frame_hidden(params, cfg, torch.as_tensor(tokens, device=device),
                     torch.as_tensor(mask, device=device), dtype)
    B, S = tokens.shape[:2]
    pos = torch.arange(S, dtype=torch.int32, device=device).expand(B, S)
    attn = mask_ops.causal_mask(S, device).expand(B, S, S)
    hh, _ = transformer_forward(params["backbone"], cfg.backbone, h, pos, attn)
    return hh


def _noise(cfg, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.empty((1, cfg.audio_num_codebooks, cfg.audio_vocab_size),
                       device=device).exponential_(generator=gen)


def measure_rounds(params, cfg, texts, label, use_draft, device,
                   depth_topk=1, depth_temperature=0.75) -> dict:
    """Jacobi rounds and ground-truth agreement on teacher-forced hiddens:
    each frame's init is the previous frame's chain, as ``lm_generate_frame``
    takes it (zeros after the text), or, with `use_draft`, the draft head's
    guess. (The JAX tool passes no init under the prev-frame label: zeros
    for every frame.)"""
    from fireredtts2_tpu_torch.models.lm.model import (
        depth_decode_jacobi, draft_depth_tokens,
    )

    ncb = cfg.audio_num_codebooks
    all_rounds, agree, total = [], 0, 0
    for text in texts:
        tokens, mask, nt = build_sequence(cfg, text)
        hh = backbone_hiddens(params, cfg, tokens, mask, device)
        for t in range(N_FRAMES):
            p = nt + t                       # the frame's row; hidden at p-1
            last_h = hh[:, p - 1]
            c0 = torch.as_tensor(tokens[:, p, 0], device=device)
            prev = torch.as_tensor(tokens[:, p - 1, 1:ncb], device=device)
            init = prev.clamp(0, cfg.audio_vocab_size - 1)
            if use_draft and "depth_draft" in params:
                init = draft_depth_tokens(params, cfg, last_h, c0)
            samples, rounds = depth_decode_jacobi(
                params, cfg, last_h, c0, _noise(cfg, 1000 + t, device),
                depth_topk, depth_temperature, init=init)
            all_rounds.append(rounds)
            got = samples[0, 1:].cpu().numpy()
            agree += int((got == tokens[0, p, 1:ncb]).sum())
            total += ncb - 1
    r = np.asarray(all_rounds)
    return {"label": label, "rounds_mean": round(float(r.mean()), 3),
            "rounds_max": int(r.max()), "worst_case": ncb - 1,
            "gt_token_acc": round(agree / total, 3)}


def token_accuracy(engine, texts) -> float:
    """Generation against the ground-truth mapping through the serving
    path (``engine._run_ar``, top-1 codebook 0): the small model's WER."""
    ncb = engine.config.llm.audio_num_codebooks
    agree = total = 0
    for text in texts:
        tokens, mask, nt = build_sequence(engine.config.llm, text)
        [gen] = engine._run_ar([(tokens[0, :nt], mask[0, :nt])],
                               N_FRAMES + 4, 0.75, 1, utt_seed=0)
        s = int(text[0] % (V_AUDIO - 1))
        for t in range(min(len(gen), N_FRAMES)):
            agree += int((gen[t] == gt_frame(s, t, ncb)).sum())
            total += ncb
        total += abs(len(gen) - N_FRAMES) * ncb   # length errors count
    return round(agree / max(total, 1), 3)


def kernel_overlap(params, cfg, texts, plans, device) -> dict:
    """Kernel B's plan modes against the plain depth chain (top-1) on the
    given weights: the share of equal tokens per plan. The a8 modes change
    the numerics by design; this is their quality check on trained
    weights."""
    from fireredtts2_tpu_torch.models.lm.model import _depth_decode
    from fireredtts2_tpu_torch.ops.depth_chain import (
        fused_depth_decode, prepare_depth_chain,
    )

    plain_cfg = dataclasses.replace(cfg, speculative_depth=False,
                                    fused_depth_plan="")
    hs, c0s = [], []
    for text in texts[:2]:
        tokens, mask, nt = build_sequence(cfg, text)
        hh = backbone_hiddens(params, cfg, tokens, mask, device)
        for t in range(0, N_FRAMES, 2):
            hs.append(hh[:, nt + t - 1])
            c0s.append(torch.as_tensor(tokens[:, nt + t, 0], device=device))
    out = {}
    for plan in plans:
        pcfg = dataclasses.replace(plain_cfg, fused_depth_plan=plan)
        bundle = prepare_depth_chain(params, pcfg, plan)
        match = total = 0
        for i, (h, c0) in enumerate(zip(hs, c0s)):
            noise = _noise(cfg, i, device)
            want = _depth_decode(params, plain_cfg, h, c0, noise, 1, 0.75)
            got = fused_depth_decode(bundle, pcfg, h, c0, noise, depth_topk=1,
                                     depth_temperature=0.75, plan=plan)
            match += int((got == want).sum())
            total += want.numel()
        out[plan] = round(match / total, 3)
    return out


def run(steps_lm: int = 2000, steps_codec: int = 150, out: str | None = None,
        device="cuda", log=print) -> dict:
    """The whole loop; returns the summary (also printed)."""
    from fireredtts2_tpu_torch.engine import FireRedTTS2Engine
    from fireredtts2_tpu_torch.models.lm.model import init_lm_params
    from fireredtts2_tpu_torch.runtime.convert import run_export
    from fireredtts2_tpu_torch.serve.qa import FidelityHarness, QAPipeline
    from fireredtts2_tpu_torch.train.codec_loop import (
        CodecTrainConfig, train_codec, wav_dir_batches,
    )
    from fireredtts2_tpu_torch.train.loop import (
        TrainConfig, jsonl_batches, train,
    )
    from fireredtts2_tpu_torch.weights import dtype_of, resolve_device

    dev = resolve_device(device)
    config = "kernel" if dev.type == "cuda" else "tiny"
    cfg, lm_cfg = loop_config(config == "kernel")
    lr = 3e-3 if config == "tiny" else 1e-3
    work = out or tempfile.mkdtemp(prefix="trained_loop_")
    os.makedirs(work, exist_ok=True)
    quiet = lambda *a, **k: None       # noqa: E731 -- the trainers' step lines
    rng = np.random.default_rng(0)
    held_out = [rng.integers(1, lm_cfg.text_vocab_size,
                             int(rng.integers(4, 9))).tolist()
                for _ in range(4)]
    try:
        # ---- 1. data and training ------------------------------------
        jl = os.path.join(work, "lm_data.jsonl")
        make_jsonl(jl, 4096, lm_cfg.audio_num_codebooks,
                   lm_cfg.text_vocab_size, seed=1)
        t0 = time.perf_counter()
        tcfg = TrainConfig(batch_size=16, seq_len=32, peak_lr=lr,
                           warmup_steps=min(50, max(steps_lm // 4, 1)),
                           total_steps=steps_lm, checkpoint_every=steps_lm,
                           checkpoint_dir=os.path.join(work, "lm_ck"),
                           log_every=max(steps_lm // 10, 1),
                           mixed_precision=config == "kernel")
        train(lm_cfg, tcfg, data=jsonl_batches(jl, lm_cfg, tcfg),
              num_steps=steps_lm, log=quiet, device=dev)
        log(json.dumps({"phase": "train_lm", "config": config,
                        "steps": steps_lm,
                        "secs": round(time.perf_counter() - t0, 1)}))

        wd = os.path.join(work, "wavs")
        make_wavs(wd, 32, seed=2)
        t0 = time.perf_counter()
        ccfg = CodecTrainConfig(batch_size=4, window_samples=5120,
                                peak_lr=1e-3,
                                warmup_steps=min(20, max(steps_codec // 4, 1)),
                                total_steps=steps_codec,
                                checkpoint_every=steps_codec,
                                checkpoint_dir=os.path.join(work, "codec_ck"),
                                log_every=max(steps_codec // 5, 1))
        train_codec(cfg.codec, ccfg, data=wav_dir_batches(wd, ccfg),
                    num_steps=steps_codec, log=quiet, device=dev)
        log(json.dumps({"phase": "train_codec", "steps": steps_codec,
                        "secs": round(time.perf_counter() - t0, 1)}))

        # ---- 2. export -> serve --------------------------------------
        with open(os.path.join(work, "config_llm.json"), "w") as f:
            json.dump({"llm_models": {k: getattr(lm_cfg, k) for k in (
                "backbone_flavor", "decoder_flavor", "text_vocab_size",
                "audio_vocab_size", "audio_num_codebooks",
                "decoder_loss_weight")}}, f)
        with open(os.path.join(work, "config_codec.json"), "w") as f:
            json.dump({"codec": {}}, f)
        serving = os.path.join(work, "serving")
        run_export(serving, work,
                   lm_ckpt=os.path.join(work, "lm_ck", f"step_{steps_lm:08d}"),
                   codec_ckpt=os.path.join(work, "codec_ck",
                                           f"step_{steps_codec:08d}"))
        # the JSONs cannot name every field of these configs: pin them all
        llm_over = {f.name: getattr(lm_cfg, f.name)
                    for f in dataclasses.fields(lm_cfg)}
        codec_over = {f.name: getattr(cfg.codec, f.name)
                      for f in dataclasses.fields(cfg.codec)}
        engine = FireRedTTS2Engine(pretrained_dir=serving, device=dev,
                                   llm_overrides=llm_over,
                                   codec_overrides=codec_over)
        trained = engine.lm_params
        random_params = init_lm_params(
            torch.Generator(device=dev).manual_seed(7), lm_cfg,
            dtype_of(lm_cfg.dtype), dev)

        # ---- 3. measurements -----------------------------------------
        results = {"phase": "summary", "config": config,
                   "steps_lm": steps_lm, "steps_codec": steps_codec}
        with torch.inference_mode():
            results["token_acc_trained"] = token_accuracy(engine, held_out)
            results["rounds"] = [
                measure_rounds(trained, lm_cfg, held_out,
                               "trained prev-frame t1", False, dev),
                measure_rounds(trained, lm_cfg, held_out,
                               "trained draft-init t1", True, dev),
                measure_rounds(trained, lm_cfg, held_out,
                               "trained draft-init t10", True, dev,
                               depth_topk=10),
                measure_rounds(random_params, lm_cfg, held_out,
                               "random prev-frame t1", False, dev),
            ]
            results["kernel_overlap_route"] = (
                "kernel B" if dev.type == "cuda" else "kernel B's plain version")
            results["kernel_overlap_trained"] = kernel_overlap(
                trained, lm_cfg, held_out, PLANS, dev)
            results["kernel_overlap_random"] = kernel_overlap(
                random_params, lm_cfg, held_out, PLANS, dev)

        # ---- 4. QA on the trained engine -----------------------------
        qa = QAPipeline(engine).run_all()
        results["qa_pass"] = sum(1 for r in qa if r.passed)
        results["qa_total"] = len(qa)
        results["qa_detail"] = [f"{r.name}: {'PASS' if r.passed else r.detail}"
                                for r in qa]
        # the harness's wiring only: no transcriber knows this task
        rep = FidelityHarness(
            engine, transcriber=lambda a: "trained loop probe"
        ).evaluate_utterance("trained loop probe")
        results["fidelity_ran"] = bool(rep.wer == 0.0)
        log(json.dumps(results))
        return results
    finally:
        if out is None:
            shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps-lm", type=int, default=2000)
    ap.add_argument("--steps-codec", type=int, default=150)
    ap.add_argument("--out", default=None,
                    help="work dir to keep (default: a temporary one)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.steps_lm, args.steps_codec, args.out, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
