"""Command-line interface of the port.

Counterpart of ``fireredtts2_tpu/__main__.py``:

  python -m fireredtts2_tpu_torch generate  --text "[S1]Hi. [S2]Hello." --out out.wav
  python -m fireredtts2_tpu_torch monologue --text "..." --prompt-wav ref.wav \\
                                            --prompt-text "..." --out out.wav
  python -m fireredtts2_tpu_torch serve     --ws-port 8765 --http-port 8080
  python -m fireredtts2_tpu_torch serve     --asr --asr-dir whisper-large-v3
  python -m fireredtts2_tpu_torch qa        # run the QA scenario suite
  python -m fireredtts2_tpu_torch train     --model lm --steps 100 --ckpt-dir ckpts
  python -m fireredtts2_tpu_torch export    --out DIR --config-dir CFG \\
                                            --lm-ckpt ckpts/step_00000100
  python -m fireredtts2_tpu_torch --pretrained-dir DIR convert [--fidelity]

The engine and training run on the card (``--device cuda``, the default);
a CPU run asks for it with ``--device cpu``. Without --pretrained-dir a tiny
random-weight config is used (dev mode). The serving preset on the card is
``--quantize-backbone --fused-depth-plan gate=r8,up=s8,down=s8``;
``--speculative-depth`` runs the depth decoder's Jacobi rounds instead of
its 15 steps (without a fused plan).

The JAX CLI's flags and subcommands that have no port yet are accepted by
the parser and exit non-zero, naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import re
import sys

# flag or subcommand -> the ROADMAP item (queue 1) that ports it
NOT_PORTED = {
    "--tp": "item 13 (multi-GPU)",
    "--dp": "item 13 (multi-GPU)",
    "--zero1": "item 13 (multi-GPU)",
    "--profiler-port": "the tracing item (a live profiler endpoint)",
    "bench": "item 1 (bench harness)",
}


def _not_ported(what: str):
    sys.exit(f"fireredtts2_tpu_torch: {what} has no port yet: ROADMAP.md "
             f"queue 1, {NOT_PORTED[what]}")


def _check_ported(args) -> None:
    """Exit non-zero on any flag of the JAX CLI the port lacks."""
    if args.tp is not None:
        _not_ported("--tp")
    if args.dp is not None:
        _not_ported("--dp")
    if getattr(args, "profiler_port", None):
        _not_ported("--profiler-port")


def _build_engine(args):
    from fireredtts2_tpu_torch.config import tiny_engine_config
    from fireredtts2_tpu_torch.engine import FireRedTTS2Engine

    llm_overrides = {}
    if args.quantize_backbone:
        llm_overrides["quantize_backbone"] = True
    if args.fused_depth_plan:
        llm_overrides["fused_depth_plan"] = args.fused_depth_plan
    if args.speculative_depth:
        llm_overrides["speculative_depth"] = True
    if args.pretrained_dir:
        return FireRedTTS2Engine(pretrained_dir=args.pretrained_dir,
                                 gen_type=args.gen_type, device=args.device,
                                 llm_overrides=llm_overrides or None)
    print("[warn] no --pretrained-dir: using tiny random-weight dev config",
          file=sys.stderr)
    return FireRedTTS2Engine(config=tiny_engine_config(),
                             gen_type=args.gen_type, device=args.device,
                             llm_overrides=llm_overrides or None)


def _cmd_generate(args):
    from fireredtts2_tpu_torch.utils.audio_io import save_wav

    engine = _build_engine(args)
    max_utt = args.max_utterance_ms
    if max_utt is None:
        # the dev config's small prompt buckets: long utterances would
        # overflow the dialogue's context
        max_utt = 30_000 if args.pretrained_dir else 1_600
    # "[S1]... [S2]..." inline dialogue text -> utterances
    parts = re.split(r"(?=\[S\d\])", args.text)
    text_list = [p.strip() for p in parts if p.strip()]
    if not text_list[0].startswith("[S"):
        text_list = ["[S1]" + args.text]
    audio = engine.generate_dialogue(
        text_list,
        prompt_wav_list=args.prompt_wav or None,
        prompt_text_list=args.prompt_text or None,
        temperature=args.temperature, topk=args.topk,
        max_utterance_ms=max_utt)
    save_wav(args.out, audio, engine.output_sample_rate)
    print(f"wrote {args.out}: {len(audio)/engine.output_sample_rate:.2f}s")


def _cmd_monologue(args):
    from fireredtts2_tpu_torch.utils.audio_io import save_wav

    engine = _build_engine(args)
    audio = engine.generate_monologue(
        args.text, prompt_wav=args.prompt_wav_single,
        prompt_text=args.prompt_text_single,
        temperature=args.temperature, topk=args.topk)
    save_wav(args.out, audio, engine.output_sample_rate)
    print(f"wrote {args.out}: {len(audio)/engine.output_sample_rate:.2f}s")


def _build_asr(args):
    """serve --asr: Whisper from --asr-dir (an HF whisper checkpoint dir),
    else the tiny random-weight dev model; --asr-int8 makes its hot
    matmuls weight-only int8; --asr-max-new-tokens caps each window's
    decode. None without --asr."""
    if not args.asr:
        return None
    import numpy as np

    from fireredtts2_tpu_torch.asr import ASRConfig, WhisperASR

    config = ASRConfig()
    if args.asr_max_new_tokens is not None:
        config = ASRConfig(max_new_tokens=args.asr_max_new_tokens)

    if args.asr_dir:
        import time

        from fireredtts2_tpu_torch.asr import load_hf_whisper

        t0 = time.perf_counter()
        params, model_cfg = load_hf_whisper(args.asr_dir)
        asr = WhisperASR(config, params=params, model_cfg=model_cfg,
                         warmup=False, quantize_int8=args.asr_int8,
                         device=args.device)
        t1 = time.perf_counter()
        asr.transcribe(np.zeros(16_000, np.float32), 16_000)   # warm-up
        print(f"serve: ASR from {args.asr_dir}: loaded in {t1 - t0:.2f} s, "
              f"warmed up in {time.perf_counter() - t1:.2f} s", flush=True)
        return asr
    print("[warn] serve --asr without --asr-dir: tiny random-weight dev ASR "
          "(transcripts are noise)", file=sys.stderr)
    return WhisperASR(config, warmup=False, quantize_int8=args.asr_int8,
                      device=args.device)


def _cmd_serve(args):
    import os

    from fireredtts2_tpu_torch.serve.llm import build_responder_chain
    from fireredtts2_tpu_torch.serve.server import serve

    engine = _build_engine(args)
    responder = build_responder_chain(
        primary=args.llm_primary, hf_model_dir=args.llm_model_dir,
        openai_base_url=args.openai_base_url, openai_model=args.openai_model,
        openai_api_key=os.environ.get("OPENAI_API_KEY"))
    asr = _build_asr(args)
    serve(engine, ws_port=args.ws_port, http_port=args.http_port,
          session_dir=args.session_dir, max_streams=args.max_streams,
          voice_dir=args.voice_dir, responder=responder,
          require_auth=args.require_auth, host=args.host,
          reload_root=args.reload_root,
          transcriber=asr.as_transcriber() if asr else None)


def _cmd_qa(args):
    from fireredtts2_tpu_torch.serve.qa import QAPipeline, QAThresholds

    engine = _build_engine(args)
    thresholds = None
    if not args.pretrained_dir:
        # random-weight dev audio has no SNR/silence structure: keep the
        # structural gates, drop the perceptual ones
        thresholds = QAThresholds(min_snr_db=-100.0, max_silence_ratio=1.0,
                                  min_rms=0.0)
    results = QAPipeline(engine, thresholds).run_all()
    ok = all(r.passed for r in results)
    for r in results:
        mark = "PASS" if r.passed else "FAIL"
        print(f"[{mark}] {r.name} ({r.duration_s:.1f}s) {r.detail}")
    sys.exit(0 if ok else 1)


def _cmd_train(args):
    import os

    if args.zero1:
        _not_ported("--zero1")
    for flag, ways in (("--tp", args.train_tp), ("--dp", args.train_dp)):
        if ways is not None and ways > 1:
            _not_ported(flag)
    if args.model == "lm":
        from fireredtts2_tpu_torch.config import (
            llm_config_from_json, tiny_engine_config,
        )
        from fireredtts2_tpu_torch.train.loop import (
            TrainConfig, jsonl_batches, train,
        )

        cfg = (llm_config_from_json(
                   os.path.join(args.pretrained_dir, "config_llm.json"))
               if args.pretrained_dir else tiny_engine_config().llm)
        tcfg = TrainConfig(
            batch_size=args.batch_size, seq_len=args.seq_len,
            peak_lr=args.lr, checkpoint_dir=args.ckpt_dir,
            checkpoint_every=args.ckpt_every, log_every=args.log_every,
            mixed_precision=args.bf16, eval_every=args.eval_every,
            metrics_path=args.metrics_path, remat=args.remat,
            grad_accum=args.grad_accum)
        data = jsonl_batches(args.data, cfg, tcfg) if args.data else None
        train(cfg, tcfg, data=data, num_steps=args.steps, seed=args.seed,
              device=args.device)
    else:
        from fireredtts2_tpu_torch.config import (
            codec_config_from_json, tiny_engine_config,
        )
        from fireredtts2_tpu_torch.train.codec_loop import (
            CodecTrainConfig, train_codec, wav_dir_batches,
        )

        cfg = (codec_config_from_json(
                   os.path.join(args.pretrained_dir, "config_codec.json"))
               if args.pretrained_dir else tiny_engine_config().codec)
        tcfg = CodecTrainConfig(
            batch_size=args.batch_size, peak_lr=args.lr,
            window_samples=args.window_samples,
            checkpoint_dir=args.ckpt_dir, checkpoint_every=args.ckpt_every,
            log_every=args.log_every, eval_every=args.eval_every,
            metrics_path=args.metrics_path, remat=args.remat)
        data = wav_dir_batches(args.data, tcfg) if args.data else None
        train_codec(cfg, tcfg, data=data, num_steps=args.steps,
                    seed=args.seed, device=args.device)


def _cmd_export(args):
    from fireredtts2_tpu_torch.runtime.convert import export_main

    sys.exit(export_main(args))


def _cmd_convert(args):
    if not args.pretrained_dir:
        sys.exit("convert requires --pretrained-dir")
    from fireredtts2_tpu_torch.runtime.convert import main as convert_main

    sys.exit(convert_main(args))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fireredtts2_tpu_torch")
    p.add_argument("--pretrained-dir", default=None,
                   help="serving dir (config_llm.json, config_codec.json, "
                        "torch/ trees or the reference's .pt files)")
    p.add_argument("--gen-type", default="dialogue",
                   choices=["dialogue", "monologue"])
    p.add_argument("--device", default="cuda",
                   help="where the engine or training runs (default cuda; "
                        "cpu must be asked for)")
    p.add_argument("--quantize-backbone", action="store_true",
                   help="weight-only int8 backbone")
    p.add_argument("--fused-depth-plan", default=None, metavar="PLAN",
                   help="kernel B's weight plan, e.g. gate=r8,up=s8,down=s8")
    p.add_argument("--speculative-depth", action="store_true",
                   help="Jacobi speculative depth decode (the same tokens; "
                        "rounds of a 16-position forward in place of 15 "
                        "steps; off under a fused depth plan)")
    # the JAX CLI's flags without a port (NOT_PORTED): exit non-zero
    p.add_argument("--tp", type=int, default=None, help="not ported (item 13)")
    p.add_argument("--dp", type=int, default=None, help="not ported (item 13)")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="dialogue synthesis to a wav")
    g.add_argument("--text", required=True)
    g.add_argument("--prompt-wav", nargs="*", default=None)
    g.add_argument("--prompt-text", nargs="*", default=None)
    g.add_argument("--temperature", type=float, default=0.9)
    g.add_argument("--topk", type=int, default=20)
    g.add_argument("--out", default="out.wav")
    g.add_argument("--max-utterance-ms", type=float, default=None)
    g.set_defaults(fn=_cmd_generate)

    m = sub.add_parser("monologue", help="monologue synthesis (optional clone)")
    m.add_argument("--text", required=True)
    m.add_argument("--prompt-wav", dest="prompt_wav_single", default=None)
    m.add_argument("--prompt-text", dest="prompt_text_single", default=None)
    m.add_argument("--temperature", type=float, default=0.75)
    m.add_argument("--topk", type=int, default=20)
    m.add_argument("--out", default="out.wav")
    m.set_defaults(fn=_cmd_monologue)

    s = sub.add_parser("serve", help="websocket + http serving")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--ws-port", type=int, default=8765)
    s.add_argument("--http-port", type=int, default=8080)
    s.add_argument("--session-dir", default=None)
    s.add_argument("--max-streams", type=int, default=8,
                   help="concurrent batched streams (1 = one worker, serial)")
    s.add_argument("--voice-dir", default=None,
                   help="voice-profile store dir (enables /api/v1/voices)")
    s.add_argument("--require-auth", action="store_true",
                   help="demand Bearer tokens on WS TTS + the API routes "
                        "(secret via FRTTS2_TOKEN_SECRET)")
    s.add_argument("--reload-root", default=None,
                   help="enables /api/v1/admin/reload for serving dirs "
                        "under this dir (their DIR/torch/ trees); off "
                        "without it")
    s.add_argument("--llm-primary", default="rule_based",
                   choices=["rule_based", "local", "openai"],
                   help="primary conversation-LLM backend")
    s.add_argument("--llm-model-dir", default=None,
                   help="local HF causal-LM dir for the 'local' backend")
    s.add_argument("--openai-base-url", default=None,
                   help="OpenAI-compatible endpoint for the 'openai' backend"
                        " (API key via OPENAI_API_KEY)")
    s.add_argument("--openai-model", default="gpt-3.5-turbo")
    s.add_argument("--profiler-port", type=int, default=0,
                   help="not ported (a live profiler endpoint)")
    s.add_argument("--asr", action="store_true",
                   help="serve /v1/audio/transcriptions with Whisper")
    s.add_argument("--asr-dir", default=None,
                   help="HF whisper checkpoint dir (config.json and "
                        "model.safetensors or pytorch_model.bin; default: "
                        "a tiny random-weight dev model)")
    s.add_argument("--asr-int8", action="store_true",
                   help="weight-only int8 ASR matmuls")
    s.add_argument("--asr-max-new-tokens", type=int, default=None,
                   help="tokens each 30 s window may decode (default 224, "
                        "less what the model's positions cannot hold)")
    s.set_defaults(fn=_cmd_serve)

    q = sub.add_parser("qa", help="run QA scenarios against the engine")
    q.set_defaults(fn=_cmd_qa)

    t = sub.add_parser(
        "train", help="train the LM (jsonl token shards) or the codec (wav "
                      "dir) on one card, with checkpoint/resume")
    t.add_argument("--model", default="lm", choices=["lm", "codec"])
    t.add_argument("--data", default=None,
                   help="lm: jsonl token-shard path; codec: wav directory "
                        "(default: synthetic smoke batches)")
    t.add_argument("--steps", type=int, default=100)
    t.add_argument("--batch-size", type=int, default=8)
    t.add_argument("--lr", type=float, default=3e-4)
    t.add_argument("--ckpt-dir", default=None)
    t.add_argument("--ckpt-every", type=int, default=1000)
    t.add_argument("--log-every", type=int, default=50)
    t.add_argument("--eval-every", type=int, default=0)
    t.add_argument("--metrics-path", default=None,
                   help="append jsonl train/eval metrics here")
    t.add_argument("--dp", dest="train_dp", type=int, default=None,
                   help="above 1: not ported (item 13)")
    t.add_argument("--tp", dest="train_tp", type=int, default=1,
                   help="above 1: not ported (item 13)")
    t.add_argument("--seq-len", type=int, default=256,
                   help="lm only: training sequence length (frames)")
    t.add_argument("--window-samples", type=int, default=32_000,
                   help="codec only: 16 kHz window length (multiple of "
                        "1280 = one 12.5 Hz token)")
    t.add_argument("--bf16", action="store_true",
                   help="lm only: bf16 forward/backward, fp32 master params")
    t.add_argument("--zero1", action="store_true",
                   help="not ported (item 13)")
    t.add_argument("--remat", default="", choices=["", "full", "dots"],
                   help="per-layer rematerialization (activation memory "
                        "for recompute; values unchanged)")
    t.add_argument("--grad-accum", type=int, default=1,
                   help="lm only: micro-batches accumulated per optimizer "
                        "update (batch-size must divide evenly)")
    t.add_argument("--seed", type=int, default=0)
    t.set_defaults(fn=_cmd_train)

    x = sub.add_parser(
        "export", help="train checkpoint(s) -> a serving dir of DIR/torch/ "
                       "trees (closes train -> serve)")
    x.add_argument("--out", required=True, help="serving dir to write")
    x.add_argument("--config-dir", required=True,
                   help="dir holding config_llm.json/config_codec.json "
                        "(and fallback torch/ trees for unexported families)")
    x.add_argument("--lm-ckpt", default=None,
                   help="train.loop step dir (step_XXXXXXXX)")
    x.add_argument("--codec-ckpt", default=None,
                   help="train.codec_loop step dir")
    x.set_defaults(fn=_cmd_export)

    c = sub.add_parser(
        "convert",
        help="reference checkpoint dir -> DIR/torch/ trees + golden parity "
             "smoke on the card (the real-checkpoint bring-up drill)")
    c.add_argument("--out", default=None,
                   help="output dir of the converted trees (default "
                        "<pretrained-dir>/torch)")
    c.add_argument("--fidelity", action="store_true",
                   help="also run the WER/CER fidelity harness on an "
                        "engine loaded from the dir")
    c.set_defaults(fn=_cmd_convert)

    sub.add_parser("bench", help=f"not ported ({NOT_PORTED['bench']})",
                   add_help=False)
    return p


def main(argv=None):
    p = build_parser()
    args, unknown = p.parse_known_args(argv)
    if args.cmd in NOT_PORTED:         # whatever its own arguments
        _not_ported(args.cmd)
    if unknown:
        p.error(f"unrecognized arguments: {' '.join(unknown)}")
    _check_ported(args)
    args.fn(args)


if __name__ == "__main__":
    main()
