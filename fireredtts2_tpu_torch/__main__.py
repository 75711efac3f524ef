"""Command-line interface of the port.

Counterpart of ``fireredtts2_tpu/__main__.py``:

  python -m fireredtts2_tpu_torch generate  --text "[S1]Hi. [S2]Hello." --out out.wav
  python -m fireredtts2_tpu_torch monologue --text "..." --prompt-wav ref.wav \\
                                            --prompt-text "..." --out out.wav
  python -m fireredtts2_tpu_torch serve     --ws-port 8765 --http-port 8080
  python -m fireredtts2_tpu_torch qa        # run the QA scenario suite

The engine runs on the card (``--device cuda``, the default); a CPU run
asks for it with ``--device cpu``. Without --pretrained-dir a tiny
random-weight config is used (dev mode). The serving preset on the card is
``--quantize-backbone --fused-depth-plan gate=r8,up=s8,down=s8``.

The JAX CLI's flags and subcommands that have no port yet are accepted by
the parser and exit non-zero, naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import re
import sys

# flag or subcommand -> the ROADMAP item (queue 1) that ports it
NOT_PORTED = {
    "--speculative-depth": "item 9 (speculative depth)",
    "--tp": "item 13 (multi-GPU)",
    "--dp": "item 13 (multi-GPU)",
    "--profiler-port": "the tracing item (a live profiler endpoint)",
    "--asr": "item 11 (ASR)",
    "--asr-dir": "item 11 (ASR)",
    "--asr-int8": "item 11 (ASR)",
    "bench": "item 1 (bench harness)",
    "train": "item 12 (training)",
    "export": "item 12 (training)",
    "convert": "item 11 (ASR: the convert drill's fidelity report)",
}


def _not_ported(what: str):
    sys.exit(f"fireredtts2_tpu_torch: {what} has no port yet: ROADMAP.md "
             f"queue 1, {NOT_PORTED[what]}")


def _check_ported(args) -> None:
    """Exit non-zero on any flag of the JAX CLI the port lacks."""
    if args.speculative_depth:
        _not_ported("--speculative-depth")
    if args.tp is not None:
        _not_ported("--tp")
    if args.dp is not None:
        _not_ported("--dp")
    for flag in ("profiler_port", "asr", "asr_dir", "asr_int8"):
        if getattr(args, flag, None):
            _not_ported("--" + flag.replace("_", "-"))


def _build_engine(args):
    from fireredtts2_tpu_torch.config import tiny_engine_config
    from fireredtts2_tpu_torch.engine import FireRedTTS2Engine

    llm_overrides = {}
    if args.quantize_backbone:
        llm_overrides["quantize_backbone"] = True
    if args.fused_depth_plan:
        llm_overrides["fused_depth_plan"] = args.fused_depth_plan
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


def _cmd_serve(args):
    import os

    from fireredtts2_tpu_torch.serve.llm import build_responder_chain
    from fireredtts2_tpu_torch.serve.server import serve

    engine = _build_engine(args)
    responder = build_responder_chain(
        primary=args.llm_primary, hf_model_dir=args.llm_model_dir,
        openai_base_url=args.openai_base_url, openai_model=args.openai_model,
        openai_api_key=os.environ.get("OPENAI_API_KEY"))
    serve(engine, ws_port=args.ws_port, http_port=args.http_port,
          session_dir=args.session_dir, max_streams=args.max_streams,
          voice_dir=args.voice_dir, responder=responder,
          require_auth=args.require_auth, host=args.host,
          reload_root=args.reload_root)


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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fireredtts2_tpu_torch")
    p.add_argument("--pretrained-dir", default=None,
                   help="serving dir (config_llm.json, config_codec.json, "
                        "torch/ trees or the reference's .pt files)")
    p.add_argument("--gen-type", default="dialogue",
                   choices=["dialogue", "monologue"])
    p.add_argument("--device", default="cuda",
                   help="where the engine runs (default cuda; cpu must be "
                        "asked for)")
    p.add_argument("--quantize-backbone", action="store_true",
                   help="weight-only int8 backbone")
    p.add_argument("--fused-depth-plan", default=None, metavar="PLAN",
                   help="kernel B's weight plan, e.g. gate=r8,up=s8,down=s8")
    # the JAX CLI's flags without a port (NOT_PORTED): exit non-zero
    p.add_argument("--speculative-depth", action="store_true",
                   help="not ported (ROADMAP item 9)")
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
    s.add_argument("--asr", action="store_true", help="not ported (item 11)")
    s.add_argument("--asr-dir", default=None, help="not ported (item 11)")
    s.add_argument("--asr-int8", action="store_true",
                   help="not ported (item 11)")
    s.set_defaults(fn=_cmd_serve)

    q = sub.add_parser("qa", help="run QA scenarios against the engine")
    q.set_defaults(fn=_cmd_qa)

    for name in ("bench", "train", "export", "convert"):
        sub.add_parser(name, help=f"not ported ({NOT_PORTED[name]})",
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
