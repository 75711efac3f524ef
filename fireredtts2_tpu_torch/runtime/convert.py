"""The convert drill, and export from training checkpoints.

Counterpart of ``fireredtts2_tpu/runtime/convert.py``.

``python -m fireredtts2_tpu_torch --pretrained-dir DIR convert`` is the
one-step bring-up of a reference checkpoint dir (config_llm.json,
config_codec.json, llm_posttrain.pt and/or llm_pretrain.pt, codec.pt,
optionally a local HF whisper checkout for the SSL encoder):

1. every pickle is converted to the port's tree (``runtime.checkpoint``)
   and saved under ``DIR/torch/`` (``--out``), the trees the engine's
   ``pretrained_dir`` route loads;
2. a token-parity smoke on the card: the codec tokens of a fixed chirp and
   eight top-1 LM frames of a fixed prompt, compared with
   ``DIR/goldens.json`` (recorded on the first run). The file's keys and
   values are the JAX drill's, so goldens recorded by either package
   validate the other;
3. with ``--fidelity``, the fidelity harness (``serve/qa.py``: synthesize,
   transcribe, WER and CER) on an engine loaded from the dir.

The drill's engine runs the checkpoint's own config (bf16, no int8
backbone, no fused depth plan), as JAX's does: kernel A for the S=1
decode, the plain depth decode, kernel C in the vocoder.

``run_export`` closes train -> serve: the port's ``train.loop`` and
``train.codec_loop`` step directories become ``DIR/torch/`` trees written
by ``runtime.checkpoint.save_params``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from fireredtts2_tpu_torch.config import (
    codec_config_from_json, llm_config_from_json,
)
from fireredtts2_tpu_torch.runtime.checkpoint import (
    _to, converted_path, find_hf_whisper_dir, load_codec_checkpoint,
    load_lm_checkpoint, save_params,
)
from fireredtts2_tpu_torch.train.loop import load_tree
from fireredtts2_tpu_torch.weights import dtype_of, resolve_device

LM_CKPTS = ("llm_posttrain.pt", "llm_pretrain.pt")


def _chirp(seconds: float, sr: int) -> np.ndarray:
    """A fixed 200 -> 1200 Hz chirp, the golden codec input."""
    t = np.arange(int(seconds * sr)) / sr
    f = 200.0 + (1200.0 - 200.0) * t / max(t[-1], 1e-9)
    return (0.4 * np.sin(2 * np.pi * f * t)).astype(np.float32)


def _golden_codec_tokens(codec_params, codec_cfg) -> list[int]:
    """The codes of 1 s of the chirp, codebook-major, on the params'
    device."""
    from fireredtts2_tpu_torch.models.codec.model import codec_encode

    audio = _chirp(1.0, codec_cfg.input_sample_rate)
    codes, tlen = codec_encode(codec_params, codec_cfg, audio[None, :])
    return [int(x) for x in np.asarray(codes[0, :, : int(tlen[0])]).reshape(-1)]


def _golden_lm_frames(lm_params, llm_cfg) -> list[list[int]]:
    """Eight top-1 frames after a fixed 16-token text prompt, on the
    params' device."""
    from fireredtts2_tpu_torch.models.lm.model import (
        init_lm_state, lm_generate_loop,
    )

    S, C = 16, llm_cfg.num_columns
    tokens = np.zeros((1, S, C), np.int32)
    tokens[0, :, -1] = (np.arange(1, S + 1) * 7) % llm_cfg.text_vocab_size
    mask = np.zeros((1, S, C), bool)
    mask[0, :, -1] = True
    dev = lm_params["text_embeddings"].device
    state = init_lm_state(llm_cfg, 1, dtype_of(llm_cfg.dtype), dev)
    # top-1 at every codebook picks the argmax whatever the draws, so the
    # noise is any tensor of the right shape (JAX passes a fixed key)
    noise = torch.ones((1, llm_cfg.audio_num_codebooks,
                        llm_cfg.audio_vocab_size), device=dev)
    _, buf, n = lm_generate_loop(
        lm_params, llm_cfg, state, torch.from_numpy(tokens).to(dev),
        torch.from_numpy(mask).to(dev),
        torch.ones((1, S), dtype=torch.bool, device=dev), lambda t: noise,
        max_frames=8, frame_cap=8, temperature=1.0, topk=1, depth_topk=1)
    return buf[0, : int(n[0])].cpu().numpy().astype(int).tolist()


def run_convert(pretrained_dir: str, out_dir: Optional[str] = None,
                fidelity: bool = False,
                llm_overrides: Optional[dict] = None,
                codec_overrides: Optional[dict] = None,
                device=None) -> dict[str, Any]:
    """Convert and smoke-check one reference dir on `device` ("cuda"
    unless another is asked for). Returns a summary: the files converted,
    each golden's parity ("recorded" on the first run, then "ok" or
    "MISMATCH"), parity_ok, and with `fidelity` the harness's wer, cer and
    speaker_sim (None: the drill passes no prompt). A missing codec.pt or
    LM checkpoint raises FileNotFoundError."""
    device = resolve_device(device)
    out_dir = out_dir or os.path.join(pretrained_dir, "torch")
    llm_cfg = llm_config_from_json(
        os.path.join(pretrained_dir, "config_llm.json"),
        **(llm_overrides or {}))
    codec_cfg = codec_config_from_json(
        os.path.join(pretrained_dir, "config_codec.json"),
        **(codec_overrides or {}))
    summary: dict[str, Any] = {"pretrained_dir": pretrained_dir,
                               "out_dir": out_dir, "converted": [],
                               "parity": {}}

    # fp32 codec, whatever its config's dtype: the goldens' numerics
    codec_params = load_codec_checkpoint(
        os.path.join(pretrained_dir, "codec.pt"), codec_cfg, torch.float32,
        hf_whisper_dir=find_hf_whisper_dir(pretrained_dir))
    save_params(os.path.join(out_dir, "codec.pt"), codec_params)
    summary["converted"].append("codec.pt")

    lm_trees: dict[str, Any] = {}
    for name in LM_CKPTS:
        path = os.path.join(pretrained_dir, name)
        if not os.path.exists(path):
            continue
        lm_trees[name] = load_lm_checkpoint(path, llm_cfg,
                                            dtype_of(llm_cfg.dtype))
        save_params(os.path.join(out_dir, name), lm_trees[name])
        summary["converted"].append(name)
    if not lm_trees:
        raise FileNotFoundError(
            f"no LM checkpoint ({' / '.join(LM_CKPTS)}) in {pretrained_dir}")

    # ---- golden token-parity smoke on the card --------------------------
    lm_name = next(n for n in LM_CKPTS if n in lm_trees)
    goldens = {
        "codec_tokens": _golden_codec_tokens(_to(codec_params, device),
                                             codec_cfg),
        f"lm_frames[{lm_name}]": _golden_lm_frames(
            _to(lm_trees[lm_name], device), llm_cfg),
    }
    golden_path = os.path.join(pretrained_dir, "goldens.json")
    if os.path.exists(golden_path):
        with open(golden_path) as f:
            want = json.load(f)
        for key, got in goldens.items():
            if key not in want:
                summary["parity"][key] = "recorded"
            elif want[key] == got:
                summary["parity"][key] = "ok"
            else:
                summary["parity"][key] = "MISMATCH"
        want.update({k: v for k, v in goldens.items() if k not in want})
        with open(golden_path, "w") as f:
            json.dump(want, f)
    else:
        with open(golden_path, "w") as f:
            json.dump(goldens, f)
        summary["parity"] = {k: "recorded" for k in goldens}
    summary["parity_ok"] = all(v in ("ok", "recorded")
                               for v in summary["parity"].values())

    # ---- fidelity harness -----------------------------------------------
    if fidelity:
        from fireredtts2_tpu_torch.asr import ASRConfig, WhisperASR
        from fireredtts2_tpu_torch.engine import FireRedTTS2Engine
        from fireredtts2_tpu_torch.serve.qa import FidelityHarness

        del codec_params, lm_trees
        engine = FireRedTTS2Engine(
            pretrained_dir=pretrained_dir,
            gen_type="dialogue" if "llm_posttrain.pt" in summary["converted"]
            else "monologue",
            llm_overrides=llm_overrides, codec_overrides=codec_overrides,
            device=device)
        # the random-weight dev ASR (24 target positions): a budget that
        # fits it, and no <|startofprev|> context over several windows
        asr = WhisperASR(warmup=False, device=device)
        mt = asr.model_cfg.max_target_positions
        if asr.config.max_new_tokens + 8 > mt:
            asr = WhisperASR(config=ASRConfig(max_new_tokens=max(4, mt - 8),
                                              prev_window=0), device=device)
        harness = FidelityHarness(engine, asr.as_transcriber())
        rep = harness.evaluate_utterance(
            "The quick brown fox jumps over the lazy dog.")
        summary["fidelity"] = {
            "wer": rep.wer, "cer": rep.cer, "speaker_sim": rep.speaker_sim,
        }
    return summary


def main(args) -> int:
    """``convert``: run_convert on --pretrained-dir, its summary printed as
    JSON; exit 1 on a golden MISMATCH."""
    summary = run_convert(args.pretrained_dir, out_dir=args.out,
                          fidelity=args.fidelity, device=args.device)
    print(json.dumps(summary, indent=2, default=str))
    return 0 if summary["parity_ok"] else 1


def run_export(out_dir: str, config_dir: str, lm_ckpt: Optional[str] = None,
               codec_ckpt: Optional[str] = None,
               gen_type: str = "dialogue") -> dict:
    """Train checkpoints -> a complete serving dir.

    - config_llm.json and config_codec.json are copied from `config_dir`;
    - `lm_ckpt` (a ``step_XXXXXXXX`` dir of ``train.loop``): its fp32
      master params go to OUT/torch/llm_posttrain.pt (llm_pretrain.pt for
      gen_type "monologue"); the engine casts them to its dtype at load;
    - `codec_ckpt` (of ``train.codec_loop``): its trained and frozen trees
      merged, fp32, to OUT/torch/codec.pt;
    - a family not exported falls back to a copy of config_dir's own
      ``torch/<name>.pt``; with neither, FileNotFoundError.
    """
    out_dir = os.path.abspath(out_dir)
    os.makedirs(os.path.join(out_dir, "torch"), exist_ok=True)
    summary: dict[str, Any] = {"out_dir": out_dir, "exported": []}

    for name in ("config_llm.json", "config_codec.json"):
        src = os.path.join(config_dir, name)
        if not os.path.exists(src):
            raise FileNotFoundError(f"{src} (need both config jsons)")
        shutil.copyfile(src, os.path.join(out_dir, name))

    lm_name = "llm_pretrain" if gen_type == "monologue" else "llm_posttrain"
    if lm_ckpt:
        save_params(converted_path(out_dir, lm_name), load_tree(lm_ckpt, "params"))
        summary["exported"].append(lm_name)
        summary["lm_step"] = int(load_tree(lm_ckpt, "step"))
    if codec_ckpt:
        save_params(converted_path(out_dir, "codec"),
                    {**load_tree(codec_ckpt, "params"),
                     **load_tree(codec_ckpt, "frozen")})
        summary["exported"].append("codec")
        summary["codec_step"] = int(load_tree(codec_ckpt, "step"))

    for name in (lm_name, "codec"):
        dst = converted_path(out_dir, name)
        src = converted_path(config_dir, name)
        if not os.path.exists(dst):
            if not os.path.exists(src):
                raise FileNotFoundError(
                    f"no checkpoint given for '{name}' and no fallback "
                    f"tree at {src}")
            shutil.copyfile(src, dst)
            summary["exported"].append(f"{name} (copied from config_dir)")
    return summary


def export_main(args) -> int:
    summary = run_export(args.out, args.config_dir, lm_ckpt=args.lm_ckpt,
                         codec_ckpt=args.codec_ckpt, gen_type=args.gen_type)
    print(json.dumps(summary, indent=2, default=str))
    return 0
