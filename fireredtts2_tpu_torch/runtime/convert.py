"""Export: training checkpoints -> a serving dir the engine loads.

Counterpart of ``fireredtts2_tpu/runtime/convert.py: run_export`` /
``export_main`` (the convert drill, ``run_convert``, waits on the ASR
port). It closes train -> serve: the port's ``train.loop`` and
``train.codec_loop`` step directories become ``DIR/torch/`` trees written
by ``runtime.checkpoint.save_params``, which the engine's ``pretrained_dir``
route loads.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

from fireredtts2_tpu_torch.runtime.checkpoint import converted_path, save_params
from fireredtts2_tpu_torch.train.loop import load_tree


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
