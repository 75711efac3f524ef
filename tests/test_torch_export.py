"""PyTorch port, train -> export -> serve on the CPU (tiny config): a tiny
LM trained 2 steps and a codec trained 1 step by the port's loops, their
checkpoints exported into a serving dir by runtime/convert.py: run_export,
and the port's engine loaded from that dir through its DIR/torch/ route.

- The loaded engine's parameters equal the exported fp32 masters cast to
  its dtype, and its greedy frames equal those of an engine built from the
  same parameters and config.
- A family not exported is copied from the config dir's torch/ tree; with
  neither a checkpoint nor a tree, or without a config JSON, export raises.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from fireredtts2_tpu_torch.config import CodecConfig
from fireredtts2_tpu_torch.config import tiny_engine_config as t_tiny
from fireredtts2_tpu_torch.engine import FireRedTTS2Engine as TEngine
from fireredtts2_tpu_torch.runtime import checkpoint as tck
from fireredtts2_tpu_torch.runtime.convert import run_export
from fireredtts2_tpu_torch.train import codec_loop, loop
from fireredtts2_tpu_torch.train.step import tree_leaves, tree_map
from fireredtts2_tpu_torch.weights import init_random

from _torch_parity import one_torch_thread  # noqa: F401  (autouse)

TT = t_tiny()
LLM_OVER = {"max_seq_len": TT.llm.max_seq_len, "dtype": "float32"}
CODEC_OVER = {f.name: getattr(TT.codec, f.name)
              for f in dataclasses.fields(CodecConfig)}


def write_config_dir(d: str, with_trees: bool = True) -> dict:
    """A config dir: the tiny config's JSONs (its widths by flavor name;
    the rest comes as overrides) and, with_trees, random torch/ trees of
    both families (the LM's under both gen types' names). Returns the
    codec tree."""
    os.makedirs(d, exist_ok=True)
    llm = TT.llm
    with open(os.path.join(d, "config_llm.json"), "w") as f:
        json.dump({"llm_models": {
            "backbone_flavor": llm.backbone_flavor,
            "decoder_flavor": llm.decoder_flavor,
            "text_vocab_size": llm.text_vocab_size,
            "audio_vocab_size": llm.audio_vocab_size,
            "audio_num_codebooks": llm.audio_num_codebooks,
            "decoder_loss_weight": llm.decoder_loss_weight}}, f)
    with open(os.path.join(d, "config_codec.json"), "w") as f:
        json.dump({"codec": {}}, f)
    lm, codec = init_random(TT, seed=1, device="cpu")
    if with_trees:
        for name in ("llm_posttrain", "llm_pretrain"):
            tck.save_params(tck.converted_path(d, name), lm)
        tck.save_params(tck.converted_path(d, "codec"), codec)
    return codec


def greedy_frames(engine, text: str = "Trained weights.") -> np.ndarray:
    engine.config = dataclasses.replace(engine.config, depth_topk=1)
    prompt, mask = engine._build_prompt([], text, "[S1]")
    [frames] = engine._run_ar([(prompt, mask)], 10, 1.0, 1)
    return frames


def test_train_export_serve(tmp_path):
    cfg_dir = str(tmp_path / "cfg")
    write_config_dir(cfg_dir)
    ck = str(tmp_path / "lm_ckpt")
    logs: list[str] = []
    state = loop.train(TT.llm, loop.TrainConfig(
        batch_size=2, seq_len=16, peak_lr=1e-2, warmup_steps=1,
        checkpoint_dir=ck, log_every=1), num_steps=2, seed=3, log=logs.append,
        device="cpu")
    assert state.step == 2 and logs[-1].startswith("step 2: loss ")
    out = str(tmp_path / "served")
    summary = run_export(out, cfg_dir, lm_ckpt=loop.latest_checkpoint(ck))
    assert summary["lm_step"] == 2
    assert summary["exported"] == ["llm_posttrain",
                                   "codec (copied from config_dir)"]
    assert os.path.exists(os.path.join(out, "config_codec.json"))

    served = TEngine(pretrained_dir=out, device="cpu", llm_overrides=LLM_OVER,
                     codec_overrides=CODEC_OVER)
    masters = tree_map(torch.Tensor.detach, state.params)
    moved = tree_map(lambda a, b: not torch.equal(a, b), masters,
                     init_random(TT, seed=3, device="cpu")[0])
    assert any(tree_leaves(moved))              # the steps changed weights
    for name in ("text_embeddings", "audio_embeddings", "codebook0_head",
                 "projection", "audio_head"):
        assert torch.equal(served.lm_params[name], masters[name])
    assert torch.equal(served.lm_params["backbone"]["wq"],
                       masters["backbone"]["wq"])
    same = TEngine(served.config, device="cpu", lm_params=masters,
                   codec_params=tck.load_params(
                       tck.converted_path(cfg_dir, "codec")))
    got = greedy_frames(served)
    assert got.shape[0] > 0
    np.testing.assert_array_equal(got, greedy_frames(same))


def test_export_codec_checkpoint_and_fallbacks(tmp_path):
    cfg_dir = str(tmp_path / "cfg")
    write_config_dir(cfg_dir)
    ck = str(tmp_path / "codec_ckpt")
    state = codec_loop.train_codec(
        TT.codec, codec_loop.CodecTrainConfig(
            batch_size=1, window_samples=2560, warmup_steps=1,
            checkpoint_dir=ck, log_every=1),
        num_steps=1, log=lambda _: None, device="cpu")
    out = str(tmp_path / "mono")
    summary = run_export(out, cfg_dir,
                         codec_ckpt=codec_loop.latest_codec_checkpoint(ck),
                         gen_type="monologue")
    assert summary["codec_step"] == 1
    assert summary["exported"] == ["codec",
                                   "llm_pretrain (copied from config_dir)"]
    tree = tck.load_params(tck.converted_path(out, "codec"))
    assert {"ssl", "mel_filters", "semantic_decoder", "acoustic_decoder"} <= set(tree)
    assert torch.equal(tree["rvq"]["codebook"],
                       state.params["rvq"]["codebook"].detach())
    assert torch.equal(tree["ssl"]["conv1"]["w"], state.frozen["ssl"]["conv1"]["w"])
    eng = TEngine(pretrained_dir=out, gen_type="monologue", device="cpu",
                  llm_overrides=LLM_OVER, codec_overrides=CODEC_OVER)
    assert torch.equal(eng.codec_params["upsample"]["up_conv_w"],
                       tree["upsample"]["up_conv_w"])

    bare = str(tmp_path / "bare")
    write_config_dir(bare, with_trees=False)
    with pytest.raises(FileNotFoundError, match="no fallback tree"):
        run_export(str(tmp_path / "x"), bare,
                   codec_ckpt=codec_loop.latest_codec_checkpoint(ck))
    os.remove(os.path.join(bare, "config_codec.json"))
    with pytest.raises(FileNotFoundError, match="config jsons"):
        run_export(str(tmp_path / "y"), bare)
