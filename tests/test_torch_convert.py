"""PyTorch port, the convert drill and the fidelity harness, held against
the JAX package on the CPU (tiny widths, float32).

The reference dir is written by the port's shared pickle writer
(fireredtts2_tpu_torch/tools/ref_checkpoint.py) from the JAX initialisers'
trees: config_llm.json and config_codec.json (the tiny config by flavor
name, the rest as overrides, float32 as the drill's CPU run asks), then
llm_posttrain.pt and codec.pt.

- goldens recorded by JAX's own _golden_codec_tokens and _golden_lm_frames
  on the same trees validate "ok" in the port's run_convert, and the
  goldens the port records (through the CLI) equal them;
- a tampered golden: "MISMATCH", parity_ok false, the CLI exits 1; no
  --pretrained-dir: JAX's message; no LM checkpoint: FileNotFoundError;
- --fidelity adds wer and cer, and speaker_sim None;
- FidelityHarness with a perfect and a wrong transcriber (JAX's
  tests/test_fidelity.py:41);
- the converted DIR/torch/ trees load in the port's engine;
- the shared writer's LM state dict has the keys and shapes of
  tests/test_parity_loss.py's TorchDualModel (the independent witness),
  and its pickles convert back to the trees they were written from.

The CLI reads the configs from the dir's JSONs alone, which cannot name
the tiny codec's SSL encoder; its cases patch the drill's two JSON readers
to add the overrides.
"""

import dataclasses
import functools
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from fireredtts2_tpu.config import codec_config_from_json as j_codec_json
from fireredtts2_tpu.config import llm_config_from_json as j_llm_json
from fireredtts2_tpu.runtime import convert as j_convert

import fireredtts2_tpu_torch.__main__ as cli
import fireredtts2_tpu_torch.config as t_config
from fireredtts2_tpu_torch.config import tiny_engine_config as t_tiny
from fireredtts2_tpu_torch.engine import FireRedTTS2Engine as TEngine
from fireredtts2_tpu_torch.runtime import checkpoint as tck
from fireredtts2_tpu_torch.runtime import convert as t_convert
from fireredtts2_tpu_torch.serve.qa import FidelityHarness
from fireredtts2_tpu_torch.tools.ref_checkpoint import (
    codec_state_dict, lm_state_dict, write_reference_pickles,
)

from _torch_parity import one_torch_thread, tiny_params  # noqa: F401
from test_parity_loss import TorchDualModel

TT = t_tiny()
LLM_OVER = {"max_seq_len": TT.llm.max_seq_len, "dtype": "float32"}
CODEC_OVER = {f.name: getattr(TT.codec, f.name)
              for f in dataclasses.fields(TT.codec)}
LM_KEY = "lm_frames[llm_posttrain.pt]"


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


def _write_configs(d):
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


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """(the reference dir, the port's LM and codec trees, JAX's goldens
    of the same trees)."""
    jcfg, _, jlm, jcodec, tlm, tcodec = tiny_params(0)
    d = str(tmp_path_factory.mktemp("reference"))
    _write_configs(d)
    write_reference_pickles(d, tlm, tcodec)
    jllm_cfg = j_llm_json(os.path.join(d, "config_llm.json"), **LLM_OVER)
    jcodec_cfg = j_codec_json(
        os.path.join(d, "config_codec.json"),
        **{f.name: getattr(jcfg.codec, f.name)
           for f in dataclasses.fields(jcfg.codec)})
    goldens = {"codec_tokens": j_convert._golden_codec_tokens(jcodec,
                                                              jcodec_cfg),
               LM_KEY: j_convert._golden_lm_frames(jlm, jllm_cfg)}
    assert goldens["codec_tokens"] and len(goldens[LM_KEY]) > 0
    return d, tlm, tcodec, goldens


def _copy(ref, tmp_path, goldens=None):
    d = str(tmp_path / "dir")
    shutil.copytree(ref[0], d)
    if goldens is not None:
        with open(os.path.join(d, "goldens.json"), "w") as f:
            json.dump(goldens, f)
    return d


def _convert(d, **kw):
    return t_convert.run_convert(d, llm_overrides=LLM_OVER,
                                 codec_overrides=CODEC_OVER, device="cpu",
                                 **kw)


def _cli(monkeypatch, capsys, d, *extra):
    """`python -m fireredtts2_tpu_torch --device cpu --pretrained-dir d
    convert ...` in process -> (exit code, the printed summary)."""
    for name, over in (("llm_config_from_json", LLM_OVER),
                       ("codec_config_from_json", CODEC_OVER)):
        monkeypatch.setattr(t_convert, name,
                            functools.partial(getattr(t_config, name), **over))
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", "--pretrained-dir", d, "convert",
                  *extra])
    return e.value.code, json.loads(capsys.readouterr().out)


def test_jax_goldens_validate_in_port(ref, tmp_path):
    d = _copy(ref, tmp_path, goldens=ref[3])
    summary = _convert(d)
    assert summary["parity"] == {"codec_tokens": "ok", LM_KEY: "ok"}
    assert summary["parity_ok"] is True
    assert summary["converted"] == ["codec.pt", "llm_posttrain.pt"]
    assert summary["out_dir"] == os.path.join(d, "torch")
    assert "fidelity" not in summary


def test_cli_convert_records_goldens_equal_to_jax(ref, tmp_path, monkeypatch,
                                                 capsys):
    d = _copy(ref, tmp_path)
    code, summary = _cli(monkeypatch, capsys, d)
    assert code == 0
    assert summary["parity"] == {"codec_tokens": "recorded",
                                 LM_KEY: "recorded"}
    with open(os.path.join(d, "goldens.json")) as f:
        assert json.load(f) == ref[3]
    # a second run validates what the first recorded
    code, summary = _cli(monkeypatch, capsys, d)
    assert code == 0 and summary["parity"] == {"codec_tokens": "ok",
                                               LM_KEY: "ok"}


def test_cli_convert_mismatch_exits_1(ref, tmp_path, monkeypatch, capsys):
    tampered = dict(ref[3])
    frames = [list(f) for f in tampered[LM_KEY]]
    frames[0][0] = (frames[0][0] + 1) % TT.llm.audio_vocab_size
    tampered[LM_KEY] = frames
    d = _copy(ref, tmp_path, goldens=tampered)
    code, summary = _cli(monkeypatch, capsys, d, "--out",
                         str(tmp_path / "trees"))
    assert code == 1
    assert summary["parity"] == {"codec_tokens": "ok", LM_KEY: "MISMATCH"}
    assert summary["parity_ok"] is False
    assert os.path.exists(tmp_path / "trees" / "llm_posttrain.pt")


def test_cli_convert_needs_pretrained_dir():
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", "convert"])
    assert e.value.code == "convert requires --pretrained-dir"
    assert "convert" not in cli.NOT_PORTED


def test_missing_lm_checkpoint_raises(ref, tmp_path):
    d = _copy(ref, tmp_path)
    os.remove(os.path.join(d, "llm_posttrain.pt"))
    with pytest.raises(FileNotFoundError, match="no LM checkpoint"):
        _convert(d)


def test_fidelity_report(ref, tmp_path):
    """--fidelity: the harness on an engine loaded from the dir's
    converted trees and the tiny random-weight ASR: wer and cer reported
    (random weights: not gated), no speaker similarity without a prompt."""
    d = _copy(ref, tmp_path, goldens=ref[3])
    fid = _convert(d, fidelity=True)["fidelity"]
    assert sorted(fid) == ["cer", "speaker_sim", "wer"]
    assert all(math.isfinite(fid[k]) and fid[k] >= 0 for k in ("wer", "cer"))
    assert fid["speaker_sim"] is None


def test_fidelity_harness_perfect_and_wrong_transcriber():
    engine = TEngine(config=t_tiny(), seed=0, device="cpu")
    text = "check the fidelity loop"
    prompt = np.sin(np.linspace(0, 440 * np.pi, 16_000)).astype(np.float32)
    rep = FidelityHarness(engine, transcriber=lambda a: text) \
        .evaluate_utterance(text, prompt_audio_16k=prompt)
    assert rep.wer == 0.0 and rep.cer == 0.0 and rep.transcript == text
    assert rep.speaker_sim is not None and -1.0 <= rep.speaker_sim <= 1.0
    rep2 = FidelityHarness(engine, transcriber=lambda a: "something else") \
        .evaluate_utterance(text, audio=np.zeros(24_000, np.float32))
    assert rep2.wer > 0.5 and rep2.speaker_sim is None


def test_converted_trees_load_in_port_engine(ref, tmp_path):
    d = _copy(ref, tmp_path, goldens=ref[3])
    _convert(d)
    _trees_equal(tck.load_converted_lm(tck.converted_path(d, "llm_posttrain"),
                                       torch.float32), ref[1])
    _trees_equal(tck.load_params(tck.converted_path(d, "codec")), ref[2])
    engine = TEngine(pretrained_dir=d, llm_overrides=LLM_OVER,
                     codec_overrides=CODEC_OVER, device="cpu")
    assert torch.equal(engine.lm_params["text_embeddings"],
                       ref[1]["text_embeddings"])
    audio = engine.generate("Converted.", "[S1]", max_audio_length_ms=320,
                            temperature=1.0, topk=1)
    assert audio.shape == (4 * 1920,) and np.isfinite(audio).all()


def test_shared_writer_matches_reference_model_and_round_trips(ref):
    _, tlm, tcodec, _ = ref
    torch.manual_seed(0)
    witness = TorchDualModel(TT.llm, TT.llm.backbone, TT.llm.decoder)
    want = {k: tuple(v.shape) for k, v in witness.state_dict().items()}
    sd = lm_state_dict(tlm)
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    _trees_equal(tck.convert_lm_state_dict(sd, TT.llm, torch.float32), tlm)
    _trees_equal(tck.convert_codec_state_dict(codec_state_dict(tcodec),
                                              TT.codec, torch.float32), tcodec)
