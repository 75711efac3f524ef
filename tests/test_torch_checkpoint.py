"""PyTorch port, checkpoints: the reference-pickle converters, the HF
whisper reader, serving from a pretrained dir and hot reload, held against
the JAX package on the CPU (tiny widths).

- LM: a state dict of tests/test_parity_loss.py's TorchDualModel (torchtune
  qwen2 naming), with q/k/v biases and without them.
- Codec: a random reference-layout state dict of a JAX tiny codec tree,
  written by the port's inverse of convert_codec_state_dict
  (tools/ref_checkpoint.py), the RVQ projections in both weight-norm forms.
The JAX and port converters must give equal trees: exactly in float32, and
bit for bit after the bfloat16 cast. Reload is held to what
tests/test_reload.py holds the JAX engine to.
"""

import ast
import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireredtts2_tpu.config import CodecConfig as JCodecConfig
from fireredtts2_tpu.config import tiny_engine_config as j_tiny
from fireredtts2_tpu.engine.engine import FireRedTTS2Engine as JEngine
from fireredtts2_tpu.models.codec.model import init_codec_params as j_init_codec
from fireredtts2_tpu.runtime import checkpoint as jck

from fireredtts2_tpu_torch.config import tiny_engine_config as t_tiny
from fireredtts2_tpu_torch.engine import FireRedTTS2Engine as TEngine
from fireredtts2_tpu_torch.runtime import checkpoint as tck
from fireredtts2_tpu_torch.runtime.batcher import ContinuousBatcher
from fireredtts2_tpu_torch.tools.ref_checkpoint import codec_state_dict
from fireredtts2_tpu_torch.weights import from_jax, init_random

from _torch_parity import one_torch_thread  # noqa: F401  (autouse)
from test_parity_loss import TorchDualModel

JT, TT = j_tiny(), t_tiny()


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _trees_equal(got, want):
    """Port tree (torch) == JAX tree (jax / numpy): the same keys, shapes
    and dtypes, every value bit for bit."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for k in w:
        wt = from_jax(w[k]) if not torch.is_tensor(w[k]) else w[k]
        assert g[k].dtype == wt.dtype and g[k].shape == wt.shape, k
        assert torch.equal(g[k], wt), k


# ---------------------------------------------------------------------------
# Reference-layout state dicts
# ---------------------------------------------------------------------------


def lm_state_dict(seed: int, biases: bool) -> dict:
    torch.manual_seed(seed)
    llm = TT.llm
    sd = TorchDualModel(llm, llm.backbone, llm.decoder).state_dict()
    if not biases:
        sd = {k: v for k, v in sd.items()
              if not k.endswith(("q_proj.bias", "k_proj.bias", "v_proj.bias"))}
    return sd


@pytest.fixture(scope="module")
def jax_codec_tree():
    return jax.jit(j_init_codec, static_argnums=(1, 2))(
        jax.random.PRNGKey(5), JT.codec, jnp.float32)


# ---------------------------------------------------------------------------
# Converters and loaders against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("biases", [True, False], ids=["qkv_bias", "no_bias"])
def test_lm_converter_matches_jax(biases):
    sd = lm_state_dict(0, biases)
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        got = tck.convert_lm_state_dict(sd, TT.llm, td)
        _trees_equal(got, jck.convert_lm_state_dict(sd, JT.llm, jd))
    if not biases:
        assert not got["backbone"]["bq"].any()


@pytest.mark.parametrize("form", ["weight", "wn"])
def test_codec_converter_matches_jax(jax_codec_tree, form):
    sd = codec_state_dict(from_jax(jax_codec_tree), form,
                          np.random.default_rng(1))
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        got = tck.convert_codec_state_dict(sd, TT.codec, td)
        _trees_equal(got, jck.convert_codec_state_dict(sd, JT.codec, jd))
        assert got["rvq"]["codebook"].dtype == torch.float32
    if form == "weight":     # the layout round trip gives the tree back
        _trees_equal(tck.convert_codec_state_dict(sd, TT.codec, torch.float32),
                     jax_codec_tree)


def test_load_pickles_and_hf_whisper_dir(tmp_path, jax_codec_tree):
    """load_lm_checkpoint / load_codec_checkpoint from torch.save pickles;
    a codec.pt without ssl.* takes the SSL encoder from an HF whisper dir,
    through model.safetensors (the port's own reader) and through
    pytorch_model.bin; with no dir, FileNotFoundError."""
    sd_lm = lm_state_dict(1, True)
    torch.save({"model": sd_lm}, tmp_path / "llm.pt")
    _trees_equal(tck.load_lm_checkpoint(str(tmp_path / "llm.pt"), TT.llm,
                                        torch.float32),
                 jck.load_lm_checkpoint(str(tmp_path / "llm.pt"), JT.llm,
                                        jnp.float32))
    sd = codec_state_dict(from_jax(jax_codec_tree), "wn",
                          np.random.default_rng(2))
    torch.save({"generator": sd}, tmp_path / "codec.pt")
    want = jck.load_codec_checkpoint(str(tmp_path / "codec.pt"), JT.codec)
    _trees_equal(tck.load_codec_checkpoint(str(tmp_path / "codec.pt"),
                                           TT.codec), want)

    no_ssl = {k: v for k, v in sd.items() if not k.startswith("ssl.")}
    hf = {"model.encoder." + k[4:]: v.clone() for k, v in sd.items()
          if k.startswith("ssl.")}
    hf["model.decoder.layer_norm.weight"] = torch.ones(4)   # not the encoder
    path = str(tmp_path / "codec_no_ssl.pt")
    torch.save({"generator": no_ssl}, path)
    with pytest.raises(FileNotFoundError):
        tck.load_codec_checkpoint(path, TT.codec)
    safetensors_torch = pytest.importorskip("safetensors.torch")
    for kind in ("safetensors", "bin"):
        d = tmp_path / f"whisper_{kind}"
        d.mkdir()
        (d / "config.json").write_text(json.dumps({"model_type": "whisper"}))
        if kind == "safetensors":
            safetensors_torch.save_file(hf, str(d / "model.safetensors"))
        else:
            torch.save(hf, d / "pytorch_model.bin")
        assert tck.find_hf_whisper_dir(str(tmp_path)) is not None
        _trees_equal(tck.load_codec_checkpoint(path, TT.codec,
                                               hf_whisper_dir=str(d)), want)
        os.remove(d / "config.json")
    st = tck.read_safetensors(str(tmp_path / "whisper_safetensors"
                                  / "model.safetensors"))
    assert sorted(st) == sorted(hf)
    assert all(torch.equal(st[k], hf[k]) for k in hf)
    imports = [n for node in ast.walk(ast.parse(open(tck.__file__).read()))
               if isinstance(node, (ast.Import, ast.ImportFrom))
               for n in ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""])]
    assert not any("safetensors" in n for n in imports)


def test_converted_trees_round_trip_with_dtype_policy(tmp_path, jax_codec_tree):
    """save_params / load_converted_*: float leaves cast to the dtype, the
    codec's RVQ subtree and mel filters left as saved."""
    codec = tck.convert_codec_state_dict(
        codec_state_dict(from_jax(jax_codec_tree), "weight",
                         np.random.default_rng(3)),
        TT.codec)
    path = tck.converted_path(str(tmp_path), "codec")
    tck.save_params(path, codec)
    got = tck.load_converted_codec(path, torch.bfloat16)
    assert got["ssl"]["pos"].dtype == torch.bfloat16
    assert torch.equal(got["rvq"]["codebook"], codec["rvq"]["codebook"])
    assert torch.equal(got["mel_filters"], codec["mel_filters"])
    lm = tck.convert_lm_state_dict(lm_state_dict(2, True), TT.llm,
                                   torch.float32)
    tck.save_params(tck.converted_path(str(tmp_path), "llm_posttrain"), lm)
    got = tck.load_converted_lm(
        tck.converted_path(str(tmp_path), "llm_posttrain"), torch.bfloat16)
    assert torch.equal(got["backbone"]["wq"], lm["backbone"]["wq"].bfloat16())


# ---------------------------------------------------------------------------
# Serving from a pretrained dir
# ---------------------------------------------------------------------------


def _write_configs(d: str) -> tuple[dict, dict]:
    llm = TT.llm
    with open(os.path.join(d, "config_llm.json"), "w") as f:
        json.dump({"llm_models": {
            "backbone_flavor": llm.backbone_flavor,
            "decoder_flavor": llm.decoder_flavor,
            "text_vocab_size": llm.text_vocab_size,
            "audio_vocab_size": llm.audio_vocab_size,
            "audio_num_codebooks": llm.audio_num_codebooks,
            "decoder_loss_weight": llm.decoder_loss_weight,
        }}, f)
    with open(os.path.join(d, "config_codec.json"), "w") as f:
        json.dump({"codec": {}}, f)
    return ({"max_seq_len": llm.max_seq_len, "dtype": "float32"},
            {f.name: getattr(JT.codec, f.name)
             for f in dataclasses.fields(JCodecConfig)})


def test_pretrained_dir_engine_matches_jax(tmp_path, jax_codec_tree):
    """Engines from one serving dir of reference pickles and JSON configs
    (plus overrides): the port's parameters equal the JAX engine's, its
    greedy frames equal the JAX engine's; a second dir holding only the
    port's converted trees (DIR/torch/) serves the same parameters."""
    d = str(tmp_path / "serving")
    os.makedirs(d)
    llm_over, codec_over = _write_configs(d)
    torch.save({"model": lm_state_dict(3, True)},
               os.path.join(d, "llm_posttrain.pt"))
    torch.save({"generator": codec_state_dict(from_jax(jax_codec_tree), "wn",
                                              np.random.default_rng(4))},
               os.path.join(d, "codec.pt"))
    jeng = JEngine(pretrained_dir=d, llm_overrides=llm_over,
                   codec_overrides=codec_over)
    teng = TEngine(pretrained_dir=d, device="cpu", llm_overrides=llm_over,
                   codec_overrides=codec_over)
    assert teng.config.prefill_buckets == jeng.config.prefill_buckets
    _trees_equal(teng.lm_params, jeng.lm_params)
    _trees_equal(teng.codec_params, jeng.codec_params)

    for e in (jeng, teng):
        e.config = dataclasses.replace(e.config, depth_topk=1)
    prompt, mask = teng._build_prompt([], "Serve from a dir.", "[S1]")
    want = jeng._run_ar(prompt, mask, 10, 1.0, 1)
    [got] = teng._run_ar([(prompt, mask)], 10, 1.0, 1)
    assert got.shape[0] > 0
    np.testing.assert_array_equal(got, want)

    d2 = str(tmp_path / "converted")
    os.makedirs(d2)
    _write_configs(d2)
    raw = tck.load_lm_checkpoint(os.path.join(d, "llm_posttrain.pt"), TT.llm,
                                 torch.float32)
    tck.save_params(tck.converted_path(d2, "llm_posttrain"), raw)
    tck.save_params(tck.converted_path(d2, "codec"), teng.codec_params)
    teng2 = TEngine(pretrained_dir=d2, device="cpu", llm_overrides=llm_over,
                    codec_overrides=codec_over)
    _trees_equal(teng2.lm_params, teng.lm_params)
    _trees_equal(teng2.codec_params, teng.codec_params)


# ---------------------------------------------------------------------------
# Hot reload
# ---------------------------------------------------------------------------


def _reload_dir(tmp_path, seed: int, config=TT) -> tuple[str, dict]:
    """A DIR/torch/ serving layout of random raw trees; returns (dir, the
    LM tree)."""
    lm, codec = init_random(config, seed, "cpu")
    d = str(tmp_path / f"reload_{seed}")
    tck.save_params(tck.converted_path(d, "llm_posttrain"), lm)
    tck.save_params(tck.converted_path(d, "codec"), codec)
    return d, lm


def test_engine_reload_swaps_weights_and_clears_caches(tmp_path):
    d, lm = _reload_dir(tmp_path, 42)
    engine = TEngine(TT, seed=0, device="cpu")
    assert not torch.equal(engine.lm_params["backbone"]["wq"],
                           lm["backbone"]["wq"])
    wav = (np.random.default_rng(0).standard_normal(4000) * 0.05
           ).astype(np.float32)
    engine.encode_prompt_tokens(wav)
    engine.encode_prompt_tokens(wav)
    assert engine.encode_calls == 1              # a cache hit
    engine.reload_checkpoint(d)
    assert torch.equal(engine.lm_params["backbone"]["wq"], lm["backbone"]["wq"])
    engine.encode_prompt_tokens(wav)
    assert engine.encode_calls == 2              # re-encoded, new weights
    assert not engine._voice_state_cache
    audio = engine.generate("Hello there.", "[S1]", max_audio_length_ms=240)
    assert audio.shape[0] > 0 and np.isfinite(audio).all()


def test_engine_reload_shape_mismatch_raises(tmp_path):
    other = dataclasses.replace(
        TT, llm=dataclasses.replace(TT.llm, audio_vocab_size=32))
    d, _ = _reload_dir(tmp_path, 1, other)
    engine = TEngine(TT, seed=0, device="cpu")
    old = engine.lm_params
    with pytest.raises(ValueError, match="audio_embeddings.*shape"):
        engine.reload_checkpoint(d)
    assert engine.lm_params is old


def test_batcher_reload_drains_then_swaps(tmp_path):
    """reload() while a stream is live: the stream finishes whole on the
    old weights, the swap lands after, and a request after it is served;
    a drain that cannot finish in time raises TimeoutError and keeps the
    old weights with admissions resumed."""
    d, lm = _reload_dir(tmp_path, 43)
    # a vocoder slab of 128 frames, so the busy stream outlasts a prepare
    long = dataclasses.replace(TT, codec=dataclasses.replace(
        TT.codec, acoustic_decoder=dataclasses.replace(
            TT.codec.acoustic_decoder, max_stream_latents=1024)))
    engine = TEngine(long, seed=0, device="cpu")
    old = engine.lm_params
    batcher = ContinuousBatcher(engine, max_streams=2)
    batcher.start()
    try:
        h = batcher.submit("A long stream to keep the slot busy.",
                           max_audio_length_ms=80 * 1000)
        assert h.chunks.get(timeout=120) is not None
        with pytest.raises(TimeoutError):
            batcher.reload(d, timeout_s=0.0)
        assert engine.lm_params is old
        assert not batcher._admit_paused.is_set()
        assert sum(len(c) for c in h) > 0

        h = batcher.submit("Another sentence keeps a slot busy.",
                           max_audio_length_ms=80 * 30)
        first = h.chunks.get(timeout=120)
        assert first is not None
        err: list = []
        t = threading.Thread(target=lambda: _reload(batcher, d, err))
        t.start()
        samples = len(first) + sum(len(c) for c in h)
        t.join(timeout=120)
        assert not err, err
        assert samples == h.samples and h.finished_s is not None
        assert h.tokens.shape[0] * 1920 == samples
        assert torch.equal(engine.lm_params["backbone"]["wq"],
                           lm["backbone"]["wq"])
        audio = np.concatenate(list(batcher.submit(
            "After the swap.", max_audio_length_ms=240)))
        assert audio.shape[0] > 0 and np.isfinite(audio).all()
    finally:
        batcher.stop()


def _reload(batcher, d, err):
    try:
        batcher.reload(d, timeout_s=120.0)
    except Exception as e:  # noqa: BLE001
        err.append(e)


def test_engine_warmup_prefills_every_bucket_and_leaves_no_state(monkeypatch):
    """warmup(): one prefill per prompt bucket, then one short stream (its
    own prefill and blocks); afterwards the engine serves exactly what a
    cold one does (seed chain and caches untouched)."""
    import fireredtts2_tpu_torch.engine.engine as engine_mod
    seen: list = []
    real = engine_mod.lm_generate_frame

    def spy(params, cfg, state, tokens, *a, **k):
        seen.append(tokens.shape[1])
        return real(params, cfg, state, tokens, *a, **k)
    monkeypatch.setattr(engine_mod, "lm_generate_frame", spy)
    warm = TEngine(TT, seed=0, device="cpu")
    cold = TEngine(TT, seed=0, device="cpu")
    assert warm.warmup() > 0
    buckets = list(TT.prefill_buckets)
    assert seen[:len(buckets)] == buckets and len(seen) == len(buckets) + 1
    assert warm.last_tokens.shape[0] > 1
    got = warm.generate("Hello there.", "[S1]", max_audio_length_ms=240)
    want = cold.generate("Hello there.", "[S1]", max_audio_length_ms=240)
    np.testing.assert_array_equal(got, want)


GREEDY = dataclasses.replace(TT, llm=dataclasses.replace(TT.llm, dtype="float32"),
                             depth_topk=1)


@pytest.mark.parametrize("case", ["cached_context", "dialogue"])
def test_batcher_reload_rebuilds_requests_of_old_weights(tmp_path, case):
    """What the old weights made is not carried onto the new ones: a
    request queued with a cached context's KV prefix while a reload swaps
    the weights, and a dialogue whose carried prefix spans a reload, are
    admitted anew on the new weights. Greedy, each equals a fresh engine
    on the new weights (the dialogue's second turn: turn 0's text and
    streamed audio as its context)."""
    from fireredtts2_tpu_torch.engine.engine import Segment
    from fireredtts2_tpu_torch.utils.audio_io import resample

    d, _ = _reload_dir(tmp_path, 44, GREEDY)
    engine = TEngine(GREEDY, seed=0, device="cpu")
    fresh = TEngine(GREEDY, seed=0, device="cpu")
    fresh.reload_checkpoint(d)
    wav = (np.random.default_rng(1).standard_normal(4000) * 0.05
           ).astype(np.float32)
    ctx = [Segment(speaker="[S1]", text="A fixed voice.", audio=wav)]
    batcher = ContinuousBatcher(engine, max_streams=2, topk=1)
    batcher.start()
    try:
        if case == "cached_context":
            for _ in range(2):           # cached on its second sighting
                batcher._context_prefix(ctx)
            assert len(batcher._prefix_cache) == 1
            with batcher.burst():        # queued until after the swap
                h = batcher.submit("hello after reload", "[S1]", context=ctx,
                                   topk=1, max_audio_length_ms=480)
                batcher.reload(d, timeout_s=60.0)
            got = np.concatenate(list(h))
            want = np.concatenate(list(fresh.generate_stream(
                "hello after reload", "[S1]", context=ctx, topk=1,
                max_audio_length_ms=480)))
            np.testing.assert_array_equal(h.tokens, fresh.last_tokens)
        else:
            turns: dict = {}
            err: list = []
            t = None
            for i, c in batcher.run_dialogue(
                    ["[S1]hello there friend", "[S2]hi right back"], topk=1,
                    max_utterance_ms=480):
                turns.setdefault(i, []).append(c)
                if t is None:            # turn 0 is live: reload now
                    t = threading.Thread(target=lambda: _reload(batcher, d, err))
                    t.start()
                    while not batcher._admit_paused.is_set() and t.is_alive():
                        pass
            t.join(timeout=120)
            assert not err, err
            a16 = resample(np.concatenate(turns[0]), engine.output_sample_rate,
                           engine.sample_rate)
            got = np.concatenate(turns[1])
            want = np.concatenate(list(fresh.generate_stream(
                "hi right back", "[S2]",
                context=[Segment(speaker="[S1]", text="hello there friend",
                                 audio=a16)],
                topk=1, max_audio_length_ms=480)))
        assert batcher._gen == 1
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))
    finally:
        batcher.stop()
