"""PyTorch port, Whisper ASR: the model, the HF dir reader and the service
held against the JAX package on the CPU at float32 (TINY_ASR, parameters
from JAX's init_asr_params bridged by weights.from_jax).

- asr_decoder_forward, a prefill then S=1 steps over the same encoder
  context: logits within 1e-4 x (1 + |jax|);
- asr_greedy_decode: tokens and n_tokens equal, sum_logprob and
  no_speech_prob within 1e-5 relative (fp32 summation order);
- sampling at T > 0 with JAX's draws injected: jax.random.categorical is
  checked to be a Gumbel-max over jax.random.gumbel's draws of its key,
  and those draws (of fold_in(key, t)) are the port's noise; tokens equal;
- asr_detect_language: probabilities within 1e-5;
- int8: the leaves of quantize_asr_params_int8 bit-equal to JAX's as its
  service computes them (eagerly), the scales within 1 ulp; tokens equal;
- load_hf_whisper on a tiny HF dir written by the port's writer: the tree
  equal to JAX's load_hf_whisper of the same dir (which reads the
  safetensors file with the safetensors package);
- WhisperASR.transcribe: every TranscriptionResult field as JAX's service
  gives it, for one window, two windows with <|startofprev|>
  conditioning, the fallback ladder's T > 0 rungs and the no-speech gate;
- the speech-to-speech pipeline with the real transcriber.
Beam search, best-of-N, word timestamps and streaming:
tests/test_torch_asr_search.py.

One JAX service (``jref``) holds every jitted JAX program the file runs:
its decode program (asr_greedy_decode at max_new_tokens=6) and its
language program; only the ASRConfig knobs the host reads change between
cases.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireredtts2_tpu.asr import asr as j_asr
from fireredtts2_tpu.asr import convert as j_convert
from fireredtts2_tpu.asr import model as jm

from fireredtts2_tpu_torch.asr import asr as t_asr
from fireredtts2_tpu_torch.asr import convert as t_convert
from fireredtts2_tpu_torch.asr import model as tm
from fireredtts2_tpu_torch.serve.s2s import SpeechToSpeechPipeline
from fireredtts2_tpu_torch.weights import from_jax

from _torch_parity import one_torch_thread, to_t, voiced  # noqa: F401

CFG = jm.TINY_ASR
V = CFG.vocab_size
MAX_NEW = 6
# the knobs a service's compiled programs depend on (max_new_tokens and
# the conditioned prompt's length); every case keeps them
BASE = dict(max_new_tokens=MAX_NEW, prev_window=4)
SEED = 3
J_GUMBEL = jax.jit(lambda key, t: jax.random.gumbel(
    jax.random.fold_in(key, t), (1, V), jnp.float32))


@pytest.fixture(scope="module")
def jref():
    """JAX params, JAX's service on them, and the port's copy."""
    jparams = jm.init_asr_params(jax.random.PRNGKey(0), CFG)
    jsvc = j_asr.WhisperASR(config=j_asr.ASRConfig(**BASE), params=jparams,
                            model_cfg=CFG, warmup=False)
    return jparams, jsvc, from_jax(jparams)


def _port_service(tparams, **kw):
    svc = t_asr.WhisperASR(config=t_asr.ASRConfig(**BASE, **kw),
                           params=tparams, model_cfg=tm.TINY_ASR,
                           warmup=False, device="cpu")
    return svc


def _jax_noise(seed: int, attempt: int):
    """The draws JAX's service samples rung `attempt` with, step by step."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), attempt)
    return lambda t: to_t(J_GUMBEL(key, t))


def _mel(jsvc, n: int, seed: int):
    """A window's JAX mel (1, T, n_mels) and length, and the port's."""
    audio = voiced(n, seed)
    mel, mel_len = jsvc._mel(audio)
    return mel, mel_len, to_t(mel), to_t(mel_len).long()


def _close(got, want, rel=1e-5, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * max(float(np.abs(want).max()), 1e-3),
                               err_msg=what)


def _result_equal(t, j, what=""):
    assert (t.text, t.language, len(t.segments)) == \
        (j.text, j.language, len(j.segments)), what
    assert t.start_time == j.start_time and t.end_time == pytest.approx(j.end_time)
    assert t.confidence == pytest.approx(j.confidence, rel=1e-5, abs=1e-7)
    for ts, js in zip(t.segments, j.segments):
        for k in ("id", "start", "end", "text", "tokens", "temperature",
                  "compression_ratio"):
            assert ts[k] == js[k], (what, k)
        for k in ("avg_logprob", "no_speech_prob"):
            assert ts[k] == pytest.approx(js[k], rel=1e-5, abs=1e-7), (what, k)


def test_configs_match_jax():
    for j, t in ((jm.TINY_ASR, tm.TINY_ASR),
                 (jm.WhisperASRModelConfig(), tm.WhisperASRModelConfig())):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t_asr.LANGUAGES == j_asr.LANGUAGES
    assert dataclasses.asdict(t_asr.ASRConfig()) == \
        dataclasses.asdict(j_asr.ASRConfig())
    for s in ("", "the the the the " * 40, "A plain line of varied words."):
        assert t_asr._compression_ratio(s) == j_asr._compression_ratio(s)


J_FORWARD = jax.jit(lambda p, mel, mel_len, prompt, steps: _j_forward(
    p, mel, mel_len, prompt, steps))


def _j_forward(p, mel, mel_len, prompt, steps):
    enc, enc_len = jm.asr_encode(p, CFG, mel, mel_len)
    cross = jm.precompute_cross_kv(p, CFG, enc)
    state = jm.init_asr_decode_state(CFG, prompt.shape[0])
    out = []
    logits, state = jm.asr_decoder_forward(p, CFG, prompt, state, cross, enc_len)
    out.append(logits)
    for i in range(steps.shape[1]):
        logits, state = jm.asr_decoder_forward(p, CFG, steps[:, i:i + 1], state,
                                               cross, enc_len)
        out.append(logits)
    return enc, out


def test_decoder_prefill_and_steps_match_jax(jref, rng):
    """B=2 windows of different lengths (the cross mask), a 4-token
    prefill, then 3 single-token steps on the slab it wrote."""
    jparams, jsvc, tparams = jref
    mels = [_mel(jsvc, n, s) for n, s in ((6000, 1), (9000, 2))]
    jmel = jnp.concatenate([m[0] for m in mels])
    jlen = jnp.concatenate([m[1] for m in mels])
    prompt = np.array([[CFG.sot_id, 44, CFG.transcribe_id, CFG.no_timestamps_id],
                       [CFG.sot_id, 41, CFG.transcribe_id, CFG.no_timestamps_id]])
    steps = rng.integers(0, V, (2, 3))
    jenc, jlogits = J_FORWARD(jparams, jmel, jlen, jnp.asarray(prompt, jnp.int32),
                              jnp.asarray(steps, jnp.int32))
    cross, enc_len = tm.encoder_context(tparams, tm.TINY_ASR, to_t(jmel),
                                        to_t(jlen).long())
    state = tm.init_asr_decode_state(tm.TINY_ASR, 2)
    got = []
    for toks in [prompt] + [steps[:, i:i + 1] for i in range(3)]:
        logits, state = tm.asr_decoder_forward(tparams, tm.TINY_ASR,
                                               torch.from_numpy(toks), state,
                                               cross, enc_len)
        got.append(logits)
    assert state.pos == 7
    for i, (g, w) in enumerate(zip(got, jlogits)):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        assert np.all(np.abs(g.numpy() - w) <= 1e-4 * (1 + np.abs(w))), i


def test_categorical_is_gumbel_max_over_its_draws():
    """jax.random.categorical(key, x) == argmax(x + gumbel(key, x.shape))
    in the installed JAX, which the port's sampler relies on."""
    f = jax.jit(lambda key, x: (
        jax.random.categorical(key, x, axis=-1),
        jnp.argmax(x + jax.random.gumbel(key, x.shape, x.dtype), axis=-1)))
    x = jnp.asarray(np.random.default_rng(0).standard_normal((4, V)) * 3,
                    jnp.float32)
    for t in range(8):
        a, b = f(jax.random.fold_in(jax.random.PRNGKey(7), t), x)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("temp", [0.0, 0.6, 1.0])
def test_greedy_and_sampled_decode_match_jax(jref, temp):
    """asr_greedy_decode at T=0 and sampled at T>0 (JAX's fold_in(key, t)
    draws injected): the same GreedyResult."""
    jparams, jsvc, tparams = jref
    jmel, jlen, tmel, tlen = _mel(jsvc, 8000, 4)
    prompt = np.array([[CFG.sot_id, CFG.transcribe_id, CFG.no_timestamps_id]])
    key = jax.random.PRNGKey(11)
    want = jsvc._decode(jparams, jmel, jlen, jnp.asarray(prompt, jnp.int32),
                        jnp.float32(temp), key, 0)
    got = tm.asr_greedy_decode(
        tparams, tm.TINY_ASR, tmel, tlen, torch.from_numpy(prompt), MAX_NEW,
        temp, (lambda t: to_t(J_GUMBEL(key, t))) if temp else None)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.n_tokens.numpy(), np.asarray(want.n_tokens))
    _close(got.sum_logprob.numpy(), want.sum_logprob, what="sum_logprob")
    _close(got.no_speech_prob.numpy(), want.no_speech_prob, what="no_speech")


def test_detect_language_matches_jax(jref):
    jparams, jsvc, tparams = jref
    jmel, jlen, tmel, tlen = _mel(jsvc, 7000, 5)
    want = jsvc._lang(jparams, jmel, jlen)
    got = tm.asr_detect_language(tparams, tm.TINY_ASR, tmel, tlen)
    assert got.shape == (1, CFG.num_languages)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    audio = voiced(7000, 5)
    t = _port_service(tparams).detect_language(audio)
    j = jsvc.detect_language(audio)
    assert t["language"] == j["language"] and list(t["all_probabilities"]) == \
        list(j["all_probabilities"])
    assert t["confidence"] == pytest.approx(j["confidence"], abs=1e-5)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def test_int8_leaves_bit_equal_and_tokens_match_jax(jref):
    """quantize_asr_params_int8 as JAX's service runs it (eagerly): int8
    leaves bit-equal, scales within 1 ulp, every other leaf unchanged;
    then the int8 model's greedy tokens equal JAX's."""
    jparams, jsvc, tparams = jref
    jq = jm.quantize_asr_params_int8(jparams)
    tq = tm.quantize_asr_params_int8(tparams)
    want, got = dict(_leaves(jq)), dict(_leaves(tq))
    assert sorted(want) == sorted(got)
    n8 = 0
    for name, w in want.items():
        w, g = np.asarray(w), got[name].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name.endswith("_scale"):
            assert np.all(np.abs(g.view(np.int32) - w.view(np.int32)) <= 1), name
        else:
            n8 += w.dtype == np.int8
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert n8 == 6 + 8
    jmel, jlen, tmel, tlen = _mel(jsvc, 8000, 6)
    prompt = np.array([[CFG.sot_id, CFG.transcribe_id, CFG.no_timestamps_id]])
    res = jsvc._decode(jq, jmel, jlen, jnp.asarray(prompt, jnp.int32),
                       jnp.float32(0.0), jax.random.PRNGKey(0), 0)
    out = tm.asr_greedy_decode(tq, tm.TINY_ASR, tmel, tlen,
                               torch.from_numpy(prompt), MAX_NEW)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(res.tokens))
    svc = _port_service(tparams, fallback_temperatures=())
    svc8 = t_asr.WhisperASR(config=svc.config, params=tparams,
                            model_cfg=tm.TINY_ASR, warmup=False, device="cpu",
                            quantize_int8=True)
    for name, g in _leaves(svc8.params):
        assert torch.equal(g, dict(_leaves(tq))[name]), name


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_load_hf_whisper_matches_jax(jref, tmp_path, fmt):
    """A tiny HF whisper dir written by the port (config.json plus
    model.safetensors from its own writer, or pytorch_model.bin): both
    packages' load_hf_whisper give the same config and tree, and the tree
    is the one written."""
    _, _, tparams = jref
    d = str(tmp_path / "whisper")
    t_convert.write_hf_whisper_dir(d, tparams, tm.TINY_ASR)
    if fmt == "bin":
        sd = t_convert.hf_whisper_state_dict(tparams)
        os.remove(os.path.join(d, "model.safetensors"))
        torch.save(sd, os.path.join(d, "pytorch_model.bin"))
    jp, jcfg = j_convert.load_hf_whisper(d)
    tp, tcfg = t_convert.load_hf_whisper(d)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.embed_dim, tcfg.sot_id, tcfg.eot_id) == (32, CFG.sot_id, CFG.eot_id)
    want, got, orig = dict(_leaves(jp)), dict(_leaves(tp)), dict(_leaves(tparams))
    assert sorted(want) == sorted(got) == sorted(orig)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(w), name)
        assert torch.equal(got[name], orig[name]), name


CASES = {
    # greedy only, one window
    "one_window": (dict(fallback_temperatures=()), [9000]),
    # two windows, greedy: window 2's prompt carries window 1's last 4
    # tokens after <|startofprev|>
    "two_windows_conditioned": (dict(fallback_temperatures=()), [10240, 6000]),
    # an unmet logprob gate: every rung of the ladder runs, T > 0 included
    "fallback_ladder": (dict(logprob_threshold=1e9,
                             fallback_temperatures=(0.2, 0.7)), [9000]),
    # any p(no speech) is silence: one rung, then the gate empties it
    "no_speech_gate": (dict(no_speech_threshold=0.0, logprob_threshold=1e9),
                       [9000]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_transcribe_matches_jax_service(jref, monkeypatch, case):
    jparams, jsvc, tparams = jref
    kw, lengths = CASES[case]
    monkeypatch.setattr(jsvc, "config", j_asr.ASRConfig(**BASE, seed=SEED, **kw))
    tsvc = _port_service(tparams, seed=SEED, **kw)
    tsvc.noise_fn = lambda attempt: _jax_noise(SEED, attempt)
    sots = []
    prompt_ids = tsvc._prompt_ids
    tsvc._prompt_ids = lambda *a: sots.append(prompt_ids(*a)[1]) or prompt_ids(*a)
    audio = np.concatenate([voiced(n, 7 + i) for i, n in enumerate(lengths)])
    j0, t0 = jsvc.decode_calls, tsvc.decode_calls
    want, got = jsvc.transcribe(audio), tsvc.transcribe(audio)
    _result_equal(got, want, case)
    assert tsvc.decode_calls - t0 == jsvc.decode_calls - j0
    calls = tsvc.decode_calls - t0
    if case == "two_windows_conditioned":
        assert len(got.segments) == 2 and sots[-1] == 5
    elif case == "fallback_ladder":
        assert calls == 3 and got.segments[0]["temperature"] == 0.7
    elif case == "no_speech_gate":
        assert calls == 1 and got.text == "" and not got.segments
    else:
        assert calls == 1 and got.segments
    assert tsvc.get_performance_stats()["backend"] == "cpu"


class _Engine:
    """The engine surface the pipeline calls: text -> a short tone."""

    def __init__(self):
        self.texts = []

    def generate(self, text, speaker, context, max_audio_length_ms):
        self.texts.append(text)
        return np.sin(np.arange(2400, dtype=np.float32) / 9)


def test_s2s_pipeline_with_real_transcriber(jref, monkeypatch):
    """speech in -> the port's WhisperASR -> the responder -> the engine:
    the transcript is JAX's service's text of the same audio."""
    jparams, jsvc, tparams = jref
    audio = voiced(9000, 12)
    svc = _port_service(tparams, fallback_temperatures=())
    eng = _Engine()
    res = SpeechToSpeechPipeline(eng, transcriber=svc.as_transcriber()) \
        .process_audio_input(audio)
    monkeypatch.setattr(jsvc, "config",
                        j_asr.ASRConfig(**BASE, fallback_temperatures=()))
    assert res.transcript == jsvc.transcribe(audio).text != ""
    assert eng.texts == [res.response_text] and res.audio24k.size == 2400
    assert "asr_s" in res.timings


def test_no_card_no_fallback():
    """Without a CUDA device the service raises; it never runs on the CPU
    unless asked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_asr.WhisperASR(warmup=False)
