"""PyTorch port, streaming block and engine: held against the JAX package
on the CPU at float32 (tiny config, parameters bridged from the JAX
engine's own initialisation), plus the port's loop == stream invariant.

Tolerances: waveforms to 1e-4 of their peak (fp32 summation order);
EOS flags and token ids exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireredtts2_tpu.config import tiny_engine_config as j_tiny
from fireredtts2_tpu.engine.engine import FireRedTTS2Engine as JEngine
from fireredtts2_tpu.models.codec.model import stream_decode_init as j_vinit
from fireredtts2_tpu.models.lm.model import init_lm_state as j_lminit
from fireredtts2_tpu.models.pipeline import stream_block as j_stream_block

from fireredtts2_tpu_torch.config import tiny_engine_config as t_tiny
from fireredtts2_tpu_torch.engine import FireRedTTS2Engine as TEngine
from fireredtts2_tpu_torch.models.codec.model import stream_decode_init as t_vinit
from fireredtts2_tpu_torch.models.lm.model import init_lm_state as t_lminit
from fireredtts2_tpu_torch.models.pipeline import stream_block as t_stream_block
from fireredtts2_tpu_torch.weights import from_jax

from _torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    jax_frame_noise, one_torch_thread, tiny_params, to_t, wave_close,
)


def test_stream_block_packed_matches_jax(rng):
    """A 4-frame block from fresh states, as global frames 9..12: the
    packed [middles | tails | EOS flags | frames] row, with JAX's draws for
    those frames injected as the noise."""
    jcfg, tcfg, jlm, jcodec, tlm, tcodec = tiny_params()
    ncb, V = tcfg.llm.audio_num_codebooks, tcfg.llm.audio_vocab_size
    B, K, t_base = 1, 4, 9
    jstate = j_lminit(jcfg.llm, B, jnp.float32)
    tstate = t_lminit(tcfg.llm, B)
    jv = j_vinit(jcfg.codec, B, jnp.float32)
    tv = t_vinit(tcfg.codec, B)
    frame = rng.integers(1, V, (B, ncb)).astype(np.int32)
    key = jax.random.PRNGKey(4)
    emitted = np.zeros((B,), np.int32)
    kw = dict(temperature=0.9, topk=20, depth_topk=10, depth_temperature=0.75)
    outs = j_stream_block(jlm, jcodec, jcfg.llm, jcfg.codec, jstate, jv,
                          jnp.asarray(frame), jnp.asarray(emitted), key,
                          jnp.int32(t_base), K, **kw)
    noise = torch.stack([jax_frame_noise(key, t_base + t, B, ncb, V)
                         for t in range(K)])
    touts = t_stream_block(tlm, tcodec, tcfg.llm, tcfg.codec, tstate, tv,
                           to_t(frame), to_t(emitted), noise, K, **kw)
    jp, tp = np.asarray(outs[4]), touts[4].numpy()
    assert tp.shape == jp.shape
    ac = tcfg.codec.acoustic_decoder
    cs = 8 * ac.hop_length
    ts = (ac.n_fft - ac.hop_length) - (ac.n_fft - ac.hop_length) // 2
    audio = K * (cs + ts)
    wave_close(tp[:, :audio], jp[:, :audio], "middles + tails")
    np.testing.assert_array_equal(tp[:, audio:], jp[:, audio:])  # flags, ids
    np.testing.assert_array_equal(touts[2].numpy(), np.asarray(outs[2]))
    np.testing.assert_array_equal(touts[3].numpy(), np.asarray(outs[3]))


def test_engine_generate_equals_generate_stream():
    """One utterance seed: the whole-utterance loop and the streaming
    blocks sample the same frames, so their audio is the same (sampled
    decoding, not greedy)."""
    eng = TEngine(t_tiny(), seed=0, device="cpu")
    a = eng.generate("Hello there.", "[S1]", max_audio_length_ms=1600,
                     utt_seed=123)
    s = np.concatenate(list(eng.generate_stream(
        "Hello there.", "[S1]", max_audio_length_ms=1600, utt_seed=123)))
    assert a.shape == s.shape == (20 * 1920,)
    assert np.isfinite(a).all()
    wave_close(s, a, "stream vs loop")
    batch = eng.generate_batch(["Hello there.", "Hi."], ["[S1]", "[S2]"],
                               max_audio_length_ms=800, utt_seed=7)
    assert [b.shape for b in batch] == [(10 * 1920,), (10 * 1920,)]


@pytest.fixture(scope="module")
def greedy_engines():
    """A JAX engine and a port engine with its weights bridged, both
    float32 with a top-1 depth chain (built once: the JAX engine compiles
    its programs per instance)."""
    jcfg = j_tiny(depth_topk=1)
    jcfg = dataclasses.replace(
        jcfg, llm=dataclasses.replace(jcfg.llm, dtype="float32"))
    tcfg = t_tiny(depth_topk=1)
    tcfg = dataclasses.replace(
        tcfg, llm=dataclasses.replace(tcfg.llm, dtype="float32"))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jeng = JEngine(config=jcfg, seed=3)
    teng = TEngine(tcfg, device="cpu", lm_params=from_jax(jeng.lm_params),
                   codec_params=from_jax(jeng.codec_params))
    return jeng, teng


def test_engine_greedy_generate_matches_jax_engine(greedy_engines):
    """Greedy (top-1 for codebook 0 and the depth chain) at float32: the
    port's generate, with the JAX engine's weights bridged, gives the JAX
    engine's audio."""
    jeng, teng = greedy_engines
    want = jeng.generate("Good morning.", "[S1]", [], max_audio_length_ms=960,
                         temperature=1.0, topk=1)
    got = teng.generate("Good morning.", "[S1]", max_audio_length_ms=960,
                        temperature=1.0, topk=1)
    assert got.shape == want.shape == (12 * 1920,)
    wave_close(got, want, "greedy audio")


def test_engine_greedy_generate_batch_matches_jax_engine(greedy_engines):
    """Two texts of different lengths decoded together (left-padded into
    one bucket, one batched vocoder pass): each greedy waveform equals the
    JAX engine's generate_batch output."""
    jeng, teng = greedy_engines
    texts, speakers = ["Good morning to you all.", "Hi."], ["[S1]", "[S2]"]
    want = jeng.generate_batch(texts, speakers, max_audio_length_ms=640,
                               temperature=1.0, topk=1)
    got = teng.generate_batch(texts, speakers, max_audio_length_ms=640,
                              temperature=1.0, topk=1)
    assert [g.shape for g in got] == [w.shape for w in want] == [(8 * 1920,)] * 2
    for i, (g, w) in enumerate(zip(got, want)):
        wave_close(g, w, f"batch stream {i}")
