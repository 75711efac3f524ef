"""PyTorch port, weight quantisation and kernels E and F, held against the
JAX package on the CPU at float32, tiny widths.

Tolerances: quantised values bit for bit; kernel E's plain version to
1e-5 of the output's peak (both round the weights and x to bf16 and sum in
fp32; only the summation order differs); kernel F's plain version to 1e-5
absolute (fp32 softmax); waveforms to 1e-4 of their peak.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireredtts2_tpu.config import TransformerConfig as JTC
from fireredtts2_tpu.config import tiny_engine_config as j_tiny
from fireredtts2_tpu.engine.engine import FireRedTTS2Engine as JEngine
from fireredtts2_tpu.models.codec import whisper_nn as jwn
from fireredtts2_tpu.models.codec.model import init_codec_params as j_init_codec
from fireredtts2_tpu.models.lm import transformer as jtr
from fireredtts2_tpu.models.lm.model import init_lm_params as j_init_lm
from fireredtts2_tpu.ops.pallas_attention import pallas_decode_attention as j_f
from fireredtts2_tpu.ops.pallas_int4 import int4_matmul as j_int4

from fireredtts2_tpu_torch.config import tiny_engine_config as t_tiny
from fireredtts2_tpu_torch.engine import FireRedTTS2Engine as TEngine
from fireredtts2_tpu_torch.models.codec import whisper_nn as twn
from fireredtts2_tpu_torch.models.lm import transformer as ttr
from fireredtts2_tpu_torch.ops import flash_decode as tfd
from fireredtts2_tpu_torch.ops import int4 as ti4
from fireredtts2_tpu_torch.ops.quant import quantized_matmul
from fireredtts2_tpu_torch.weights import from_jax, init_random

from _torch_parity import to_t, wave_close


@pytest.fixture(scope="module")
def stacks():
    """A JAX transformer stack and a whisper layer stack, float32."""
    tc = JTC(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             embed_dim=64, intermediate_dim=192, max_seq_len=64)
    return (jtr.init_transformer_params(jax.random.PRNGKey(1), tc, jnp.float32),
            jwn.init_whisper_layers(jax.random.PRNGKey(2), 2, 64, 256,
                                    jnp.float32))


@pytest.mark.parametrize("which", ["transformer_int8", "transformer_int4",
                                   "whisper_int8"])
def test_quantizers_match_jax_bit_for_bit(stacks, which):
    tree, wtree = stacks
    jfn, tfn, src = {
        "transformer_int8": (jtr.quantize_transformer_int8,
                             ttr.quantize_transformer_int8, tree),
        "transformer_int4": (jtr.quantize_transformer_int4,
                             ttr.quantize_transformer_int4, tree),
        "whisper_int8": (jwn.quantize_whisper_layers_int8,
                         twn.quantize_whisper_layers_int8, wtree),
    }[which]
    want, got = from_jax(jfn(src)), tfn(from_jax(src))
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        assert torch.equal(want[k], got[k]), k


@pytest.mark.parametrize("M", [1, 5])
def test_int4_matmul_plain_matches_jax_kernel(stacks, rng, M):
    """Kernel E's plain version vs the Pallas kernel (interpret mode) on a
    real quantised matrix (I = 192, O = 64, group 64), and the int4 matmul
    route with the output-major layout gives the same values."""
    tree, _ = stacks
    q = jtr.quantize_transformer_int4(tree)
    packed, scales = q["w_down"][0], q["w_down_scale4"][0]      # (96, 64)
    x = rng.standard_normal((M, 192)).astype(np.float32)
    want = np.asarray(j_int4(jnp.asarray(x), packed, scales, interpret=True))
    tp, ts = to_t(packed), to_t(scales)
    got = ti4.int4_matmul(to_t(x), tp, ts)
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * peak)
    lp = ti4.prepare_int4_layout({"w": tp, "w_scale4": ts})
    assert lp["w_t4"].shape == (64, 96) and lp["w_s4t"].shape == (64, 3)
    assert torch.equal(quantized_matmul(to_t(x), lp, "w"), got)
    assert ti4.int4_matmul.launches == 0                # CPU: plain version


def test_kernel_f_plain_matches_jax(rng):
    """pallas_decode_attention over unmerged slabs with left-padded
    windows: the port's plain version vs the Pallas kernel."""
    B, Hq, Hkv, D, T = 3, 4, 2, 16, 64
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    start = np.array([0, 5, 20], np.int32)
    end = np.array([30, 64, 41], np.int32)
    want = np.asarray(j_f(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(start), jnp.asarray(end), interpret=True))
    got = tfd.pallas_decode_attention(to_t(q), to_t(k), to_t(v), to_t(start),
                                      to_t(end))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert tfd.pallas_decode_attention.launches == 0


def _engines(codec=None, **llm):
    """A JAX engine and a port engine with the same raw parameters, float32,
    greedy depth chain, with the given codec and LLM config overrides."""
    def cfg(make):
        c = make(depth_topk=1)
        return dataclasses.replace(
            c, llm=dataclasses.replace(c.llm, dtype="float32", **llm),
            codec=dataclasses.replace(c.codec, **(codec or {})))
    jcfg, tcfg = cfg(j_tiny), cfg(t_tiny)
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    jeng = JEngine(config=jcfg, seed=4)
    teng = TEngine(tcfg, device="cpu",
                   lm_params=from_jax(j_init_lm(k1, jcfg.llm, jnp.float32)),
                   codec_params=from_jax(j_init_codec(k2, jcfg.codec,
                                                      jnp.float32)))
    return jeng, teng


def test_int4_depth_engine_matches_jax_engine(monkeypatch):
    """quantize_depth with 4 bits: the port's depth matmuls run kernel E's
    plain version; the JAX engine takes its int4 kernel too
    (FRTTS2_INT4_KERNEL=1), so both round as the kernel does."""
    monkeypatch.setenv("FRTTS2_INT4_KERNEL", "1")
    jeng, teng = _engines(quantize_depth=True, quantize_depth_bits=4)
    assert "w_gate_t4" in teng.lm_params["decoder"]
    want = jeng.generate("Int four.", "[S1]", [], max_audio_length_ms=320,
                         temperature=1.0, topk=1)
    got = teng.generate("Int four.", "[S1]", max_audio_length_ms=320,
                        temperature=1.0, topk=1)
    assert got.shape == want.shape == (4 * 1920,)
    wave_close(got, want, "int4 depth greedy audio")


def test_int8_vocoder_stream_equals_batch():
    """quantize_vocoder: the int8 vocoder's audio equals the JAX engine's
    with quantize_vocoder (greedy, same raw parameters), and the port's
    streaming chunks concatenate to its whole-utterance audio."""
    jeng, teng = _engines(codec={"quantize_vocoder": True})
    layers = teng.codec_params["acoustic_decoder"]["layers"]
    assert layers["wq"].dtype == torch.int8 and "fc2_w_scale" in layers
    want = jeng.generate("Vocoder in int8.", "[S1]", [], max_audio_length_ms=480,
                         temperature=1.0, topk=1)
    a = teng.generate("Vocoder in int8.", "[S1]", max_audio_length_ms=480,
                      temperature=1.0, topk=1, utt_seed=8)
    assert a.shape == want.shape == (6 * 1920,)
    wave_close(a, want, "int8 vocoder greedy audio")
    s = np.concatenate(list(teng.generate_stream(
        "Vocoder in int8.", "[S1]", max_audio_length_ms=480, temperature=1.0,
        topk=1, utt_seed=8)))
    wave_close(s, a, "int8 vocoder stream vs batch")


def test_entry_points_need_a_card_unless_cpu_is_asked_for(monkeypatch):
    """No silent CPU fallback: without a CUDA device the engine and the
    random initialiser raise unless device='cpu' is passed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(t_tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_random(t_tiny())
    lm, _ = init_random(t_tiny(), device="cpu")
    assert lm["projection"].device.type == "cpu"
