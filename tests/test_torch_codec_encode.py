"""PyTorch port, codec encode: the mel frontend, the SSL and acoustic
encoders, the adaptor, the downsample and the RVQ encode held against the
JAX package on the CPU (tiny config, codec parameters from the JAX
initialiser, jitted once per module, bridged by weights.from_jax).

Tolerances: the STFT power and log-mel to 1e-5 of the reference's peak;
encoder, adaptor and downsample outputs to 1e-4 of the reference's peak
(fp32 summation order); codes token for token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireredtts2_tpu.config import tiny_engine_config as j_tiny
from fireredtts2_tpu.models.codec import encoder as jenc
from fireredtts2_tpu.models.codec import model as jcm
from fireredtts2_tpu.models.codec import rvq as jrvq
from fireredtts2_tpu.models.codec import whisper_nn as jw
from fireredtts2_tpu.ops import audio as jaudio
from fireredtts2_tpu.ops import stft as jstft

from fireredtts2_tpu_torch.models.codec import encoder as tenc
from fireredtts2_tpu_torch.models.codec import model as tcm
from fireredtts2_tpu_torch.models.codec import rvq as trvq
from fireredtts2_tpu_torch.models.codec import whisper_nn as tw
from fireredtts2_tpu_torch.ops import audio as taudio
from fireredtts2_tpu_torch.ops import stft as tstft
from fireredtts2_tpu_torch.config import tiny_engine_config as t_tiny
from fireredtts2_tpu_torch.weights import from_jax

from _torch_parity import one_torch_thread, to_t, voiced  # noqa: F401

JCFG, TCFG = j_tiny().codec, t_tiny().codec
# JAX's references, each one program (an eager op compiles at each new
# shape and dtype)
J_STFT = jax.jit(jstft.stft_power, static_argnums=(1, 2))
J_LOGMEL = jax.jit(jaudio.log_mel_spectrogram, static_argnums=(2, 3))
J_ENCODER = jax.jit(jw.whisper_encoder_forward, static_argnums=(1,))
J_ADAPTOR = jax.jit(jenc.ssl_adaptor_forward, static_argnums=(1,))
J_DOWN = jax.jit(jenc.down_conv_forward, static_argnums=(1,))


def peak_close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    peak = float(np.abs(want).max())
    assert peak > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * peak, err_msg=what)


@pytest.fixture(scope="module")
def codec():
    """(JAX codec tree, its bridge into the port) at float32."""
    jc = jax.jit(lambda k: jcm.init_codec_params(k, JCFG, jnp.float32))(
        jax.random.PRNGKey(7))
    return jc, from_jax(jc)


@pytest.fixture(scope="module")
def windows():
    """Two 6 s windows of the tiny config's 16 kHz input, the second one
    partly zero-padded."""
    a = np.zeros((2, 96_000), np.float32)
    a[0] = voiced(96_000, 0)
    a[1, :70_000] = voiced(70_000, 1)
    return a


def test_stft_power_and_log_mel_match_jax(windows, codec):
    jcodec, tcodec = codec
    m = TCFG.mel
    jp = J_STFT(jnp.asarray(windows), m.n_fft, m.hop_length)
    tp = tstft.stft_power(to_t(windows), m.n_fft, m.hop_length)
    peak_close(tp.numpy(), jp, 1e-5, "stft power")
    np.testing.assert_allclose(taudio.whisper_mel_filters(m.num_mels),
                               jaudio.whisper_mel_filters(m.num_mels))
    jm = J_LOGMEL(jnp.asarray(windows), jcodec["mel_filters"], m.n_fft,
                  m.hop_length)
    tm = taudio.log_mel_spectrogram(to_t(windows), tcodec["mel_filters"],
                                    m.n_fft, m.hop_length)
    assert tm.shape == (2, m.num_mels, 600)
    peak_close(tm.numpy(), jm, 1e-5, "log-mel")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoders_adaptor_and_downsample_match_jax(rng, codec, dtype):
    """whisper_encoder_forward (SSL and acoustic), ssl_adaptor_forward and
    down_conv_forward on the same log-mels, with ragged lengths; with bf16
    weights the fp32 activations promote in both."""
    jcodec = codec[0]
    if dtype == "bfloat16":
        jcodec = jax.jit(lambda t: jax.tree_util.tree_map(
            lambda a: a.astype(jnp.bfloat16), t))(jcodec)
    tcodec = from_jax(jcodec)
    c = JCFG
    mel = rng.standard_normal((2, 64, c.mel.num_mels)).astype(np.float32)
    mlen = np.array([64, 40], np.int32)
    for name, ecfg in (("ssl", c.ssl), ("acoustic_encoder", c.acoustic_encoder)):
        jh, jl = J_ENCODER(jcodec[name], ecfg.num_heads, jnp.asarray(mel),
                           jnp.asarray(mlen))
        th, tl = tw.whisper_encoder_forward(tcodec[name], ecfg.num_heads,
                                            to_t(mel), to_t(mlen))
        assert th.dtype == torch.float32
        peak_close(th.numpy(), jh, 1e-4, name)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    x = rng.standard_normal((2, 32, c.ssl_adaptor.in_dim)).astype(np.float32)
    xlen = np.array([32, 20], np.int32)
    ja, _ = J_ADAPTOR(jcodec["ssl_adaptor"], c.ssl_adaptor, jnp.asarray(x),
                      jnp.asarray(xlen))
    ta, _ = tenc.ssl_adaptor_forward(tcodec["ssl_adaptor"], TCFG.ssl_adaptor,
                                     to_t(x), to_t(xlen))
    peak_close(ta.numpy(), ja, 1e-4, "ssl adaptor")
    f = rng.standard_normal((2, 32, c.downsample_embed_dim)).astype(np.float32)
    jd_, jdl = J_DOWN(jcodec["downsample"], c.downsample_factor,
                      jnp.asarray(f), jnp.asarray(xlen))
    td_, tdl = tenc.down_conv_forward(tcodec["downsample"], c.downsample_factor,
                                      to_t(f), to_t(xlen))
    peak_close(td_.numpy(), jd_, 1e-4, "downsample")
    np.testing.assert_array_equal(tdl.numpy(), np.asarray(jdl))


def test_rvq_encode_matches_jax_and_round_trips(rng, codec):
    """Codes token for token; code_gaps is the best-vs-second distance gap
    (positive where the codes are unique; the first quantizer's recomputed
    here); code_mismatches counts nothing between equal encodes and flags
    a changed code whose gap is not a near-tie."""
    jcodec, tcodec = codec
    z = rng.standard_normal((2, 10, JCFG.rvq.input_dim)).astype(np.float32)
    jc = np.asarray(jrvq.rvq_encode(jcodec["rvq"], JCFG.rvq, jnp.asarray(z)))
    tc = trvq.rvq_encode(tcodec["rvq"], TCFG.rvq, to_t(z))
    gaps = trvq.code_gaps(tcodec["rvq"], TCFG.rvq, to_t(z), tc)
    assert tc.dtype == torch.int32 and tc.shape == jc.shape == (4, 2, 10)
    np.testing.assert_array_equal(tc.numpy(), jc)
    assert gaps.shape == tc.shape and (gaps.numpy() >= 0).all()
    p = {k: v.numpy().astype(np.float64) for k, v in tcodec["rvq"].items()}
    z0 = z.astype(np.float64)
    if "input_proj_w" in p:
        z0 = z0 @ p["input_proj_w"] + p["input_proj_b"]
    z_e = z0 @ p["in_proj_w"][0] + p["in_proj_b"][0]
    dist = ((z_e[:, :, None, :] - p["codebook"][0][None, None]) ** 2).sum(-1)
    two = np.sort(dist, axis=-1)[..., :2]
    scale = (z_e ** 2).sum(-1) + (p["codebook"][0] ** 2).sum(-1)[jc[0]]
    np.testing.assert_allclose(gaps[0].numpy(), (two[..., 1] - two[..., 0])
                               / scale, rtol=1e-3, atol=1e-6)
    assert trvq.code_mismatches(jc, tc.numpy(), gaps.numpy()) == (0, 0)
    moved = jc.copy()
    moved[1, 0, 3] = (moved[1, 0, 3] + 1) % 64
    moved[2, 0, 3] = (moved[2, 0, 3] + 1) % 64
    gap = float(gaps[1, 0, 3])
    assert trvq.code_mismatches(jc, moved, gaps.numpy(), rel=gap / 2) == (1, 1)
    assert trvq.code_mismatches(jc, moved, gaps.numpy(), rel=gap * 2) == (1, 0)


def test_fp32_exact_scopes_overlap_across_threads():
    """The TF32 flags are process-wide: while scopes of two threads overlap
    (A enters, B enters, A leaves, B leaves) they stay off, and the last
    scope out restores the caller's flags, whatever the order of exits."""
    import threading

    from fireredtts2_tpu_torch.ops.precision import fp32_exact

    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, mm.allow_tf32)
    seen = []

    def flags():
        return (cudnn.allow_tf32, mm.allow_tf32)

    try:
        for caller in ((True, True), (True, False), (False, True)):
            for a_leaves_first in (True, False):
                cudnn.allow_tf32, mm.allow_tf32 = caller
                a_in, b_in = threading.Event(), threading.Event()
                a_out, b_out = threading.Event(), threading.Event()

                def a():
                    with fp32_exact():
                        a_in.set()
                        b_in.wait()
                        seen.append(flags())
                        if not a_leaves_first:
                            b_out.wait()
                            seen.append(flags())
                    a_out.set()

                def b():
                    a_in.wait()
                    with fp32_exact():
                        b_in.set()
                        if a_leaves_first:
                            a_out.wait()
                        seen.append(flags())
                    b_out.set()

                threads = [threading.Thread(target=f) for f in (a, b)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(10)
                assert not any(t.is_alive() for t in threads)
                assert flags() == caller, (caller, a_leaves_first)
        assert seen and all(f == (False, False) for f in seen)
        with fp32_exact():
            with fp32_exact():
                assert flags() == (False, False)
            assert flags() == (False, False)
        assert flags() == caller
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = saved


def test_codec_encode_multiwindow_matches_jax(codec):
    """Two prompts of 7.4 s and 3.2 s (three 6 s windows) in sub-batches of
    at most 2 (padded to powers of two): codes and token lengths token for
    token, and encode_window on the first window equals the first 75
    tokens."""
    jcodec, tcodec = codec
    jc = dataclasses.replace(JCFG, encode_max_batch=2)
    tc = dataclasses.replace(TCFG, encode_max_batch=2)
    audio = np.zeros((2, 118_400), np.float32)
    audio[0] = voiced(118_400, 2)
    audio[1, :51_200] = voiced(51_200, 3)
    lengths = np.array([118_400, 51_200])
    jcodes, jlen = jcm.codec_encode(
        jcodec, jc, audio, lengths,
        encode_fn=jax.jit(lambda a, n: jcm.encode_window(jcodec, jc, a, n)))
    tcodes, tlen = tcm.codec_encode(tcodec, tc, audio, lengths)
    np.testing.assert_array_equal(tlen, jlen)
    assert list(tlen) == [93, 40]
    np.testing.assert_array_equal(tcodes, jcodes)
    w = tcm.encode_window(tcodec, tc, to_t(audio[:1, :96_000]),
                          torch.tensor([96_000], dtype=torch.int32))
    np.testing.assert_array_equal(w[:, 0].numpy(), tcodes[0, :, :75])
