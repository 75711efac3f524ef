"""PyTorch port, the one-token streaming vocoder (the reference's
``decode_one_token`` route): ``ops.stft.istft_chunk``,
``models.codec.decoder.stream_decode_chunk`` and
``models.codec.model.stream_decode_step`` held against the JAX package on
the CPU at float32 (codec parameters from the JAX initialiser, bridged by
weights.from_jax), and against the port's batch routes.

Tolerances: 1e-5 of the reference's peak for waveforms (fp32 summation
order through the conv, attention and iSTFT stages); istft_chunk's
windowed-frame cache to 1e-5 absolute.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fireredtts2_tpu.config import tiny_engine_config as j_tiny
from fireredtts2_tpu.models.codec import model as jcm
from fireredtts2_tpu.ops import stft as jstft

from fireredtts2_tpu_torch.models.codec import (
    codec_decode, stream_decode_init, stream_decode_step,
)
from fireredtts2_tpu_torch.config import tiny_engine_config as t_tiny
from fireredtts2_tpu_torch.ops import flash_decode as tfd
from fireredtts2_tpu_torch.ops import stft as tstft
from fireredtts2_tpu_torch.weights import from_jax

from _torch_parity import jax_init, one_torch_thread, to_t  # noqa: F401

TOL = 1e-5        # of the reference's peak


def close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    peak = float(np.abs(want).max())
    assert peak > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * peak,
                               err_msg=what)


@lru_cache(maxsize=None)
def tiny_codec():
    """(jax cfg, port cfg, jax codec params, port codec params): the codec
    of ``_torch_parity.tiny_params`` (its key), without the LM's init."""
    jcfg, tcfg = j_tiny(), t_tiny()
    _, key = jax.random.split(jax.random.PRNGKey(0))
    jcodec = jax_init(jcm.init_codec_params, key, jcfg.codec)
    return jcfg, tcfg, jcodec, from_jax(jcodec)


def _tokens(cfg, L, rng, B=1):
    return rng.integers(0, cfg.codec.rvq.codebook_size,
                        (B, cfg.codec.rvq.num_quantizers, L)).astype(np.int32)


def _port_chain(tcodec, tcfg, toks):
    """The port's stream_decode_step over every token, concatenated."""
    L = toks.shape[-1]
    state = stream_decode_init(tcfg.codec, toks.shape[0])
    pieces = []
    for t in range(L):
        audio, state = stream_decode_step(tcodec, tcfg.codec,
                                          to_t(toks[:, :, t:t + 1]), state,
                                          first=t == 0, last=t == L - 1)
        pieces.append(audio.numpy())
    return np.concatenate(pieces, axis=1), state


def _jax_chain(jcodec, jcfg, toks):
    """JAX's stream_decode_step over every token, each of its three
    first/last variants one program traced afresh (the FRTTS2_FLASH_VOC
    route is read while tracing)."""
    step = jax.jit(lambda tok, st, first, last: jcm.stream_decode_step(
        jcodec, jcfg.codec, tok, st, first, last), static_argnums=(2, 3))
    L = toks.shape[-1]
    state = jcm.stream_decode_init(jcfg.codec, toks.shape[0], jnp.float32)
    pieces = []
    for t in range(L):
        audio, state = step(jnp.asarray(toks[:, :, t:t + 1]), state, t == 0,
                            t == L - 1)
        pieces.append(np.asarray(audio))
    return np.concatenate(pieces, axis=1)


def test_istft_chunk_chain_matches_jax_and_batch(rng):
    """Chunks of 8, 8, 3 and 5 frames: each chunk's audio and cache
    against JAX's istft_chunk, and the chain against the port's batch
    istft of all 24 frames."""
    n_fft, hop, B = 64, 16, 2
    F = n_fft // 2 + 1
    re = rng.standard_normal((B, F, 24)).astype(np.float32)
    im = rng.standard_normal((B, F, 24)).astype(np.float32)
    jchunk = jax.jit(jstft.istft_chunk, static_argnums=(3, 4, 5))
    jcache = tcache = None
    pieces, start = [], 0
    for i, n in enumerate((8, 8, 3, 5)):
        last = i == 3
        sl = slice(start, start + n)
        start += n
        ja, jcache = jchunk(jnp.asarray(re[:, :, sl]), jnp.asarray(im[:, :, sl]),
                            jcache, n_fft, hop, last)
        ta, tcache = tstft.istft_chunk(to_t(re[:, :, sl]), to_t(im[:, :, sl]),
                                       tcache, n_fft, hop, last_chunk=last)
        close(ta.numpy(), ja, f"chunk {i}")
        np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache), rtol=0,
                                   atol=1e-5)
        pieces.append(ta.numpy())
    close(np.concatenate(pieces, axis=1),
          tstft.istft(to_t(re), to_t(im), n_fft, hop).numpy(), "batch istft")


def test_stream_decode_step_chain_matches_jax_and_codec_decode(rng):
    """12 tokens one at a time (B=2): the chain against JAX's
    stream_decode_step chain and against the port's batch codec_decode of
    the same tokens; the state's position advances by 8 latents a token
    (kernel C's plain version on the CPU)."""
    jcfg, tcfg, jcodec, tcodec = tiny_codec()
    toks = _tokens(jcfg, 12, rng, B=2)
    got, state = _port_chain(tcodec, tcfg, toks)
    close(got, _jax_chain(jcodec, jcfg, toks), "JAX chain")
    close(got, codec_decode(tcodec, tcfg.codec, to_t(toks)).numpy(),
          "codec_decode")
    assert state.pos.tolist() == [96, 96]
    assert tfd.flash_decode_update_bounded.launches == 0


@pytest.mark.parametrize("voc_path", ["interpret", "0"])
def test_stream_decode_step_past_the_slab_matches_jax_chip_route(
        rng, monkeypatch, voc_path):
    """A chain of T/8 + 4 tokens over the tiny codec's 256-latent slab: the
    port writes each token's rows at min(pos, T - 8), as JAX's chip route
    (the Pallas kernel, here in interpret mode) does, so the chain equals
    that route's to the last token; JAX's plain route ("0") drops the rows
    past the slab and agrees only up to the last token that fits."""
    jcfg, tcfg, jcodec, tcodec = tiny_codec()
    fit = jcfg.codec.acoustic_decoder.max_stream_latents // 8
    toks = _tokens(jcfg, fit + 4, rng)
    got, _ = _port_chain(tcodec, tcfg, toks)
    monkeypatch.setenv("FRTTS2_FLASH_VOC", voc_path)
    want = _jax_chain(jcodec, jcfg, toks)
    if voc_path == "interpret":
        close(got, want, "chip route")
    else:
        n = fit * 1920 - 360              # what the fitting tokens emit
        close(got[:, :n], want[:, :n], "plain route, tokens that fit")
        assert np.abs(got - want).max() > 100 * TOL * np.abs(want).max()
