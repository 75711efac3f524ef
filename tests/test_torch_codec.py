"""PyTorch port, codec decode: RVQ decode, UpConv and the streaming
vocoder held against the JAX package on the CPU at float32, with codec
parameters from the JAX initialiser bridged by weights.from_jax; and the
port's own streaming == batch invariant.

Tolerance: waveforms to 1e-4 of their peak (fp32 summation order through
12 conv/attention/iSTFT stages); slab contents and positions exactly
where no arithmetic differs, else 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireredtts2_tpu.models.codec import decoder as jdec
from fireredtts2_tpu.models.codec import model as jcm
from fireredtts2_tpu.models.codec import whisper_nn as jwn

from fireredtts2_tpu_torch.models.codec import decoder as tdec
from fireredtts2_tpu_torch.models.codec import model as tcm
from fireredtts2_tpu_torch.models.codec import whisper_nn as twn
from fireredtts2_tpu_torch.ops import flash_decode as tfd

from _torch_parity import one_torch_thread, tiny_params, to_t, wave_close  # noqa: F401


def _j_decode(jcodec, cfg, toks):
    """JAX's codec_decode_chunks as one program, traced afresh (the
    FRTTS2_FLASH_VOC route is read while tracing)."""
    return jax.jit(lambda t: jcm.codec_decode_chunks(jcodec, cfg, t))(
        jnp.asarray(toks))


def _tokens(cfg, B, L, rng):
    return rng.integers(0, cfg.codec.rvq.codebook_size,
                        (B, cfg.codec.rvq.num_quantizers, L)).astype(np.int32)


@pytest.mark.parametrize("voc_path", ["0", "interpret"])
def test_codec_decode_chunks_matches_jax(rng, monkeypatch, voc_path):
    """tokens -> (middles, tails) through RVQ decode, UpConv and
    stream_decode_scan (S = 64 queries per kernel-C call), against the JAX
    XLA slab path ("0") and the JAX Pallas kernel in interpret mode."""
    monkeypatch.setenv("FRTTS2_FLASH_VOC", voc_path)
    jcfg, tcfg, _, jcodec, _, tcodec = tiny_params()
    toks = _tokens(jcfg, 2, 16, rng)
    jm, jt = _j_decode(jcodec, jcfg.codec, toks)
    tm, tt = tcm.codec_decode_chunks(tcodec, tcfg.codec, to_t(toks))
    assert tm.shape == jm.shape and tt.shape == jt.shape
    wave_close(tm.numpy(), jm, "middles")
    wave_close(tt.numpy(), jt, "tails")
    assert tfd.flash_decode_update_bounded.launches == 0


def test_vocoder_slab_write_past_end_matches_jax_chip_route(rng, monkeypatch):
    """One vocoder slab layer (_whisper_layer_slab4) writing S=16 rows at
    pos T - 8 (half past the slab's end) and T (wholly past). JAX's chip
    route (the Pallas kernel, here in interpret mode) writes at
    min(pos, T - S); its plain route scatters and drops the rows past T.
    The port writes as the chip route does, on every device: output and
    slabs within 1e-5. The plain route's difference is pinned: stream 1's
    rows all dropped, stream 0's first 8 rows at their own slots."""
    jcfg, _, _, jcodec, _, tcodec = tiny_params()
    acfg = jcfg.codec.acoustic_decoder
    L, H, D, T = (acfg.num_layers, acfg.num_heads, acfg.embed_dim,
                  acfg.max_stream_latents)
    B, S, layer = 2, 16, 1
    pos = np.array([T - 8, T], np.int32)
    q_end = (pos[:, None] + 8 * (np.arange(S)[None] // 8 + 1)).astype(np.int32)
    live_hi = np.int32(pos.max() + S)
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    k4, v4 = (rng.standard_normal((L, B, T, D)).astype(np.float32)
              for _ in range(2))
    lp_j = {k: v[layer] for k, v in jcodec["acoustic_decoder"]["layers"].items()}
    lp_t = {k: v[layer] for k, v in tcodec["acoustic_decoder"]["layers"].items()}

    def jax_route(route):
        monkeypatch.setenv("FRTTS2_FLASH_VOC", route)
        f = jax.jit(lambda *a: jwn._whisper_layer_slab4(
            a[0], lp_j, jnp.int32(layer), H, *a[1:]))
        return [np.asarray(x) for x in f(h, k4, v4, pos, q_end, live_hi)]

    chip, plain = jax_route("interpret"), jax_route("0")
    tk, tv = to_t(k4), to_t(v4)
    th = twn._whisper_layer_slab4(to_t(h), lp_t, layer, H, tk, tv, to_t(pos),
                                  to_t(q_end), int(live_hi))
    for got, want, what in ((th, chip[0], "h"), (tk, chip[1], "k"),
                            (tv, chip[2], "v")):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=what)
    np.testing.assert_array_equal(plain[1][layer, 1], k4[layer, 1])
    np.testing.assert_allclose(plain[1][layer, 0, T - 8:],
                               chip[1][layer, 0, T - S:T - 8], rtol=1e-6,
                               atol=1e-6)
    assert np.abs(plain[0] - chip[0]).max() > 1e-3


def test_codec_decode_chunks_past_the_slab_matches_jax_chip_route(rng,
                                                                   monkeypatch):
    """The offline decode of T/8 + 8 tokens (its fifth 8-token pass starts
    at the 256-latent slab's end) against JAX's chip route in interpret
    mode: middles and tails within 1e-4 of the peak, the overflowing pass
    included. JAX's plain route agrees up to the last token that fits and
    differs from there on."""
    jcfg, tcfg, _, jcodec, _, tcodec = tiny_params()
    fit = jcfg.codec.acoustic_decoder.max_stream_latents // 8
    toks = _tokens(jcfg, 1, fit + 8, rng)
    tm, tt = tcm.codec_decode_chunks(tcodec, tcfg.codec, to_t(toks))
    monkeypatch.setenv("FRTTS2_FLASH_VOC", "interpret")
    jm, jt = _j_decode(jcodec, jcfg.codec, toks)
    wave_close(tm.numpy(), jm, "middles")
    wave_close(tt.numpy(), jt, "tails")
    monkeypatch.setenv("FRTTS2_FLASH_VOC", "0")
    pm, _ = _j_decode(jcodec, jcfg.codec, toks)
    pm, jm = np.asarray(pm), np.asarray(jm)
    wave_close(pm[:fit], jm[:fit], "plain route, tokens that fit")
    assert np.abs(pm[fit:] - jm[fit:]).max() > 1e-2 * np.abs(jm).max()


def test_stream_decode_block_batched_matches_jax(rng):
    """Two K-token blocks (K = 1 then 4) from a fresh state, slot 1 joining
    at the second block: middles, cut tails and the carried state."""
    jcfg, tcfg, _, jcodec, _, tcodec = tiny_params()
    acfg_j, acfg_t = jcfg.codec.acoustic_decoder, tcfg.codec.acoustic_decoder
    B, D = 2, acfg_j.embed_dim
    js = jdec.stream_state_init(acfg_j, B, jnp.float32)
    ts = tdec.stream_state_init(acfg_t, B)
    jblock = jax.jit(jdec.stream_decode_block_batched, static_argnums=(1,))
    for K, first in ((1, [True, False]), (4, [False, True])):
        x = rng.standard_normal((B, 4 * K, D)).astype(np.float32)
        f = np.array(first)
        jm, jt, js = jblock(jcodec["acoustic_decoder"], acfg_j, jnp.asarray(x),
                            js, jnp.asarray(f))
        tm, tt, ts = tdec.stream_decode_block_batched(
            tcodec["acoustic_decoder"], acfg_t, to_t(x), ts, to_t(f))
        wave_close(tm.numpy(), jm, f"middle K={K}")
        wave_close(tt.numpy(), jt, f"tails K={K}")
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    np.testing.assert_allclose(ts.kv_k.numpy(), np.asarray(js.kv_k), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ts.istft_cache.numpy(),
                               np.asarray(js.istft_cache), rtol=0, atol=1e-5)
    wave_close(tdec.stream_decode_tail(acfg_t, ts).numpy(),
                jdec.stream_decode_tail(acfg_j, js), "closing tail")


def test_streaming_equals_batch_in_port(rng):
    """Inside the port: blocks of 1, 4 and 3 tokens through
    stream_decode_block_batched, emitted as a stream would be, give the
    waveform of the bucketed batch decode (codec_decode_chunks +
    assemble_chunks) of the same 8 tokens."""
    _, tcfg, _, _, _, tcodec = tiny_params()
    cc, acfg = tcfg.codec, tcfg.codec.acoustic_decoder
    T = 8
    toks = _tokens(tcfg, 1, T, rng)
    padded = np.zeros((1, toks.shape[1], 32), np.int32)
    padded[:, :, :T] = toks
    m, t = tcm.codec_decode_chunks(tcodec, cc, to_t(padded))
    batch = tcm.assemble_chunks(m.numpy(), t.numpy(), T, acfg.hop_length,
                                acfg.n_fft)[0]

    from fireredtts2_tpu_torch.models.codec.rvq import rvq_decode
    feats = rvq_decode(tcodec["rvq"], cc.rvq, to_t(toks).permute(1, 0, 2))
    up = tdec.upconv_forward(tcodec["upsample"], cc.upsample_stride, feats)
    state = tdec.stream_state_init(acfg, 1)
    pieces, tail, i = [], None, 0
    for K in (1, 4, 3):
        middle, tails, state = tdec.stream_decode_block_batched(
            tcodec["acoustic_decoder"], acfg, up[:, 4 * i: 4 * (i + K)], state,
            torch.tensor([i == 0]))
        lead = (acfg.n_fft - acfg.hop_length) - (acfg.n_fft - acfg.hop_length) // 2
        pieces.append(middle[0, lead:] if i == 0 else middle[0])
        tail = tails[-1, 0]
        i += K
    stream = torch.cat(pieces + [tail]).numpy()
    assert stream.shape == batch.shape
    wave_close(stream, batch, "stream vs batch")
