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

from fireredtts2_tpu_torch.models.codec import decoder as tdec
from fireredtts2_tpu_torch.models.codec import model as tcm
from fireredtts2_tpu_torch.ops import flash_decode as tfd

from _torch_parity import one_torch_thread, tiny_params, to_t, wave_close  # noqa: F401


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
    jm, jt = jcm.codec_decode_chunks(jcodec, jcfg.codec, jnp.asarray(toks))
    tm, tt = tcm.codec_decode_chunks(tcodec, tcfg.codec, to_t(toks))
    assert tm.shape == jm.shape and tt.shape == jt.shape
    wave_close(tm.numpy(), jm, "middles")
    wave_close(tt.numpy(), jt, "tails")
    assert tfd.flash_decode_update_bounded.launches == 0


def test_stream_decode_block_batched_matches_jax(rng):
    """Two K-token blocks (K = 1 then 4) from a fresh state, slot 1 joining
    at the second block: middles, cut tails and the carried state."""
    jcfg, tcfg, _, jcodec, _, tcodec = tiny_params()
    acfg_j, acfg_t = jcfg.codec.acoustic_decoder, tcfg.codec.acoustic_decoder
    B, D = 2, acfg_j.embed_dim
    js = jdec.stream_state_init(acfg_j, B, jnp.float32)
    ts = tdec.stream_state_init(acfg_t, B)
    for K, first in ((1, [True, False]), (4, [False, True])):
        x = rng.standard_normal((B, 4 * K, D)).astype(np.float32)
        f = np.array(first)
        jm, jt, js = jdec.stream_decode_block_batched(
            jcodec["acoustic_decoder"], acfg_j, jnp.asarray(x), js,
            jnp.asarray(f))
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
