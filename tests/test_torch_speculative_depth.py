"""PyTorch port, speculative (Jacobi) depth: ``depth_decode_jacobi``,
``draft_depth_tokens`` and ``lm_generate_frame``'s speculative branch held
against the JAX package on the CPU at float32 (tiny config, JAX weights
bridged by weights.from_jax, JAX's fold_in draws injected as the port's
noise), and the port's own invariants: the Jacobi tokens are the
sequential chain's (bf16 backbone, int8 backbone, int8 depth, int4 depth
through kernel E's plain version), an engine with the flag streams what it
generates and generates what an engine without it does, and a
ContinuousBatcher stream equals its lone request.

Tolerances: tokens and round counts exactly; generate_stream against
generate rtol 1e-3 / atol 1e-4 (JAX's
test_stream_equals_batch_with_speculative_depth).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireredtts2_tpu.models.lm import model as jmodel

from fireredtts2_tpu_torch.config import tiny_engine_config as t_tiny
from fireredtts2_tpu_torch.engine import FireRedTTS2Engine
from fireredtts2_tpu_torch.models.lm import model as tmodel
from fireredtts2_tpu_torch.models.lm.transformer import (
    quantize_transformer_int4, quantize_transformer_int8,
)
from fireredtts2_tpu_torch.ops import int4 as tint4
from fireredtts2_tpu_torch.runtime.batcher import ContinuousBatcher

from _torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    jax_frame_noise, one_torch_thread, tiny_params, to_t,
)

B = 3
J_JACOBI = jax.jit(jmodel.depth_decode_jacobi, static_argnums=(1, 5, 6))
J_DRAFT = jax.jit(jmodel.draft_depth_tokens, static_argnums=(1,))
J_FRAME = jax.jit(jmodel.lm_generate_frame, static_argnums=(1,),
                  static_argnames=("temperature", "topk", "depth_topk",
                                   "depth_temperature"))


def _spec(cfg):
    return dataclasses.replace(cfg, speculative_depth=True)


def depth_noise(key, B, ncb, V) -> torch.Tensor:
    """JAX's per-codebook draws of a depth decode under `key` (codebook i
    from fold_in(key, i)) as the port's (B, ncb, V) noise; column 0, which
    the depth decode does not read, is ones."""
    rows = [jnp.ones((B, V), jnp.float32)]
    rows += [jax.random.exponential(jax.random.fold_in(key, i), (B, V),
                                    jnp.float32) for i in range(1, ncb)]
    return to_t(np.stack([np.asarray(r) for r in rows], axis=1))


def _frame_inputs(cfg, rng):
    last_h = rng.standard_normal((B, cfg.backbone.embed_dim)).astype(np.float32)
    c0 = rng.integers(0, cfg.audio_vocab_size, (B,)).astype(np.int32)
    return last_h, c0


def _with_draft(jlm, tlm, cfg, rng):
    """Both trees with the same random depth_draft head (non-zero position
    offsets, so every position's draft differs)."""
    D2, Dd = 2 * cfg.backbone.embed_dim, cfg.decoder.embed_dim
    head = {"trunk": rng.uniform(-0.2, 0.2, (D2, Dd)).astype(np.float32),
            "pos": rng.standard_normal((cfg.audio_num_codebooks - 1, Dd))
            .astype(np.float32)}
    return ({**jlm, "depth_draft": {k: jnp.asarray(v) for k, v in head.items()}},
            {**tlm, "depth_draft": {k: to_t(v) for k, v in head.items()}})


@pytest.mark.parametrize("seed", [3, 7])
def test_jacobi_matches_jax(rng, seed):
    """Sampled depth (top-10, T 0.75) from the zero guess: the port's
    tokens and round count equal JAX's, with JAX's fold_in(key, i) draws
    as the noise rows."""
    jcfg, tcfg, jlm, _, tlm, _ = tiny_params()
    last_h, c0 = _frame_inputs(tcfg.llm, rng)
    key = jax.random.PRNGKey(seed)
    ncb, V = tcfg.llm.audio_num_codebooks, tcfg.llm.audio_vocab_size
    jtok, jrounds = J_JACOBI(jlm, jcfg.llm, jnp.asarray(last_h),
                             jnp.asarray(c0), key, 10, 0.75)
    ttok, trounds = tmodel.depth_decode_jacobi(
        tlm, tcfg.llm, to_t(last_h), to_t(c0), depth_noise(key, B, ncb, V),
        10, 0.75)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert trounds == int(jrounds)


def test_jacobi_equals_sequential_and_init_sets_rounds(rng):
    """Against the port's sequential _depth_decode on the same noise rows:
    sampled and greedy; the true chain as the init verifies in one round;
    a wrong init at every position still ends in the true chain within
    ncb - 1 rounds; the counters count frames and rounds."""
    _, tcfg, _, _, tlm, _ = tiny_params()
    cfg = tcfg.llm
    ncb, V = cfg.audio_num_codebooks, cfg.audio_vocab_size
    last_h, c0 = (to_t(a) for a in _frame_inputs(cfg, rng))
    noise = torch.from_numpy(rng.exponential(size=(B, ncb, V)).astype(np.float32))
    tmodel.reset_jacobi_counts()
    for topk in (10, 1):
        seq = tmodel._depth_decode(tlm, cfg, last_h, c0, noise, topk, 0.75)
        jac, rounds = tmodel.depth_decode_jacobi(tlm, cfg, last_h, c0, noise,
                                                 topk, 0.75)
        assert torch.equal(jac, seq) and 1 <= rounds <= ncb - 1
        one, r1 = tmodel.depth_decode_jacobi(tlm, cfg, last_h, c0, noise, topk,
                                             0.75, init=seq[:, 1:])
        assert torch.equal(one, seq) and r1 == 1
        bad, rb = tmodel.depth_decode_jacobi(tlm, cfg, last_h, c0, noise, topk,
                                             0.75, init=(seq[:, 1:] + 1) % V)
        assert torch.equal(bad, seq) and rb <= ncb - 1
    assert tmodel.depth_decode_jacobi.calls == 6
    assert tmodel.depth_decode_jacobi.max_rounds <= ncb - 1


def test_draft_depth_tokens_matches_jax(rng):
    """The draft head's one-shot greedy chain equals JAX's."""
    jcfg, tcfg, jlm, _, tlm, _ = tiny_params()
    jlm, tlm = _with_draft(jlm, tlm, tcfg.llm, rng)
    last_h, c0 = _frame_inputs(tcfg.llm, rng)
    want = J_DRAFT(jlm, jcfg.llm, jnp.asarray(last_h), jnp.asarray(c0))
    got = tmodel.draft_depth_tokens(tlm, tcfg.llm, to_t(last_h), to_t(c0))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_depth_jacobi_equals_sequential(rng, bits):
    """An int8 or int4 depth decoder (int4: kernel E's plain version on the
    CPU, 16 rows a stream a round): the Jacobi tokens equal the sequential
    chain's."""
    _, tcfg, _, _, tlm, _ = tiny_params()
    cfg = tcfg.llm
    quant = (quantize_transformer_int8 if bits == 8 else
             lambda t: tint4.prepare_int4_layout(quantize_transformer_int4(t)))
    params = {**tlm, "decoder": quant(tlm["decoder"])}
    ncb, V = cfg.audio_num_codebooks, cfg.audio_vocab_size
    last_h, c0 = (to_t(a) for a in _frame_inputs(cfg, rng))
    for _ in range(2):
        noise = torch.from_numpy(
            rng.exponential(size=(B, ncb, V)).astype(np.float32))
        seq = tmodel._depth_decode(params, cfg, last_h, c0, noise, 10, 0.75)
        jac, _ = tmodel.depth_decode_jacobi(params, cfg, last_h, c0, noise, 10,
                                            0.75)
        assert torch.equal(jac, seq)
    assert tint4.int4_matmul.launches == 0          # the CPU: plain version


@pytest.mark.parametrize("draft", [False, True])
def test_frame_with_previous_frame_init_matches_jax(rng, draft):
    """A speculative lm_generate_frame over an S=8 window whose last row
    holds audio tokens in every column (the init is that row's chain; with
    a draft head, the draft), sampled with JAX's draws: the frame equals
    JAX's lm_generate_frame's."""
    jcfg, tcfg, jlm, _, tlm, _ = tiny_params()
    jcfg_s, tcfg_s = _spec(jcfg.llm), _spec(tcfg.llm)
    if draft:
        jlm, tlm = _with_draft(jlm, tlm, tcfg_s, rng)
    C = tcfg_s.num_columns
    ncb, V = tcfg_s.audio_num_codebooks, tcfg_s.audio_vocab_size
    Bf, S = 2, 8
    tokens = rng.integers(1, 60, (Bf, S, C)).astype(np.int32)
    tmask = np.ones((Bf, S, C), bool)
    valid = np.ones((Bf, S), bool)
    key = jax.random.PRNGKey(12)
    kw = dict(temperature=0.9, topk=20, depth_topk=10, depth_temperature=0.75)
    _, jframe = J_FRAME(jlm, jcfg_s, jmodel.init_lm_state(jcfg_s, Bf, jnp.float32),
                        jnp.asarray(tokens), jnp.asarray(tmask),
                        jnp.asarray(valid), jax.random.fold_in(key, 0), **kw)
    tmodel.reset_jacobi_counts()
    _, tframe = tmodel.lm_generate_frame(
        tlm, tcfg_s, tmodel.init_lm_state(tcfg_s, Bf), to_t(tokens),
        to_t(tmask), to_t(valid), jax_frame_noise(key, 0, Bf, ncb, V), **kw)
    np.testing.assert_array_equal(tframe.numpy(), np.asarray(jframe))
    assert tmodel.depth_decode_jacobi.calls == 1


def _engine(cfg, **llm):
    return FireRedTTS2Engine(dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, **llm)), device="cpu", seed=0)


@pytest.mark.parametrize("quant", [
    {}, {"quantize_backbone": True}, {"quantize_depth": True},
    {"quantize_depth": True, "quantize_depth_bits": 4}],
    ids=["bf16", "int8_backbone", "int8_depth", "int4_depth"])
def test_engine_speculative_generate_equals_plain(quant):
    """The engine takes speculative depth with each backbone and depth
    decoder (the tiny config's float32 in place of bf16): its generate
    equals the same engine's without the flag, audio exactly."""
    cfg = t_tiny()
    text = "speculative depth check"
    plain = _engine(cfg, **quant).generate(text, "[S1]",
                                           max_audio_length_ms=400, utt_seed=5)
    tmodel.reset_jacobi_counts()
    eng = _engine(cfg, speculative_depth=True, **quant)
    got = eng.generate(text, "[S1]", max_audio_length_ms=400, utt_seed=5)
    np.testing.assert_array_equal(got, plain)
    assert tmodel.depth_decode_jacobi.calls >= eng.last_stats["frames"] > 0


def test_engine_refuses_only_the_noncausal_vocoder():
    cfg = t_tiny()
    ad = dataclasses.replace(cfg.codec.acoustic_decoder, causal=False)
    with pytest.raises(NotImplementedError, match="non-causal"):
        FireRedTTS2Engine(dataclasses.replace(
            cfg, llm=_spec(cfg.llm),
            codec=dataclasses.replace(cfg.codec, acoustic_decoder=ad)),
            device="cpu")


def test_stream_equals_batch_with_speculative_depth():
    """generate_stream equals generate under the flag (one utterance seed),
    as JAX's test_stream_equals_batch_with_speculative_depth holds."""
    eng = _engine(t_tiny(), speculative_depth=True)
    text = "stream speculative"
    streamed = np.concatenate(list(eng.generate_stream(
        text, "[S1]", max_audio_length_ms=480, utt_seed=123)))
    stream_tokens = eng.last_tokens
    batch = eng.generate(text, "[S1]", max_audio_length_ms=480, utt_seed=123)
    np.testing.assert_array_equal(stream_tokens, eng.last_tokens)
    assert streamed.shape == batch.shape
    np.testing.assert_allclose(streamed, batch, rtol=1e-3, atol=1e-4)


def test_batcher_stream_matches_lone_request_with_speculative_depth():
    """Two sampled requests admitted as one burst into a pool whose depth
    decode runs Jacobi rounds over both slots: each stream's frames and
    audio equal generate_stream replayed with its handle's seed."""
    eng = _engine(t_tiny(), speculative_depth=True)
    texts = ("pool stream one", "another pooled line")
    b = ContinuousBatcher(eng, max_streams=2)
    with b.burst():
        hs = [b.submit(t, "[S1]", max_audio_length_ms=560, topk=k,
                       temperature=0.9) for t, k in zip(texts, (5, 20))]
    b.start()
    try:
        got = []
        for h in hs:
            chunks = []
            while (c := h.chunks.get(timeout=120)) is not None:
                chunks.append(c)
            assert h.error is None
            got.append(np.concatenate(chunks))
    finally:
        b.stop()
    for text, k, h, g in zip(texts, (5, 20), hs, got):
        want = np.concatenate(list(eng.generate_stream(
            text, "[S1]", max_audio_length_ms=560, topk=k, temperature=0.9,
            utt_seed=h.seed)))
        np.testing.assert_array_equal(h.tokens, eng.last_tokens)
        assert g.shape == want.shape
        np.testing.assert_allclose(g, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
