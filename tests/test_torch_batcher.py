"""PyTorch port, serving slice: the continuous batcher and the slot
functions it stands on, held against the JAX package on the CPU at
float32 (tiny config, JAX weights bridged; JAX's fold_in draws injected
as the port's noise).

- The K/V write past the slab's end (a stream at pos >= T drops its rows,
  as JAX's scatter does) against JAX's lm_generate_frame.
- Slot functions against JAX: topk_filter_dynamic, reset_lm_slots,
  reset_vocoder_slots, prefill_into_slots (a burst padded with dummy
  rows), prefill_into_slot_prefix after slot_kv_prefix, stream_block with
  per-row temperature and top-k. Tolerance 1e-5 absolute (fp32 summation
  order), tokens and flags exactly.
- The batcher's behaviour, as tests/test_batcher.py, test_clone_batched.py
  and test_dialogue_batched.py hold JAX's: greedy streams equal the port
  engine's generate_stream and their tokens the JAX engine's; a sampled
  stream equals generate_stream replayed with its handle's seed; batched
  clone and dialogue equal the engine's glue; the port's policy makes
  JAX's decisions.
"""

import dataclasses
import queue
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireredtts2_tpu.config import tiny_engine_config as j_tiny
from fireredtts2_tpu.models.codec import decoder as j_dec
from fireredtts2_tpu.models.lm import model as j_lm
from fireredtts2_tpu.models.pipeline import stream_block as j_stream_block
from fireredtts2_tpu.ops import sampling as j_sampling
from fireredtts2_tpu.runtime import policy as j_policy

from fireredtts2_tpu_torch.config import tiny_engine_config as t_tiny
from fireredtts2_tpu_torch.engine import FireRedTTS2Engine as TEngine
from fireredtts2_tpu_torch.engine.engine import Segment
from fireredtts2_tpu_torch.models.codec import decoder as t_dec
from fireredtts2_tpu_torch.models.lm import model as t_lm
from fireredtts2_tpu_torch.models.pipeline import stream_block as t_stream_block
from fireredtts2_tpu_torch.ops import sampling as t_sampling
from fireredtts2_tpu_torch.runtime import policy as t_policy
from fireredtts2_tpu_torch.runtime.batcher import ContinuousBatcher
from fireredtts2_tpu_torch.utils.text import clean_text, split_text
from fireredtts2_tpu_torch.weights import from_jax

from _torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    jax_engine, jax_frame_noise, one_torch_thread, tiny_params, to_t,
    wave_close,
)

ATOL = 1e-5
KW = dict(temperature=0.9, topk=20, depth_topk=10, depth_temperature=0.75)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL,
                               err_msg=what)


def _state_equal(tstate, jstate, rows=None):
    """LM states equal: positions and validity exactly, slabs to ATOL (on
    slab rows < `rows` when given)."""
    np.testing.assert_array_equal(_np(tstate.pos), _np(jstate.pos))
    np.testing.assert_array_equal(_np(tstate.slot_valid), _np(jstate.slot_valid))
    sl = slice(None) if rows is None else slice(0, rows)
    _close(_np(tstate.cache_k)[:, :, sl], _np(jstate.cache_k)[:, :, sl], "cache_k")
    _close(_np(tstate.cache_v)[:, :, sl], _np(jstate.cache_v)[:, :, sl], "cache_v")


def _filled_states(rng, cfg_j, cfg_t, B):
    """A JAX and a port LM state of B streams with the same random slabs,
    validity and positions."""
    js = j_lm.init_lm_state(cfg_j, B, jnp.float32)
    k = rng.standard_normal(js.cache_k.shape).astype(np.float32)
    v = rng.standard_normal(js.cache_v.shape).astype(np.float32)
    pos = rng.integers(20, 60, (B,)).astype(np.int32)
    valid = np.arange(js.slot_valid.shape[1])[None] < pos[:, None]
    js = j_lm.LMState(jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
                      jnp.asarray(pos))
    ts = t_lm.LMState(to_t(k), to_t(v), to_t(valid), to_t(pos))
    return js, ts


def _window(rng, cfg, N, S, lens, right=False):
    """(N, S, C+1) tokens, mask and (N, S) valid: text in the last column,
    some rows audio frames, `lens` real slots (left-padded, or
    right-padded with `right`)."""
    C = cfg.num_columns
    tokens = np.zeros((N, S, C), np.int32)
    mask = np.zeros((N, S, C), bool)
    valid = np.zeros((N, S), bool)
    for i, L in enumerate(lens):
        sl = slice(0, L) if right else slice(S - L, S)
        tokens[i, sl, -1] = rng.integers(1, cfg.text_vocab_size, L)
        mask[i, sl, -1] = True
        tokens[i, sl, :-1] = rng.integers(0, cfg.audio_vocab_size,
                                          (L, C - 1))
        mask[i, sl, :-1][: L // 2] = True
        valid[i, sl] = True
    return tokens, mask, valid


# ---------------------------------------------------------------------------
# The repair and the slot functions against JAX
# ---------------------------------------------------------------------------


def test_kv_write_past_slab_end_matches_jax(rng):
    """B=2, one stream starting at pos T - 1, stepped 3 frames (pos T - 1,
    T, T + 1) by the port and by JAX's lm_generate_frame: the same
    samples, no raise, and the same caches on rows < T (JAX's scatter
    drops rows past the slab; before the repair the port raised
    IndexError on the second step)."""
    jcfg, tcfg, jlm, _, tlm, _ = tiny_params()
    ncb, V = tcfg.llm.audio_num_codebooks, tcfg.llm.audio_vocab_size
    js, ts = _filled_states(rng, jcfg.llm, tcfg.llm, 2)
    T = js.cache_k.shape[2]
    pos = np.array([T - 1, 40], np.int32)
    valid = np.arange(T)[None] < pos[:, None]
    js = js._replace(pos=jnp.asarray(pos), slot_valid=jnp.asarray(valid))
    ts = dataclasses.replace(ts, pos=to_t(pos), slot_valid=to_t(valid))
    key = jax.random.PRNGKey(11)
    frame = rng.integers(1, V, (2, ncb)).astype(np.int32)
    jframe, tframe = jnp.asarray(frame), to_t(frame)
    jstep = jax.jit(lambda s, tok, m, v, k: j_lm.lm_generate_frame(
        jlm, jcfg.llm, s, tok, m, v, k, **KW))
    for t in range(3):
        jt, jm = j_lm.build_step_frame(jcfg.llm, jframe)
        tt, tm = t_lm.build_step_frame(tcfg.llm, tframe)
        ones = np.ones((2, 1), bool)
        js, jframe = jstep(js, jt, jm, jnp.asarray(ones),
                           jax.random.fold_in(key, t))
        ts, tframe = t_lm.lm_generate_frame(
            tlm, tcfg.llm, ts, tt, tm, to_t(ones),
            jax_frame_noise(key, t, 2, ncb, V), **KW)
        np.testing.assert_array_equal(tframe.numpy(), np.asarray(jframe))
    assert int(ts.pos[0]) == T + 2
    _state_equal(ts, js, rows=T)


def test_slab_write_rows_drop_past_end():
    """The write placement itself: kept rows where they belong, dropped
    rows on distinct rows outside the window, nothing past T."""
    from fireredtts2_tpu_torch.models.lm.transformer import slab_write_rows
    T, S = 16, 4
    pos = torch.tensor([0, 13, 15, 16, 40])
    rows, keep = slab_write_rows(pos, S, T)
    assert int(rows.max()) < T and int(rows.min()) >= 0
    for b in range(len(pos)):
        want_keep = (pos[b] + torch.arange(S)) < T
        assert torch.equal(keep[b], want_keep)
        assert torch.equal(rows[b][keep[b]], (pos[b] + torch.arange(S))[keep[b]])
        assert len(set(rows[b].tolist())) == S


def test_topk_filter_dynamic_matches_jax(rng):
    """Per-row k, including k = 0 (clamped to 1) and k > 64 (clamped to
    the cap), and the per-row sampler with JAX's exponential draws."""
    logits = rng.standard_normal((5, 96)).astype(np.float32)
    k = np.array([0, 1, 7, 64, 100], np.int32)
    want = j_sampling.topk_filter_dynamic(jnp.asarray(logits), jnp.asarray(k))
    got = t_sampling.topk_filter_dynamic(to_t(logits), to_t(k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    temp = np.array([[0.5], [0.9], [1.0], [1.3], [0.7]], np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.exponential(key, logits.shape, jnp.float32))
    want = j_sampling.sample_topk(jnp.asarray(logits), jnp.asarray(k),
                                  jnp.asarray(temp), key)
    got = t_sampling.sample_topk(to_t(logits), to_t(k), to_t(temp), to_t(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("form", ["slots", "slot"])
def test_reset_slots_match_jax(rng, form):
    """Vectorised resets with padding ids (= B, dropped), and the
    single-slot form: the LM state's validity and positions, and every
    cache of the vocoder state."""
    jcfg, tcfg = j_tiny(), t_tiny()
    B = 4
    bs = np.array([2, B, 0, B], np.int32)
    js, ts = _filled_states(rng, jcfg.llm, tcfg.llm, B)
    if form == "slots":
        _state_equal(t_lm.reset_lm_slots(ts, bs),
                     j_lm.reset_lm_slots(js, jnp.asarray(bs)))
    else:
        _state_equal(t_lm.reset_lm_slot(ts, 2), j_lm.reset_lm_slot(js, 2))

    jv = j_dec.stream_state_init(jcfg.codec.acoustic_decoder, B, jnp.float32,
                                 latents=64)
    fields = {f: rng.standard_normal(getattr(jv, f).shape).astype(np.float32)
              for f in jv._fields if f != "pos"}
    pos = rng.integers(8, 40, (B,)).astype(np.int32)
    jv = jv._replace(pos=jnp.asarray(pos),
                     **{f: jnp.asarray(a) for f, a in fields.items()})
    tv = t_dec.stream_state_init(tcfg.codec.acoustic_decoder, B, latents=64)
    tv = dataclasses.replace(tv, pos=to_t(pos),
                             **{f: to_t(a) for f, a in fields.items()})
    if form == "slots":
        jv = j_dec.reset_vocoder_slots(jv, jnp.asarray(bs))
        tv = t_dec.reset_vocoder_slots(tv, bs)
    else:
        jv = j_dec.reset_vocoder_slot(jv, 2)
        tv = t_dec.reset_vocoder_slot(tv, 2)
    for f in jv._fields:
        np.testing.assert_array_equal(_np(getattr(tv, f)), np.asarray(getattr(jv, f)),
                                      err_msg=f)


@pytest.fixture(scope="module")
def burst():
    """A burst of two prompts into slots 3 and 1 of a 4-slot state, padded
    to B rows with dummy rows aimed at slot B, per-row temperature and
    top-k: (jax state, port state, jax frames, port frames)."""
    rng = np.random.default_rng(5)
    jcfg, tcfg, jlm, _, tlm, _ = tiny_params()
    ncb, V = tcfg.llm.audio_num_codebooks, tcfg.llm.audio_vocab_size
    B, S = 4, 32
    js, ts = _filled_states(rng, jcfg.llm, tcfg.llm, B)
    bs = np.array([3, 1, B, B], np.int32)
    tokens, mask, valid = _window(rng, tcfg.llm, B, S, [20, 9, 1, 1])
    temp = np.array([[0.8], [1.2], [0.9], [0.9]], np.float32)
    topk = np.array([5, 1, 20, 20], np.int32)
    key = jax.random.PRNGKey(7)
    js, jf = jax.jit(j_lm.prefill_into_slots, static_argnames=(
        "cfg", "depth_topk", "depth_temperature"))(
        jlm, jcfg.llm, js, jnp.asarray(bs), jnp.asarray(tokens),
        jnp.asarray(mask), jnp.asarray(valid), jax.random.fold_in(key, 0),
        jnp.asarray(temp), jnp.asarray(topk), 10, 0.75)
    ts, tf = t_lm.prefill_into_slots(
        tlm, tcfg.llm, ts, bs, to_t(tokens), to_t(mask), to_t(valid),
        jax_frame_noise(key, 0, B, ncb, V), to_t(temp), to_t(topk), 10, 0.75)
    return js, ts, jf, tf


def test_prefill_into_slots_burst_matches_jax(burst):
    js, ts, jf, tf = burst
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    _state_equal(ts, js)


def test_prefill_into_slot_matches_jax(rng):
    """One prompt into slot 2 of a 4-slot state (the single-slot
    admission) with its own temperature and top-k."""
    jcfg, tcfg, jlm, _, tlm, _ = tiny_params()
    ncb, V = tcfg.llm.audio_num_codebooks, tcfg.llm.audio_vocab_size
    js, ts = _filled_states(rng, jcfg.llm, tcfg.llm, 4)
    tokens, mask, valid = _window(rng, tcfg.llm, 1, 32, [17])
    temp, topk = np.array([[0.8]], np.float32), np.array([5], np.int32)
    key = jax.random.PRNGKey(9)
    js, jf = jax.jit(j_lm.prefill_into_slot, static_argnames=(
        "cfg", "depth_topk", "depth_temperature"))(
        jlm, jcfg.llm, js, jnp.int32(2), jnp.asarray(tokens),
        jnp.asarray(mask), jnp.asarray(valid), jax.random.fold_in(key, 0),
        jnp.asarray(temp), jnp.asarray(topk), 10, 0.75)
    ts, tf = t_lm.prefill_into_slot(
        tlm, tcfg.llm, ts, 2, to_t(tokens), to_t(mask), to_t(valid),
        jax_frame_noise(key, 0, 1, ncb, V), to_t(temp), to_t(topk), 10, 0.75)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    _state_equal(ts, js)


def test_prefill_into_slot_prefix_matches_jax(burst):
    """slot_kv_prefix of a burst's slot (P = 128), then an append-prefill
    of a right-padded window onto it in another slot."""
    rng = np.random.default_rng(9)
    js, ts, _, _ = burst
    jcfg, tcfg, jlm, _, tlm, _ = tiny_params()
    ncb, V = tcfg.llm.audio_num_codebooks, tcfg.llm.audio_vocab_size
    jpk, jpv = j_lm.slot_kv_prefix(js, jnp.int32(3), P=128)
    tpk, tpv = t_lm.slot_kv_prefix(ts, 3, 128)
    _close(tpk, jpk, "pk")
    _close(tpv, jpv, "pv")
    plen, real_len = 32, 11
    tokens, mask, valid = _window(rng, tcfg.llm, 1, 32, [real_len], right=True)
    key = jax.random.PRNGKey(13)
    js2, jf = jax.jit(j_lm.prefill_into_slot_prefix, static_argnames=(
        "cfg", "depth_topk", "depth_temperature"))(
        jlm, jcfg.llm, js, jnp.int32(0), jpk, jpv, jnp.asarray([plen]),
        jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(valid),
        jnp.asarray([real_len]), jax.random.fold_in(key, 0),
        jnp.full((1, 1), 0.9, jnp.float32), jnp.asarray([20]), 10, 0.75)
    ts2, tf = t_lm.prefill_into_slot_prefix(
        tlm, tcfg.llm, ts, 0, tpk, tpv, torch.tensor([plen]), to_t(tokens),
        to_t(mask), to_t(valid), torch.tensor([real_len]),
        jax_frame_noise(key, 0, 1, ncb, V), torch.full((1, 1), 0.9),
        torch.tensor([20]), 10, 0.75)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    _state_equal(ts2, js2)


def test_stream_block_per_row_sampling_matches_jax(rng):
    """A 4-frame block of 3 streams, each with its own temperature and
    top-k (one of them greedy), from ragged positions."""
    jcfg, tcfg, jlm, jcodec, tlm, tcodec = tiny_params()
    ncb, V = tcfg.llm.audio_num_codebooks, tcfg.llm.audio_vocab_size
    B, K, t_base = 3, 4, 5
    js, ts = _filled_states(rng, jcfg.llm, tcfg.llm, B)
    jv = j_dec.stream_state_init(jcfg.codec.acoustic_decoder, B, jnp.float32)
    tv = t_dec.stream_state_init(tcfg.codec.acoustic_decoder, B)
    frame = rng.integers(1, V, (B, ncb)).astype(np.int32)
    emitted = np.array([0, 4, 0], np.int32)
    temp = np.array([[0.7], [1.1], [1.0]], np.float32)
    topk = np.array([3, 30, 1], np.int32)
    key = jax.random.PRNGKey(4)
    jout = jax.jit(j_stream_block, static_argnames=(
        "llm_cfg", "codec_cfg", "block", "depth_topk", "depth_temperature"))(
                          jlm, jcodec, jcfg.llm, jcfg.codec, js, jv,
                          jnp.asarray(frame), jnp.asarray(emitted), key,
                          jnp.int32(t_base), K, jnp.asarray(temp),
                          jnp.asarray(topk), 10, 0.75)
    noise = torch.stack([jax_frame_noise(key, t_base + t, B, ncb, V)
                         for t in range(K)])
    tout = t_stream_block(tlm, tcodec, tcfg.llm, tcfg.codec, ts, tv,
                          to_t(frame), to_t(emitted), noise, K,
                          to_t(temp), to_t(topk), 10, 0.75)
    jp, tp = np.asarray(jout[4]), tout[4].numpy()
    ac = tcfg.codec.acoustic_decoder
    audio = K * (8 * ac.hop_length + (ac.n_fft - ac.hop_length) // 2)
    wave_close(tp[:, :audio], jp[:, :audio], "middles + tails")
    np.testing.assert_array_equal(tp[:, audio:], jp[:, audio:])
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    _state_equal(tout[0], jout[0])


def test_policy_matches_jax():
    """The port's copy of the block policy: the same choose() decisions and
    snapshot on the same recorded walls, through the first-block discard,
    the probe and the fit."""
    walls = [(4, 2.0), (4, 0.05), (4, 0.052), (4, 0.049), (4, 0.05), (4, 0.051),
             (4, 0.05), (4, 0.05), (4, 0.05), (4, 0.05), (1, 0.09), (1, 0.031),
             (1, 0.03), (16, 0.4), (16, 0.21), (16, 0.2)]
    for ladder, start in (((1, 4, 16), 4), ((1, 2, 4, 8, 16), 1)):
        jp = j_policy.AdaptiveBlockPolicy(j_policy.BlockPolicyConfig(
            ladder=ladder, start_block=start, probe_after=8))
        tp = t_policy.AdaptiveBlockPolicy(t_policy.BlockPolicyConfig(
            ladder=ladder, start_block=start, probe_after=8))
        for k, w in walls:
            jp.record(k, w)
            tp.record(k, w)
            for pending in (False, True):
                assert tp.choose(pending, 3) == jp.choose(pending, 3)
            assert tp.snapshot() == jp.snapshot()
    stats = {"first_packet_p95_ms": 450.0, "active_streams": 12,
             "aggregate_rtf": 8.0, "queue_depth": 30,
             "device_ms_per_frame": 12.0, "chunk_drops": 2,
             "hbm_used_fraction": 0.97}
    codes = {r.code for r in t_policy.RecommendationEngine(
        device_budget_ms=8.0).evaluate(stats)}
    assert codes == {r.code for r in j_policy.RecommendationEngine(
        device_budget_ms=8.0).evaluate(stats)}


# ---------------------------------------------------------------------------
# The batcher
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """A JAX engine and a port engine with its weights bridged, float32,
    a top-1 depth chain."""
    jcfg = j_tiny(depth_topk=1)
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm,
                                                             dtype="float32"))
    tcfg = t_tiny(depth_topk=1)
    tcfg = dataclasses.replace(tcfg, llm=dataclasses.replace(tcfg.llm,
                                                             dtype="float32"))
    jeng = jax_engine(config=jcfg, seed=3)
    teng = TEngine(tcfg, device="cpu", lm_params=from_jax(jeng.lm_params),
                   codec_params=from_jax(jeng.codec_params))
    return jeng, teng


@pytest.fixture(scope="module")
def batcher(engines):
    b = ContinuousBatcher(engines[1], max_streams=4, topk=1)
    b.start()
    yield b
    b.stop()


def _collect(handle, timeout=120):
    chunks = []
    while True:
        c = handle.chunks.get(timeout=timeout)   # Empty on a hang
        if c is None:
            if handle.error is not None:
                raise handle.error
            break
        chunks.append(c)
    return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)


def _stream(teng, text, ms, **kw):
    return np.concatenate(list(teng.generate_stream(text, "[S1]",
                                                    max_audio_length_ms=ms,
                                                    **kw)))


@pytest.mark.parametrize("case", ["plain", "mid_block_cap", "warmup_ladder"])
def test_greedy_stream_matches_engines(engines, batcher, case):
    """A greedy batched stream equals the port engine's greedy
    generate_stream, and its frames equal the JAX engine's: a plain 8-frame
    stream, a 3-frame cap landing inside the second (4-frame) block, and a
    pool that ran its warm-up ladder first (garbage rows written while all
    slots were idle)."""
    jeng, teng = engines
    text = "hello batch"
    ms = 240 if case == "mid_block_cap" else 640
    b = batcher
    if case == "warmup_ladder":
        b = ContinuousBatcher(teng, max_streams=4, topk=1, warmup_blocks=True)
        b.start()
    try:
        assert b.wait_ready(timeout=120)
        h = b.submit(text, "[S1]", max_audio_length_ms=ms)
        got = _collect(h)
    finally:
        if b is not batcher:
            b.stop()
    want = _stream(teng, text, ms, topk=1)
    assert got.shape == want.shape == (int(ms / 80) * 1920,)
    wave_close(got, want, case)
    np.testing.assert_array_equal(h.tokens, teng.last_tokens)
    jtok = jeng._run_ar(*jeng._build_prompt([], text, "[S1]"), int(ms / 80),
                        1.0, 1)
    np.testing.assert_array_equal(h.tokens, jtok)
    assert h.first_packet_s is not None and h.first_packet_s > 0


@pytest.mark.parametrize("admit", ["before_start", "burst"])
def test_concurrent_streams_are_independent(engines, admit):
    """Identical greedy requests admitted together in one burst (queued
    before the worker starts, or inside burst() on a running pool) give
    identical frames and audio; a different text differs."""
    b = ContinuousBatcher(engines[1], max_streams=4, topk=1)
    if admit == "burst":
        b.start()
    with b.burst():
        handles = [b.submit("twin stream text", "[S1]",
                            max_audio_length_ms=480) for _ in range(3)]
        other = b.submit("completely different words", "[S1]",
                         max_audio_length_ms=480)
        time.sleep(0.05)           # a running worker would admit by now
    if admit == "before_start":
        b.start()
    try:
        got = [_collect(h) for h in handles]
        got_other = _collect(other)
    finally:
        b.stop()
    for g, h in zip(got[1:], handles[1:]):
        np.testing.assert_array_equal(g, got[0])
        np.testing.assert_array_equal(h.tokens, handles[0].tokens)
    assert not np.array_equal(other.tokens, handles[0].tokens)
    admits = [e for e in b.timeline if e["ev"] == "admit"]
    assert admits[0]["n"] == 4            # one burst
    assert got_other.shape[0] > 0


def test_slot_reuse_beyond_capacity(batcher):
    """More requests than slots, twice over: slots recycle cleanly."""
    for round_ in range(2):
        handles = [batcher.submit(f"req {round_} {i}", "[S1]",
                                  max_audio_length_ms=320) for i in range(6)]
        for h in handles:
            o = _collect(h)
            assert o.shape[0] % 1920 == 0 and o.shape[0] > 0
            assert np.isfinite(o).all()


def test_per_request_sampling_config(engines, batcher):
    """Per-request top-k and frame caps inside the shared step: a 3-frame
    cap bounds the audio; a sampled top-4 neighbour leaves a top-1 stream
    equal to the engine's greedy one."""
    _, teng = engines
    got = _collect(batcher.submit("cap me", "[S1]", max_audio_length_ms=240))
    assert got.shape[0] <= 3 * 1920
    h_wide = batcher.submit("some other words", "[S1]", topk=4,
                            temperature=1.1, max_audio_length_ms=640)
    h_greedy = batcher.submit("hello batch", "[S1]", topk=1,
                              max_audio_length_ms=640)
    _collect(h_wide)
    got = _collect(h_greedy)
    want = _stream(teng, "hello batch", 640, topk=1)
    assert got.shape == want.shape
    wave_close(got, want, "greedy beside a sampled neighbour")


def test_sampled_stream_replays_with_handle_seed(engines, batcher):
    """Sampled streams (top-k 5 and 20) draw each frame's noise from their
    request's seed at their own frame index: generate_stream replayed with
    the handle's seed gives the same frames and audio."""
    _, teng = engines
    hs = [batcher.submit(t, "[S1]", max_audio_length_ms=800, topk=k,
                         temperature=0.9)
          for t, k in (("sampled stream one", 5), ("sampled stream two", 20))]
    for h, k in zip(hs, (5, 20)):
        got = _collect(h)
        want = _stream(teng, "sampled stream one" if k == 5
                       else "sampled stream two", 800, topk=k,
                       temperature=0.9, utt_seed=h.seed)
        np.testing.assert_array_equal(h.tokens, teng.last_tokens)
        wave_close(got, want, f"replay topk={k}")
    assert hs[0].seed != hs[1].seed


def test_stop_terminates_live_streams(engines):
    """stop() mid-stream drains the block in flight and closes every live
    handle with its final None."""
    b = ContinuousBatcher(engines[1], max_streams=4, topk=1)
    b.start()
    h = b.submit("a long stream that will be interrupted", "[S1]",
                 max_audio_length_ms=30_000)
    assert h.chunks.get(timeout=120) is not None
    b.stop()
    while True:
        try:
            c = h.chunks.get(timeout=30)
        except queue.Empty:
            pytest.fail("stream handle never closed after stop()")
        if c is None:
            break
    assert h.error is None


def test_host_stats_attribution(batcher):
    _collect(batcher.submit("host stats probe", "[S1]", max_audio_length_ms=640))
    stats = batcher.host_stats()
    assert stats["blocks"] > 0 and stats["frames"] > 0
    for k in ("dispatch_ms_per_frame", "fetch_ms_per_frame",
              "fanout_ms_per_frame", "host_ms_per_frame"):
        assert np.isfinite(stats[k]) and stats[k] >= 0.0, k
    assert stats["host_ms_per_frame"] == pytest.approx(
        stats["dispatch_ms_per_frame"] + stats["fanout_ms_per_frame"])


def test_capacity_class_pool_with_idle_slot_past_slab(engines):
    """A capacity-classed pool: slabs sized by the class, an idle slot
    stepping past its slab's end (placed at T - 2) while a neighbour
    streams, the neighbour equal to the engine's stream, the frame cap
    enforced and an oversized prompt rejected."""
    _, teng = engines
    b = ContinuousBatcher(teng, max_streams=2, topk=1, seq_capacity=128,
                          max_frames_cap=8)
    T = b.lm_state.cache_k.shape[2]
    assert T == t_lm.kv_capacity(128) and b.vo_state.kv_k.shape[2] == 64
    b.lm_state = dataclasses.replace(
        b.lm_state, pos=torch.tensor([T - 2, 0], dtype=torch.int32))
    b.start()
    try:
        got = _collect(b.submit("hello batch", "[S1]", max_audio_length_ms=640))
        # slots pop from the end of the free list: slot 1 streamed and
        # slot 0 idled past its slab
        assert int(b.lm_state.pos[0]) > T
        want = _stream(teng, "hello batch", 640, topk=1)
        wave_close(got, want, "beside an idle slot past its slab")
        capped = _collect(b.submit("cap me to the class", "[S1]",
                                   max_audio_length_ms=30_000))
        assert capped.shape[0] <= 8 * 1920
        with pytest.raises(ValueError, match="capacity"):
            b.submit("far too many words " * 7, "[S1]")
    finally:
        b.stop()


def test_submit_fails_fast_after_worker_death_or_stop(engines):
    """Every submit path raises once the worker is dead or stopped."""
    teng = engines[1]
    b = ContinuousBatcher(teng, max_streams=2, topk=1)
    b._dead = RuntimeError("simulated worker crash")
    with pytest.raises(RuntimeError, match="worker died"):
        b.submit("text after death", "[S1]")
    with pytest.raises(RuntimeError, match="worker died"):
        b.submit_prompt(*teng._build_prompt([], "direct", "[S1]"))
    b = ContinuousBatcher(teng, max_streams=2, topk=1)
    b.start()
    b.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        b.submit("text after stop", "[S1]")
    with pytest.raises(RuntimeError, match="stopped"):
        list(b.run_dialogue(["[S1]hello"], topk=1))


def test_worker_failure_reaches_every_handle(engines):
    """A failure inside the worker (here: the block itself raising) is
    every live and pending handle's error, never carried on."""
    b = ContinuousBatcher(engines[1], max_streams=2, topk=1)

    def broken(K, noise):
        raise RuntimeError("kernel launch failed")
    b._block = broken
    hs = [b.submit(f"doomed {i}", "[S1]", max_audio_length_ms=320)
          for i in range(3)]
    b.start()
    for h in hs:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            _collect(h)
    b.stop()


PROMPT_TEXT = "A short voice prompt."


@pytest.fixture(scope="module")
def prompt_audio():
    rng = np.random.default_rng(4)
    return (rng.standard_normal(8000) * 0.05).astype(np.float32)


def test_batched_clone_matches_engine_glue(engines, batcher, prompt_audio):
    """Greedy batched clone == the port engine's generate_monologue glue
    at the same frame cap (merged prompt text, last 3 prompt frames
    dropped, 2 frames trimmed, then vocoded); 24 frames clear the 18-frame
    retry bar on both sides."""
    _, teng = engines
    pieces = []
    pt = clean_text(PROMPT_TEXT)
    text = "hello cloned batch"
    for chunk in split_text(clean_text(text), 400) or [text]:
        seg = Segment(speaker="[S1]", text=pt[:-1] + "," + clean_text(chunk),
                      audio=prompt_audio)
        prompt, mask = teng._build_prompt([seg], None, None)
        [gen] = teng._run_ar([(prompt[:-3], mask[:-3])], 24, 0.75, 1)
        pieces.append(teng._decode_tokens([gen[2:]])[0])
    want = np.concatenate(pieces)
    got = batcher.generate_monologue_clone(text, prompt_text=PROMPT_TEXT,
                                           prompt_audio=prompt_audio, topk=1,
                                           max_frames=24)
    assert got.shape == want.shape
    wave_close(got, want, "batched clone")
    with pytest.raises(ValueError, match="prompt"):
        batcher.generate_monologue_clone("no prompt here", prompt_text="x")


TEXTS = ["[S1]hello there friend", "[S2]hi right back"]


def _dialogue(batcher, **kw):
    per_utt: dict = {}
    for i, chunk in batcher.run_dialogue(list(TEXTS), topk=1,
                                         max_utterance_ms=640, **kw):
        per_utt.setdefault(i, []).append(chunk)
    return per_utt


def test_batched_dialogue_matches_engine(engines, batcher):
    """Greedy batched dialogue == the port engine's incremental
    generate_dialogue (contiguous positions, right-padded windows,
    re-encoded audio fed back), chunks tagged per utterance; a repeat
    gives the same audio."""
    _, teng = engines
    want = teng.generate_dialogue(list(TEXTS), topk=1, max_utterance_ms=640)
    per_utt = _dialogue(batcher)
    assert sorted(per_utt) == [0, 1]
    got = np.concatenate([c for i in sorted(per_utt) for c in per_utt[i]])
    assert got.shape == want.shape
    wave_close(got, want, "batched dialogue")
    # the policy sizes blocks from measured walls, so a repeat may group
    # the vocoder's passes differently: fp32 summation order
    again = _dialogue(batcher)
    for i in per_utt:
        wave_close(np.concatenate(again[i]), np.concatenate(per_utt[i]),
                   f"repeat, turn {i}")


def test_context_prefix_admission_under_lock(engines, prompt_audio):
    """A repeat context is admitted from the cached KV prefix (one entry;
    the first sighting runs the plain path, the second builds, then hits),
    every run equal under greedy; four threads asking for the prefix at
    once all get the cached entry and the cache stays one entry."""
    teng = engines[1]
    ctx = [Segment(speaker="[S1]", text="A fixed voice context.",
                   audio=prompt_audio)]
    b = ContinuousBatcher(teng, max_streams=4, topk=1)
    b.start()
    try:
        outs = [_collect(b.submit("hello prefix", "[S1]", context=ctx,
                                  max_audio_length_ms=640, topk=1))
                for _ in range(4)]
        assert len(b._prefix_cache) == 1
        for o in outs[1:]:
            wave_close(o, outs[0], "prefix admission")
        hits, errors = [], []

        def ask():
            try:
                hits.append(b._context_prefix(ctx))
            except Exception as e:  # noqa: BLE001
                errors.append(e)
        threads = [threading.Thread(target=ask) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors and len(hits) == 4
        assert all(h is hits[0] for h in hits)
        assert len(b._prefix_cache) == 1
    finally:
        b.stop()
