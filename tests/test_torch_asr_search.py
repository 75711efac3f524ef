"""PyTorch port, Whisper search and streaming: beam search, best-of-N, the
alignment maps, the word-timestamp copy, the service with all three, the
streaming thread and the realtime WebSocket server, held against the JAX
package on the CPU at float32 (TINY_ASR, parameters from JAX's
init_asr_params bridged by weights.from_jax).

The parameters scale the EOT row of the tied token embedding by 4, so that
EOT enters the beams' top-(W+1) and the finished pools fill (at W = 2 and
4 the search stops on a full pool before its budget); everything else is
JAX's initialiser's.

- asr_beam_decode at W = 1, 2, 4 on two utterances: tokens, n_tokens and
  n_finished equal; sum_logprob and no_speech_prob within 1e-4 relative;
- asr_sample_best_of with JAX's draws (fold_in(key, t), all B·N rows)
  injected: the same fields;
- asr_alignment_probs: JAX pads the teacher-forced row with EOT to
  P + max_new + 1, the port runs prompt + ids; maps on rows [P, P+n) and
  token_logprob on [0, P+n) within 1e-5;
- the timestamps copy pinned to JAX's on the same numpy inputs;
- one service with beam_size=3, best_of=2, word_timestamps and a ladder
  whose T > 0 rung runs: every TranscriptionResult field as JAX's, word
  times within one 20 ms frame;
- StreamingWhisperASR and create_asr_interface; a kept exception raised;
- RealtimeASRServer over localhost websockets (JAX's
  tests/test_realtime_asr.py scenarios).

The JAX references are jitted once at module scope, one per function and
static shape.
"""

import asyncio
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireredtts2_tpu.asr import asr as j_asr
from fireredtts2_tpu.asr import model as jm
from fireredtts2_tpu.asr import timestamps as j_ts

from fireredtts2_tpu_torch.asr import asr as t_asr
from fireredtts2_tpu_torch.asr import model as tm
from fireredtts2_tpu_torch.asr import timestamps as t_ts
from fireredtts2_tpu_torch.asr.realtime import (
    RealtimeASRClient, RealtimeASRServer, StreamingConfig,
)
from fireredtts2_tpu_torch.weights import from_jax

from _torch_parity import one_torch_thread, to_t, voiced  # noqa: F401
from conftest import free_port

CFG = jm.TINY_ASR
V = CFG.vocab_size
MAX_NEW = 8
PROMPT = np.array([[CFG.sot_id, CFG.transcribe_id, CFG.no_timestamps_id]] * 2)
REL = 1e-4
# static: cfg, max_new, beam_size / best_of, sot_index
J_BEAM = jax.jit(jm.asr_beam_decode, static_argnums=(1, 5, 6, 7))
J_BEST_OF = jax.jit(
    lambda p, mel, mel_len, prompt, temp, key: jm.asr_sample_best_of(
        p, CFG, mel, mel_len, prompt, MAX_NEW, 3, temp, key))
J_ALIGN = jax.jit(jm.asr_alignment_probs, static_argnums=(1, 5))
J_GUMBEL = jax.jit(lambda key, t, rows: jax.random.gumbel(
    jax.random.fold_in(key, t), (rows, V), jnp.float32), static_argnums=(2,))


@pytest.fixture(scope="module")
def jref():
    """JAX params (the EOT row scaled), the port's copy, and two windows'
    JAX mels and lengths (B=2) with their port copies."""
    jp = jm.init_asr_params(jax.random.PRNGKey(0), CFG)
    emb = jp["decoder"]["token_emb"]
    jp["decoder"]["token_emb"] = emb.at[CFG.eot_id].multiply(4.0)
    svc = j_asr.WhisperASR(config=j_asr.ASRConfig(max_new_tokens=MAX_NEW),
                           params=jp, model_cfg=CFG, warmup=False)
    mels = [svc._mel(voiced(n, s)) for n, s in ((6000, 1), (9000, 2))]
    jmel = jnp.concatenate([m[0] for m in mels])
    jlen = jnp.concatenate([m[1] for m in mels])
    return jp, from_jax(jp), jmel, jlen, to_t(jmel), to_t(jlen).long()


def _close(got, want, rel=REL, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * max(float(np.abs(want).max()), 1e-3),
                               err_msg=what)


def _same_result(got, want, fields=("tokens", "n_tokens")):
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    _close(got.sum_logprob.numpy(), want.sum_logprob, what="sum_logprob")
    _close(got.no_speech_prob.numpy(), want.no_speech_prob, what="no_speech")


@pytest.mark.parametrize("W", [1, 2, 4])
def test_beam_decode_matches_jax(jref, W):
    jp, tp, jmel, jlen, tmel, tlen = jref
    want = J_BEAM(jp, CFG, jmel, jlen, jnp.asarray(PROMPT, jnp.int32),
                  MAX_NEW, W, 0)
    got = tm.asr_beam_decode(tp, tm.TINY_ASR, tmel, tlen,
                             torch.from_numpy(PROMPT), MAX_NEW, W)
    _same_result(got, want, ("tokens", "n_tokens", "n_finished"))
    assert got.tokens.dtype == torch.int32
    if W > 1:       # a full pool ended the search before its budget
        assert (got.n_finished.numpy() == W).all()
        assert (got.n_tokens.numpy() < MAX_NEW).all()


def test_best_of_matches_jax_with_its_draws(jref):
    """N=3 candidates for each of B=2 utterances at T=0.8: JAX's
    gumbel(fold_in(key, t)) draws of all six rows are the port's noise."""
    jp, tp, jmel, jlen, tmel, tlen = jref
    key = jax.random.PRNGKey(11)
    want = J_BEST_OF(jp, jmel, jlen, jnp.asarray(PROMPT, jnp.int32),
                     jnp.float32(0.8), key)
    got = tm.asr_sample_best_of(tp, tm.TINY_ASR, tmel, tlen,
                                torch.from_numpy(PROMPT), MAX_NEW, 3, 0.8,
                                lambda t: to_t(J_GUMBEL(key, t, 6)))
    _same_result(got, want)


def test_alignment_probs_match_jax(jref):
    """Maps of heads in both layers; JAX's row padded with EOT to its
    static length, the port's not."""
    jp, tp, jmel, jlen, tmel, tlen = jref
    heads = ((0, 1), (1, 0), (1, 1))
    ids = [7, 19, 3, 44, 12]
    row = list(PROMPT[0]) + ids
    P, n = PROMPT.shape[1], len(ids)
    padded = (row + [CFG.eot_id] * 32)[:P + MAX_NEW + 1]
    want_p, want_lp = J_ALIGN(jp, CFG, jmel[:1], jlen[:1],
                              jnp.asarray([padded], jnp.int32), heads)
    got_p, got_lp = tm.asr_alignment_probs(tp, tm.TINY_ASR, tmel[:1],
                                           tlen[:1], torch.tensor([row]), heads)
    assert got_p.shape == (1, 3, P + n, CFG.max_source_positions)
    np.testing.assert_allclose(got_p[0, :, P:].numpy(),
                               np.asarray(want_p)[0, :, P:P + n], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got_lp[0].numpy(),
                               np.asarray(want_lp)[0, :P + n], rtol=0,
                               atol=1e-5)
    assert float(got_lp[0, 0]) == 0.0


def test_timestamps_copy_matches_jax(rng):
    x = rng.standard_normal((3, 5, 40))
    for w in (1, 3, 7, 9):
        np.testing.assert_array_equal(t_ts.median_filter(x, w),
                                      j_ts.median_filter(x, w))
    cost = rng.standard_normal((6, 30))
    for a, b in zip(t_ts.dtw_path(cost), j_ts.dtw_path(cost)):
        np.testing.assert_array_equal(a, b)
    pieces = {1: " Hello", 2: "'s", 3: " world", 4: "中", 5: "文", 6: " ",
              7: "!"}

    def detok(ids):
        return "".join(pieces[i] for i in ids)
    for ids in ([1, 2, 3, 7], [4, 5, 6, 1], [6, 1, 3]):
        assert t_ts.split_to_words(ids, detok) == j_ts.split_to_words(ids, detok)
    probs = rng.random((2, 9, 30))
    lp = np.log(rng.random(9))
    args = dict(text_start=2, n_text=4, ids=[1, 2, 3, 7], detokenize=detok)
    for n_frames in (None, 20):
        assert t_ts.word_timestamps_from_alignment(
            probs, lp, n_frames=n_frames, **args) == \
            j_ts.word_timestamps_from_alignment(probs, lp, n_frames=n_frames,
                                                **args)
    assert t_ts.default_alignment_heads(32, 20) == \
        j_ts.default_alignment_heads(32, 20)
    assert len(t_ts.default_alignment_heads(32, 20)) == 320


def test_service_beam_best_of_and_words_match_jax(jref, monkeypatch):
    """A logprob gate no decode passes: the T=0 rung runs beam search
    (W=3), the T=0.5 rung best-of-2 with JAX's draws; two windows, the
    second with its words offset by the first's length."""
    jp, tp = jref[:2]
    kw = dict(max_new_tokens=MAX_NEW, beam_size=3, best_of=2,
              word_timestamps=True, logprob_threshold=1e9,
              fallback_temperatures=(0.5,), seed=5)
    jsvc = j_asr.WhisperASR(config=j_asr.ASRConfig(**kw), params=jp,
                            model_cfg=CFG, warmup=False)
    tsvc = t_asr.WhisperASR(config=t_asr.ASRConfig(**kw), params=tp,
                            model_cfg=tm.TINY_ASR, warmup=False, device="cpu")

    def noise(attempt, rows=1):
        key = jax.random.fold_in(jax.random.PRNGKey(5), attempt)
        return lambda t: to_t(J_GUMBEL(key, t, rows))
    tsvc.noise_fn = noise
    audio = np.concatenate([voiced(10240, 3), voiced(7000, 4)])
    want, got = jsvc.transcribe(audio), tsvc.transcribe(audio)
    assert (got.text, got.language, len(got.segments)) == \
        (want.text, want.language, len(want.segments)) != ("", "unknown", 0)
    assert got.confidence == pytest.approx(want.confidence, rel=1e-5, abs=1e-7)
    assert tsvc.decode_calls == jsvc.decode_calls == 4
    for ts, js in zip(got.segments, want.segments):
        assert ts["temperature"] == js["temperature"] == 0.5
        for k in ("id", "start", "end", "text", "tokens", "compression_ratio"):
            assert ts[k] == js[k], k
        for k in ("avg_logprob", "no_speech_prob"):
            assert ts[k] == pytest.approx(js[k], rel=1e-5, abs=1e-7), k
        assert [w["word"] for w in ts["words"]] == \
            [w["word"] for w in js["words"]] and ts["words"]
        for tw, jw in zip(ts["words"], js["words"]):
            assert abs(tw["start"] - jw["start"]) <= 0.02 + 1e-9
            assert abs(tw["end"] - jw["end"]) <= 0.02 + 1e-9
            assert tw["probability"] == pytest.approx(jw["probability"],
                                                      rel=1e-4)
    assert got.segments[1]["words"][0]["start"] >= got.segments[1]["start"]


def _tiny_service(**kw):
    return t_asr.WhisperASR(
        config=t_asr.ASRConfig(max_new_tokens=4, fallback_temperatures=(),
                               **kw), warmup=False, device="cpu", seed=1)


def test_streaming_gives_results_and_reraises_a_fault():
    asr, streaming, api = t_asr.create_asr_interface(_tiny_service())
    assert api["get_result"] == streaming.get_transcription_result
    assert api["supported_languages"]() == asr.get_supported_languages()
    api["start_streaming"]()
    audio = voiced(3 * 16_000, 9)
    for i in range(0, len(audio), 8000):
        api["add_audio_chunk"](audio[i:i + 8000])
    res, deadline = None, time.monotonic() + 60
    while res is None and time.monotonic() < deadline:
        res = api["get_result"](timeout=0.5)
    assert res is not None and res.text and res.is_final is False
    assert streaming.context_tokens

    def fault(*a, **kw):
        raise RuntimeError("CUDA error: device lost")
    asr.transcribe = fault
    api["add_audio_chunk"](audio[:2 * 16_000])
    deadline = time.monotonic() + 30
    while streaming.error is None and time.monotonic() < deadline:
        time.sleep(0.05)
    with pytest.raises(RuntimeError, match="device lost"):
        streaming.get_transcription_result()
    with pytest.raises(RuntimeError, match="device lost"):
        api["stop_streaming"]()
    assert streaming._thread is None and not streaming.is_streaming
    api["stop_streaming"]()          # raised once: a second stop is clean


def _speech(seconds: float, sr: int = 16_000, seed: int = 0) -> np.ndarray:
    """A modulated multi-tone burst the hybrid VAD calls speech."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    sig = sum(np.sin(2 * np.pi * f * t) for f in (220, 440, 880))
    env = 0.6 + 0.4 * np.sin(2 * np.pi * 4 * t)
    return (0.3 * sig * env + 0.01 * rng.standard_normal(len(t))
            ).astype(np.float32)


async def _recv_until(client, pred, timeout=60.0):
    msgs = []
    while True:
        m = await client.recv(timeout=timeout)
        msgs.append(m)
        if pred(m):
            return msgs


def _run_session(server, scenario):
    async def main():
        await server.start()
        client = RealtimeASRClient(f"ws://127.0.0.1:{server.port}")
        try:
            await client.connect()
            return await scenario(client)
        finally:
            await client.close()
            await server.stop()
    return asyncio.run(main())


def test_realtime_turn_detected_and_transcribed():
    """Speech then silence: the VAD's end of turn gives a final
    transcription; status, then end_session."""
    server = RealtimeASRServer(
        _tiny_service(), StreamingConfig(interim_interval_s=0.05,
                                         min_turn_s=0.1),
        host="127.0.0.1", port=free_port())

    async def scenario(client):
        out = {"started": await client.start_session()}
        audio = np.concatenate([_speech(1.0), np.zeros(16_000, np.float32)])
        for i in range(0, len(audio), 4000):
            await client.send_audio(audio[i:i + 4000])
        out["msgs"] = await _recv_until(
            client, lambda m: m["type"] == "transcription" and m["is_final"])
        await client.ws.send(json.dumps({"type": "get_status"}))
        out["status"] = (await _recv_until(
            client, lambda m: m["type"] == "status"))[-1]
        await client.end_session()
        out["ended"] = (await _recv_until(
            client, lambda m: m["type"] == "session_ended"))[-1]
        return out

    out = _run_session(server, scenario)
    assert out["started"]["type"] == "session_started"
    final = out["msgs"][-1]
    assert final["turn"] == 1 and final["text"] and \
        0.0 <= final["confidence"] <= 1.0
    assert not [m for m in out["msgs"] if m["type"] == "error"]
    assert out["status"]["turns"] >= 1
    assert out["ended"]["type"] == "session_ended"
    assert server.get_server_stats()["total_transcriptions"] >= 1


def test_realtime_flush_and_errors():
    """Invalid JSON and an unknown type are answered with errors; flush
    forces a final transcription; a failing transcriber is answered with
    an error message and the session goes on."""
    asr = _tiny_service()
    server = RealtimeASRServer(asr, StreamingConfig(min_turn_s=0.05),
                               host="127.0.0.1", port=free_port())
    transcribe = asr.transcribe

    def fault(*a, **kw):
        raise RuntimeError("CUDA error: device lost")

    async def scenario(client):
        out = {}
        await client.start_session()
        await client.ws.send("not json")
        out["err"] = await client.recv()
        await client.ws.send('{"type": "bogus"}')
        out["unknown"] = await client.recv()
        await client.send_audio(_speech(0.4, seed=2))
        await client.flush()
        out["flushed"] = (await _recv_until(
            client, lambda m: m["type"] == "transcription"
            and m["is_final"]))[-1]
        asr.transcribe = fault
        await client.send_audio(_speech(0.4, seed=3))
        await client.flush()
        out["fault"] = await client.recv()
        asr.transcribe = transcribe
        await client.flush()
        out["after"] = (await _recv_until(
            client, lambda m: m["type"] == "transcription"))[-1]
        return out

    out = _run_session(server, scenario)
    assert out["err"]["type"] == "error"
    assert "unknown" in out["unknown"]["error"]
    assert out["flushed"]["is_final"] is True
    assert out["fault"]["type"] == "error" and \
        "device lost" in out["fault"]["error"]
    assert out["after"]["is_final"] is True and out["after"]["turn"] == 2
