"""PyTorch port, the serving front end's ops modules on the CPU:

- the modules kept as copies (sessions, security, VAD, the web UI, the
  responders of s2s and llm, qa's validators and scorers) behave as the
  JAX package's modules on the same inputs (copy drift: an edit on one
  side shows here);
- the modules that differ: monitor (the CUDA allocator's memory, the CPU
  report), voices over the port engine's encoder, the speech-to-speech
  pipeline with a transcriber passed in;
- ``utils/audio_io.py``'s PCM16 packing against the JAX package's numpy
  route;
- ``runtime/perf.py: load_perf_budget`` reads the port's own budget.

Tolerances: exact where both sides run the same Python.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import fireredtts2_tpu.serve.llm as j_llm
import fireredtts2_tpu.serve.qa as j_qa
import fireredtts2_tpu.serve.s2s as j_s2s
import fireredtts2_tpu.serve.security as j_sec
import fireredtts2_tpu.serve.sessions as j_sess
import fireredtts2_tpu.serve.vad as j_vad
import fireredtts2_tpu.serve.voices as j_voices
import fireredtts2_tpu.serve.webui as j_webui
from fireredtts2_tpu.serve.monitor import (
    analyze_audio_quality as j_quality,
)

import fireredtts2_tpu_torch.serve.llm as t_llm
import fireredtts2_tpu_torch.serve.qa as t_qa
import fireredtts2_tpu_torch.serve.s2s as t_s2s
import fireredtts2_tpu_torch.serve.security as t_sec
import fireredtts2_tpu_torch.serve.sessions as t_sess
import fireredtts2_tpu_torch.serve.vad as t_vad
import fireredtts2_tpu_torch.serve.voices as t_voices
import fireredtts2_tpu_torch.serve.webui as t_webui
from fireredtts2_tpu_torch.runtime import perf as t_perf
from fireredtts2_tpu_torch.serve import monitor as t_mon
from fireredtts2_tpu_torch.utils import audio_io as t_audio

from _torch_parity import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _speech_like(rng, n, sr=16_000):
    t = np.arange(n) / sr
    sig = sum(np.sin(2 * np.pi * f * t) for f in (300, 600, 1200, 2400))
    return (0.3 * sig / 4 + 0.001 * rng.standard_normal(n)).astype(np.float32)


def _turn_audio(rng, sr=16_000):
    return np.concatenate([
        0.0005 * rng.standard_normal(sr // 2).astype(np.float32),
        _speech_like(rng, sr),
        0.0005 * rng.standard_normal(sr).astype(np.float32),
        _speech_like(rng, int(0.12 * sr)),
        0.0005 * rng.standard_normal(sr // 2).astype(np.float32),
    ])


# ---------------------------------------------------------------------------
# Copy drift: the port's copies behave as the JAX modules
# ---------------------------------------------------------------------------


def _session_trace(mod, d):
    """A session manager's life -> its observable state, ids and times
    stripped."""
    mgr = mod.SessionManager(persist_dir=d, max_context_turns=3)
    s = mgr.create_session({"user": "x"})
    for i in range(5):
        mgr.add_turn(s.session_id, "user" if i % 2 == 0 else "assistant",
                     f"turn {i}", audio_duration_s=0.1 * i)
    ctx = [(t.role, t.text, t.audio_duration_s)
           for t in mgr.context_window(s.session_id, 2)]
    again = mod.SessionManager(persist_dir=d, max_context_turns=3)
    js = again.get(s.session_id).to_json()
    out = dict(ctx=ctx, active=mgr.active_count, reloaded_turns=[
        (t["role"], t["text"]) for t in js["turns"]],
        keys=sorted(js), metadata=js["metadata"])
    mgr.end_session(s.session_id)
    out["after_end"] = (mgr.get(s.session_id) is None, mgr.active_count)
    short = mod.SessionManager(expiry_seconds=0.0)
    short.create_session()
    time.sleep(0.01)
    out["expired"] = short.cleanup_expired()
    return out


def test_sessions_copy_matches_jax(tmp_path):
    assert _session_trace(t_sess, str(tmp_path / "t")) == \
        _session_trace(j_sess, str(tmp_path / "j"))


def test_vad_copy_matches_jax(rng):
    audio = _turn_audio(rng)
    for cfg in ({}, {"min_speech_ms": 250}, {"energy_weight": 0.8}):
        tv = t_vad.HybridVAD(t_vad.VADConfig(**cfg))
        jv = j_vad.HybridVAD(j_vad.VADConfig(**cfg))
        te, je = tv.process_audio(audio), jv.process_audio(audio)
        assert [(e.kind, e.timestamp, e.duration_ms) for e in te] == \
            [(e.kind, e.timestamp, e.duration_ms) for e in je]
        assert te, "the test audio must hold a speech turn"
        assert tv.state.value == jv.state.value
        n = tv.cfg.frame_size
        assert [tv.frame_decision(audio[i:i + n]) for i in range(0, 8000, n)] \
            == [jv.frame_decision(audio[i:i + n]) for i in range(0, 8000, n)]


TEXTS = ["Hello, world! 你好。", "Line one.\nLine two.", "", "   ", "a" * 10_001,
         "'; DROP TABLE users; --", "<script>alert(1)</script>",
         "see ../../etc/passwd", "x; rm -rf /", "javascript:void(0)",
         "null\x00byte", "[S1]A normal dialogue line."]


def test_security_copy_matches_jax():
    for t in TEXTS:
        a, b = t_sec.validate_text_input(t), j_sec.validate_text_input(t)
        assert (a.ok, a.reason) == (b.ok, b.reason), t
    for data, cap in ((b"RIFF" + b"\x00" * 4 + b"WAVE" + b"\x00" * 100, None),
                      (b"fLaC" + b"\x00" * 100, None),
                      (b"MZ\x90\x00" + b"\x00" * 100, None), (b"RIFF", 2)):
        kw = {} if cap is None else {"max_bytes": cap}
        a = t_sec.validate_audio_upload(data, **kw)
        b = j_sec.validate_audio_upload(data, **kw)
        assert (a.ok, a.reason) == (b.ok, b.reason)
    tr, jr = t_sec.RateLimiter(3, 10.0), j_sec.RateLimiter(3, 10.0)
    steps = [("c", 100.0 + i) for i in range(5)] + [("o", 103.0), ("c", 111.0)]
    assert [tr.allow(c, t) for c, t in steps] == [jr.allow(c, t) for c, t in steps]
    ta = t_sec.TokenAuthenticator(b"k" * 32, ttl_seconds=60)
    ja = j_sec.TokenAuthenticator(b"k" * 32, ttl_seconds=60)
    tok = ta.issue("client-1", now=1000.0)
    assert tok == ja.issue("client-1", now=1000.0)
    for probe, now in ((tok, 1010.0), (tok + "x", 1010.0), (tok, 5000.0),
                       (tok.replace("client-1", "client-2"), 1010.0)):
        assert ta.verify(probe, now=now) == ja.verify(probe, now=now)
    for kw in ({}, {"require_auth": True}):
        ts, js = t_sec.create_security_system(**kw), j_sec.create_security_system(**kw)
        for text in ("Hello there", "<script>x</script>"):
            a, b = ts.check_request("c1", text), js.check_request("c1", text)
            assert (a.ok, a.reason) == (b.ok, b.reason)


def test_webui_copy_matches_jax():
    page = t_webui.demo_page(8765)
    assert page.replace("fireredtts2_tpu_torch", "fireredtts2_tpu") == \
        j_webui.demo_page(8765)
    assert "8765" in page and "/api/v1/tts/clone" in page


PROMPTS = ["hello there", "Hi, how are you?", "What's your name?", "thanks!",
           "bye now", "weather today?", "what can you do", "Is it true?",
           "I went for a walk."]


def test_responders_copy_match_jax():
    tr, jr = t_s2s.RuleBasedResponder(seed=3), j_s2s.RuleBasedResponder(seed=3)
    assert [tr(p, []) for p in PROMPTS * 2] == [jr(p, []) for p in PROMPTS * 2]

    def boom(text, history):
        raise ConnectionError("down")

    for mod in (t_s2s, j_s2s):
        chain = mod.ResponderChain([boom, lambda t, h: "",
                                    mod.RuleBasedResponder(seed=0)])
        assert chain("hello", []) in ("Hello! How can I help you today?",
                                      "Hi there! What can I do for you?")
        with pytest.raises(ConnectionError):
            mod.ResponderChain([boom])("hi", [])
        assert mod.ResponderChain([lambda t, h: " "])("hi", []) == \
            "I'm sorry, I didn't catch that."
    hist = [("user", f"u{i}") if i % 2 == 0 else ("assistant", f"a{i}")
            for i in range(14)]
    to = t_llm.OpenAICompatResponder("http://127.0.0.1:1/v1", api_key="k")
    jo = j_llm.OpenAICompatResponder("http://127.0.0.1:1/v1", api_key="k")
    assert to._messages("now?", hist) == jo._messages("now?", hist)
    assert to.stats() == jo.stats()
    for kw in ({}, {"primary": "openai", "openai_base_url": "http://x/v1",
                    "hf_model_dir": "/nonexistent"}):
        tc, jc = t_llm.build_responder_chain(**kw), j_llm.build_responder_chain(**kw)
        assert [type(r).__name__ for r in tc.responders] == \
            [type(r).__name__ for r in jc.responders]


def test_hf_responder_copy_matches_jax(tmp_path):
    """The local HF backend: a tiny random GPT-2 with a word-level
    tokenizer, saved locally; greedy replies and stats equal."""
    torch.manual_seed(0)
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import (
        GPT2Config, GPT2LMHeadModel, PreTrainedTokenizerFast,
    )

    words = ["hello", "world", "how", "are", "you", "good", "fine", "thanks"]
    vocab = {"<|endoftext|>": 0, "<unk>": 1}
    vocab.update({w: i + 2 for i, w in enumerate(words)})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="<|endoftext|>",
                            unk_token="<unk>", pad_token="<|endoftext|>"
                            ).save_pretrained(tmp_path)
    GPT2LMHeadModel(GPT2Config(vocab_size=len(vocab), n_positions=64,
                               n_embd=16, n_layer=1, n_head=2)
                    ).save_pretrained(tmp_path)
    hist = [("user", "hello"), ("assistant", "hello world")]
    replies = []
    for mod in (t_llm, j_llm):
        r = mod.HFCausalLMResponder(str(tmp_path), max_new_tokens=6,
                                    greedy=True)
        replies.append((r("how are you", hist), r.total_generations))
    assert replies[0] == replies[1]


def test_hf_responder_raises_without_transformers(monkeypatch):
    """The HF backend imports transformers only when it loads, and raises
    where it is absent, as the JAX one does."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    for mod in (t_llm, j_llm):
        r = mod.HFCausalLMResponder("/nonexistent/model/dir")
        with pytest.raises(ImportError):
            r("hello", [])


def test_qa_validators_and_scorers_copy_match_jax(rng):
    sr = 24_000
    t = np.arange(sr) / sr
    cases = [
        (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32),
        np.concatenate([0.001 * rng.standard_normal(sr // 2),
                        0.5 * np.sin(2 * np.pi * 440 * t[:sr // 2])]
                       ).astype(np.float32),
        np.zeros(sr, np.float32),
        np.clip(2.0 * np.sin(2 * np.pi * 100 * t), -1.5, 1.5).astype(np.float32),
        np.zeros(10, np.float32),
    ]
    ths = [None, (t_qa.QAThresholds(min_snr_db=-100.0, max_silence_ratio=1.0,
                                    min_rms=0.0),
                  j_qa.QAThresholds(min_snr_db=-100.0, max_silence_ratio=1.0,
                                    min_rms=0.0))]
    for audio in cases:
        assert t_mon.analyze_audio_quality(audio, sr) == j_quality(audio, sr)
        for th in ths:
            a = t_qa.validate_audio_output(audio, sr, th and th[0])
            b = j_qa.validate_audio_output(audio, sr, th and th[1])
            assert (a.passed, a.score, a.checks, a.failures) == \
                (b.passed, b.score, b.checks, b.failures)
    pairs = [("the cat sat on the mat", "the cat sat on mat"),
             ("Hello world", "hello  world"), ("", "x"), ("abc", "")]
    for ref, hyp in pairs:
        assert t_qa.word_error_rate(ref, hyp) == j_qa.word_error_rate(ref, hyp)
        assert t_qa.char_error_rate(ref, hyp) == j_qa.char_error_rate(ref, hyp)
    a, b = cases[1][:16_000], cases[0][:16_000]
    assert t_qa.speaker_similarity(a, b) == j_qa.speaker_similarity(a, b)
    np.testing.assert_array_equal(t_qa.spectral_speaker_embedding(a),
                                  j_qa.spectral_speaker_embedding(a))
    assert [f.name for f in dataclasses.fields(t_qa.FidelityReport)] == \
        [f.name for f in dataclasses.fields(j_qa.FidelityReport)]


def test_voice_store_matches_jax(tmp_path, rng):
    """Profiles, stored prompt tokens and the dialogue mapping, over the
    same fake encoder, as the JAX store keeps them."""
    audio = _speech_like(rng, 40_000)

    def encoder(a):
        return (np.arange(12, dtype=np.int32).reshape(3, 4),
                np.ones((3, 4), bool))

    out = []
    for mod, d in ((t_voices, tmp_path / "t"), (j_voices, tmp_path / "j")):
        store = mod.VoiceProfileManager(str(d))
        a = store.create_profile("alice", "[S1]Hi.", audio16k=audio,
                                 metadata={"language": "en"}, encoder=encoder)
        b = store.create_profile("bob", "Yo.", audio16k=audio[:8000])
        again = mod.VoiceProfileManager(str(d))
        wavs, texts = again.dialogue_prompts({"[S2]": b.profile_id,
                                              "[S1]": a.profile_id})
        frames, mask = again.prompt_tokens(a.profile_id)
        out.append(dict(
            quality=(a.quality, b.quality), names=[p.name for p in
                                                   again.list_profiles()],
            texts=texts, wavs=[os.path.basename(w) == f"{p}.wav" for w, p in
                               zip(wavs, (a.profile_id, b.profile_id))],
            tokens=(frames.tolist(), mask.tolist()),
            no_tokens=again.prompt_tokens(b.profile_id) is None,
            by_name=again.by_name("bob").profile_id == b.profile_id,
            deleted=(again.delete(a.profile_id), again.delete(a.profile_id)),
            left=len(os.listdir(d))))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# Modules that differ from the JAX ones
# ---------------------------------------------------------------------------


def test_monitor_cpu_stats_and_tracking():
    assert t_mon.device_memory_stats("cpu") == {"platform": "cpu"}
    mon = t_mon.PerformanceMonitor()
    mon.start_inference("r1")
    mon.record_first_packet("r1")
    mon.record_frame("r1", 10)
    rec = mon.end_inference("r1", audio_seconds=0.8)
    assert rec.first_packet_s is not None and rec.rtf > 0
    mon.start_inference("r2")
    mon.end_inference("r2", error=True)
    s = mon.summary("cpu")
    assert s["requests"] == 2 and s["errors"] == 1 and s["frames"] == 10
    assert "first_packet_ms_p50" in s and s["device"] == {"platform": "cpu"}
    assert t_mon.reset_performance_monitor() is t_mon.get_performance_monitor()


class _FakeEngine:
    output_sample_rate = 24_000

    def __init__(self):
        self.texts = []

    def generate(self, text, speaker, context, max_audio_length_ms=30_000):
        self.texts.append(text)
        return np.full(2400, 0.1, np.float32)


def test_s2s_pipeline_with_transcriber_passed_in():
    eng = _FakeEngine()
    p = t_s2s.SpeechToSpeechPipeline(eng)
    r = p.process_text_input("hello there")
    assert r.response_text in ("Hello! How can I help you today?",
                               "Hi there! What can I do for you?")
    assert eng.texts == [r.response_text] and len(r.audio24k) == 2400
    sid = r.timings["session_id"]
    assert [t.role for t in p.sessions.context_window(sid)] == ["user", "assistant"]
    with pytest.raises(RuntimeError):
        p.process_audio_input(np.zeros(16_000, np.float32))
    p2 = t_s2s.SpeechToSpeechPipeline(eng, transcriber=lambda a: "thank you")
    r2 = p2.process_audio_input(np.zeros(16_000, np.float32))
    assert r2.transcript == "thank you" and "asr_s" in r2.timings
    assert r2.response_text in ("You're welcome!", "Happy to help!")


# ---------------------------------------------------------------------------
# PCM16 packing and the perf budget
# ---------------------------------------------------------------------------


def test_pcm16_packing_matches_jax_numpy_route(monkeypatch, rng):
    """utils/audio_io's PCM16 packing is the JAX package's numpy route
    (``fireredtts2_tpu/utils/native.py`` without its library), byte for
    byte, clipped at +-1."""
    import fireredtts2_tpu.utils.native as j_native

    monkeypatch.setattr(j_native, "_LIB", None)
    monkeypatch.setattr(j_native, "_TRIED", True)
    x = np.concatenate([(rng.standard_normal(4096) * 0.5),
                        [2.0, -2.0, 1.0, -1.0, 0.0]]).astype(np.float32)
    got = t_audio.f32_to_pcm16(x)
    assert got == j_native.f32_to_pcm16(x)
    assert np.frombuffer(got, "<i2")[-5:].tolist() == [32767, -32767, 32767,
                                                       -32767, 0]
    raw = rng.integers(-32768, 32768, 5000).astype("<i2").tobytes()
    np.testing.assert_array_equal(t_audio.pcm16_to_f32(raw),
                                  j_native.pcm16_to_f32(raw))


def test_pcm16_round_trip_within_one_lsb(rng):
    x = (rng.uniform(-1, 1, 10_000)).astype(np.float32)
    back = t_audio.pcm16_to_f32(t_audio.f32_to_pcm16(x))
    assert back.dtype == np.float32 and back.shape == x.shape
    assert np.abs(back - x).max() <= 2 / 32768


def test_perf_budget_is_the_ports_own(monkeypatch, tmp_path):
    """load_perf_budget reads fireredtts2_tpu_torch/perf_budget.json (the
    card's measured block frame cost), not the root's TPU budget."""
    monkeypatch.delenv("FRTTS2_PERF_BUDGET", raising=False)
    port_file = os.path.join(REPO, "fireredtts2_tpu_torch", "perf_budget.json")
    assert os.path.abspath(t_perf.DEFAULT_BUDGET) == port_file
    with open(port_file) as f:
        want = json.load(f)
    with open(os.path.join(REPO, "perf_budget.json")) as f:
        root = json.load(f)
    got = t_perf.load_perf_budget()
    assert got == want
    assert got["block_frame_cost_ms"] != root["block_frame_cost_ms"]
    assert "H100" in got["_comment"] and " W" in got["_comment"]
    p = tmp_path / "b.json"
    p.write_text(json.dumps({"block_frame_cost_ms": 1.5}))
    monkeypatch.setenv("FRTTS2_PERF_BUDGET", str(p))
    assert t_perf.load_perf_budget() == {"block_frame_cost_ms": 1.5}
    monkeypatch.setenv("FRTTS2_PERF_BUDGET", str(tmp_path / "missing.json"))
    assert t_perf.load_perf_budget() == {}


def test_perf_budget_margin_is_wider_than_its_readings():
    """The port's budget is the median of the card's readings of the block
    policy's frame cost, and the alarm's margin is wider than their
    spread: no reading trips it, a frame cost past the margin does."""
    from fireredtts2_tpu_torch.runtime.policy import RecommendationEngine

    with open(os.path.join(REPO, "fireredtts2_tpu_torch",
                           "perf_budget.json")) as f:
        b = json.load(f)
    r = b["block_frame_cost_readings_ms"]
    budget, margin = b["block_frame_cost_ms"], b["block_frame_cost_margin"]
    assert len(r) >= 3 and budget == float(np.median(r))
    assert margin > max(r) / min(r)
    rules = RecommendationEngine(device_budget_ms=budget, device_margin=margin)

    def fires(ms):
        return "device_regression" in {
            x.code for x in rules.evaluate({"device_ms_per_frame": ms})}
    assert not any(fires(x) for x in r)
    assert fires(budget * margin * 1.01)
    assert fires(budget * 1.2) == (margin < 1.2)


def test_port_imports_without_websockets_or_transformers():
    """Every port module, the server and the CLI included, imports in a
    fresh interpreter where websockets and transformers cannot be
    imported (the card's machine may lack them)."""
    import pathlib
    import subprocess

    port = pathlib.Path(REPO) / "fireredtts2_tpu_torch"
    mods = sorted(
        "fireredtts2_tpu_torch." + ".".join(p.relative_to(port).with_suffix("").parts)
        for p in port.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import sys, importlib\n"
        "for name in ('websockets', 'transformers'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr
    assert "fireredtts2_tpu_torch.serve.server" in mods
    assert "fireredtts2_tpu_torch.__main__" in mods


def test_single_worker_reload_runs_between_requests():
    """TTSService.reload swaps on the worker after the request in flight;
    one the worker has not started by its timeout raises TimeoutError and
    never runs."""
    import threading

    from fireredtts2_tpu_torch.serve.server import TTSRequest, TTSService

    gate = threading.Event()

    class Engine(_FakeEngine):
        device = torch.device("cpu")
        reloads: list = []

        def generate(self, text, speaker, context, **kw):
            gate.wait(30)
            return super().generate(text, speaker, context)

        def reload_checkpoint(self, d):
            self.reloads.append(d)

    eng = Engine()
    svc = TTSService(eng)
    done = threading.Event()
    svc.submit(TTSRequest("r1", "hi", "[S1]", 0.9, 20, False,
                          on_chunk=None, on_done=lambda a, e: done.set()))
    with pytest.raises(TimeoutError):
        svc.reload("/ckpt/a", timeout_s=0.05)
    gate.set()
    assert done.wait(30)
    svc.reload("/ckpt/b", timeout_s=30)
    assert eng.reloads == ["/ckpt/b"]
    svc.shutdown()
