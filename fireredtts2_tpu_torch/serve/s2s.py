"""Speech-to-speech pipeline: ASR -> conversation LLM -> TTS.

Counterpart of ``fireredtts2_tpu/serve/s2s.py``: the responders and the
pipeline class; the transcriber is passed in
(``asr.WhisperASR.as_transcriber()``).
Capability parity with the reference overlay:
- `speech_to_speech_interface.py` (:267-450): process_audio_input /
  process_text_input pipeline glue;
- `conversation_llm.py`: pluggable response generators with a primary/
  fallback chain (:559-679) — here a rule-based responder is built in
  (the reference's default fallback, :437-556) and external/HF backends
  plug in via the same protocol;
- `whisper_asr.py`: the ASR is a pluggable protocol (the reference wraps
  openai-whisper, which is CUDA-bound and out of the TTS core's scope —
  any callable transcriber slots in).
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Protocol

import numpy as np

from fireredtts2_tpu_torch.serve.sessions import SessionManager
from fireredtts2_tpu_torch.serve.vad import HybridVAD, VADConfig


# ---------------------------------------------------------------- protocols

class Transcriber(Protocol):
    def __call__(self, audio16k: np.ndarray) -> str: ...


class Responder(Protocol):
    def __call__(self, text: str, history: list[tuple[str, str]]) -> str: ...


# ---------------------------------------------------------------- rule LLM

_RULES: list[tuple[tuple[str, ...], list[str]]] = [
    (("hello", "hi ", "hey"), [
        "Hello! How can I help you today?",
        "Hi there! What can I do for you?"]),
    (("how are you",), [
        "I'm doing well, thanks for asking! How about you?"]),
    (("your name", "who are you"), [
        "I'm a speech assistant built on a TPU-native text to speech stack."]),
    (("thank",), ["You're welcome!", "Happy to help!"]),
    (("bye", "goodbye", "see you"), [
        "Goodbye! Have a great day!", "See you later!"]),
    (("weather",), [
        "I don't have live weather data, but I hope it's nice where you are!"]),
    (("help", "what can you do"), [
        "I can chat with you and speak my answers out loud. Ask me anything!"]),
]


class RuleBasedResponder:
    """Deterministic-ish conversational fallback (reference
    conversation_llm.py:437-556)."""

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)

    def __call__(self, text: str, history: list[tuple[str, str]]) -> str:
        lower = " " + text.lower().strip() + " "
        for keys, answers in _RULES:
            if any(k in lower for k in keys):
                return self._rng.choice(answers)
        if text.rstrip().endswith("?"):
            return "That's a good question. Let me think about it and get back to you."
        return "I see. Tell me more about that."


class ResponderChain:
    """Primary/fallback chain (reference ConversationLLMManager :559-679)."""

    def __init__(self, responders: list[Responder]):
        assert responders
        self.responders = responders

    def __call__(self, text: str, history: list[tuple[str, str]]) -> str:
        last_err: Optional[Exception] = None
        for r in self.responders:
            try:
                out = r(text, history)
                if out and out.strip():
                    return out
            except Exception as e:  # fall through to the next backend
                last_err = e
        if last_err is not None:
            raise last_err
        return "I'm sorry, I didn't catch that."


# ---------------------------------------------------------------- pipeline

@dataclass
class S2SResult:
    transcript: str
    response_text: str
    audio24k: np.ndarray
    timings: dict = field(default_factory=dict)


class SpeechToSpeechPipeline:
    """VAD-gated ASR -> LLM -> TTS with session history
    (reference speech_to_speech_interface.py:267-450)."""

    def __init__(self, engine, transcriber: Optional[Transcriber] = None,
                 responder: Optional[Responder] = None,
                 sessions: Optional[SessionManager] = None,
                 vad_config: Optional[VADConfig] = None,
                 speaker: str = "[S1]"):
        self.engine = engine
        self.transcriber = transcriber
        self.responder = responder or ResponderChain([RuleBasedResponder()])
        self.sessions = sessions or SessionManager()
        self.vad = HybridVAD(vad_config or VADConfig())
        self.speaker = speaker

    def _history(self, session_id: str) -> list[tuple[str, str]]:
        return [(t.role, t.text) for t in self.sessions.context_window(session_id)]

    def process_text_input(self, text: str, session_id: Optional[str] = None
                           ) -> S2SResult:
        """Text in -> spoken reply (reference :365)."""
        if session_id is None:
            session_id = self.sessions.create_session().session_id
        t0 = time.perf_counter()
        history = self._history(session_id)
        reply = self.responder(text, history)
        t1 = time.perf_counter()
        audio = self.engine.generate(reply, self.speaker, [],
                                     max_audio_length_ms=30_000)
        t2 = time.perf_counter()
        self.sessions.add_turn(session_id, "user", text)
        self.sessions.add_turn(session_id, "assistant", reply,
                               audio_duration_s=len(audio) / 24_000)
        return S2SResult(transcript=text, response_text=reply, audio24k=audio,
                         timings={"llm_s": t1 - t0, "tts_s": t2 - t1,
                                  "session_id": session_id})

    def process_audio_input(self, audio16k: np.ndarray,
                            session_id: Optional[str] = None) -> S2SResult:
        """Speech in -> spoken reply (reference :267). Requires a
        transcriber backend."""
        if self.transcriber is None:
            raise RuntimeError(
                "no ASR backend configured; pass transcriber= to the pipeline")
        t0 = time.perf_counter()
        transcript = self.transcriber(audio16k)
        t1 = time.perf_counter()
        result = self.process_text_input(transcript, session_id)
        result.transcript = transcript
        result.timings["asr_s"] = t1 - t0
        return result
