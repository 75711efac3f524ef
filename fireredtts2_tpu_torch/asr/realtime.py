"""Realtime streaming ASR over WebSocket.

Counterpart of ``fireredtts2_tpu/asr/realtime.py``: a WebSocket server
that takes binary PCM16 frames per session, runs ``serve/vad.py``'s hybrid
energy and spectral VAD over them, transcribes on end-of-turn (and at an
interim cadence), and answers the same messages (session control,
transcriptions with is_final, status); ``RealtimeASRClient`` is its
client. The transcriber is the port's ``WhisperASR``, run in a thread
executor so the socket loop stays responsive. ``websockets`` is imported
when a server starts or a client connects, not before.

One difference from the JAX server, which lets an exception of its
executor escape the connection handler: a transcription that raises (a
device fault; ``WhisperASR.transcribe`` logs and answers other failures
with an empty result) is logged and answered with {"type": "error"}.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from fireredtts2_tpu_torch.serve.vad import HybridVAD, VADConfig, VADState
from fireredtts2_tpu_torch.utils.audio_io import pcm16_to_f32

log = logging.getLogger(__name__)


@dataclass
class StreamingConfig:
    """The session knobs (JAX's StreamingConfig)."""
    sample_rate: int = 16_000
    interim_interval_s: float = 1.0     # cadence of non-final transcripts
    max_buffer_s: float = 30.0
    min_turn_s: float = 0.3             # ignore blips shorter than this


@dataclass
class _Session:
    session_id: str
    ws: Any
    buffer: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    vad: HybridVAD = field(default_factory=lambda: HybridVAD(VADConfig()))
    last_interim: float = field(default_factory=time.monotonic)
    turn_count: int = 0
    created_at: float = field(default_factory=time.time)


class RealtimeASRServer:
    """WebSocket streaming transcription.

    Protocol:
      binary frame           -> PCM16 mono audio at cfg.sample_rate
      {"type": "start_session"}        -> {"type": "session_started", id}
      {"type": "end_session"}          -> final transcript + session_ended
      {"type": "flush"}                -> force-transcribe the buffer now
      {"type": "get_status"}           -> {"type": "status", ...}
    Server pushes {"type": "transcription", text, confidence, is_final,
    turn} on VAD end-of-turn (final) and on interim cadence (non-final).
    """

    def __init__(self, asr, config: Optional[StreamingConfig] = None,
                 host: str = "0.0.0.0", port: int = 8766):
        self.asr = asr
        self.cfg = config or StreamingConfig()
        self.host, self.port = host, port
        self.sessions: Dict[str, _Session] = {}
        self._server = None
        self.started = time.time()
        self.total_transcriptions = 0

    # ------------------------------------------------------------ lifecycle

    async def start(self) -> None:
        import websockets

        self._server = await websockets.serve(self._handle, self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # ------------------------------------------------------------- handling

    async def _handle(self, ws) -> None:
        sess = _Session(session_id=uuid.uuid4().hex, ws=ws)
        self.sessions[sess.session_id] = sess
        try:
            async for raw in ws:
                if isinstance(raw, (bytes, bytearray)):
                    await self._on_audio(sess, bytes(raw))
                else:
                    await self._on_control(sess, raw)
        finally:
            self.sessions.pop(sess.session_id, None)

    async def _send(self, sess: _Session, obj: dict) -> None:
        await sess.ws.send(json.dumps(obj))

    async def _on_control(self, sess: _Session, raw: str) -> None:
        try:
            msg = json.loads(raw)
        except json.JSONDecodeError:
            await self._send(sess, {"type": "error", "error": "invalid json"})
            return
        mtype = msg.get("type")
        if mtype == "start_session":
            sess.buffer = np.zeros(0, np.float32)
            sess.vad.reset()
            await self._send(sess, {"type": "session_started",
                                    "session_id": sess.session_id,
                                    "sample_rate": self.cfg.sample_rate})
        elif mtype == "end_session":
            await self._transcribe(sess, is_final=True)
            await self._send(sess, {"type": "session_ended",
                                    "session_id": sess.session_id,
                                    "turns": sess.turn_count})
        elif mtype == "flush":
            await self._transcribe(sess, is_final=True)
        elif mtype == "get_status":
            await self._send(sess, {
                "type": "status", "session_id": sess.session_id,
                "buffered_s": len(sess.buffer) / self.cfg.sample_rate,
                "vad_state": sess.vad.state.value,
                "turns": sess.turn_count})
        else:
            await self._send(sess, {"type": "error",
                                    "error": f"unknown message type: {mtype}"})

    async def _on_audio(self, sess: _Session, data: bytes) -> None:
        audio = pcm16_to_f32(data)
        sess.buffer = np.concatenate([sess.buffer, audio])
        cap = int(self.cfg.max_buffer_s * self.cfg.sample_rate)
        if len(sess.buffer) > cap:
            sess.buffer = sess.buffer[-cap:]

        # VAD over the new audio only; end-of-turn triggers a final pass
        events = sess.vad.process_audio(audio)
        if any(e.kind == "speech_end" for e in events):
            if len(sess.buffer) >= self.cfg.min_turn_s * self.cfg.sample_rate:
                await self._transcribe(sess, is_final=True)
            else:
                sess.buffer = np.zeros(0, np.float32)
        elif (sess.vad.state in (VADState.SPEECH, VADState.SPEECH_TO_SILENCE)
              and time.monotonic() - sess.last_interim
              >= self.cfg.interim_interval_s):
            await self._transcribe(sess, is_final=False)

    async def _transcribe(self, sess: _Session, is_final: bool) -> None:
        if sess.buffer.size == 0:
            return
        buf = sess.buffer
        loop = asyncio.get_running_loop()
        # the model call blocks; keep the socket loop responsive
        try:
            result = await loop.run_in_executor(
                None, lambda: self.asr.transcribe(buf, self.cfg.sample_rate))
        except Exception as e:
            log.exception("realtime transcription failed")
            await self._send(sess, {"type": "error",
                                    "error": f"transcription failed: {e}"})
            return
        self.total_transcriptions += 1
        sess.last_interim = time.monotonic()
        if is_final:
            sess.turn_count += 1
            sess.buffer = np.zeros(0, np.float32)
            sess.vad.reset()
        await self._send(sess, {
            "type": "transcription", "session_id": sess.session_id,
            "text": result.text, "confidence": result.confidence,
            "language": result.language, "is_final": is_final,
            "turn": sess.turn_count,
            "processing_time_ms": result.processing_time_ms})

    def get_server_stats(self) -> Dict[str, Any]:
        return {"active_sessions": len(self.sessions),
                "total_transcriptions": self.total_transcriptions,
                "uptime_s": time.time() - self.started}


class RealtimeASRClient:
    """Async client of RealtimeASRServer."""

    def __init__(self, url: str):
        self.url = url
        self.ws = None

    async def connect(self) -> None:
        import websockets

        self.ws = await websockets.connect(self.url)

    async def close(self) -> None:
        if self.ws is not None:
            await self.ws.close()

    async def start_session(self) -> dict:
        await self.ws.send(json.dumps({"type": "start_session"}))
        return json.loads(await self.ws.recv())

    async def send_audio(self, audio: np.ndarray) -> None:
        pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
        await self.ws.send(pcm)

    async def flush(self) -> None:
        await self.ws.send(json.dumps({"type": "flush"}))

    async def end_session(self) -> None:
        await self.ws.send(json.dumps({"type": "end_session"}))

    async def recv(self, timeout: float = 30.0) -> dict:
        return json.loads(await asyncio.wait_for(self.ws.recv(), timeout))
