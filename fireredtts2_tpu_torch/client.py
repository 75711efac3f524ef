"""Python client for a running fireredtts2_tpu_torch server.

Counterpart of ``fireredtts2_tpu/client.py``: the whole surface — REST,
the OpenAI-compatible routes, and the WebSocket streaming protocol — with
numpy in/out and no dependencies beyond the stdlib (+ `websockets`,
imported only by the streaming WebSocket methods). The synthesis methods
also take the port server's ``seed`` (the request's noise seed).

    from fireredtts2_tpu_torch.client import FireRedTTSClient

    c = FireRedTTSClient("http://host:8080", api_key=token)
    audio = c.synthesize("[S1]Hello there.")            # np.float32 @24k
    for chunk in c.synthesize_streaming("[S1]Hi."):     # low-latency
        play(chunk)
    wav_bytes = c.speech("Hello", response_format="wav")  # OpenAI-compat
    text = c.transcribe(mic_audio)       # needs serve --asr (see transcribe)
    pid = c.create_voice("alice", "reference text", ref_wav)
    cloned = c.clone_speech("New words.", pid)
"""

from __future__ import annotations

import json
import urllib.request
from typing import Iterator, Optional

import numpy as np


def _pcm16_to_f32(raw: bytes) -> np.ndarray:
    return np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0


def _with_seed(obj: dict, seed: Optional[int]) -> dict:
    if seed is not None:
        obj["seed"] = int(seed)
    return obj


def _f32_to_pcm16_hex(audio: np.ndarray) -> str:
    pcm = (np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
           * 32767.0).astype("<i2")
    return pcm.tobytes().hex()


class FireRedTTSClient:
    """Client for the HTTP/WS servers (`python -m fireredtts2_tpu_torch
    serve`).

    base_url: the HTTP server (default port 8080). ws_url: the WebSocket
    server (default port 8765; derived from base_url's host when omitted).
    api_key: bearer token when the server runs --require-auth.
    """

    def __init__(self, base_url: str = "http://127.0.0.1:8080",
                 ws_url: Optional[str] = None,
                 api_key: Optional[str] = None, timeout: float = 600.0):
        self.base_url = base_url.rstrip("/")
        host = self.base_url.split("://", 1)[-1].rsplit(":", 1)[0]
        self.ws_url = ws_url or f"ws://{host}:8765"
        self.api_key = api_key
        self.timeout = timeout

    # ------------------------------------------------------------- HTTP

    def _headers(self, ctype: str = "application/json") -> dict:
        h = {"Content-Type": ctype}
        if self.api_key:
            h["Authorization"] = f"Bearer {self.api_key}"
        return h

    def _post(self, path: str, obj: dict) -> dict:
        req = urllib.request.Request(
            self.base_url + path, data=json.dumps(obj).encode(),
            headers=self._headers(), method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    def _get(self, path: str) -> dict:
        req = urllib.request.Request(self.base_url + path,
                                     headers=self._headers())
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    def health(self) -> dict:
        return self._get("/health")

    def stats(self) -> dict:
        return self._get("/stats")

    # -------------------------------------------------------------- TTS

    def synthesize(self, text: str, speaker: str = "[S1]",
                   temperature: float = 0.9, top_k: int = 20,
                   max_audio_length_ms: float = 30_000,
                   seed: Optional[int] = None) -> tuple[np.ndarray, int]:
        """Blocking synthesis -> (float32 audio, sample_rate)."""
        out = self._post("/api/v1/tts/generate", _with_seed({
            "text": text, "speaker": speaker, "temperature": temperature,
            "top_k": top_k, "max_audio_length_ms": max_audio_length_ms},
            seed))
        return _pcm16_to_f32(bytes.fromhex(out["data"])), out["sample_rate"]

    def synthesize_streaming(self, text: str, speaker: str = "[S1]",
                             max_audio_length_ms: float = 30_000,
                             chunk_bytes: int = 32_768,
                             temperature: float = 0.9, top_k: int = 20,
                             seed: Optional[int] = None
                             ) -> Iterator[np.ndarray]:
        """Chunked-transfer streaming -> float32 chunks as they decode."""
        req = urllib.request.Request(
            self.base_url + "/api/v1/tts/generate-streaming",
            data=json.dumps(_with_seed({
                "text": text, "speaker": speaker,
                "temperature": temperature, "top_k": top_k,
                "max_audio_length_ms": max_audio_length_ms}, seed)).encode(),
            headers=self._headers(), method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            carry = b""
            while True:
                raw = r.read(chunk_bytes)
                if not raw:
                    break
                raw, carry = carry + raw, b""
                if len(raw) % 2:                 # pcm16 alignment
                    raw, carry = raw[:-1], raw[-1:]
                if raw:
                    yield _pcm16_to_f32(raw)

    def stream_ws(self, text: str, max_audio_length_ms: float = 30_000,
                  temperature: float = 0.9, top_k: int = 20,
                  seed: Optional[int] = None) -> Iterator[np.ndarray]:
        """WebSocket streaming (lowest latency; runs its own event loop —
        use the async protocol directly inside an existing loop)."""
        import asyncio
        import queue as _q
        import threading

        out: "_q.Queue" = _q.Queue()

        async def run():
            import websockets

            async with websockets.connect(self.ws_url,
                                          max_size=1 << 24) as ws:
                msg: dict = _with_seed({
                    "type": "generate_speech", "text": text,
                    "streaming": True, "temperature": temperature,
                    "top_k": top_k,
                    "max_audio_length_ms": max_audio_length_ms}, seed)
                if self.api_key:
                    msg["token"] = self.api_key
                await ws.send(json.dumps(msg))
                while True:
                    m = json.loads(await asyncio.wait_for(
                        ws.recv(), self.timeout))
                    if m["type"] == "audio_chunk":
                        out.put(_pcm16_to_f32(bytes.fromhex(m["data"])))
                    elif m["type"] == "generation_complete":
                        out.put(None)
                        return
                    elif m["type"] == "error":
                        out.put(RuntimeError(m.get("error", "server error")))
                        return

        threading.Thread(target=lambda: asyncio.run(run()),
                         daemon=True).start()
        while True:
            item = out.get(timeout=self.timeout)
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def stream_dialogue_ws(self, text_list: list[str],
                           voices: Optional[dict] = None,
                           max_utterance_ms: float = 30_000
                           ) -> Iterator[tuple[int, np.ndarray]]:
        """WebSocket streaming dialogue -> (utterance_index, chunk) pairs.
        voices: optional {"[S1]": <profile id or name>} clone mapping
        (server needs --voice-dir)."""
        import asyncio
        import queue as _q
        import threading

        out: "_q.Queue" = _q.Queue()

        async def run():
            import websockets

            async with websockets.connect(self.ws_url,
                                          max_size=1 << 24) as ws:
                msg: dict = {"type": "generate_dialogue",
                             "text_list": list(text_list),
                             "max_utterance_ms": max_utterance_ms}
                if voices:
                    msg["voices"] = dict(voices)
                if self.api_key:
                    msg["token"] = self.api_key
                await ws.send(json.dumps(msg))
                while True:
                    m = json.loads(await asyncio.wait_for(
                        ws.recv(), self.timeout))
                    if m["type"] == "audio_chunk":
                        out.put((int(m["utterance"]),
                                 _pcm16_to_f32(bytes.fromhex(m["data"]))))
                    elif m["type"] == "generation_complete":
                        out.put(None)
                        return
                    elif m["type"] == "error":
                        out.put(RuntimeError(m.get("error", "server error")))
                        return

        threading.Thread(target=lambda: asyncio.run(run()),
                         daemon=True).start()
        while True:
            item = out.get(timeout=self.timeout)
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    # -------------------------------------------------- OpenAI-compat

    def speech(self, input: str, voice: Optional[str] = None,
               response_format: str = "wav",
               temperature: Optional[float] = None,
               seed: Optional[int] = None,
               max_audio_length_ms: Optional[float] = None) -> bytes:
        """POST /v1/audio/speech -> binary audio (wav | pcm). The port's
        extensions: seed, max_audio_length_ms (default 30 s)."""
        body: dict = _with_seed({"model": "fireredtts2", "input": input,
                                 "response_format": response_format}, seed)
        if temperature is not None:
            body["temperature"] = temperature
        if max_audio_length_ms is not None:
            body["max_audio_length_ms"] = max_audio_length_ms
        if voice:
            body["voice"] = voice
        req = urllib.request.Request(
            self.base_url + "/v1/audio/speech",
            data=json.dumps(body).encode(), headers=self._headers(),
            method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return r.read()

    def transcribe(self, audio: np.ndarray, sample_rate: int = 16_000
                   ) -> str:
        """POST /v1/audio/transcriptions -> the transcript. The server
        must run with ``serve --asr`` (503 otherwise): ``--asr-dir DIR``
        names a local HF whisper checkpoint (config.json and
        model.safetensors or pytorch_model.bin); without it the server
        transcribes with a tiny random-weight dev model. The server's
        decoding is its WhisperASR's ASRConfig: greedy with the
        temperature-fallback ladder by default; beam_size (beam search on
        the T = 0 rung), best_of (best-of-N on the T > 0 rungs) and
        word_timestamps all work there, and the route answers the text
        alone."""
        out = self._post("/v1/audio/transcriptions", {
            "data": _f32_to_pcm16_hex(audio), "sample_rate": sample_rate})
        return out["text"]

    # ------------------------------------------------------------ voices

    def create_voice(self, name: str, reference_text: str,
                     audio: np.ndarray, sample_rate: int = 16_000) -> str:
        """Store a voice profile -> profile_id."""
        out = self._post("/api/v1/voices/create", {
            "name": name, "reference_text": reference_text,
            "data": _f32_to_pcm16_hex(audio), "sample_rate": sample_rate})
        return out["profile_id"]

    def list_voices(self) -> list[dict]:
        return self._get("/api/v1/voices")["voices"]

    def clone_speech(self, text: str, profile_id: str,
                     temperature: float = 0.75,
                     seed: Optional[int] = None,
                     max_audio_length_ms: Optional[float] = None
                     ) -> tuple[np.ndarray, int]:
        """Synthesize in a stored voice -> (float32 audio, sample_rate);
        max_audio_length_ms caps each text chunk (default 400 frames)."""
        body = _with_seed({"text": text, "voice_profile_id": profile_id,
                           "temperature": temperature}, seed)
        if max_audio_length_ms is not None:
            body["max_audio_length_ms"] = max_audio_length_ms
        out = self._post("/api/v1/tts/clone", body)
        return _pcm16_to_f32(bytes.fromhex(out["data"])), out["sample_rate"]

    # ----------------------------------------------------- conversations

    def start_conversation(self, **metadata) -> str:
        return self._post("/api/v1/conversations/start",
                          metadata)["session_id"]

    def conversation_turn(self, session_id: str, text: str,
                          **params) -> dict:
        """Text turn -> {"response_text", "data" (hex pcm16), ...};
        params: the reply's synthesis fields (max_audio_length_ms, top_k,
        temperature, seed, ...)."""
        return self._post(f"/api/v1/conversations/{session_id}/turn",
                          dict(params, text=text))

    def admin_reload(self, pretrained_dir: str,
                     timeout_s: float = 300.0) -> dict:
        """Hot-swap the server's checkpoint weights (drains live streams;
        serve/server.py /api/v1/admin/reload). Same auth as every API
        route; the dir must hold the same model shapes."""
        return self._post("/api/v1/admin/reload",
                          {"dir": pretrained_dir, "timeout_s": timeout_s})
