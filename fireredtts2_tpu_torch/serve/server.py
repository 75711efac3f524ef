"""WebSocket + HTTP serving for streaming TTS.

Counterpart of ``fireredtts2_tpu/serve/server.py``, with the same message
vocabulary, routes and payloads:
- the WebSocket protocol (generate_speech / generate_dialogue streaming
  hex-PCM16 ``audio_chunk`` messages from the real incremental decoder,
  sessions, ping, stats);
- the stdlib HTTP server: /health, /stats, /demo, REST TTS (whole and
  chunked), request status, voices CRUD, clone, conversations, admin
  reload, and the OpenAI-compatible /v1/audio/speech and
  /v1/audio/transcriptions (503 without a transcriber).

Two service modes: ``TTSService`` (one worker thread, requests in turn)
and ``BatchedTTSService`` (concurrent requests decode together through
``runtime/batcher.py: ContinuousBatcher``); pick with
``WebSocketTTSServer(max_streams=...)``.

The port's own points:
- Device work runs on one thread per service, the batcher's worker or
  TTSService's worker, each on the engine's device (its default stream,
  where the kernel wrappers launch) in inference mode. Nothing falls back
  to the CPU when a request fails: its error goes back to the client.
- The chunked REST stream starts no thread: the connection's handler
  thread submits the request with an ``on_chunk`` that feeds its queue and
  writes the chunks itself. The batched service's chunk consumers come
  from one bounded pool.
- A request may carry ``seed``: the utterance seed of its sampling noise
  (``utt_seed`` of the engine and the batcher), so a sampled request
  replays exactly; /v1/audio/speech and the clone route also take
  ``max_audio_length_ms`` (a clone's default stays 400 frames a chunk).
- ``serve()`` serves REST alone, and says so, where ``websockets`` is
  not installed; it warms the engine (CUDA) and the pool before it binds.
- Admin reload goes through the service: the batcher drains live streams
  (``ContinuousBatcher.reload``), the single worker swaps between two
  requests. It is off unless the server is given a reload root, and then
  takes only dirs under that root, reading their converted ``DIR/torch/``
  trees (no pickle is loaded).
"""

from __future__ import annotations

import asyncio
import json
import os
import queue
import sys
import threading
import time
import uuid
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional

import numpy as np
import torch

from fireredtts2_tpu_torch.serve.monitor import get_performance_monitor
from fireredtts2_tpu_torch.serve.sessions import SessionManager
from fireredtts2_tpu_torch.utils.audio_io import f32_to_pcm16, pcm16_to_f32


# Message types (the JAX server's vocabulary)
MSG_DIALOGUE_REQUEST = "generate_dialogue"
MSG_SESSION_START = "session_start"
MSG_SESSION_END = "session_end"
MSG_TTS_REQUEST = "generate_speech"
MSG_TTS_STARTED = "generation_started"
MSG_AUDIO_CHUNK = "audio_chunk"
MSG_TTS_COMPLETE = "generation_complete"
MSG_ERROR = "error"
MSG_PING = "ping"
MSG_PONG = "pong"
MSG_STATS = "get_stats"
MSG_STATS_RESPONSE = "stats"

TIMEOUT_S = 600.0               # a request's wait for its result


def pcm16_hex(audio: np.ndarray) -> str:
    """float32 [-1, 1] -> hex int16 PCM."""
    return f32_to_pcm16(audio).hex()


def _seed(obj: dict) -> Optional[int]:
    s = obj.get("seed")
    return None if s is None else int(s)


@dataclass
class TTSRequest:
    request_id: str
    text: str
    speaker: str
    temperature: float
    topk: int
    streaming: bool
    on_chunk: Any           # callable(np.ndarray) -> None (threadsafe)
    on_done: Any            # callable(np.ndarray | None, Exception | None)
    max_audio_length_ms: float = 30_000.0
    # "dialogue" (one utterance) | "monologue_clone" | "dialogue_stream"
    mode: str = "dialogue"
    prompt_wav: Optional[str] = None
    prompt_text: Optional[str] = None
    # dialogue_stream: the [S1]/[S2]-prefixed utterances; on_chunk then
    # receives (utterance_index, chunk) pairs; optional per-speaker prompts
    # (voices.dialogue_prompts format)
    text_list: Optional[list] = None
    prompt_wav_list: Optional[list] = None
    prompt_text_list: Optional[list] = None
    # pre-encoded prompt frames from the voice store (voices.prompt_tokens)
    prompt_tokens: Optional[tuple] = None
    # the utterance seed of the sampling noise (None: the engine's chain)
    seed: Optional[int] = None


def _clone_frames(req: TTSRequest) -> int:
    """A clone chunk's frame cap: the request's length cap, at most the
    engine's 400."""
    return min(400, int(req.max_audio_length_ms / 80))


def _run_clone(engine, req: TTSRequest) -> np.ndarray:
    return engine.generate_monologue(
        req.text, prompt_wav=req.prompt_wav, prompt_text=req.prompt_text,
        temperature=req.temperature, topk=req.topk,
        prompt_tokens=req.prompt_tokens, utt_seed=req.seed,
        max_frames=_clone_frames(req))


def _joined(chunks: list) -> np.ndarray:
    return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)


def _device_thread(device: torch.device) -> None:
    """Point a service thread at the engine's card: its current device
    (the default stream the kernel wrappers launch on is that device's)."""
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else torch.cuda.current_device())


class BatchedTTSService:
    """Continuous-batching front: concurrent requests decode together in
    one batched device step (``runtime/batcher.py``). Every mode batches:
    streams, clones (``generate_monologue_clone``) and dialogue
    (``run_dialogue``). Consumer threads come from one bounded pool; they
    only move chunks, device work is the batcher worker's alone."""

    def __init__(self, engine, max_streams: int = 8,
                 max_consumers: Optional[int] = None):
        from concurrent.futures import ThreadPoolExecutor

        from fireredtts2_tpu_torch.runtime.batcher import ContinuousBatcher

        self.engine = engine
        self.monitor = get_performance_monitor()
        self.batcher = ContinuousBatcher(engine, max_streams=max_streams)
        self.batcher.start()
        # Consumers block for their request's duration; past the bound,
        # requests queue in the pool (they would queue for a slot anyway).
        self._pool = ThreadPoolExecutor(
            max_workers=(max_consumers or max(8, 4 * max_streams)),
            thread_name_prefix="tts-consumer")

    def _job(self, req: TTSRequest, run: Callable[[], np.ndarray]) -> None:
        self.monitor.start_inference(req.request_id)
        try:
            audio = run()
            self.monitor.end_inference(
                req.request_id,
                audio_seconds=len(audio) / self.engine.output_sample_rate)
            req.on_done(audio, None)
        except Exception as e:  # noqa: BLE001 -- the client gets the error
            self.monitor.end_inference(req.request_id, error=True)
            req.on_done(None, e)

    def submit(self, req: TTSRequest) -> None:
        run = {"monologue_clone": self._run_clone_batched,
               "dialogue_stream": self._run_dialogue_batched}.get(
                   req.mode, self._run_stream)
        self._pool.submit(self._job, req, lambda: run(req))

    def _run_stream(self, req: TTSRequest) -> np.ndarray:
        handle = self.batcher.submit(
            req.text, req.speaker, temperature=req.temperature,
            topk=req.topk, max_audio_length_ms=req.max_audio_length_ms,
            utt_seed=req.seed)
        total = []
        for chunk in handle:
            self.monitor.record_first_packet(req.request_id)
            self.monitor.record_frame(req.request_id)
            total.append(chunk)
            if req.streaming:
                req.on_chunk(chunk)
        return _joined(total)

    def _run_dialogue_batched(self, req: TTSRequest) -> np.ndarray:
        total = []
        for i, chunk in self.batcher.run_dialogue(
                list(req.text_list or []),
                prompt_wav_list=req.prompt_wav_list,
                prompt_text_list=req.prompt_text_list,
                temperature=req.temperature, topk=req.topk,
                max_utterance_ms=req.max_audio_length_ms):
            total.append(chunk)
            if req.streaming:
                req.on_chunk((i, chunk))
        return _joined(total)

    def _run_clone_batched(self, req: TTSRequest) -> np.ndarray:
        """A clone through the shared pool; a request without a prompt is
        the plain monologue (``engine.generate_monologue``), as in JAX."""
        if req.prompt_wav is None and req.prompt_tokens is None:
            return _run_clone(self.engine, req)
        from fireredtts2_tpu_torch.utils.audio_io import load_prompt_audio_16k
        prompt_audio = (None if req.prompt_wav is None
                        else load_prompt_audio_16k(req.prompt_wav))
        return self.batcher.generate_monologue_clone(
            req.text, prompt_text=req.prompt_text,
            prompt_audio=prompt_audio, prompt_tokens=req.prompt_tokens,
            temperature=req.temperature, topk=req.topk,
            max_frames=_clone_frames(req))

    def reload(self, pretrained_dir: str, timeout_s: float = 300.0) -> None:
        """Hot-swap weights, live streams drained first (no request is
        dropped; ``ContinuousBatcher.reload``)."""
        self.batcher.reload(pretrained_dir, timeout_s=timeout_s)

    def shutdown(self) -> None:
        self.batcher.stop()
        self._pool.shutdown(wait=False)


class TTSService:
    """Single-worker queue in front of the engine: requests run one after
    another on one thread (the engine's device, inference mode)."""

    def __init__(self, engine):
        self.engine = engine
        self.queue: "queue.Queue[Any]" = queue.Queue()
        self.monitor = get_performance_monitor()
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="tts-worker")
        self._worker.start()

    def submit(self, req: TTSRequest) -> None:
        self.queue.put(req)

    def reload(self, pretrained_dir: str, timeout_s: float = 300.0) -> None:
        """Hot-swap weights between two requests: the swap runs on the
        worker, after the request in flight. Raises the swap's error, or
        TimeoutError (and the swap is dropped) when the worker has not
        started it within timeout_s."""
        done = threading.Event()
        lock = threading.Lock()
        box: dict = {"state": "queued"}

        def swap():
            with lock:
                if box["state"] == "cancelled":
                    return
                box["state"] = "running"
            try:
                self.engine.reload_checkpoint(pretrained_dir)
            except Exception as e:  # noqa: BLE001 -- raised in the caller
                box["err"] = e
            done.set()
        self.queue.put(swap)
        if not done.wait(timeout_s):
            with lock:
                if box["state"] == "queued":
                    box["state"] = "cancelled"
                    raise TimeoutError(
                        f"reload not started within {timeout_s}s")
            done.wait()                  # started: it ends on its own
        if "err" in box:
            raise box["err"]

    def shutdown(self) -> None:
        self.queue.put(None)

    def _loop(self) -> None:
        _device_thread(self.engine.device)
        with torch.inference_mode():
            while True:
                req = self.queue.get()
                if req is None:
                    return
                if callable(req):
                    req()
                    continue
                self._serve(req)

    def _serve(self, req: TTSRequest) -> None:
        self.monitor.start_inference(req.request_id)
        e = self.engine
        try:
            if req.mode == "monologue_clone":
                audio = _run_clone(e, req)
            elif req.mode == "dialogue_stream":
                total = []
                for i, chunk in e.generate_dialogue_stream(
                        list(req.text_list or []),
                        prompt_wav_list=req.prompt_wav_list,
                        prompt_text_list=req.prompt_text_list,
                        temperature=req.temperature, topk=req.topk,
                        max_utterance_ms=req.max_audio_length_ms,
                        utt_seed=req.seed):
                    total.append(chunk)
                    if req.streaming:
                        req.on_chunk((i, chunk))
                audio = _joined(total)
            elif req.streaming:
                total = []
                for chunk in e.generate_stream(
                        req.text, req.speaker, [],
                        max_audio_length_ms=req.max_audio_length_ms,
                        temperature=req.temperature, topk=req.topk,
                        utt_seed=req.seed):
                    self.monitor.record_first_packet(req.request_id)
                    self.monitor.record_frame(req.request_id)
                    total.append(chunk)
                    req.on_chunk(chunk)
                audio = _joined(total)
            else:
                audio = e.generate(
                    req.text, req.speaker, [],
                    max_audio_length_ms=req.max_audio_length_ms,
                    temperature=req.temperature, topk=req.topk,
                    utt_seed=req.seed)
            self.monitor.end_inference(
                req.request_id,
                audio_seconds=len(audio) / e.output_sample_rate)
            req.on_done(audio, None)
        except Exception as err:  # noqa: BLE001 -- the client gets the error
            self.monitor.end_inference(req.request_id, error=True)
            req.on_done(None, err)


class WebSocketTTSServer:
    """asyncio WebSocket server speaking the JAX server's message
    protocol; owns the service, the sessions and the security system that
    the HTTP server shares."""

    def __init__(self, engine, host: str = "0.0.0.0", port: int = 8765,
                 session_dir: Optional[str] = None, max_streams: int = 1,
                 security=None):
        from fireredtts2_tpu_torch.serve.security import create_security_system

        self.host, self.port = host, port
        self.service = (BatchedTTSService(engine, max_streams)
                        if max_streams > 1 else TTSService(engine))
        self.sessions = SessionManager(persist_dir=session_dir)
        self.monitor = get_performance_monitor()
        # one SecuritySystem guards both transports (HealthHTTPServer
        # shares this instance)
        self.security = (security if security is not None
                         else create_security_system())
        self.voices = None           # the HTTP server's voice store, if any
        self.clients: dict[str, Any] = {}
        self._server = None
        self.started = time.time()

    # -- message handling

    async def _handle(self, ws) -> None:
        client_id = uuid.uuid4().hex
        self.clients[client_id] = ws
        loop = asyncio.get_running_loop()
        try:
            async for raw in ws:
                try:
                    msg = json.loads(raw)
                except json.JSONDecodeError:
                    await self._send(ws, {"type": MSG_ERROR,
                                          "error": "invalid json"})
                    continue
                await self._dispatch(ws, client_id, msg, loop)
        finally:
            self.clients.pop(client_id, None)

    async def _send(self, ws, obj: dict) -> None:
        await ws.send(json.dumps(obj))

    async def _dispatch(self, ws, client_id: str, msg: dict, loop) -> None:
        mtype = msg.get("type")
        if mtype == MSG_PING:
            await self._send(ws, {"type": MSG_PONG, "ts": time.time()})
        elif mtype == MSG_SESSION_START:
            s = self.sessions.create_session(metadata={"client": client_id})
            await self._send(ws, {"type": MSG_SESSION_START,
                                  "session_id": s.session_id})
        elif mtype == MSG_SESSION_END:
            self.sessions.end_session(msg.get("session_id", ""))
            await self._send(ws, {"type": MSG_SESSION_END, "ok": True})
        elif mtype == MSG_STATS:
            await self._send(ws, {"type": MSG_STATS_RESPONSE,
                                  "stats": self.stats()})
        elif mtype == MSG_TTS_REQUEST:
            await self._handle_tts(ws, client_id, msg, loop)
        elif mtype == MSG_DIALOGUE_REQUEST:
            await self._handle_dialogue(ws, client_id, msg, loop)
        else:
            await self._send(ws, {"type": MSG_ERROR,
                                  "error": f"unknown message type: {mtype}"})

    def _queue_callbacks(self, loop):
        """(queue, on_chunk, on_done) feeding an asyncio queue from the
        service's threads."""
        out_q: asyncio.Queue = asyncio.Queue()

        def on_chunk(chunk) -> None:
            loop.call_soon_threadsafe(out_q.put_nowait, ("chunk", chunk))

        def on_done(audio, err) -> None:
            loop.call_soon_threadsafe(out_q.put_nowait, ("done", (audio, err)))
        return out_q, on_chunk, on_done

    async def _handle_tts(self, ws, client_id: str, msg: dict, loop) -> None:
        text = msg.get("text", "")
        if not text or not isinstance(text, str):
            await self._send(ws, {"type": MSG_ERROR,
                                  "error": "text is required"})
            return
        check = self.security.check_request(client_id, text,
                                            token=msg.get("token"))
        if not check.ok:
            await self._send(ws, {"type": MSG_ERROR, "error": check.reason})
            return
        request_id = msg.get("request_id") or uuid.uuid4().hex
        session_id = msg.get("session_id")
        streaming = bool(msg.get("streaming", True))
        out_q, on_chunk, on_done = self._queue_callbacks(loop)
        self.service.submit(TTSRequest(
            request_id=request_id, text=text,
            speaker=msg.get("speaker", "[S1]"),
            temperature=float(msg.get("temperature", 0.9)),
            topk=int(msg.get("top_k", 20)), streaming=streaming,
            max_audio_length_ms=float(msg.get("max_audio_length_ms", 30_000)),
            seed=_seed(msg), on_chunk=on_chunk, on_done=on_done))
        await self._send(ws, {"type": MSG_TTS_STARTED,
                              "request_id": request_id})
        sr = self.service.engine.output_sample_rate
        seq = 0
        while True:
            kind, payload = await out_q.get()
            if kind == "chunk":
                await self._send(ws, {
                    "type": MSG_AUDIO_CHUNK, "request_id": request_id,
                    "seq": seq, "sample_rate": sr, "format": "pcm16",
                    "data": pcm16_hex(payload)})
                seq += 1
                continue
            audio, err = payload
            if err is not None:
                await self._send(ws, {"type": MSG_ERROR,
                                      "request_id": request_id,
                                      "error": str(err)})
                return
            resp = {"type": MSG_TTS_COMPLETE, "request_id": request_id,
                    "chunks": seq, "duration_s": len(audio) / sr}
            if not streaming:
                resp.update(data=pcm16_hex(audio), sample_rate=sr,
                            format="pcm16")
            await self._send(ws, resp)
            if session_id and self.sessions.get(session_id):
                self.sessions.add_turn(session_id, "assistant", text,
                                       audio_duration_s=resp["duration_s"])
            return

    async def _handle_dialogue(self, ws, client_id: str, msg: dict,
                               loop) -> None:
        """Streaming multi-speaker dialogue over one socket: audio_chunk
        messages carry an ``utterance`` index; optional per-speaker voices
        {"[S1]": <profile id or name>, ...} from the voice store."""
        text_list = msg.get("text_list")
        if (not isinstance(text_list, list) or not text_list
                or not all(isinstance(t, str) and t.strip()
                           for t in text_list)):
            await self._send(ws, {"type": MSG_ERROR,
                                  "error": "text_list (non-empty list of "
                                           "[S1]-prefixed strings) required"})
            return
        check = self.security.check_request(client_id, " ".join(text_list),
                                            token=msg.get("token"))
        if not check.ok:
            await self._send(ws, {"type": MSG_ERROR, "error": check.reason})
            return
        request_id = msg.get("request_id") or uuid.uuid4().hex
        wav_list = text_prompt_list = None
        speaker_map = msg.get("voices")
        if speaker_map:
            store = self.voices
            if store is None:
                await self._send(ws, {"type": MSG_ERROR,
                                      "error": "no voice store configured "
                                               "(serve --voice-dir)"})
                return
            try:
                resolved = {}
                for spk, want in dict(speaker_map).items():
                    p = store.get(str(want)) or store.by_name(str(want))
                    if p is None:
                        raise KeyError(f"unknown voice: {want}")
                    resolved[str(spk)] = p.profile_id
                wav_list, text_prompt_list = store.dialogue_prompts(resolved)
            except (KeyError, TypeError, AttributeError) as e:
                await self._send(ws, {"type": MSG_ERROR, "error": str(e)})
                return
        out_q, on_chunk, on_done = self._queue_callbacks(loop)
        self.service.submit(TTSRequest(
            request_id=request_id, text="", speaker="[S1]",
            temperature=float(msg.get("temperature", 0.9)),
            topk=int(msg.get("top_k", 20)), streaming=True,
            max_audio_length_ms=float(msg.get("max_utterance_ms", 30_000)),
            mode="dialogue_stream", text_list=[str(t) for t in text_list],
            prompt_wav_list=wav_list, prompt_text_list=text_prompt_list,
            seed=_seed(msg), on_chunk=on_chunk, on_done=on_done))
        await self._send(ws, {"type": MSG_TTS_STARTED,
                              "request_id": request_id,
                              "utterances": len(text_list)})
        sr = self.service.engine.output_sample_rate
        seq = 0
        while True:
            kind, payload = await out_q.get()
            if kind == "chunk":
                utt, chunk = payload
                await self._send(ws, {
                    "type": MSG_AUDIO_CHUNK, "request_id": request_id,
                    "utterance": int(utt), "seq": seq, "sample_rate": sr,
                    "format": "pcm16", "data": pcm16_hex(chunk)})
                seq += 1
                continue
            audio, err = payload
            if err is not None:
                await self._send(ws, {"type": MSG_ERROR,
                                      "request_id": request_id,
                                      "error": str(err)})
            else:
                await self._send(ws, {
                    "type": MSG_TTS_COMPLETE, "request_id": request_id,
                    "chunks": seq, "utterances": len(text_list),
                    "duration_s": len(audio) / sr})
            return

    # -- lifecycle

    async def start(self) -> None:
        import websockets

        self._server = await websockets.serve(self._handle, self.host,
                                              self.port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self.service.shutdown()

    def stats(self) -> dict:
        """The monitor's summary with the engine's card memory, clients,
        sessions, uptime, each CUDA kernel's launches in this process
        (``runtime.perf.kernel_launches``); with a batcher its telemetry
        (live streams, queue depth, chunk drops, the block policy,
        host_stats); and the recommendation engine's output over all of
        it, the device-regression rule budgeted by the port's
        perf_budget.json."""
        from fireredtts2_tpu_torch.runtime.perf import (
            kernel_launches, load_perf_budget,
        )
        from fireredtts2_tpu_torch.runtime.policy import RecommendationEngine

        out = self.monitor.summary(self.service.engine.device)
        out["kernel_launches"] = kernel_launches()
        out["clients"] = len(self.clients)
        out["sessions"] = self.sessions.active_count
        out["uptime_s"] = time.time() - self.started
        batcher = getattr(self.service, "batcher", None)
        if batcher is not None:
            out["active_streams"] = batcher.active_streams
            out["queue_depth"] = batcher.pending.qsize()
            out["chunk_drops"] = batcher.chunk_drops
            out["block_policy"] = batcher.policy.snapshot()
            out["host"] = batcher.host_stats()
        rec_stats = dict(out)
        rec_stats["first_packet_p95_ms"] = out.get("first_packet_ms_p95")
        dev = out.get("device") or {}
        if dev.get("bytes_limit"):
            rec_stats["hbm_used_fraction"] = (
                dev.get("bytes_in_use", 0) / dev["bytes_limit"])
        active = rec_stats.get("active_streams")
        if active and rec_stats.get("rtf_p50") is not None:
            rec_stats["aggregate_rtf"] = rec_stats["rtf_p50"] * active
        policy_snap = rec_stats.get("block_policy") or {}
        if policy_snap.get("frame_cost_ms") is not None:
            rec_stats["device_ms_per_frame"] = policy_snap["frame_cost_ms"]
        budget = load_perf_budget()
        out["recommendations"] = [r.to_dict() for r in RecommendationEngine(
            device_budget_ms=budget.get("block_frame_cost_ms"),
            device_margin=budget.get("block_frame_cost_margin", 1.15),
        ).evaluate(rec_stats)]
        return out


class _HTTPServer(ThreadingHTTPServer):
    # The listen backlog: socketserver's default of 5 drops the handshakes
    # of a burst of more clients than that (each retried a second or more
    # later), and a pool serves 8 or more at once.
    request_queue_size = 128


class HealthHTTPServer:
    """stdlib REST endpoints (the JAX server's surface):

    - GET  /health, /stats, /demo
    - POST /api/v1/tts/generate, /api/v1/tts/generate-streaming (chunked
      PCM16 bytes; also /api/v1/tts/generate/stream)
    - GET  /api/v1/tts/status/<request_id>
    - GET/POST/DELETE /api/v1/voices[...] (uploads are hex- or base64-PCM16
      JSON) and POST /api/v1/tts/clone, with a voice_dir
    - POST /api/v1/conversations/start, GET/DELETE
      /api/v1/conversations/<id>, POST .../turn (a text turn answered by
      the responder chain, spoken)
    - POST /api/v1/admin/reload {"dir", "timeout_s"?}: only with a
      reload_root, to a dir under it (403 otherwise)
    - POST /v1/audio/speech, /v1/audio/transcriptions (OpenAI-compatible)

    Every /api/v1 and /v1 route passes the shared security system (auth
    when required, rate limit)."""

    def __init__(self, ws_server: WebSocketTTSServer, host: str = "0.0.0.0",
                 port: int = 8080, voice_dir: Optional[str] = None,
                 responder=None, transcriber=None,
                 reload_root: Optional[str] = None):
        import base64

        from fireredtts2_tpu_torch.serve.s2s import (
            ResponderChain, RuleBasedResponder,
        )
        from fireredtts2_tpu_torch.serve.security import validate_text_input
        from fireredtts2_tpu_torch.serve.voices import VoiceProfileManager
        from fireredtts2_tpu_torch.utils.audio_io import resample

        voices = VoiceProfileManager(voice_dir) if voice_dir else None
        root = os.path.realpath(reload_root) if reload_root else None
        responder = responder or ResponderChain([RuleBasedResponder()])
        statuses: dict[str, dict] = {}
        statuses_lock = threading.Lock()
        security = ws_server.security
        service = ws_server.service
        sr_out = service.engine.output_sample_rate
        # Request-body cap: the largest legitimate body is a voice-create
        # with hex PCM16; anything bigger gets 413 before the read.
        MAX_BODY_BYTES = 32 * 1024 * 1024
        MAX_PROMPT_SECONDS = 60.0

        def track(request_id: str, **kw) -> None:
            with statuses_lock:
                st = statuses.setdefault(request_id, {"request_id": request_id})
                st.update(kw)
                if len(statuses) > 512:          # the most recent 512
                    for k in list(statuses)[: len(statuses) - 512]:
                        del statuses[k]

        def submit(req: TTSRequest, track_text: Optional[str] = None,
                   on_done_extra: Optional[Callable] = None, **track_kw):
            """Submit one request -> (done event, result box). With
            track_text its status is tracked (track_kw added to it).
            on_done_extra(audio, err) runs on the service's thread before
            the event is set."""
            done = threading.Event()
            result: dict = {}

            def on_done(audio, err):
                result["audio"], result["err"] = audio, err
                if track_text is not None:
                    track(req.request_id,
                          status="error" if err is not None else "completed",
                          duration_s=(0.0 if audio is None
                                      else len(audio) / sr_out))
                if on_done_extra is not None:
                    on_done_extra(audio, err)
                done.set()
            req.on_done = on_done
            if track_text is not None:
                track(req.request_id, status="processing",
                      created_at=time.time(), text_len=len(track_text),
                      **track_kw)
            service.submit(req)
            return done, result

        def text_request(text: str, req: dict, streaming: bool = False,
                         on_chunk=None) -> TTSRequest:
            return TTSRequest(
                request_id=req.get("request_id") or uuid.uuid4().hex,
                text=text, speaker=req.get("speaker", "[S1]"),
                temperature=float(req.get("temperature", 0.9)),
                topk=int(req.get("top_k", 20)), streaming=streaming,
                max_audio_length_ms=float(
                    req.get("max_audio_length_ms", 30_000)),
                seed=_seed(req), on_chunk=on_chunk or (lambda c: None),
                on_done=None)

        def run_tts(text: str, req: dict):
            """One whole-utterance request, blocking -> (audio, err)."""
            r = text_request(text, req)
            done, result = submit(r, track_text=text)
            if not done.wait(timeout=TIMEOUT_S):
                track(r.request_id, status="timeout")
                return None, TimeoutError("generation timed out")
            return result["audio"], result["err"]

        def run_clone(text: str, req: dict, profile, temperature: float,
                      topk: int, track_text: Optional[str] = None):
            """A monologue in a stored voice, blocking -> (audio, err)."""
            r = TTSRequest(
                request_id=req.get("request_id") or uuid.uuid4().hex,
                text=text, speaker="[S1]", temperature=temperature,
                topk=topk, streaming=False, mode="monologue_clone",
                max_audio_length_ms=float(
                    req.get("max_audio_length_ms", 400 * 80)),
                prompt_wav=profile.wav_path,
                prompt_text=profile.reference_text,
                prompt_tokens=voices.prompt_tokens(profile.profile_id),
                seed=_seed(req), on_chunk=lambda c: None, on_done=None)
            done, result = submit(r, track_text=track_text,
                                  voice=profile.name)
            if not done.wait(timeout=TIMEOUT_S):
                return None, TimeoutError("generation timed out")
            return result["audio"], result["err"]

        def decode_audio_payload(req: dict) -> np.ndarray:
            """hex/base64 PCM16 (+sample_rate) -> float32 mono 16 kHz,
            duration-capped (a prompt encode is a 32-layer SSL forward per
            6 s window)."""
            if "data_b64" in req:
                raw = base64.b64decode(req["data_b64"])
            else:
                raw = bytes.fromhex(req.get("data", ""))
            audio = pcm16_to_f32(raw)
            sr = int(req.get("sample_rate", 16_000))
            if not 4_000 <= sr <= 192_000:
                raise ValueError("unsupported sample_rate")
            if len(audio) > MAX_PROMPT_SECONDS * sr:
                raise ValueError(
                    f"reference audio too long (> {MAX_PROMPT_SECONDS:.0f} s)")
            if sr != 16_000:
                audio = resample(audio, sr, 16_000)
            return audio

        def find_voice(want: str):
            if not voices or not want:
                return None
            return voices.get(want) or voices.by_name(want)

        class Handler(BaseHTTPRequestHandler):
            def _json(self, code: int, obj: dict):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _body(self) -> Optional[dict]:
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    self._json(400, {"error": "invalid content-length"})
                    return None
                if n > MAX_BODY_BYTES:
                    self._json(413, {"error": f"body too large "
                                              f"(> {MAX_BODY_BYTES} bytes)"})
                    return None
                try:
                    return json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError):
                    self._json(400, {"error": "invalid json"})
                    return None

            def _guard(self) -> bool:
                """Auth + rate limit, sharing the WS path's security
                system; sends the rejection itself."""
                auth = self.headers.get("Authorization", "")
                token = (auth[7:].strip() if auth.startswith("Bearer ")
                         else self.headers.get("X-API-Key"))
                subject = security.auth.verify(token) if token else None
                client = subject or self.client_address[0]
                check = security.check_request(client, "ok", token=token)
                if check.ok:
                    return True
                code = (401 if check.reason == "unauthorized"
                        else 429 if "rate limit" in check.reason else 400)
                self._json(code, {"error": check.reason})
                return False

            def _parts(self) -> Optional[list]:
                """The path's parts, or None once a guarded route's
                request was rejected."""
                parts = [p for p in self.path.split("?")[0].split("/") if p]
                guarded = parts[:2] in (["api", "v1"], ["v1", "audio"])
                if guarded and not self._guard():
                    return None
                return parts

            # ------------------------------------------------------- GET

            def do_GET(self):
                parts = self._parts()
                if parts is None:
                    return
                if self.path == "/health":
                    self._json(200, {"status": "healthy",
                                     "uptime_s": time.time() - ws_server.started})
                elif self.path == "/stats":
                    self._json(200, ws_server.stats())
                elif self.path in ("/", "/demo"):
                    from fireredtts2_tpu_torch.serve.webui import demo_page

                    data = demo_page(ws_server.port).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif parts[:4] == ["api", "v1", "tts", "status"] and len(parts) == 5:
                    with statuses_lock:
                        st = statuses.get(parts[4])
                    if st:
                        self._json(200, dict(st))
                    else:
                        self._json(404, {"error": "request not found"})
                elif parts[:3] == ["api", "v1", "voices"] and voices:
                    if len(parts) == 3:
                        self._json(200, {"voices": [
                            {"profile_id": p.profile_id, "name": p.name,
                             "reference_text": p.reference_text,
                             "quality": p.quality, "created_at": p.created_at}
                            for p in voices.list_profiles()]})
                        return
                    p = voices.get(parts[3])
                    if p is None:
                        self._json(404, {"error": "voice not found"})
                        return
                    self._json(200, {
                        "profile_id": p.profile_id, "name": p.name,
                        "reference_text": p.reference_text,
                        "quality": p.quality, "metadata": p.metadata})
                elif parts[:3] == ["api", "v1", "conversations"] and len(parts) == 4:
                    s = ws_server.sessions.get(parts[3])
                    if not s:
                        self._json(404, {"error": "conversation not found"})
                        return
                    self._json(200, s.to_json())
                else:
                    self._json(404, {"error": "not found"})

            # ------------------------------------------------------ POST

            def do_POST(self):
                parts = self._parts()
                if parts is None:
                    return
                path = self.path.split("?")[0]
                if path == "/api/v1/tts/generate":
                    self._tts()
                elif path in ("/api/v1/tts/generate-streaming",
                              "/api/v1/tts/generate/stream"):
                    self._tts_stream()
                elif path == "/api/v1/voices/create" and voices:
                    self._voice_create()
                elif path == "/api/v1/tts/clone" and voices:
                    self._tts_clone()
                elif path == "/api/v1/conversations/start":
                    req = self._body()
                    if req is None:
                        return
                    s = ws_server.sessions.create_session(metadata={
                        "language": req.get("language", "English"),
                        "response_style": req.get("response_style",
                                                  "conversational"),
                        "voice_profile_id": req.get("voice_profile_id"),
                    })
                    self._json(200, {"session_id": s.session_id,
                                     "created_at": s.created_at})
                elif (parts[:3] == ["api", "v1", "conversations"]
                      and len(parts) == 5 and parts[4] == "turn"):
                    self._conversation_turn(parts[3])
                elif path == "/api/v1/admin/reload":
                    self._admin_reload()
                elif path == "/v1/audio/speech":
                    self._openai_speech()
                elif path == "/v1/audio/transcriptions":
                    self._openai_transcription()
                else:
                    self._json(404, {"error": "not found"})

            def do_DELETE(self):
                parts = self._parts()
                if parts is None:
                    return
                if (parts[:3] == ["api", "v1", "voices"] and len(parts) == 4
                        and voices):
                    ok = voices.delete(parts[3])
                    self._json(200 if ok else 404,
                               {"deleted": ok} if ok
                               else {"error": "voice not found"})
                elif parts[:3] == ["api", "v1", "conversations"] and len(parts) == 4:
                    ws_server.sessions.end_session(parts[3])
                    self._json(200, {"ended": True})
                else:
                    self._json(404, {"error": "not found"})

            # -------------------------------------------------- handlers

            def _admin_reload(self):
                """Hot-swap checkpoint weights from {"dir": ...}, a dir
                under the reload root: the batched service drains live
                streams between prepare and apply, the single worker swaps
                between two requests."""
                req = self._body()
                if req is None:
                    return
                d = req.get("dir", "")
                d = d if isinstance(d, str) else ""
                if reload_root is None:
                    self._json(403, {"error": "admin reload is off (start "
                                     "the server with a reload root)"})
                    return
                real = os.path.realpath(d) if d else ""
                if os.path.commonpath([root, real or "/"]) != root:
                    self._json(403, {"error": f"not under the reload root: "
                                     f"{d!r}"})
                    return
                if not os.path.isdir(real):
                    self._json(400, {"error": f"not a directory: {d!r}"})
                    return
                t0 = time.time()
                try:
                    service.reload(real, timeout_s=float(
                        req.get("timeout_s", 300.0)))
                except TimeoutError as e:
                    self._json(503, {"error": str(e)})
                    return
                except (ValueError, FileNotFoundError, KeyError) as e:
                    # not a serving dir of the running model's shapes
                    self._json(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                except Exception as e:  # noqa: BLE001 -- answered, not dropped
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                self._json(200, {"reloaded": d,
                                 "took_s": round(time.time() - t0, 2)})

            def _text_body(self, key: str = "text"):
                """(request body, its validated text) or None after an
                error response."""
                req = self._body()
                if req is None:
                    return None
                text = req.get(key, "")
                v = validate_text_input(text)
                if not v.ok:
                    self._json(400, {"error": v.reason})
                    return None
                return req, text

            def _tts(self):
                got = self._text_body()
                if got is None:
                    return
                req, text = got
                audio, err = run_tts(text, req)
                if err is not None:
                    self._json(500, {"error": str(err)})
                    return
                self._json(200, {"sample_rate": sr_out, "format": "pcm16",
                                 "duration_s": len(audio) / sr_out,
                                 "data": pcm16_hex(audio)})

            def _tts_stream(self):
                """Chunked transfer of raw PCM16 as it decodes. This
                handler thread submits the request and writes its chunks
                itself: the service's thread only puts them on the queue."""
                got = self._text_body()
                if got is None:
                    return
                req, text = got
                chunk_q: "queue.Queue" = queue.Queue()
                r = text_request(text, req, streaming=True,
                                 on_chunk=chunk_q.put)
                submit(r, track_text=text,
                       on_done_extra=lambda audio, err: chunk_q.put(None))
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("X-Sample-Rate", str(sr_out))
                self.send_header("X-Format", "pcm16")
                self.end_headers()
                try:
                    while True:
                        c = chunk_q.get(timeout=TIMEOUT_S)
                        if c is None:
                            break
                        payload = f32_to_pcm16(c)
                        self.wfile.write(f"{len(payload):X}\r\n".encode()
                                         + payload + b"\r\n")
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError, queue.Empty):
                    pass  # client hung up, or no chunk within the timeout

            def _tts_clone(self):
                """A monologue in a stored voice."""
                got = self._text_body()
                if got is None:
                    return
                req, text = got
                p = voices.get(req.get("voice_profile_id", ""))
                if p is None:
                    self._json(404, {"error": "voice not found"})
                    return
                audio, err = run_clone(
                    text, req, p, float(req.get("temperature", 0.75)),
                    int(req.get("top_k", 20)), track_text=text)
                if isinstance(err, TimeoutError):
                    self._json(504, {"error": str(err)})
                    return
                if err is not None:
                    self._json(500, {"error": str(err)})
                    return
                self._json(200, {"sample_rate": sr_out, "format": "pcm16",
                                 "duration_s": len(audio) / sr_out,
                                 "voice": p.name, "data": pcm16_hex(audio)})

            def _openai_speech(self):
                """OpenAI-compatible TTS: {"model", "input", "voice"?,
                "response_format"? wav|pcm} -> binary audio. A "voice" that
                names a stored profile (id or name) clones it."""
                req = self._body()
                if req is None:
                    return
                text = req.get("input", "")
                v = validate_text_input(text)
                if not v.ok:
                    self._json(400, {"error": {
                        "message": v.reason,
                        "type": "invalid_request_error"}})
                    return
                fmt = req.get("response_format", "wav")
                if fmt not in ("wav", "pcm"):
                    self._json(400, {"error": {
                        "message": f"unsupported response_format {fmt!r} "
                                   f"(wav | pcm)",
                        "type": "invalid_request_error"}})
                    return
                # the port's extensions: a noise seed and a length cap
                extra = {k: req[k] for k in ("seed", "max_audio_length_ms")
                         if k in req}
                prof = find_voice(str(req.get("voice", "") or ""))
                if prof is not None:
                    audio, err = run_clone(
                        text, extra, prof,
                        float(req.get("temperature", 0.75)), 20)
                else:
                    audio, err = run_tts(text, dict(
                        extra, speaker=req.get("speaker", "[S1]"),
                        temperature=req.get("temperature", 0.9)))
                if isinstance(err, TimeoutError):
                    self._json(504, {"error": {"message": str(err)}})
                    return
                if err is not None:
                    self._json(500, {"error": {"message": str(err)}})
                    return
                self._binary_audio(audio, fmt)

            def _openai_transcription(self):
                """OpenAI-compatible ASR -> {"text"}: multipart/form-data
                with a wav ``file`` part, or the JSON audio payload. 503
                without a transcriber."""
                if transcriber is None:
                    self._json(503, {"error": {
                        "message": "no ASR wired (this server has no "
                                   "transcriber)"}})
                    return
                ctype = self.headers.get("Content-Type", "")
                try:
                    if ctype.startswith("multipart/form-data"):
                        audio = self._multipart_wav()
                    else:
                        req = self._body()
                        if req is None:
                            return
                        audio = decode_audio_payload(req)
                except ValueError as e:
                    self._json(400, {"error": {
                        "message": f"invalid audio payload: {e}",
                        "type": "invalid_request_error"}})
                    return
                if audio.size < 160:            # >= 10 ms
                    self._json(400, {"error": {
                        "message": "audio too short",
                        "type": "invalid_request_error"}})
                    return
                self._json(200, {"text": transcriber(audio)})

            def _multipart_wav(self) -> np.ndarray:
                """The first wav file part of a multipart/form-data body
                -> float32 mono at 16 kHz (stdlib parser)."""
                import io
                from email import message_from_bytes
                from email.policy import HTTP

                from fireredtts2_tpu_torch.utils.audio_io import load_wav_mono

                n = int(self.headers.get("Content-Length", "0"))
                if n > MAX_BODY_BYTES:
                    raise ValueError(f"body too large (> {MAX_BODY_BYTES})")
                raw = (b"Content-Type: "
                       + self.headers["Content-Type"].encode()
                       + b"\r\n\r\n" + self.rfile.read(n))
                msg = message_from_bytes(raw, policy=HTTP)
                if not msg.is_multipart():
                    raise ValueError("not multipart")
                for part in msg.iter_parts():
                    if part.get_filename() or part.get_param(
                            "name", header="content-disposition") == "file":
                        audio, sr = load_wav_mono(
                            io.BytesIO(part.get_payload(decode=True)))
                        if len(audio) > MAX_PROMPT_SECONDS * sr:
                            raise ValueError("audio too long")
                        return resample(audio, sr, 16_000)
                raise ValueError("no file part")

            def _binary_audio(self, audio, fmt: str):
                import struct

                pcm = f32_to_pcm16(audio)
                if fmt == "wav":
                    data = (b"RIFF" + struct.pack("<I", 36 + len(pcm))
                            + b"WAVEfmt "
                            + struct.pack("<IHHIIHH", 16, 1, 1, sr_out,
                                          sr_out * 2, 2, 16)
                            + b"data" + struct.pack("<I", len(pcm)) + pcm)
                    ctype = "audio/wav"
                else:
                    data, ctype = pcm, "application/octet-stream"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("X-Sample-Rate", str(sr_out))
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _voice_create(self):
                req = self._body()
                if req is None:
                    return
                name = req.get("name", "")
                ref_text = req.get("reference_text", "")
                if not name or not ref_text:
                    self._json(400, {"error": "name and reference_text required"})
                    return
                try:
                    audio = decode_audio_payload(req)
                except ValueError as e:
                    self._json(400, {"error": f"invalid audio payload: {e}"})
                    return
                if audio.size < 1600:           # >= 0.1 s of 16 kHz audio
                    self._json(400, {"error": "reference audio too short"})
                    return
                # the prompt is encoded once, here; clones ride its tokens
                p = voices.create_profile(
                    name=name, reference_text=ref_text, audio16k=audio,
                    metadata={k: req[k] for k in
                              ("language", "gender", "age_range",
                               "description") if k in req},
                    encoder=service.engine.encode_prompt_tokens)
                self._json(200, {"profile_id": p.profile_id, "name": p.name,
                                 "quality": p.quality})

            def _conversation_turn(self, session_id: str):
                got = self._text_body()
                if got is None:
                    return
                req, text = got
                if not ws_server.sessions.get(session_id):
                    self._json(404, {"error": "conversation not found"})
                    return
                history = [(t.role, t.text) for t in
                           ws_server.sessions.context_window(session_id)]
                reply = responder(text, history)
                audio, err = run_tts(reply, req)
                if err is not None:
                    self._json(500, {"error": str(err)})
                    return
                ws_server.sessions.add_turn(session_id, "user", text)
                ws_server.sessions.add_turn(session_id, "assistant", reply,
                                            audio_duration_s=len(audio) / sr_out)
                self._json(200, {"response_text": reply, "format": "pcm16",
                                 "sample_rate": sr_out,
                                 "data": pcm16_hex(audio),
                                 "duration_s": len(audio) / sr_out})

            def log_message(self, *a):  # quiet
                pass

        self.voices = voices
        ws_server.voices = voices      # the WS dialogue maps voices too
        self.httpd = _HTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="http-accept")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def serve(engine, ws_port: int = 8765, http_port: int = 8080,
          session_dir: Optional[str] = None, max_streams: int = 1,
          voice_dir: Optional[str] = None, responder=None,
          require_auth: bool = False, transcriber=None,
          host: str = "0.0.0.0", reload_root: Optional[str] = None) -> None:
    """Blocking entry point: WebSocket TTS + HTTP REST. max_streams > 1
    serves concurrent requests through the continuous batcher; voice_dir
    enables the voices CRUD and clone routes; responder backs the
    conversations API (``serve.llm.build_responder_chain``). require_auth
    demands a Bearer token (``security.TokenAuthenticator.issue``) on WS
    TTS requests and every /api/v1 and /v1/audio route; the issued-token
    secret is printed once at startup unless FRTTS2_TOKEN_SECRET is set.
    reload_root turns on /api/v1/admin/reload for the dirs under it (their
    converted ``DIR/torch/`` trees); without it the route answers 403.
    transcriber (16 kHz audio -> text) backs /v1/audio/transcriptions,
    e.g. ``asr.WhisperASR(...).as_transcriber()``, whose ASRConfig may ask
    for beam search, best-of-N or word timestamps (the route answers the
    text alone); the realtime streaming ASR server is
    ``asr.realtime.RealtimeASRServer``.

    A CUDA engine is warmed up (``engine.warmup``) and the pool's warm-up
    ladder awaited before the sockets bind, so /health answers only once
    the server is ready. Without ``websockets`` the REST server runs
    alone (said on stderr)."""
    security = None
    if require_auth:
        from fireredtts2_tpu_torch.serve.security import (
            TokenAuthenticator, create_security_system,
        )

        secret = os.environ.get("FRTTS2_TOKEN_SECRET")
        auth = TokenAuthenticator(secret.encode() if secret else None)
        security = create_security_system(auth=auth, require_auth=True)
        if not secret:
            print("serve: auth required; example token:",
                  security.auth.issue("operator"))
    if engine.device.type == "cuda":
        print(f"serve: engine warm-up {engine.warmup():.1f} s", flush=True)
    server = WebSocketTTSServer(engine, host=host, port=ws_port,
                                session_dir=session_dir,
                                max_streams=max_streams, security=security)
    batcher = getattr(server.service, "batcher", None)
    if batcher is not None:
        batcher.wait_ready()
    health = HealthHTTPServer(server, host=host, port=http_port,
                              voice_dir=voice_dir, responder=responder,
                              transcriber=transcriber, reload_root=reload_root)
    try:
        import websockets  # noqa: F401
        has_ws = True
    except ImportError:
        has_ws = False
        print("serve: the websockets package is not installed; serving "
              "REST only (no WebSocket on port "
              f"{ws_port})", file=sys.stderr, flush=True)

    async def main():
        if has_ws:
            await server.start()
        health.start()
        print(f"serving: http://{host}:{http_port}/health"
              + (f"  ws://{host}:{ws_port}" if has_ws else ""), flush=True)
        await asyncio.Future()  # run forever

    asyncio.run(main())
