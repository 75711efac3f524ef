"""PyTorch port, the server over sockets on the CPU (tiny config, float32,
a top-1 depth chain, weights bridged from the JAX engine's):

- parity of the slice as a whole: the same greedy requests to the JAX
  server (``fireredtts2_tpu.serve.server``, one worker) and to the port's
  (one worker; and the port's batched service, a pool of 4 through
  ``ContinuousBatcher``) on /api/v1/tts/generate, /v1/audio/speech and the
  WebSocket stream give PCM16 of equal length, every sample within
  1e-4 x peak x 32767 + 1 LSB (``wave_close``'s tolerance of the f32
  routes, plus one rounding step: the JAX package's C++ packing rounds,
  the port's numpy packing truncates);
- every route: health, stats, demo, REST TTS whole and chunked, request
  status, voices CRUD and clone, conversations, admin reload (only to a
  dir under the server's reload root, reading no pickle; with two live
  streams: none dropped, the greedy request after equals the one before),
  the OpenAI routes and transcriptions (503 without a transcriber); the
  auth guard on REST and WebSocket;
- the chunked stream starts no thread of its own: during a burst the only
  new server threads are the connections' handlers and the bounded pool's
  consumers;
- the WebSocket message vocabulary.

Each server is built once for the module.
"""

import asyncio
import dataclasses
import http.client
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from fireredtts2_tpu.config import tiny_engine_config as j_tiny
from fireredtts2_tpu.serve import server as j_server

from fireredtts2_tpu_torch.config import tiny_engine_config as t_tiny
from fireredtts2_tpu_torch.engine import FireRedTTS2Engine as TEngine
from fireredtts2_tpu_torch.runtime import checkpoint as ckpt
from fireredtts2_tpu_torch.serve import server as t_server
from fireredtts2_tpu_torch.serve.security import (
    RateLimiter, SecuritySystem, TokenAuthenticator,
)
from fireredtts2_tpu_torch.weights import from_jax

from _torch_parity import jax_engine, one_torch_thread, voiced  # noqa: F401  (autouse)
from conftest import free_port

GREEDY = {"top_k": 1, "max_audio_length_ms": 640}
TEXT = "hello from the server"


class _Live:
    """One HTTP + WebSocket server pair on free ports, the WebSocket
    server on an event loop of its own thread."""

    def __init__(self, mod, engine, max_streams=1, voice_dir=None,
                 security=None, transcriber=None, reload_root=None):
        self.ws = mod.WebSocketTTSServer(engine, host="127.0.0.1",
                                         port=free_port(),
                                         max_streams=max_streams,
                                         security=security)
        self.http = mod.HealthHTTPServer(self.ws, host="127.0.0.1",
                                         port=free_port(),
                                         voice_dir=voice_dir,
                                         transcriber=transcriber,
                                         **({"reload_root": reload_root}
                                            if reload_root else {}))
        self.http.start()
        self.loop = asyncio.new_event_loop()
        self._t = threading.Thread(target=self.loop.run_forever, daemon=True)
        self._t.start()
        self._run(self.ws.start())
        self.base = f"http://127.0.0.1:{self.http.httpd.server_port}"
        self.ws_url = f"ws://127.0.0.1:{self.ws.port}"

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(600)

    def close(self):
        self.http.stop()
        self._run(self.ws.stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._t.join(timeout=10)


def _config(tiny):
    """The tiny config at float32 with a top-1 depth chain, its vocoder slab
    the flagship's 3008 latents: /v1/audio/speech has the stock 30 s cap,
    which the flagship's slab holds and the tiny's 256 do not (past the
    slab JAX's CPU route drops rows where the port, as JAX's chip route,
    clamps: ROADMAP.md section 3)."""
    cfg = tiny(depth_topk=1)
    codec = cfg.codec
    return dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, dtype="float32"),
        codec=dataclasses.replace(codec, acoustic_decoder=dataclasses.replace(
            codec.acoustic_decoder, max_stream_latents=3008)))


@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg = _config(j_tiny), _config(t_tiny)
    jeng = jax_engine(config=jcfg, seed=3)
    teng = TEngine(tcfg, device="cpu", lm_params=from_jax(jeng.lm_params),
                   codec_params=from_jax(jeng.codec_params))
    return jeng, teng


@pytest.fixture(scope="module")
def servers(engines, tmp_path_factory):
    jeng, teng = engines
    security = SecuritySystem(
        rate_limiter=RateLimiter(max_requests=1000, window_seconds=60.0),
        auth=TokenAuthenticator(b"test-secret"), require_auth=True)
    root = str(tmp_path_factory.getbasetemp())
    live = {
        "jax": _Live(j_server, jeng),
        "single": _Live(t_server, teng, reload_root=root,
                        transcriber=lambda a: f"{len(a)} samples"),
        "batched": _Live(t_server, teng, max_streams=4, reload_root=root,
                         voice_dir=str(tmp_path_factory.mktemp("voices"))),
        "auth": _Live(t_server, teng, security=security),
    }
    live["token"] = security.auth.issue("operator")
    yield live
    for k, v in live.items():
        if k != "token":
            v.close()


def _call(base, method, path, obj=None, token=None, raw=False, timeout=600):
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(
        base + path, data=None if obj is None else json.dumps(obj).encode(),
        headers=headers, method=method)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = r.read()
        return r.status, (body if raw else json.loads(body)), r.headers


def _post(base, path, obj, **kw):
    return _call(base, "POST", path, obj, **kw)


def _get(base, path, **kw):
    return _call(base, "GET", path, **kw)


def _code(fn, *a, **kw) -> int:
    with pytest.raises(urllib.error.HTTPError) as e:
        fn(*a, **kw)
    return e.value.code


def _pcm(hex_or_bytes) -> np.ndarray:
    raw = (bytes.fromhex(hex_or_bytes) if isinstance(hex_or_bytes, str)
           else hex_or_bytes)
    return np.frombuffer(raw, "<i2").astype(np.int32)


def _generate(live, text=TEXT, **extra):
    _, out, _ = _post(live.base, "/api/v1/tts/generate",
                      dict(GREEDY, text=text, **extra))
    assert out["format"] == "pcm16" and out["sample_rate"] == 24_000
    return _pcm(out["data"])


def _speech(live, fmt="wav", **extra):
    _, body, hdr = _post(live.base, "/v1/audio/speech",
                         dict({"input": TEXT, "response_format": fmt,
                               "temperature": 1e-6}, **extra), raw=True)
    if fmt == "wav":
        assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
        assert hdr["Content-Type"] == "audio/wav"
        body = body[44:]
    return _pcm(body)


def _stream(live, text=TEXT, **extra):
    conn = http.client.HTTPConnection(live.base[7:].split(":")[0],
                                      int(live.base.rsplit(":", 1)[1]),
                                      timeout=600)
    conn.request("POST", "/api/v1/tts/generate-streaming",
                 body=json.dumps(dict(GREEDY, text=text, **extra)),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200 and resp.getheader("X-Format") == "pcm16"
    assert resp.getheader("Transfer-Encoding") == "chunked"
    data = resp.read()
    conn.close()
    return _pcm(data)


async def _ws_exchange(url, messages, until=("generation_complete", "error")):
    """Send each message and collect replies until one of `until` types
    (or one reply per message when until is None)."""
    import websockets

    out = []
    async with websockets.connect(url, max_size=1 << 24) as ws:
        for m in messages:
            await ws.send(m if isinstance(m, str) else json.dumps(m))
            while True:
                r = json.loads(await asyncio.wait_for(ws.recv(), 600))
                out.append(r)
                if until is None or r["type"] in until:
                    break
    return out


def _ws(live, *messages, until=("generation_complete", "error")):
    return asyncio.run(_ws_exchange(live.ws_url, messages, until))


def _ws_stream(live, text=TEXT, **extra):
    replies = _ws(live, dict(GREEDY, type="generate_speech", text=text,
                             streaming=True, **extra))
    assert replies[0]["type"] == "generation_started"
    assert replies[-1]["type"] == "generation_complete", replies[-1]
    chunks = [r for r in replies if r["type"] == "audio_chunk"]
    assert [c["seq"] for c in chunks] == list(range(len(chunks)))
    assert replies[-1]["chunks"] == len(chunks)
    return np.concatenate([_pcm(c["data"]) for c in chunks])


def _pcm_close(got, want, what):
    assert got.shape == want.shape and len(want) > 0, what
    peak = int(np.abs(want).max())
    assert peak > 0, what
    err = int(np.abs(got - want).max())
    assert err <= 1e-4 * peak + 1, (what, err, peak)


# ---------------------------------------------------------------------------
# Parity of the slice: JAX server vs the port's servers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["generate", "speech", "ws_stream"])
def test_port_server_matches_jax_server(servers, route):
    fn = {"generate": _generate, "speech": _speech, "ws_stream": _ws_stream}[route]
    want = fn(servers["jax"])
    _pcm_close(fn(servers["single"]), want, f"{route}: single worker")
    _pcm_close(fn(servers["batched"]), want, f"{route}: batched pool")


def test_batched_service_matches_single_worker(servers):
    """The pool (stream chunks through ContinuousBatcher) against the one
    worker (engine.generate / generate_stream) on the REST routes, the
    chunked stream included."""
    single = _generate(servers["single"], text="another line to say")
    _pcm_close(_generate(servers["batched"], text="another line to say"),
               single, "generate")
    _pcm_close(_stream(servers["batched"], text="another line to say"),
               single, "chunked stream")
    _pcm_close(_stream(servers["single"], text="another line to say"),
               single, "single chunked stream")


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------


def test_health_stats_demo(servers):
    for name in ("single", "batched"):
        live = servers[name]
        _, h, _ = _get(live.base, "/health")
        assert h["status"] == "healthy"
        _, st, _ = _get(live.base, "/stats")
        assert st["device"] == {"platform": "cpu"}
        assert isinstance(st["recommendations"], list)
        assert {"requests", "errors", "frames", "active"} <= set(st)
        _, page, hdr = _get(live.base, "/demo", raw=True)
        assert hdr["Content-Type"].startswith("text/html")
        assert str(live.ws.port).encode() in page
    _, st, _ = _get(servers["batched"].base, "/stats")
    assert st["active_streams"] == 0 and st["queue_depth"] == 0
    assert set(st["block_policy"]) == {"wall_ms_per_block", "rtt_ms",
                                       "frame_cost_ms"}
    assert {"blocks", "frames", "host_ms_per_frame"} <= set(st["host"])
    assert _code(_get, servers["single"].base, "/nope") == 404


def test_request_status_and_bad_input(servers):
    base = servers["single"].base
    _post(base, "/api/v1/tts/generate", dict(GREEDY, text="status check",
                                             request_id="req-42"))
    _, st, _ = _get(base, "/api/v1/tts/status/req-42")
    assert st["status"] == "completed" and st["duration_s"] > 0
    assert st["text_len"] == len("status check")
    assert _code(_get, base, "/api/v1/tts/status/unknown") == 404
    for path in ("/api/v1/tts/generate", "/api/v1/tts/generate-streaming"):
        assert _code(_post, base, path, {"text": ""}) == 400
        assert _code(_post, base, path, {"text": "<script>x</script>"}) == 400
    assert _code(_post, base, "/v1/audio/speech",
                 {"input": "hi", "response_format": "mp3"}) == 400


def test_engine_error_reaches_client(servers):
    """A request the engine rejects (a prompt past the largest bucket)
    answers 500 with the error; the service serves on."""
    base = servers["batched"].base
    assert _code(_post, base, "/api/v1/tts/generate",
                 dict(GREEDY, text="word " * 1500)) == 500
    assert len(_generate(servers["batched"], text="still here")) > 0


def test_voices_crud_and_clone(servers, tmp_path):
    base = servers["batched"].base
    audio = voiced(16_000, seed=1)
    pcm_hex = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes().hex()
    assert _code(_post, base, "/api/v1/voices/create",
                 {"name": "x", "reference_text": "t", "data": "00" * 10}) == 400
    assert _code(_post, base, "/api/v1/voices/create",
                 {"name": "x", "reference_text": "t", "data": pcm_hex,
                  "sample_rate": 1}) == 400
    _, v, _ = _post(base, "/api/v1/voices/create",
                    {"name": "alice", "reference_text": "Me, testing.",
                     "data": pcm_hex, "sample_rate": 16_000,
                     "language": "en"})
    pid = v["profile_id"]
    _, lst, _ = _get(base, "/api/v1/voices")
    assert [p["name"] for p in lst["voices"]] == ["alice"]
    _, one, _ = _get(base, f"/api/v1/voices/{pid}")
    assert one["metadata"] == {"language": "en"}
    _, c, _ = _post(base, "/api/v1/tts/clone",
                    {"text": "Cloned words.", "voice_profile_id": pid,
                     "top_k": 1})
    cloned = _pcm(c["data"])
    assert c["voice"] == "alice" and len(cloned) > 0
    assert np.abs(cloned).max() > 0
    # the OpenAI route clones a stored voice by name
    _, wav, _ = _post(base, "/v1/audio/speech",
                      {"input": "Cloned words.", "voice": "alice"}, raw=True)
    assert wav[:4] == b"RIFF" and len(wav) > 44
    assert _code(_post, base, "/api/v1/tts/clone",
                 {"text": "x", "voice_profile_id": "nope"}) == 404
    _, d, _ = _call(base, "DELETE", f"/api/v1/voices/{pid}")
    assert d["deleted"] is True
    assert _code(_call, base, "DELETE", f"/api/v1/voices/{pid}") == 404
    assert _code(_get, base, f"/api/v1/voices/{pid}") == 404


def test_conversation_lifecycle(servers):
    base = servers["single"].base
    _, s, _ = _post(base, "/api/v1/conversations/start", {"language": "en"})
    sid = s["session_id"]
    _, t, _ = _post(base, f"/api/v1/conversations/{sid}/turn",
                    dict(GREEDY, text="hello there"))
    assert t["response_text"] and len(_pcm(t["data"])) > 0
    _, conv, _ = _get(base, f"/api/v1/conversations/{sid}")
    assert [x["role"] for x in conv["turns"]] == ["user", "assistant"]
    _, e, _ = _call(base, "DELETE", f"/api/v1/conversations/{sid}")
    assert e["ended"] is True
    assert _code(_get, base, f"/api/v1/conversations/{sid}") == 404
    assert _code(_post, base, "/api/v1/conversations/nope/turn",
                 {"text": "hi"}) == 404


def test_openai_speech_pcm_and_transcriptions(servers):
    single, batched = servers["single"], servers["batched"]
    wav = _speech(single, "wav")
    np.testing.assert_array_equal(_speech(single, "pcm"), wav)
    audio = voiced(8_000, seed=2)
    pcm16 = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
    _, out, _ = _post(single.base, "/v1/audio/transcriptions",
                      {"data": pcm16.hex(), "sample_rate": 16_000})
    assert out == {"text": "8000 samples"}
    # multipart with a 24 kHz wav file part (resampled to 16 kHz)
    from scipy.io import wavfile
    buf = io.BytesIO()
    wavfile.write(buf, 24_000, (np.clip(voiced(12_000, 3), -1, 1)
                                * 32767).astype(np.int16))
    boundary = "frttsboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"model\""
            f"\r\n\r\nwhisper-1\r\n--{boundary}\r\nContent-Disposition: "
            f"form-data; name=\"file\"; filename=\"a.wav\"\r\nContent-Type: "
            f"audio/wav\r\n\r\n").encode() + buf.getvalue() + \
        f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        single.base + "/v1/audio/transcriptions", data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert json.loads(r.read()) == {"text": "8000 samples"}
    assert _code(_post, single.base, "/v1/audio/transcriptions",
                 {"data": "0000"}) == 400
    assert _code(_post, batched.base, "/v1/audio/transcriptions",
                 {"data": pcm16.hex()}) == 503


def _save_same_weights(engine, d):
    ckpt.save_params(ckpt.converted_path(d, "llm_posttrain"), engine.lm_params)
    ckpt.save_params(ckpt.converted_path(d, "codec"), engine.codec_params)


def test_admin_reload_keeps_live_streams(servers, engines, tmp_path):
    """A reload to the same weights while two chunked streams are live: both
    streams end whole, and the greedy request after it equals the one
    before. A dir outside the reload root answers 403, a missing dir or
    one without converted trees 400; the one-worker service swaps between
    two requests."""
    d = str(tmp_path)
    _save_same_weights(engines[1], d)
    live = servers["batched"]
    before = _generate(live, text="before and after")
    results = {}

    def stream(i):
        results[i] = _stream(live, text=f"live stream number {i}",
                             max_audio_length_ms=1600)
    ths = [threading.Thread(target=stream, args=(i,)) for i in range(2)]
    for t in ths:
        t.start()
    _, out, _ = _post(live.base, "/api/v1/admin/reload", {"dir": d})
    for t in ths:
        t.join(timeout=600)
    assert out["reloaded"] == d
    for i in range(2):
        want = _stream(servers["single"], text=f"live stream number {i}",
                       max_audio_length_ms=1600)
        _pcm_close(results[i], want, f"stream {i} across the reload")
    _pcm_close(_generate(live, text="before and after"), before,
               "after the reload")
    assert _code(_post, live.base, "/api/v1/admin/reload",
                 {"dir": "/no/such/dir"}) == 403
    assert _code(_post, live.base, "/api/v1/admin/reload",
                 {"dir": d + "/../../.."}) == 403
    assert _code(_post, live.base, "/api/v1/admin/reload",
                 {"dir": str(tmp_path / "missing")}) == 400
    assert _code(_post, live.base, "/api/v1/admin/reload",
                 {"dir": str(tmp_path / "torch")}) == 400
    _, out, _ = _post(servers["single"].base, "/api/v1/admin/reload",
                      {"dir": d})
    assert out["reloaded"] == d
    _pcm_close(_generate(servers["single"], text="before and after"), before,
               "after the one worker's reload")


def test_admin_reload_needs_a_root_and_unpickles_nothing(servers, tmp_path,
                                                         monkeypatch):
    """Without a reload root the route answers 403. Under one, a dir that
    holds only the reference pickles answers 400 and nothing is loaded:
    a hot reload reads only the converted DIR/torch/ trees."""
    import torch

    srv = t_server.HealthHTTPServer(servers["single"].ws, host="127.0.0.1",
                                    port=free_port())
    srv.start()
    try:
        assert _code(_post, f"http://127.0.0.1:{srv.httpd.server_port}",
                     "/api/v1/admin/reload", {"dir": str(tmp_path)}) == 403
    finally:
        srv.stop()
    for name in ("llm_posttrain.pt", "codec.pt"):
        torch.save({"model": {}, "generator": {}}, tmp_path / name)
    loads = []
    monkeypatch.setattr(torch, "load", lambda *a, **k: loads.append(a))
    assert _code(_post, servers["batched"].base, "/api/v1/admin/reload",
                 {"dir": str(tmp_path)}) == 400
    assert _code(_post, servers["batched"].base, "/api/v1/admin/reload",
                 {"dir": 7}) == 403
    assert loads == []


def test_chunked_stream_starts_no_thread_per_request(servers):
    """During a burst of chunked streams the server's new threads are the
    connections' handler threads and the bounded consumer pool's, nothing
    else; a second burst reuses the pool (no new consumer thread)."""
    live = servers["batched"]
    n = 4

    def burst():
        gate = threading.Barrier(n + 1, timeout=300)
        release = threading.Event()
        got = {}

        def client(i):
            conn = http.client.HTTPConnection("127.0.0.1",
                                              live.http.httpd.server_port,
                                              timeout=600)
            conn.request("POST", "/api/v1/tts/generate-streaming",
                         body=json.dumps(dict(GREEDY, text=f"burst {i}",
                                              max_audio_length_ms=1600)),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            first = resp.read(2)              # the stream has started
            gate.wait()
            release.wait(300)
            got[i] = first + resp.read()
            conn.close()
        clients = [threading.Thread(target=client, args=(i,), name=f"cl{i}")
                   for i in range(n)]
        for c in clients:
            c.start()
        gate.wait()
        during = {t.ident: t.name for t in threading.enumerate()}
        release.set()
        for c in clients:
            c.join(timeout=600)
        assert all(len(got[i]) > 2 for i in range(n))
        return during

    before = {t.ident for t in threading.enumerate()}
    during1 = burst()
    new1 = {i: nm for i, nm in during1.items()
            if i not in before and not nm.startswith("cl")}
    handlers = [nm for nm in new1.values() if "process_request_thread" in nm]
    others = [nm for nm in new1.values() if "process_request_thread" not in nm
              and not nm.startswith("tts-consumer")]
    assert len(handlers) == n and not others, new1
    consumers1 = {i for i, nm in during1.items() if nm.startswith("tts-consumer")}
    during2 = burst()
    consumers2 = {i for i, nm in during2.items() if nm.startswith("tts-consumer")}
    assert consumers2 <= consumers1 | {i for i in during2 if i in before}
    assert len(consumers2) <= 4 * 4           # the pool's bound


def test_listen_backlog_takes_a_burst_of_connections(servers):
    """32 clients connecting at once all complete their handshakes while
    the server accepts none yet (socketserver's default backlog of 5
    drops the rest, each retried a second or more later)."""
    import socket

    srv = t_server.HealthHTTPServer(servers["single"].ws, host="127.0.0.1",
                                    port=free_port())   # bound, not started
    socks = []
    try:
        for _ in range(32):
            socks.append(socket.create_connection(
                ("127.0.0.1", srv.httpd.server_port), timeout=0.5))
    finally:
        for sk in socks:
            sk.close()
        srv.httpd.server_close()
    assert len(socks) == 32


def test_auth_guard(servers):
    live, token = servers["auth"], servers["token"]
    _, h, _ = _get(live.base, "/health")
    assert h["status"] == "healthy"
    for method, path, obj in (("POST", "/api/v1/tts/generate", {"text": "hi"}),
                              ("POST", "/v1/audio/speech", {"input": "hi"}),
                              ("GET", "/api/v1/voices", None),
                              ("POST", "/api/v1/admin/reload", {"dir": "/"})):
        assert _code(_call, live.base, method, path, obj) == 401
        assert _code(_call, live.base, method, path, obj,
                     token=token + "x") == 401
    _, out, _ = _post(live.base, "/api/v1/tts/generate",
                      dict(GREEDY, text="authorised"), token=token)
    assert len(_pcm(out["data"])) > 0
    [err] = _ws(live, {"type": "generate_speech", "text": "hi"})
    assert err == {"type": "error", "error": "unauthorized"}
    replies = _ws(live, dict(GREEDY, type="generate_speech", text="hi ws",
                             token=token))
    assert replies[-1]["type"] == "generation_complete"


# ---------------------------------------------------------------------------
# The WebSocket message vocabulary
# ---------------------------------------------------------------------------


def test_websocket_vocabulary(servers):
    live = servers["single"]
    r = _ws(live, {"type": "ping"}, {"type": "session_start"}, "not json",
            {"type": "nope"}, {"type": "generate_speech"},
            {"type": "get_stats"}, until=None)
    assert [x["type"] for x in r] == ["pong", "session_start", "error",
                                      "error", "error", "stats"]
    assert r[2]["error"] == "invalid json"
    assert r[3]["error"] == "unknown message type: nope"
    assert r[4]["error"] == "text is required"
    assert r[5]["stats"]["device"] == {"platform": "cpu"}
    sid = r[1]["session_id"]
    [ended] = _ws(live, {"type": "session_end", "session_id": sid}, until=None)
    assert ended == {"type": "session_end", "ok": True}
    # a whole (non-streaming) request carries its audio in the completion
    replies = _ws(live, dict(GREEDY, type="generate_speech", text=TEXT,
                             streaming=False))
    assert [x["type"] for x in replies] == ["generation_started",
                                            "generation_complete"]
    done = replies[-1]
    assert done["chunks"] == 0 and done["format"] == "pcm16"
    _pcm_close(_pcm(done["data"]), _generate(live), "ws whole")
    [bad] = _ws(live, {"type": "generate_speech", "text": "<script>1</script>"})
    assert bad["type"] == "error"


def test_websocket_dialogue(servers, tmp_path):
    live = servers["single"]
    [bad] = _ws(live, {"type": "generate_dialogue", "text_list": []})
    assert bad["type"] == "error" and "text_list" in bad["error"]
    [nostore] = _ws(live, {"type": "generate_dialogue",
                           "text_list": ["[S1]Hi."], "voices": {"[S1]": "x"}})
    assert "no voice store" in nostore["error"]
    replies = _ws(live, {"type": "generate_dialogue", "top_k": 1,
                         "text_list": ["[S1]Hello there.", "[S2]Hi back."],
                         "max_utterance_ms": 640})
    assert replies[0] == {"type": "generation_started",
                          "request_id": replies[0]["request_id"],
                          "utterances": 2}
    chunks = [x for x in replies if x["type"] == "audio_chunk"]
    assert {c["utterance"] for c in chunks} == {0, 1}
    done = replies[-1]
    assert done["type"] == "generation_complete" and done["utterances"] == 2
    assert done["chunks"] == len(chunks) and done["duration_s"] > 0
    # voices resolved through the batched server's store, by name
    base = servers["batched"].base
    audio = voiced(16_000, seed=4)
    pcm_hex = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes().hex()
    _, v, _ = _post(base, "/api/v1/voices/create",
                    {"name": "bob", "reference_text": "[S1]Me.",
                     "data": pcm_hex})
    blive = servers["batched"]
    [unknown] = _ws(blive, {"type": "generate_dialogue",
                            "text_list": ["[S1]Hi."],
                            "voices": {"[S1]": "nobody"}})
    assert "unknown voice" in unknown["error"]
    replies = _ws(blive, {"type": "generate_dialogue", "top_k": 1,
                          "text_list": ["[S1]Hi.", "[S1]Again."],
                          "voices": {"[S1]": "bob"}, "max_utterance_ms": 640})
    assert replies[-1]["type"] == "generation_complete", replies[-1]
    assert {x["utterance"] for x in replies
            if x["type"] == "audio_chunk"} == {0, 1}
    _call(base, "DELETE", f"/api/v1/voices/{v['profile_id']}")
