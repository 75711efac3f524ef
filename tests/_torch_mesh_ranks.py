"""Rank functions of tests/test_torch_mesh_ranks.py, run by
``fireredtts2_tpu_torch.parallel.mesh.Ranks`` in fresh processes joined
by gloo. This module imports no JAX: the ranks run the port alone, on the
weights the test also gives the JAX engine."""

import dataclasses
import json
import tempfile
import threading
import urllib.error
import urllib.request

import numpy as np

from fireredtts2_tpu_torch.config import tiny_engine_config
from fireredtts2_tpu_torch.engine import FireRedTTS2Engine
from fireredtts2_tpu_torch.parallel import mesh as pm
from fireredtts2_tpu_torch.runtime.batcher import ContinuousBatcher
from fireredtts2_tpu_torch.serve.server import (
    HealthHTTPServer, TTSRequest, WebSocketTTSServer,
)

TEXTS = ["Good morning to you all.", "Hi.", "One two.", "Three four."]
SPEAKERS = ["[S1]", "[S2]", "[S1]", "[S2]"]
GREEDY = dict(max_audio_length_ms=640, temperature=1.0, topk=1)


def greedy_config(**llm):
    cfg = tiny_engine_config(depth_topk=1)
    return dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, dtype="float32", **llm))


def _refusals(ws, port: int, voice_dir: str) -> dict:
    """Rank 0, its pool serving: what a tp > 1 engine refuses outside the
    pool's lockstep (its device calls would run collectives rank 1 never
    joins) comes back as an error within a deadline: a voice-create request
    (HTTP code) and a prompt-less clone (the error's type)."""
    health = HealthHTTPServer(ws, host="127.0.0.1", port=port,
                              voice_dir=voice_dir)
    health.start()
    out = {}
    try:
        body = json.dumps({
            "name": "v", "reference_text": "Hello there.",
            "sample_rate": 16_000,
            "data": (np.zeros(8_000, "<i2") + 100).tobytes().hex()}).encode()
        try:
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/api/v1/voices/create", data=body,
                headers={"Content-Type": "application/json"}), timeout=30)
            out["voice"] = 200
        except urllib.error.HTTPError as e:
            out["voice"] = e.code
        done, box = threading.Event(), {}
        ws.service.submit(TTSRequest(
            request_id="clone", text="Hi.", speaker="[S1]", temperature=1.0,
            topk=1, streaming=False, mode="monologue_clone",
            on_chunk=lambda c: None,
            on_done=lambda audio, err: (box.update(err=err), done.set())))
        out["clone"] = (type(box["err"]).__name__ if done.wait(30)
                        else "timeout")
    finally:
        health.stop()
    return out


def _pool(engine, voice_dir: str) -> tuple:
    """The four texts as one burst through a 4-slot pool: rank 0 serves it
    (the server's pool) and submits, rank 1 follows; then rank 0's
    refusals (:func:`_refusals`). -> (the streams, the refusals) on rank 0,
    (None, None) on rank 1."""
    if not engine.mesh.is_leader:
        ContinuousBatcher(engine, max_streams=4).follow()
        return None, None
    ws = WebSocketTTSServer(engine, max_streams=4)
    b = ws.service.batcher
    try:
        with b.burst():
            hs = [b.submit(t, s, temperature=1.0, topk=1,
                           max_audio_length_ms=GREEDY["max_audio_length_ms"])
                  for t, s in zip(TEXTS, SPEAKERS)]
        streams = [np.concatenate(list(h)) for h in hs]
        return streams, _refusals(ws, pm.free_port(), voice_dir)
    finally:
        ws.service.shutdown()


def serving(rank: int, world: int, lm_params: dict, codec_params: dict
            ) -> dict:
    """Every rank: on a tp=2 engine, generate of the first text, a decode
    block of generate_stream with its collectives counted,
    generate_batch of the four texts and the pool; the same batch on a tp=2
    int8-backbone engine and on a dp=2 engine; then the tp=2 engine's
    generate once more."""
    out: dict = {}
    kw = dict(device="cpu", lm_params=lm_params, codec_params=codec_params)

    mesh = pm.make_mesh(dp=1, tp=2)
    eng = FireRedTTS2Engine(greedy_config(), mesh=mesh, **kw)
    out["wq_cols"] = eng.lm_params["backbone"]["wq"].shape[-1]
    out["fc1_cols"] = eng.codec_params["acoustic_decoder"]["layers"][
        "fc1_w"].shape[-1]
    out["generate"] = eng.generate(TEXTS[0], SPEAKERS[0], **GREEDY)
    out["tokens"] = eng.last_tokens
    stream = eng.generate_stream(TEXTS[0], SPEAKERS[0], **GREEDY)
    next(stream)                       # the prefill and the 1-frame block
    pm.reset_collective_stats()
    next(stream)                       # one decode block (4 frames)
    out["comm"] = pm.collective_stats()
    list(stream)
    out["slab_bytes"] = min(eng._new_lm_state(1).cache_k.nbytes,
                            eng._new_vstate(1).kv_k.nbytes * mesh.tp)
    out["batch_tp"] = eng.generate_batch(TEXTS, SPEAKERS, **GREEDY)
    with tempfile.TemporaryDirectory() as voice_dir:
        out["pool"], out["refused"] = _pool(eng, voice_dir)

    tp_eng = eng
    eng = FireRedTTS2Engine(greedy_config(quantize_backbone=True), mesh=mesh,
                            **kw)
    out["int8_wq"] = (str(eng.lm_params["backbone"]["wq"].dtype),
                      tuple(eng.lm_params["backbone"]["wq_scale"].shape))
    out["int8"] = eng.generate_batch(TEXTS, SPEAKERS, **GREEDY)

    eng = FireRedTTS2Engine(greedy_config(), mesh=pm.make_mesh(dp=2, tp=1),
                            **kw)
    out["dp_rows"] = eng._rows(4)
    out["batch_dp"] = eng.generate_batch(TEXTS, SPEAKERS, **GREEDY)
    # the first engine again, two engines on other meshes built since
    out["generate_again"] = tp_eng.generate(TEXTS[0], SPEAKERS[0], **GREEDY)
    return out
