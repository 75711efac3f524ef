"""PyTorch port, the client and the CLI on the CPU (tiny config):

- ``fireredtts2_tpu_torch.client.FireRedTTSClient`` against a live port
  server: every method (REST, chunked stream, WebSocket stream and
  dialogue, the OpenAI routes, voices, conversations, admin reload);
- ``python -m fireredtts2_tpu_torch --device cpu`` generate, monologue,
  qa and serve (a subprocess answering over its sockets), train (the LM
  and the codec) and export;
- serve --asr / --asr-dir (a tiny HF whisper dir) / --asr-int8 /
  --asr-max-new-tokens build the transcriber, and /v1/audio/transcriptions answers with it, in process
  and from the serve subprocess;
- ``--speculative-depth qa`` on an engine whose depth decoder runs Jacobi
  rounds;
- the entry point's defaults: the card unless --device cpu is given, and
  every flag or subcommand of the JAX CLI without a port exits non-zero
  naming its ROADMAP item.
"""

import os
import subprocess
import sys
import time
import urllib.error

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from fireredtts2_tpu_torch import __main__ as cli
from fireredtts2_tpu_torch.asr import WhisperASR, WhisperASRModelConfig
from fireredtts2_tpu_torch.asr.convert import write_hf_whisper_dir
from fireredtts2_tpu_torch.client import FireRedTTSClient
from fireredtts2_tpu_torch.config import tiny_engine_config
from fireredtts2_tpu_torch.engine import FireRedTTS2Engine
from fireredtts2_tpu_torch.runtime import checkpoint as ckpt

from _torch_parity import one_torch_thread, voiced  # noqa: F401  (autouse)
from conftest import free_port
from test_torch_rest import _Live, _pcm_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = 640


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    from fireredtts2_tpu_torch.serve import server

    engine = FireRedTTS2Engine(tiny_engine_config(), device="cpu", seed=0)
    srv = _Live(server, engine, max_streams=2,
                voice_dir=str(tmp_path_factory.mktemp("voices")),
                transcriber=lambda a: f"heard {len(a)}",
                reload_root=str(tmp_path_factory.getbasetemp()))
    yield srv, engine
    srv.close()


@pytest.fixture(scope="module")
def client(live):
    srv, _ = live
    return FireRedTTSClient(srv.base, ws_url=srv.ws_url, timeout=300)


def test_client_synthesis_routes(client):
    assert client.health()["status"] == "healthy"
    assert client.stats()["device"] == {"platform": "cpu"}
    a, sr = client.synthesize("Client words.", top_k=1, seed=7,
                              max_audio_length_ms=MS)
    assert sr == 24_000 and a.dtype == np.float32 and len(a) > 0
    # the same seed replays the same sampled request, on every route
    b, _ = client.synthesize("Client words.", top_k=1, seed=7,
                             max_audio_length_ms=MS)
    q = lambda x: np.round(x * 32768).astype(np.int32)  # noqa: E731
    _pcm_close(q(b), q(a), "a replay")
    s = np.concatenate(list(client.synthesize_streaming(
        "Client words.", top_k=1, seed=7, max_audio_length_ms=MS)))
    w = np.concatenate(list(client.stream_ws(
        "Client words.", top_k=1, seed=7, max_audio_length_ms=MS)))
    _pcm_close(q(s), q(a), "chunked stream")
    _pcm_close(q(w), q(a), "ws stream")
    wav = client.speech("Spoken words.", response_format="wav",
                        temperature=0.5, seed=3)
    assert wav[:4] == b"RIFF"
    pcm = client.speech("Spoken words.", response_format="pcm",
                        temperature=0.5, seed=3)
    _pcm_close(np.frombuffer(pcm, "<i2").astype(np.int32),
               np.frombuffer(wav[44:], "<i2").astype(np.int32), "pcm vs wav")
    pairs = list(client.stream_dialogue_ws(["[S1]Hi.", "[S2]Yo."],
                                           max_utterance_ms=MS))
    assert {i for i, _ in pairs} == {0, 1}
    assert client.transcribe(voiced(4_000, 1)) == "heard 4000"


def test_client_voices_conversations_reload(client, live, tmp_path):
    _, engine = live
    pid = client.create_voice("carol", "Me, speaking.", voiced(16_000, 2))
    assert [v["name"] for v in client.list_voices()] == ["carol"]
    a, sr = client.clone_speech("In her voice.", pid, seed=5)
    assert sr == 24_000 and len(a) > 0 and np.isfinite(a).all()
    sid = client.start_conversation(language="en")
    turn = client.conversation_turn(sid, "hello", max_audio_length_ms=MS)
    assert turn["response_text"] and len(bytes.fromhex(turn["data"])) > 0
    d = str(tmp_path)
    ckpt.save_params(ckpt.converted_path(d, "llm_posttrain"), engine.lm_params)
    ckpt.save_params(ckpt.converted_path(d, "codec"), engine.codec_params)
    out = client.admin_reload(d)
    assert out["reloaded"] == d


# subprocesses on one torch thread, as the in-process tests run
ENV = dict(os.environ, OMP_NUM_THREADS="1")


def _cli(*args, **kw):
    return subprocess.Popen([sys.executable, "-m", "fireredtts2_tpu_torch",
                             *args], cwd=REPO, env=ENV, text=True, **kw)


def test_cli_generate_monologue_qa(tmp_path):
    """The three subcommands, run side by side."""
    d_out, m_out = str(tmp_path / "d.wav"), str(tmp_path / "m.wav")
    runs = {name: _cli("--device", "cpu", *argv, stdout=subprocess.PIPE,
                       stderr=subprocess.PIPE)
            for name, argv in (
                ("generate", ["generate", "--text", "[S1]Hi there. [S2]Hello.",
                              "--out", d_out, "--max-utterance-ms", str(MS)]),
                ("monologue", ["monologue", "--text", "Hi there.", "--out",
                               m_out]),
                ("qa", ["qa"]))}
    res = {k: (p, *p.communicate(timeout=300)) for k, p in runs.items()}
    for name, (p, out, err) in res.items():
        assert p.returncode == 0, (name, out, err)
    sr, data = wavfile.read(d_out)
    assert sr == 24_000 and data.dtype == np.int16 and len(data) > 0
    assert f"wrote {d_out}" in res["generate"][1]
    assert wavfile.read(m_out)[0] == 24_000
    lines = [ln for ln in res["qa"][1].splitlines() if ln.startswith("[")]
    assert len(lines) == 5 and all(ln.startswith("[PASS]") for ln in lines)


def test_cli_serve_answers_over_sockets(tmp_path):
    """The serve subcommand: /health once ready, a request, admin reload
    only under --reload-root, a stop."""
    http_port, ws_port = free_port(), free_port()
    log = open(tmp_path / "serve.log", "w")
    proc = _cli("--device", "cpu", "serve", "--host", "127.0.0.1",
                "--http-port", str(http_port), "--ws-port", str(ws_port),
                "--max-streams", "2", "--reload-root", str(tmp_path / "ckpts"),
                "--asr", stdout=log, stderr=subprocess.STDOUT)
    try:
        c = FireRedTTSClient(f"http://127.0.0.1:{http_port}",
                             ws_url=f"ws://127.0.0.1:{ws_port}", timeout=120)
        deadline = time.monotonic() + 120
        while True:
            try:
                assert c.health()["status"] == "healthy"
                break
            except OSError:
                assert proc.poll() is None, open(tmp_path / "serve.log").read()
                assert time.monotonic() < deadline, "no /health in 120 s"
                time.sleep(0.2)
        st = c.stats()
        assert st["device"] == {"platform": "cpu"} and "active_streams" in st
        a, _ = c.synthesize("Served.", max_audio_length_ms=MS, seed=1)
        assert len(a) > 0
        assert c.transcribe(voiced(8_000, 4)) != ""
        assert len(np.concatenate(list(c.stream_ws(
            "Served.", max_audio_length_ms=MS)))) > 0
        for d, code in ((tmp_path, 403), (tmp_path / "ckpts" / "none", 400)):
            with pytest.raises(urllib.error.HTTPError) as e:
                c.admin_reload(str(d))
            assert e.value.code == code
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        log.close()
    assert "serving: http://127.0.0.1:" in open(tmp_path / "serve.log").read()


@pytest.mark.parametrize("argv,item", [
    (["--tp", "2", "qa"], "item 13"),
    (["--dp", "2", "qa"], "item 13"),
    (["serve", "--profiler-port", "9999"], "tracing item"),
    (["bench"], "item 1 "),
    (["train", "--zero1"], "item 13"),
    (["train", "--tp", "2"], "item 13"),
])
def test_cli_unported_flags_exit_nonzero(argv, item):
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu"] + argv)
    assert e.value.code not in (0, None)
    assert "no port yet" in str(e.value.code) and item in str(e.value.code)


# a tiny whisper with large-v3's vocabulary, whose special-token ids an HF
# config.json leaves at their defaults
TINY_HF = WhisperASRModelConfig(
    n_mels=16, encoder_layers=2, decoder_layers=2, num_heads=2, embed_dim=32,
    ffn_dim=64, max_source_positions=32, max_target_positions=24)


@pytest.fixture(scope="module")
def whisper_dir(tmp_path_factory):
    """A tiny HF whisper dir from random port weights, and the weights."""
    src = WhisperASR(model_cfg=TINY_HF, warmup=False, device="cpu", seed=4)
    d = str(tmp_path_factory.mktemp("whisper"))
    write_hf_whisper_dir(d, src.params, TINY_HF)
    return d, src.params


@pytest.mark.parametrize("argv", [["--asr"], ["--asr", "--asr-int8"],
                                  ["--asr", "--asr-dir", "DIR"],
                                  ["--asr", "--asr-dir", "DIR", "--asr-int8"],
                                  ["--asr", "--asr-dir", "DIR",
                                   "--asr-max-new-tokens", "6"]])
def test_cli_serve_asr_flags_build_transcriber(whisper_dir, argv, capsys):
    """serve's --asr flags -> the WhisperASR the server is given: the tiny
    dev model, or the dir's weights (loaded, warmed up), int8 on ask, each
    window's decode capped on ask (default: what the positions hold)."""
    d, params = whisper_dir
    argv = [d if a == "DIR" else a for a in argv]
    args = cli.build_parser().parse_args(["--device", "cpu", "serve", *argv])
    asr = cli._build_asr(args)
    int8 = "--asr-int8" in argv
    assert asr.device.type == "cpu"
    cap = (6 if "--asr-max-new-tokens" in argv
           else asr.model_cfg.max_target_positions - 5)
    assert asr.config.max_new_tokens == cap
    assert (asr.params["decoder"]["layers"]["fc1_w"].dtype == torch.int8) == int8
    if "--asr-dir" in argv:
        assert asr.model_cfg == TINY_HF and asr.total_transcriptions == 1
        assert torch.equal(asr.params["decoder"]["token_emb"],
                           params["decoder"]["token_emb"])
        if not int8:
            assert torch.equal(asr.params["encoder"]["layers"]["wq"],
                               params["encoder"]["layers"]["wq"])
    else:
        assert "tiny random-weight dev ASR" in capsys.readouterr().err
        assert asr.total_transcriptions == 0
    text = asr.as_transcriber()(voiced(8_000, 3))
    assert text and all(0 <= int(i) < asr.model_cfg.vocab_size
                        for i in text.split())
    assert cli._build_asr(cli.build_parser().parse_args(
        ["--device", "cpu", "serve"])) is None


def test_openai_transcription_route_with_whisper(live, whisper_dir):
    """/v1/audio/transcriptions on an in-process server with the tiny
    engine and the dir's Whisper: 200 and the transcriber's text, through
    client.transcribe."""
    from fireredtts2_tpu_torch.serve import server

    srv, _ = live
    asr = cli._build_asr(cli.build_parser().parse_args(
        ["--device", "cpu", "serve", "--asr", "--asr-dir", whisper_dir[0]]))
    http = server.HealthHTTPServer(srv.ws, host="127.0.0.1", port=free_port(),
                                   transcriber=asr.as_transcriber())
    http.start()
    try:
        c = FireRedTTSClient(f"http://127.0.0.1:{http.httpd.server_port}",
                             timeout=120)
        audio = voiced(12_000, 5)
        text = c.transcribe(audio)
        assert text != "" and text == asr.transcribe(audio).text
    finally:
        http.stop()


def test_cli_train_and_export(tmp_path, capsys):
    """train --model lm and --model codec, 2 steps each with checkpoints
    and an eval at step 2, then export both into a serving dir of
    DIR/torch/ trees."""
    ck = {m: str(tmp_path / m) for m in ("lm", "codec")}
    cli.main(["--device", "cpu", "train", "--model", "lm", "--steps", "2",
              "--batch-size", "2", "--seq-len", "16", "--log-every", "1",
              "--eval-every", "2", "--ckpt-dir", ck["lm"]])
    cli.main(["--device", "cpu", "train", "--model", "codec", "--steps", "2",
              "--batch-size", "1", "--window-samples", "2560",
              "--log-every", "1", "--eval-every", "2", "--remat", "dots",
              "--ckpt-dir", ck["codec"]])
    out = capsys.readouterr().out
    assert out.count("step 2: loss ") == 2 and "step 1: loss " in out
    evals = [ln for ln in out.splitlines() if ln.startswith("step 2: eval_")]
    assert len(evals) == 2 and all(" eval_loss " in ln for ln in evals), out
    cfg = tmp_path / "cfg"
    cfg.mkdir()
    for name in ("config_llm.json", "config_codec.json"):
        (cfg / name).write_text("{}")
    steps = {m: os.path.join(d, "step_00000002") for m, d in ck.items()}
    with pytest.raises(SystemExit) as e:
        cli.main(["export", "--out", str(tmp_path / "served"), "--config-dir",
                  str(cfg), "--lm-ckpt", steps["lm"], "--codec-ckpt",
                  steps["codec"]])
    assert e.value.code == 0
    assert '"exported": [\n    "llm_posttrain",\n    "codec"\n  ]' in \
        capsys.readouterr().out
    import torch
    lm = ckpt.load_params(ckpt.converted_path(str(tmp_path / "served"),
                                              "llm_posttrain"))
    saved = torch.load(os.path.join(steps["lm"], "params.pt"),
                       weights_only=True)
    assert torch.equal(lm["backbone"]["wq"], saved["backbone"]["wq"])


def test_cli_speculative_depth_qa(monkeypatch, capsys):
    """--speculative-depth reaches the engine's config, and the QA
    scenarios pass on it (tiny, CPU), its depth decode in Jacobi rounds."""
    from fireredtts2_tpu_torch.models.lm import model as lm_model

    built = []
    build = cli._build_engine
    monkeypatch.setattr(cli, "_build_engine",
                        lambda args: built.append(build(args)) or built[-1])
    lm_model.reset_jacobi_counts()
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", "--speculative-depth", "qa"])
    assert e.value.code == 0
    assert built[0].config.llm.speculative_depth is True
    assert lm_model.depth_decode_jacobi.calls > 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[")]
    assert len(lines) == 5 and all(ln.startswith("[PASS]") for ln in lines)
    assert "--speculative-depth" not in cli.NOT_PORTED


def test_cli_runs_on_the_card_unless_asked():
    assert cli.build_parser().parse_args(["qa"]).device == "cuda"
    assert cli.build_parser().parse_args(
        ["--device", "cpu", "qa"]).device == "cpu"
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["qa"])
