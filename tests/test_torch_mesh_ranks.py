"""Meshed serving of the port over two gloo ranks against the JAX engine
on a (1, 2) mesh (tests/test_multichip.py's engine cases): generate at
tp=2, generate_batch at dp=2, the pool on a meshed engine and the int8
backbone, all greedy at float32, so the two packages' different noise
draws cannot part them and equal audio means equal tokens. Both packages
take one set of weights, drawn by the port's initialisers. The two ranks
are spawned once for the module (tests/_torch_mesh_ranks.py, which
imports no JAX), run while the JAX engines do, and are joined or killed
before it ends; the collectives they made are counted."""

import dataclasses
import multiprocessing
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireredtts2_tpu.config import tiny_engine_config as j_tiny
from fireredtts2_tpu.engine import engine as j_engine
from fireredtts2_tpu.parallel.mesh import make_mesh

from fireredtts2_tpu_torch.models.codec.model import init_codec_params
from fireredtts2_tpu_torch.models.lm.model import init_lm_params
from fireredtts2_tpu_torch.parallel.mesh import Ranks

import _torch_mesh_ranks as ranks
from _torch_parity import one_torch_thread, wave_close  # noqa: F401


def _jcfg(**llm):
    cfg = j_tiny(depth_topk=1)
    return dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, dtype="float32", **llm))


def _jax_engine(lm, codec, **llm):
    """The JAX engine on a (1, 2) mesh, its initialisers replaced by the
    port's trees (no JAX initialiser runs)."""
    def tree(t):
        return jax.tree.map(lambda x: jnp.asarray(x.numpy()), t)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_engine, "init_lm_params", lambda k, c, d: tree(lm))
        mp.setattr(j_engine, "init_codec_params", lambda k, c, d: tree(codec))
        return j_engine.FireRedTTS2Engine(config=_jcfg(**llm), seed=0,
                                          mesh=make_mesh(dp=1, tp=2))


@pytest.fixture(scope="module")
def runs():
    """(the JAX engines' outputs, rank 0's and rank 1's results)."""
    cfg = ranks.greedy_config()
    gen = torch.Generator().manual_seed(3)
    lm = init_lm_params(gen, cfg.llm)
    codec = init_codec_params(gen, cfg.codec, semantic_head=True)
    batch = (ranks.TEXTS, ranks.SPEAKERS)
    procs = Ranks(ranks.serving, 2, (lm, codec), timeout_s=240)
    try:
        engines = {"batch": _jax_engine(lm, codec),
                   "int8": _jax_engine(lm, codec, quantize_backbone=True)}
        # the two engines compile side by side (XLA's compiles release
        # the GIL)
        with ThreadPoolExecutor(2) as pool:
            jobs = {k: pool.submit(e.generate_batch, *batch, **ranks.GREEDY)
                    for k, e in engines.items()}
        want = {k: j.result() for k, j in jobs.items()}
        want.update(wq_cols=lm["backbone"]["wq"].shape[-1],
                    fc1_cols=codec["acoustic_decoder"]["layers"]["fc1_w"]
                    .shape[-1])
    finally:
        got = procs.join()
    yield want, got
    assert multiprocessing.active_children() == []


def _rows_close(got, want, what):
    assert [a.shape for a in got] == [a.shape for a in want]
    for i, (a, b) in enumerate(zip(got, want)):
        wave_close(a, b, f"{what} row {i}")


def test_generate_tp2_matches_jax_mesh(runs):
    """generate at tp=2: wq and the vocoder's fc1 hold half their columns a
    rank; both ranks return the JAX (1, 2)-mesh engine's audio of that text
    (its row of the batch: greedy decode is invariant to the left pad) and
    the same tokens. Each engine reads its own mesh: the same call after
    two engines on other meshes were built returns the same audio."""
    want, got = runs
    assert got[0]["wq_cols"] * 2 == want["wq_cols"]
    assert got[0]["fc1_cols"] * 2 == want["fc1_cols"]
    for r in got:
        wave_close(r["generate"], want["batch"][0], "tp=2 generate")
        np.testing.assert_array_equal(r["generate_again"], r["generate"])
    np.testing.assert_array_equal(got[0]["tokens"], got[1]["tokens"])


def test_generate_batch_dp2_and_tp2_match_jax_mesh(runs):
    """generate_batch with the 4 rows split 2/2 over dp, and at tp=2 every
    row on both ranks: each row is the JAX meshed engine's."""
    want, got = runs
    assert got[0]["dp_rows"] == (0, 2) and got[1]["dp_rows"] == (2, 4)
    for r in got:
        _rows_close(r["batch_dp"], want["batch"], "dp=2")
        _rows_close(r["batch_tp"], want["batch"], "tp=2")


def test_pool_on_meshed_engine_matches_jax(runs):
    """ContinuousBatcher over the tp=2 engine, the four texts as one burst
    (rank 0 admits, rank 1 follows): each greedy stream equals the JAX
    meshed engine's audio of its text."""
    want, got = runs
    assert got[1]["pool"] is None
    _rows_close(got[0]["pool"], want["batch"], "pool")


def test_tp_server_refuses_calls_outside_the_lockstep(runs):
    """Rank 0's server on the tp=2 pool: a voice-create request answers 501
    and a prompt-less clone ends in NotImplementedError, each within 30 s
    (run, either would wait forever in a collective rank 1 never joins);
    the pool then stops both ranks."""
    _, got = runs
    assert got[0]["refused"] == {"voice": 501,
                                 "clone": "NotImplementedError"}
    assert got[1]["refused"] is None


def test_int8_backbone_tp2_matches_jax_mesh(runs):
    """The int8 backbone under tp=2: the int8 weight and its column scale
    split together; the audio is the JAX int8 meshed engine's."""
    want, got = runs
    assert got[0]["int8_wq"] == ("torch.int8", (2, 1, want["wq_cols"] // 2))
    for r in got:
        _rows_close(r["int8"], want["int8"], "int8 tp=2")


def test_no_collective_moves_a_slab(runs):
    """tests/test_comm_pattern.py's bar for a decode block of the port
    (4 frames: LM steps and their vocoder pass): no collective moves a
    quarter of either whole KV slab (an LM rank gathers its fresh
    (B, S, W) K/V rows, never the slab)."""
    _, got = runs
    for r in got:
        c = r["comm"]
        assert c["calls"] > 0
        assert c["max_bytes"] < r["slab_bytes"] // 4, c
