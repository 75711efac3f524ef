"""The port's serving mesh against the JAX package's (parallel/mesh.py):
placement rules as spec trees, make_mesh's shapes and errors, kernel A's
kv-head window and the tp shard routes of kernels A and C, on the CPU
(the port's plain versions against the Pallas kernels in interpret mode
and their shard_map routes on the 8-device virtual mesh)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireredtts2_tpu.config import tiny_engine_config as j_tiny
from fireredtts2_tpu.models.codec.model import init_codec_params as j_init_codec
from fireredtts2_tpu.models.codec.decoder import (
    stream_state_init as j_voc_state,
)
from fireredtts2_tpu.models.lm.model import init_lm_params as j_init_lm
from fireredtts2_tpu.models.lm.model import init_lm_state as j_lm_state
from fireredtts2_tpu.models.lm.transformer import (
    quantize_transformer_int8 as j_q8,
)
from fireredtts2_tpu.ops import pallas_flash as jf
from fireredtts2_tpu.parallel import mesh as jm

from fireredtts2_tpu_torch.config import tiny_engine_config as t_tiny
from fireredtts2_tpu_torch.models.codec.decoder import (
    stream_state_init as t_voc_state,
)
from fireredtts2_tpu_torch.models.lm.model import init_lm_state as t_lm_state
from fireredtts2_tpu_torch.weights import init_random
from fireredtts2_tpu_torch.models.lm.transformer import (
    quantize_transformer_int8 as t_q8,
)
from fireredtts2_tpu_torch.ops import flash_decode as tf
from fireredtts2_tpu_torch.ops.depth_chain import enable_fused_depth
from fireredtts2_tpu_torch.parallel import mesh as tm

from _torch_parity import one_torch_thread, to_t  # noqa: F401


def _trees():
    """(JAX LM, JAX codec, port LM, port codec) of the tiny config: the
    JAX trees as shapes (jax.eval_shape: no initialiser runs), the port's
    drawn by its initialisers."""
    key = jax.random.PRNGKey(0)
    jcfg = j_tiny()
    jlm = jax.eval_shape(lambda: j_init_lm(key, jcfg.llm, jnp.float32))
    jcodec = jax.eval_shape(lambda: j_init_codec(key, jcfg.codec, jnp.float32))
    tlm, tcodec = init_random(t_tiny(), 0, "cpu")
    return jlm, jcodec, tlm, tcodec


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _same_specs(jspecs, tspecs):
    """Leaf for leaf: the JAX PartitionSpec as a tuple equals the port's."""
    want = {p: tuple(s) for p, s in _flat(jspecs)}
    got = dict(_flat(tspecs))
    assert want.keys() == got.keys()
    for p in want:
        assert got[p] == want[p], (p, got[p], want[p])


def test_lm_codec_and_int8_spec_trees_equal_jax():
    jlm, jcodec, tlm, tcodec = _trees()
    _same_specs(jm.lm_param_pspecs(jlm), tm.lm_param_pspecs(tlm))
    jcodec = {k: v for k, v in jcodec.items() if k != "semantic_decoder"}
    _same_specs(jm.codec_param_pspecs(jcodec), tm.codec_param_pspecs(tcodec))
    # the int8 backbone: weights and their column-parallel scales together
    jq = dict(jlm, backbone=jax.eval_shape(j_q8, jlm["backbone"]))
    tq = dict(tlm, backbone=t_q8(tlm["backbone"]))
    _same_specs(jm.lm_param_pspecs(jq), tm.lm_param_pspecs(tq))
    assert tm.lm_param_pspecs(tq)["backbone"]["wq_scale"] == (None, None, "tp")
    assert tm.lm_param_pspecs(tq)["backbone"]["wo_scale"] == ()


def test_depth_bundle_and_state_specs_equal_jax():
    """Kernel B's bundle stays replicated (every leaf), as JAX keeps its
    own; the LM and vocoder states' specs equal JAX's field by field."""
    tcfg = t_tiny()
    tlm = _trees()[2]
    llm = dataclasses.replace(tcfg.llm, fused_depth_plan="gate=r8,up=s8,down=s8")
    specs = tm.lm_param_pspecs(enable_fused_depth(dict(tlm), llm))
    assert {s for p, s in _flat(specs) if p[0] == "depth_chain"} == {()}
    jspecs = jm.lm_param_pspecs({"depth_chain": {"w": jnp.zeros((2, 2))}})
    assert tuple(jspecs["depth_chain"]["w"]) == ()

    jcfg = j_tiny()
    for jst, tst, jfn, tfn in (
            (j_lm_state(jcfg.llm, 2), t_lm_state(tcfg.llm, 2),
             jm.lm_state_pspecs, tm.lm_state_pspecs),
            (j_voc_state(jcfg.codec.acoustic_decoder, 2),
             t_voc_state(tcfg.codec.acoustic_decoder, 2),
             jm.vocoder_state_pspecs, tm.vocoder_state_pspecs)):
        js, ts = jfn(jst), tfn(tst)
        for f in dataclasses.fields(ts):
            assert getattr(ts, f.name) == tuple(getattr(js, f.name)), f.name


def test_make_mesh_shapes_errors_and_sanitize_equal_jax():
    assert len(jax.devices()) == 8
    for kw in ({"tp": 4}, {"tp": 2}, {"dp": 1, "tp": 2}, {"dp": 2, "tp": 2},
               {"tp": 8}):
        assert tm.make_mesh(world=8, **kw).shape == dict(jm.make_mesh(**kw).shape)
    for kw, words in (({"tp": 3}, "tp=3 does not divide the 8 visible"),
                      ({"dp": 4, "tp": 4}, "dp=4 x tp=4 exceeds the 8 visible")):
        with pytest.raises(ValueError, match=words):
            jm.make_mesh(**kw)
        with pytest.raises(ValueError, match=words):
            tm.make_mesh(world=8, **kw)
    # sanitize: dims the mesh does not divide become replicated, as JAX's
    tcfg = t_tiny()
    jlm, _, tlm, _ = _trees()
    jmesh, tmesh = jm.make_mesh(dp=2, tp=4), tm.make_mesh(dp=2, tp=4, world=8)
    jst, tst = j_lm_state(j_tiny().llm, 1), t_lm_state(tcfg.llm, 1)
    js = jm.sanitize_pspecs(jmesh, jst, jm.lm_state_pspecs(jst))
    ts = tm.sanitize_pspecs(tmesh, tst, tm.lm_state_pspecs(tst))
    for f in dataclasses.fields(ts):
        want = tuple(getattr(js, f.name))
        got = getattr(ts, f.name)
        assert got[:len(want)] == want and set(got[len(want):]) <= {None}
    jsan = jm.sanitize_pspecs(jmesh, jlm, jm.lm_param_pspecs(jlm))
    tsan = tm.sanitize_pspecs(tmesh, tlm, tm.lm_param_pspecs(tlm))
    _same_specs(jsan, _strip(tsan, jsan))


def _strip(tspecs, jspecs):
    """The port's sanitized specs name every dimension; JAX's stop at the
    last named one: drop the port's trailing Nones to compare."""
    if isinstance(tspecs, dict):
        return {k: _strip(v, jspecs[k]) for k, v in tspecs.items()}
    return tspecs[:len(tuple(jspecs))]


def _gqa_inputs(B=2, Hq=12, Hkv=2, Dh=16, T=48, L=2, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Dh)).astype(np.float32)
    k4 = rng.standard_normal((L, B, T, Hkv * Dh)).astype(np.float32)
    v4 = rng.standard_normal((L, B, T, Hkv * Dh)).astype(np.float32)
    qs = np.array([3, 0][:B], np.int32)
    qe = np.array([41, 29][:B], np.int32)
    return q, k4, v4, qs, qe


@pytest.mark.parametrize("tp,rank", [(2, 0), (2, 1), (4, 3)])
def test_kernel_a_window_plain_equals_jax(tp, rank):
    """flash_decode_gqa1's plain version over a rank's kv-head window equals
    JAX's kernel (interpret mode) with the same kv_base/hkv: at tp=4 the
    rank holds 3 query heads, half of a group of 6."""
    q, k4, v4, qs, qe = _gqa_inputs()
    Hq, Hkv = 12, 2
    hql = Hq // tp
    kv0, hkv = tf.gqa1_window(Hq, Hkv, tp, rank)
    ql = q[:, rank * hql:(rank + 1) * hql]
    args = (1, qs, qe, int(qs.min()), int(qe.max()))
    want = jf.flash_decode_gqa1(
        jnp.asarray(ql), jnp.asarray(k4), jnp.asarray(v4), jnp.int32(1),
        jnp.asarray(qs), jnp.asarray(qe), jnp.int32(args[3]),
        jnp.int32(args[4]), interpret=True, kv_base=kv0, hkv=hkv)
    got = tf.flash_decode_gqa1_plain(to_t(ql), to_t(k4), to_t(v4), 1,
                                     to_t(qs), to_t(qe), args[3], args[4],
                                     kv_base=kv0, hkv=hkv)
    assert got.shape == (2, hql, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("tp", [2, 4])
def test_kernel_a_shard_concat_equals_jax_shard(tp, monkeypatch):
    """Every tp rank's flash_decode_gqa1_shard, concatenated over heads,
    equals JAX's shard_mapped flash_decode_gqa1_shard on a (1, tp) mesh."""
    monkeypatch.setenv("FRTTS2_FLASH_LM", "interpret")   # JAX: no lane limit
    q, k4, v4, qs, qe = _gqa_inputs()
    jmesh = jm.make_mesh(dp=1, tp=tp)
    assert jf.flash_lm_tp_ok(jmesh, jnp.asarray(q)[:, None], jnp.asarray(k4),
                             interpret=True)
    want = jf.flash_decode_gqa1_shard(
        jmesh, jnp.asarray(q), jnp.asarray(k4), jnp.asarray(v4), jnp.int32(0),
        jnp.asarray(qs), jnp.asarray(qe), jnp.int32(int(qs.min())),
        jnp.int32(int(qe.max())), interpret=True)
    hql = 12 // tp
    outs = [tf.flash_decode_gqa1_shard(
        tm.Mesh(dp=1, tp=tp, rank=t), to_t(q[:, t * hql:(t + 1) * hql]),
        to_t(k4), to_t(v4), 0, to_t(qs), to_t(qe), int(qs.min()),
        int(qe.max())) for t in range(tp)]
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(),
                               np.asarray(want), rtol=2e-5, atol=2e-5)
    assert tf.flash_lm_tp_ok(tm.Mesh(dp=1, tp=tp), 12, 2, 16, 64, cuda=False)


@pytest.mark.parametrize("Hq,Hkv,tp", [(12, 2, 2), (12, 2, 4), (6, 3, 2),
                                       (8, 4, 2), (4, 2, 4), (12, 2, 3)])
def test_tp_eligibility_equals_jax(Hq, Hkv, tp, monkeypatch):
    """flash_lm_tp_ok / flash_voc_tp_ok take the same head splits as JAX's
    (interpret mode: no lane alignment), and on the card the flagship is
    eligible at tp 1, 2 and 4."""
    monkeypatch.setenv("FRTTS2_FLASH_LM", "interpret")
    Dh, T = 16, 64
    mesh_shape = {"dp": 1, "tp": tp}

    class M:
        shape = mesh_shape
    q = jnp.zeros((2, 1, Hq, Dh))
    k4 = jnp.zeros((1, 2, T, Hkv * Dh))
    assert tf.flash_lm_tp_ok(M, Hq, Hkv, Dh, T, cuda=False) == \
        jf.flash_lm_tp_ok(M, q, k4, interpret=True)
    qv = jnp.zeros((2, 8, Hq, Dh))
    assert tf.flash_voc_tp_ok(M, Hq, Dh, 8, T, cuda=False) == \
        jf.flash_voc_tp_ok(M, qv, jnp.zeros((1, 2, T, Hq * Dh)),
                           interpret=True)
    for n in (1, 2, 4):
        flag = tm.Mesh(dp=1, tp=n)
        assert tf.flash_lm_tp_ok(flag, 12, 2, 128, 3584)
        assert tf.flash_voc_tp_ok(flag, 16, 64, 8, 3008)


def test_kernel_c_shard_equals_jax_shard():
    """Kernel C's tp route on every (dp, tp) rank of a (2, 4) mesh, each on
    its rows, heads and slab columns, assembles JAX's shard_mapped
    flash_decode_update_bounded_shard (tests/test_pallas_flash.py's case):
    the attention and the written slabs."""
    B, S, T, H, Dh, L = 2, 8, 32, 4, 64, 2
    D = H * Dh
    ks = jax.random.split(jax.random.PRNGKey(9), 5)
    q = jax.random.normal(ks[0], (B, S, H, Dh))
    new_k = jax.random.normal(ks[1], (B, S, D))
    new_v = jax.random.normal(ks[2], (B, S, D))
    k4 = jax.random.normal(ks[3], (L, B, T, D))
    v4 = jax.random.normal(ks[4], (L, B, T, D))
    pos = jnp.array([8, 16], jnp.int32)
    q_end = jnp.broadcast_to(pos[:, None] + S, (B, S))
    jmesh = jm.make_mesh(dp=2, tp=4)
    want, k4_ref, v4_ref = jf.flash_decode_update_bounded_shard(
        jmesh, q, new_k, new_v, k4, v4, jnp.int32(1), pos, q_end,
        jnp.max(q_end), interpret=True)

    got = np.zeros((B, S, H, Dh), np.float32)
    k4_got, v4_got = np.asarray(k4).copy(), np.asarray(v4).copy()
    for d in range(2):
        for t in range(4):
            mesh = tm.Mesh(dp=2, tp=4, rank=d * 4 + t)
            r, c = slice(d, d + 1), slice(t * Dh, (t + 1) * Dh)
            kl = to_t(np.asarray(k4)[:, r, :, c])
            vl = to_t(np.asarray(v4)[:, r, :, c])
            out = tf.flash_decode_update_bounded_shard(
                mesh, to_t(np.asarray(q)[r, :, t:t + 1]),
                to_t(np.asarray(new_k)[r, :, c]),
                to_t(np.asarray(new_v)[r, :, c]), kl, vl, 1,
                to_t(np.asarray(pos)[r]), to_t(np.asarray(q_end)[r]),
                int(np.asarray(q_end)[r].max()))
            got[r, :, t:t + 1] = out.numpy()
            k4_got[:, r, :, c], v4_got[:, r, :, c] = kl.numpy(), vl.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=3e-6, atol=3e-6)
    np.testing.assert_array_equal(k4_got, np.asarray(k4_ref))
    np.testing.assert_array_equal(v4_got, np.asarray(v4_ref))


def test_shard_params_keeps_undivided_dims_whole():
    """shard_params places as JAX's sanitized specs do: a vocabulary tp
    does not divide (the flagship's 2051 audio tokens at tp=2) stays whole
    on every rank, the rest split by the rank's part; a whisper stack's
    undivided split raises, naming the leaf."""
    mesh = tm.Mesh(dp=1, tp=2, rank=1)
    tree = {"codebook0_head": torch.zeros(8, 2051),
            "text_embeddings": torch.arange(12.0)[:, None].expand(12, 4),
            "backbone": {"wq": torch.zeros(2, 8, 6)}}
    out = tm.shard_params(mesh, tree, tm.lm_param_pspecs(tree))
    assert out["codebook0_head"].shape == (8, 2051)
    assert out["text_embeddings"][:, 0].tolist() == list(range(6, 12))
    assert out["backbone"]["wq"].shape == (2, 8, 3)
    codec = {"acoustic_decoder": {"layers": {"fc1_w": torch.zeros(1, 4, 7)}}}
    with pytest.raises(ValueError, match="acoustic_decoder/layers/fc1_w"):
        tm.shard_params(mesh, codec, tm.codec_param_pspecs(codec))
