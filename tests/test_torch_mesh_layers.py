"""The tensor-parallel pieces of the port's serving mesh on emulated tp
ranks in one process: fireredtts2_tpu_torch/parallel/layers.py's split
matmuls, vocabulary lookups and logits and its head window, and
parallel/mesh.py's placement, collectives and rank layout.

Each emulated rank is a thread with its own Mesh; the collectives'
transport (torch.distributed.all_reduce) is an in-process sum over the
threads in rank order. Every split computation is held against the same
computation on whole tensors, the rank layout against JAX's mesh. Real
gloo ranks serve the whole engine in tests/test_torch_mesh_ranks.py."""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fireredtts2_tpu.parallel import mesh as jm

from fireredtts2_tpu_torch.config import tiny_engine_config as t_tiny
from fireredtts2_tpu_torch.models.codec.whisper_nn import (
    init_whisper_layers, whisper_layers_forward,
    quantize_whisper_layers_int8 as t_q8w,
)
from fireredtts2_tpu_torch.models.lm.transformer import (
    quantize_transformer_int8 as t_q8,
)
from fireredtts2_tpu_torch.ops.quant import quantize_int8, quantized_matmul
from fireredtts2_tpu_torch.parallel import layers as tl
from fireredtts2_tpu_torch.parallel import mesh as tm
from fireredtts2_tpu_torch.weights import init_random

from _torch_parity import one_torch_thread  # noqa: F401  (autouse)

_local = threading.local()


class _Bus:
    """all_reduce over n threads: each deposits its tensor, and after a
    barrier every rank's tensor becomes the sum, taken in rank order (so
    all ranks hold the same values, as a real all-reduce leaves them)."""

    def __init__(self, n: int):
        self.box = [None] * n
        self.barrier = threading.Barrier(n, timeout=60)

    def all_reduce(self, x, group=None):
        assert group == "tp"
        self.box[_local.mesh.tp_rank] = x.clone()
        self.barrier.wait()
        total = self.box[0].clone()
        for y in self.box[1:]:
            total += y
        self.barrier.wait()
        x.copy_(total)


def on_ranks(monkeypatch, tp: int, fn) -> list:
    """fn(mesh) on tp emulated ranks of a (1, tp) mesh -> results by rank."""
    bus = _Bus(tp)
    monkeypatch.setattr(tm, "dist", SimpleNamespace(all_reduce=bus.all_reduce))
    out, errors = [None] * tp, []

    def run(r):
        _local.mesh = tm.Mesh(dp=1, tp=tp, rank=r, tp_group="tp")
        try:
            with tm.use_mesh(_local.mesh):
                out[r] = fn(_local.mesh)
        except BaseException as e:        # noqa: BLE001  (re-raised below)
            errors.append(e)
            bus.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


def _part(x: torch.Tensor, dim: int, tp: int, r: int) -> torch.Tensor:
    w = x.shape[dim] // tp
    return x.narrow(dim, r * w, w)


def _rand(*shape, seed=0, dtype=torch.float32):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


# ---------------------------------------------------------------------------
# Split matmuls, lookups and logits against their whole versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["float", "int8"])
def test_row_matmul_sums_the_ranks_partial_products(monkeypatch, tp, kind):
    """A row-parallel weight (its input rows split over tp, an int8 scale
    per output column replicated): every rank's row_matmul of the whole
    activation is the whole product, equal on every rank."""
    a, w = _rand(3, 16, seed=1), _rand(16, 8, seed=2)
    if kind == "int8":
        q, s = quantize_int8(w)
        whole = {"w": q, "w_scale": s}
    else:
        whole = {"w": w}
    want = quantized_matmul(a, whole, "w")

    def rank(m):
        lp = dict(whole, w=_part(whole["w"], 0, tp, m.tp_rank))
        return tl.row_matmul(a, lp, "w", full_in=16)

    got = on_ranks(monkeypatch, tp, rank)
    for y in got:
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(y, got[0])


@pytest.mark.parametrize("tp", [2, 4])
def test_row_matmul_of_a_replicated_weight_gathers_the_activation(
        monkeypatch, tp):
    """A weight the mesh left whole takes the whole activation: a rank's
    column-parallel part of it is gathered first, then no sum follows."""
    a, w = _rand(3, 16, seed=3), _rand(16, 8, seed=4)
    want = a @ w
    got = on_ranks(monkeypatch, tp, lambda m: tl.row_matmul(
        _part(a, -1, tp, m.tp_rank), {"w": w}, "w", full_in=16))
    for y in got:
        torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("table_split,reduce", [
    (True, True), (True, False), (False, True), (False, False)])
def test_vocab_lookup_equals_the_whole_table(monkeypatch, tp, table_split,
                                             reduce):
    """table[idx] with the vocabulary split over tp (or whole, where tp does
    not divide it): reduce=True gives the rows on every rank; reduce=False
    gives the rank's part, which tp_sum assembles (a whole table's rows come
    from tp rank 0 alone, so the sum counts each row once)."""
    table = _rand(12, 4, seed=5)
    idx = torch.from_numpy(np.random.default_rng(6).integers(0, 12, (2, 5)))

    def rank(m):
        t = _part(table, 0, tp, m.tp_rank) if table_split else table
        rows = tl.vocab_lookup(t, idx, 12, reduce=reduce)
        return rows if reduce else tl.tp_sum(rows)

    for y in on_ranks(monkeypatch, tp, rank):
        assert torch.equal(y, table[idx])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vocab_logits_are_gathered_whole_and_exact(monkeypatch, tp, dtype):
    """h @ w for a head whose vocabulary columns split over tp: every rank
    holds all the logits, bit for bit its ranks' own products side by side,
    in the input's dtype (16-bit values ride the gather in fp32 and come
    back exact)."""
    h, w = _rand(2, 8, seed=7, dtype=dtype), _rand(8, 12, seed=8, dtype=dtype)
    parts = [h @ _part(w, -1, tp, r) for r in range(tp)]
    got = on_ranks(monkeypatch, tp, lambda m: tl.vocab_logits(
        h, _part(w, -1, tp, m.tp_rank), 12))
    for y in got:
        assert y.dtype == dtype
        assert torch.equal(y, torch.cat(parts, dim=-1))


@pytest.mark.parametrize("Hq,Hkv,tp", [(12, 2, 2), (12, 2, 4), (8, 4, 2),
                                       (8, 2, 8)])
def test_head_window_covers_exactly_the_kv_heads_read(monkeypatch, Hq, Hkv,
                                                      tp):
    """A rank's (kv_base, hkv) spans the kv heads its query heads read
    (query head h reads kv head h // (Hq / Hkv)); a rank holding every
    query head reads every kv head."""
    g = Hq // Hkv
    hql = Hq // tp
    for r in range(tp):
        with tm.use_mesh(tm.Mesh(dp=1, tp=tp, rank=r)):
            read = {h // g for h in range(r * hql, (r + 1) * hql)}
            assert tl.head_window(hql, Hq, Hkv) == (min(read), len(read))
            assert tl.head_window(Hq, Hq, Hkv) == (0, Hkv)


def test_helpers_are_the_plain_computation_without_a_mesh():
    """Without a current mesh every helper is the single-rank computation."""
    assert tm.serving_mesh() is None
    a, w = _rand(3, 6, seed=9), _rand(6, 5, seed=10)
    table = _rand(7, 2, seed=11)
    idx = torch.tensor([[0, 6, 3]])
    assert torch.equal(tl.row_matmul(a, {"w": w}, "w", 6), a @ w)
    assert torch.equal(tl.vocab_lookup(table, idx, 7, reduce=False),
                       table[idx])
    assert torch.equal(tl.vocab_logits(a, w, 5), a @ w)
    assert tl.gather_cols(a, 99) is a
    assert tl.tp_sum(a) is a
    assert tl.head_window(3, 12, 2) == (0, 2)


# ---------------------------------------------------------------------------
# Collectives: counted, 16-bit floats summed in fp32
# ---------------------------------------------------------------------------


def test_all_reduce_sums_16_bit_floats_in_fp32(monkeypatch):
    """bfloat16 parts 256, 1, 1, 0 sum to 258 (a bfloat16 value) when summed
    in fp32 and rounded once; summed in bfloat16 they would stay at 256."""
    vals = [256.0, 1.0, 1.0, 0.0]
    got = on_ranks(monkeypatch, 4, lambda m: tm.all_reduce(
        torch.tensor([vals[m.tp_rank]], dtype=torch.bfloat16), m.tp_group))
    for y in got:
        assert y.dtype == torch.bfloat16 and y.item() == 258.0
    x = torch.tensor([1.0])
    assert tm.all_reduce(x, None) is x


@pytest.mark.parametrize("dtype,wire", [(torch.float32, 4),
                                        (torch.bfloat16, 4),
                                        (torch.float16, 4),
                                        (torch.int64, 8)])
def test_gather_dim_is_one_counted_all_reduce_of_the_whole(monkeypatch,
                                                           dtype, wire):
    """gather_dim is one all-reduce a rank of a buffer of the whole
    dimension (16-bit floats ride in fp32): the stats count one call per
    rank and the gathered shape as the largest tensor moved."""
    x = torch.arange(2 * 3 * 8).reshape(2, 3, 8).to(dtype)
    tm.reset_collective_stats()
    got = on_ranks(monkeypatch, 2, lambda m: tm.gather_dim(
        _part(x, -1, 2, m.tp_rank), 8, -1, m.tp_group, m.tp_rank))
    for y in got:
        assert y.dtype == dtype and torch.equal(y, x)
    st = tm.collective_stats()
    assert st["calls"] == 2
    assert st["max_shape"] == (2, 3, 8)
    assert st["max_bytes"] == 2 * 3 * 8 * wire
    assert st["bytes"] == 2 * st["max_bytes"]
    tm.reset_collective_stats()
    assert tm.collective_stats()["calls"] == 0


# ---------------------------------------------------------------------------
# Placement and rank layout
# ---------------------------------------------------------------------------


def _trees():
    lm, codec = init_random(t_tiny(), 0, "cpu")
    return {"lm": (lm, tm.lm_param_pspecs),
            "lm_int8": (dict(lm, backbone=t_q8(lm["backbone"])),
                        tm.lm_param_pspecs),
            "codec": (codec, tm.codec_param_pspecs)}


def _leaves(tree, specs, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, specs[k], path + (k,))
    elif torch.is_tensor(tree):
        yield path, tree, specs


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["lm", "lm_int8", "codec"])
def test_shard_params_partitions_every_leaf(name, tp):
    """The ranks' shards of every leaf of the tiny trees put back together
    along the split dimension are the whole leaf, and a replicated leaf is
    whole on every rank: placement loses and repeats nothing."""
    tree, rule = _trees()[name]
    meshes = [tm.Mesh(dp=1, tp=tp, rank=r) for r in range(tp)]
    specs = tm.sanitize_pspecs(meshes[0], tree, rule(tree))
    shards = [tm.shard_params(m, tree, rule(tree)) for m in meshes]
    n = 0
    for path, leaf, spec in _leaves(tree, specs):
        parts = [_at(s, path) for s in shards]
        if "tp" in spec:
            d = spec.index("tp")
            assert all(p.shape[d] * tp == leaf.shape[d] for p in parts), path
            assert torch.equal(torch.cat(parts, dim=d), leaf), path
            n += 1
        else:
            assert all(torch.equal(p, leaf) for p in parts), path
    assert n > 0


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (2, 4), (4, 2), (1, 8)])
def test_rank_layout_is_jax_mesh_layout(dp, tp):
    """Rank r sits where JAX's make_mesh puts device r: rank = dp_rank * tp
    + tp_rank, row-major, the leader at (0, 0)."""
    devices = np.asarray(jm.make_mesh(dp=dp, tp=tp).devices)
    assert devices.shape == (dp, tp)
    for r in range(dp * tp):
        m = tm.Mesh(dp=dp, tp=tp, rank=r)
        assert devices[m.dp_rank, m.tp_rank].id == r
        assert (m.axis_rank("dp"), m.axis_rank("tp")) == (m.dp_rank, m.tp_rank)
        assert m.is_leader == (r == 0)


@pytest.mark.parametrize("n,dp", [(4, 2), (8, 4), (3, 2), (6, 1)])
def test_shard_spec_rows_split_rows_evenly_or_keep_them_whole(n, dp):
    """The dp ranks' [start, stop) rows tile [0, n) in rank order when dp
    divides n; otherwise every rank keeps all n, as sanitize_pspecs
    replicates an undivided dimension."""
    spans = [tm.shard_spec_rows(n, tm.Mesh(dp=dp, tp=2, rank=d * 2))
             for d in range(dp)]
    if n % dp:
        assert spans == [(0, n)] * dp
    else:
        assert [s for span in spans for s in range(*span)] == list(range(n))
        assert {b - a for a, b in spans} == {n // dp}


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"WORLD_SIZE": "4", "RANK": "3"}, (4, 3, 3)),
    ({"WORLD_SIZE": "8", "RANK": "5", "LOCAL_RANK": "1"}, (8, 5, 1)),
])
def test_env_world_reads_torchrun_variables(monkeypatch, env, want):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tm.env_world() == want


def test_serving_mesh_reaches_model_code_only_when_it_splits():
    """tp_mesh() is the current mesh when tp > 1 and None otherwise; the
    current mesh is the innermost use_mesh block's, of this thread alone,
    and the one before comes back when the block ends; a mesh without
    groups broadcasts a host object to itself."""
    outer = tm.Mesh(dp=1, tp=4)
    seen = []
    with tm.use_mesh(outer):
        for mesh, want_tp in ((tm.Mesh(dp=2, tp=1), False),
                              (tm.Mesh(dp=1, tp=2), True), (None, False)):
            with tm.use_mesh(mesh):
                assert tm.serving_mesh() is mesh
                assert tm.tp_mesh() is (mesh if want_tp else None)
            assert tm.serving_mesh() is outer
        t = threading.Thread(target=lambda: seen.append(tm.serving_mesh()))
        t.start()
        t.join()
    assert seen == [None] and tm.serving_mesh() is None
    box = {"k": 1}
    assert tm.broadcast_object(box, tm.Mesh(dp=1, tp=1)) is box


@pytest.mark.parametrize("split,tp", [(False, 2), (True, 2), (True, 4)])
def test_whisper_stack_whole_or_split_under_a_tp_mesh(monkeypatch, split, tp):
    """A whisper layer stack run with a tp mesh current: a whole one (as
    the ASR's, which shard_params never splits) is the plain computation,
    with no collective; the ranks' shards of a split one (int8 matmuls,
    so the row-parallel scales apply after the sum) give the whole stack's
    output on every rank."""
    D, H, F, L = 16, 4, 48, 2
    layers = t_q8w(init_whisper_layers(torch.Generator().manual_seed(0), L,
                                       D, F))
    h = _rand(2, 5, D, seed=12)
    want, _ = whisper_layers_forward(layers, H, h)

    def rank(m):
        tree = {"layers": layers}
        p = (tm.shard_params(m, tree, tm.codec_param_pspecs(tree))["layers"]
             if split else layers)
        assert (p["fc2_w"].shape[-2] * tp == F) == split
        return whisper_layers_forward(p, H, h)[0]

    tm.reset_collective_stats()
    for y in on_ranks(monkeypatch, tp, rank):
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    assert (tm.collective_stats()["calls"] > 0) == split
