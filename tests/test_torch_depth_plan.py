"""PyTorch port, kernel B's plan (ops/depth_chain.py) on the CPU: the
reference of the work partition the CUDA kernel walks (tile_range,
block_schedule) and of the shared memory its library lays out for a launch
(chain_layout; tests/test_torch_gpu.py holds both equal to the library's),
and the kernel's top-k threshold by passes against the JAX package's
_kth_largest and the port's plain sampler.

Tolerances: none; partitions, sizes and sampled tokens are exact.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireredtts2_tpu.ops import pallas_depth as jpd

from fireredtts2_tpu_torch.config import LLMConfig
from fireredtts2_tpu_torch.ops import depth_chain as tdc
from fireredtts2_tpu_torch.ops.sampling import sample_topk

from _torch_parity import one_torch_thread  # noqa: F401

PRESET = "gate=r8,up=s8,down=s8"
PLANS = [PRESET, "gate=r4,up=s8,down=r4", "gate=r8a8,up=s8a8,down=s8a8"]


def _matrices(cfg: LLMConfig, plan: str) -> dict:
    """(rows, row bytes, keys) of every matrix the kernel streams in a
    frame: keys are (step, layer), or for the projection and the head the
    step."""
    d, modes = cfg.decoder, tdc.parse_plan(plan)
    Db, Dd, I = cfg.backbone.embed_dim, d.embed_dim, d.intermediate_dim
    ncb, L = cfg.audio_num_codebooks, d.num_layers
    layers = [(p, l) for p in range(ncb) for l in range(L)]
    rb = {m: (K // 2 if modes[m] == "r4" else K)
          for m, K in (("w_gate", Dd), ("w_up", Dd), ("w_down", I))}
    return {
        "proj": (Dd, 2 * Db, range(ncb)),
        "wqkv": ((d.num_heads + 2 * d.num_kv_heads) * d.head_dim, Dd, layers),
        "wo": (Dd, d.num_heads * d.head_dim, layers),
        "w_gate": (I, rb["w_gate"], layers), "w_up": (I, rb["w_up"], layers),
        "w_down": (Dd, rb["w_down"], layers),
        "head": (cfg.audio_vocab_size, 2 * Dd, range(1, ncb)),
    }


@pytest.mark.parametrize("grid", [1, 7, 66, 132, 264])
def test_every_row_streamed_by_one_block_once(grid):
    """At qwen-200m (int4 gate, int8 up and down), every row of every matrix
    of every layer and step (the projection and the audio head of every
    step) belongs to exactly one block's tiles, and each of its chunks
    passes through that block's ring exactly once: the chunks cover the
    row's bytes."""
    cfg, plan = LLMConfig(), "gate=r4,up=s8,down=s8"
    mats = _matrices(cfg, plan)
    seen = [s for b in range(grid) for s in tdc.block_schedule(cfg, b, grid, plan)]
    want = {(name, key, t, c)
            for name, (O, rb, keys) in mats.items() for key in keys
            for t in range(-(-O // tdc.TILE)) for c in range(-(-rb // tdc.CHUNK))}
    assert len(seen) == len(want) and set(seen) == want
    for name, (O, rb, keys) in mats.items():
        rows = collections.Counter()
        for b in range(grid):
            t0, t1 = tdc.tile_range(O, b, grid)
            rows.update(r for t in range(t0, t1)
                        for r in range(t * tdc.TILE, min(O, (t + 1) * tdc.TILE)))
        assert sorted(rows) == list(range(O)) and set(rows.values()) == {1}, name
        assert -(-rb // tdc.CHUNK) * tdc.CHUNK - rb < tdc.CHUNK and rb % 64 == 0


@pytest.mark.parametrize("plan", PLANS)
def test_ring_and_staging_fit_shared_memory(plan):
    """For B = 1..8 the staged activations of every phase plus at least two
    ring stages fit the 227 KB of a block, and the ring takes what is
    left (up to 16 stages)."""
    cfg = LLMConfig()
    d = cfg.decoder
    Db, Dd, I, V = (cfg.backbone.embed_dim, d.embed_dim, d.intermediate_dim,
                    cfg.audio_vocab_size)
    for B in range(1, 9):
        lay = tdc.chain_layout(cfg, B, plan)
        assert lay["smem_bytes"] <= 232448
        assert 2 <= lay["stages"] <= tdc.MAX_STAGES
        assert (lay["stages"] == tdc.MAX_STAGES
                or lay["smem_bytes"] + tdc.STAGE_BYTES > 232448)
        # the largest input any phase stages, and the sampling buffer
        assert lay["act_bytes"] >= B * max(2 * Db, 2 * Dd, 4 * V)
        if plan.endswith("down=s8"):
            assert lay["act_bytes"] >= B * 2 * I
    assert tdc.chain_layout(cfg, 8, PRESET)["stages"] == 8
    assert tdc.chain_layout(cfg, 1, PRESET)["stages"] == 16
    assert tdc.barriers_per_frame(cfg) == 351


def _logit_rows() -> np.ndarray:
    """Rows with ties, with fewer than k distinct values, with -1e30
    entries (and only those), and plain random rows."""
    rng = np.random.default_rng(0)
    V = 300
    rows = [rng.standard_normal(V),
            np.round(rng.standard_normal(V) * 2) / 2,          # many ties
            np.repeat(rng.standard_normal(4), V // 4),           # 4 distinct
            np.full(V, 1.5),                                     # 1 distinct
            np.where(rng.random(V) < 0.97, -1e30, rng.standard_normal(V)),
            np.full(V, -1e30),
            np.where(rng.random(V) < 0.5, -1e30, np.round(rng.standard_normal(V)))]
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2, 5, 10, 40])
def test_kth_largest_by_passes_matches_jax_and_plain(k):
    """The kernel's threshold (k - 1 warp-wide passes of "the largest value
    below the last one", floored at -1e30) equals JAX's _kth_largest and
    the plain version's, with ties, fewer than k distinct values and -1e30
    entries."""
    x = _logit_rows()
    got = tdc.kth_largest_by_passes(torch.from_numpy(x), k)
    want = np.asarray(jpd._kth_largest(jnp.asarray(x), k))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, tdc._kth_largest(torch.from_numpy(x), k))


def _race(lf: torch.Tensor, kth: torch.Tensor, noise: torch.Tensor):
    filt = torch.where(lf < kth, torch.full_like(lf, -1e30), lf)
    ex = torch.exp(filt - filt.amax(dim=-1, keepdim=True))
    return torch.argmax(ex / ex.sum(dim=-1, keepdim=True) / noise, dim=-1)


def test_selection_samples_the_plain_tokens():
    """The kernel's selection (the threshold by passes, then softmax and the
    exponential race) picks the plain version's token on every row, and on
    rows without ties the port's sampler's token (top-k by torch.topk)."""
    x = torch.from_numpy(_logit_rows())
    gen = torch.Generator().manual_seed(1)
    for temp, k in ((0.75, 10), (1.0, 3), (0.5, 1)):
        lf = x / temp
        for _ in range(4):
            noise = torch.empty(x.shape).exponential_(generator=gen)
            got = _race(lf, tdc.kth_largest_by_passes(lf, k), noise)
            assert torch.equal(got, _race(lf, tdc._kth_largest(lf, k), noise))
            distinct = torch.tensor([len(set(r.tolist())) == r.numel() for r in x])
            ref = sample_topk(x, k, temp, noise).to(torch.int64)
            assert torch.equal(got[distinct], ref[distinct])
