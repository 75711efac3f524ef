"""PyTorch port on the card: the CUDA kernels against their plain PyTorch
versions, a small engine through both kernels and a tiny LM's train step.
Marked `gpu`; each test skips when no CUDA device is present.

Run on a machine with a card (no JAX needed there, so the suite's
conftest.py, which imports jax, is left out):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance of a kernel against its plain version (bf16 in and out, fp32
inside): |kernel - plain| <= 1e-2 + 2e-2 * |plain|; both round the output
and the softmax probabilities to bf16, at different points. Slab writes
must be identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fireredtts2_tpu_torch.ops import flash_decode as fd

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rnd(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).to(torch.bfloat16)


def _close(out, ref):
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=2e-2)


def _kernel_a_inputs(dev, B, Hkv, G, Dh, q_start, q_end, L=3, T=3584):
    gen = torch.Generator(device=dev).manual_seed(B * 100 + G * 10 + Dh)
    q = _rnd(gen, B, Hkv * G, Dh)
    k4, v4 = _rnd(gen, L, B, T, Hkv * Dh), _rnd(gen, L, B, T, Hkv * Dh)
    qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
    qe = torch.tensor(q_end, dtype=torch.int32, device=dev)
    return q, k4, v4, qs, qe


# windows as functions of the split the library plans (sp slots)
@pytest.mark.parametrize("B,Hkv,G,Dh,windows", [
    pytest.param(1, 2, 6, 128, lambda sp: ([0], [200]), id="1-q_start0-q_end0"),
    # ragged; chunk edge; slab end
    pytest.param(3, 2, 6, 128, lambda sp: ([0, 37, 511], [3000, 1024, 3584]),
                 id="3-q_start1-q_end1"),
    pytest.param(1, 2, 6, 128, lambda sp: ([sp + 3], [2 * sp - 5]),
                 id="inside-one-split"),
    pytest.param(2, 2, 6, 128, lambda sp: ([0, 17], [3 * sp, 5 * sp]),
                 id="ends-on-split-edges"),
    # live_lo 1100: chunks and splits below 1024 are skipped
    pytest.param(2, 2, 6, 128, lambda sp: ([1100, 1300], [2500, 3100]),
                 id="live-lo-skips-splits"),
    pytest.param(8, 2, 6, 128, lambda sp: (
        [0, 5, 40, 0, 300, 17, 2, 900], [3584, 200, 1000, 7, 2900, 1601, 33, 901]),
        id="B8-ragged"),
    pytest.param(2, 2, 6, 64, lambda sp: ([0, 10], [1000, 3000]), id="Dh64"),
    pytest.param(2, 2, 1, 128, lambda sp: ([0, 10], [1000, 3000]), id="G1"),
    pytest.param(2, 2, 8, 128, lambda sp: ([0, 10], [1000, 3000]), id="G8"),
])
def test_kernel_a_matches_plain(cuda, B, Hkv, G, Dh, windows):
    T = 3584
    sp = fd.gqa1_plan(B, Hkv, G, T, Dh, cuda.index or 0)[0]
    q_start, q_end = windows(sp)
    q, k4, v4, qs, qe = _kernel_a_inputs(cuda, B, Hkv, G, Dh, q_start, q_end)
    before = fd.flash_decode_gqa1.launches
    out = fd.flash_decode_gqa1(q, k4, v4, 2, qs, qe, min(q_start), max(q_end))
    torch.cuda.synchronize()
    assert fd.flash_decode_gqa1.launches == before + 1
    _close(out, fd.flash_decode_gqa1_plain(q, k4, v4, 2, qs, qe,
                                           min(q_start), max(q_end)))


@pytest.mark.parametrize("tp,rank,Dh", [(2, 0, 128), (2, 1, 128), (4, 2, 128),
                                        (4, 3, 64)])
def test_kernel_a_kv_window_matches_plain(cuda, tp, rank, Dh):
    """Kernel A over one tp rank's kv-head window of the whole slab
    (flash_decode_gqa1_shard: Hq=12 over Hkv=2, so 6 or 3 query heads a
    rank) against its plain version with the same window, and every
    rank's output concatenated against the unsharded call."""
    from fireredtts2_tpu_torch.parallel.mesh import Mesh

    q, k4, v4, qs, qe = _kernel_a_inputs(cuda, 3, 2, 6, Dh, [0, 37, 511],
                                         [3000, 1024, 3584])
    hql = 12 // tp
    kv0, hkv = fd.gqa1_window(12, 2, tp, rank)
    parts = []
    for t in range(tp):
        ql = q[:, t * hql:(t + 1) * hql].contiguous()
        before = fd.flash_decode_gqa1_shard.launches
        parts.append(fd.flash_decode_gqa1_shard(Mesh(dp=1, tp=tp, rank=t), ql,
                                                k4, v4, 2, qs, qe, 0, 3584))
        assert fd.flash_decode_gqa1_shard.launches == before + 1
        if t == rank:
            _close(parts[-1], fd.flash_decode_gqa1_plain(
                ql, k4, v4, 2, qs, qe, 0, 3584, kv_base=kv0, hkv=hkv))
    torch.cuda.synchronize()
    _close(torch.cat(parts, dim=1),
           fd.flash_decode_gqa1(q, k4, v4, 2, qs, qe, 0, 3584))


def test_kernel_c_tp_route_matches_plain(cuda):
    """Kernel C on each tp=2 rank's 8 heads and slab columns
    (flash_decode_update_bounded_shard) against the plain version on
    copies: outputs close, written rows identical, and the ranks' columns
    assembling the unsharded call's slab."""
    from fireredtts2_tpu_torch.parallel.mesh import Mesh

    gen = torch.Generator(device=cuda).manual_seed(7)
    B, S, H, Dh, L, T = 2, 32, 16, 64, 2, 3008
    q = _rnd(gen, B, S, H, Dh)
    nk, nv = _rnd(gen, B, S, H * Dh), _rnd(gen, B, S, H * Dh)
    k4, v4 = _rnd(gen, L, B, T, H * Dh), _rnd(gen, L, B, T, H * Dh)
    pos = torch.tensor([200, 2900], dtype=torch.int32, device=cuda)
    q_end = pos[:, None] + 8 * (torch.arange(S, device=cuda,
                                             dtype=torch.int32)[None] // 8 + 1)
    kk, vk = k4.clone(), v4.clone()
    whole = fd.flash_decode_update_bounded(q, nk, nv, kk, vk, 1, pos, q_end,
                                           pos.max() + S)
    for t in range(2):
        c = slice(t * 512, (t + 1) * 512)
        args = (q[:, :, 8 * t:8 * (t + 1)].contiguous(), nk[..., c].contiguous(),
                nv[..., c].contiguous())
        kl, vl = k4[..., c].contiguous(), v4[..., c].contiguous()
        kp, vp = kl.clone(), vl.clone()
        out = fd.flash_decode_update_bounded_shard(
            Mesh(dp=1, tp=2, rank=t), *args, kl, vl, 1, pos, q_end,
            pos.max() + S)
        torch.cuda.synchronize()
        _close(out, fd.flash_decode_update_bounded_plain(
            *args, kp, vp, 1, pos, q_end, pos.max() + S))
        _close(out, whole[:, :, 8 * t:8 * (t + 1)])
        assert torch.equal(kl, kp) and torch.equal(vl, vp)
        assert torch.equal(kl, kk[..., c]) and torch.equal(vl, vk[..., c])


def test_kernel_a_merge_counts_reset(cuda):
    """Kernel A twice at one batch, then at another: the last block of each
    (stream, kv head) leaves its merge count at zero for the next call."""
    for B in (2, 2, 5):
        q_start = [3 * b for b in range(B)]
        q_end = [3000 - 100 * b for b in range(B)]
        q, k4, v4, qs, qe = _kernel_a_inputs(cuda, B, 2, 6, 128, q_start, q_end)
        lo, hi = qs.min(), qe.max()
        out = fd.flash_decode_gqa1(q, k4, v4, 1, qs, qe, lo, hi)
        torch.cuda.synchronize()
        _close(out, fd.flash_decode_gqa1_plain(q, k4, v4, 1, qs, qe, lo, hi))
        counts = fd._counters[("gqa1", q.device)]
        assert int(counts.abs().sum()) == 0


def test_kernel_a_replays_in_cuda_graph(cuda):
    """One call of kernel A captured in a CUDA graph: the replay equals the
    eager call, before and after new queries are copied into the input."""
    q, k4, v4, qs, qe = _kernel_a_inputs(cuda, 2, 2, 6, 128, [0, 40], [2900, 1500])
    lo, hi = qs.min(), qe.max()
    eager = fd.flash_decode_gqa1(q, k4, v4, 1, qs, qe, lo, hi)   # warm
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fd.flash_decode_gqa1(q, k4, v4, 1, qs, qe, lo, hi)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = fd.flash_decode_gqa1(q, k4, v4, 1, qs, qe, lo, hi)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static, eager)
    q.copy_(torch.flip(q, dims=(0,)))
    graph.replay()
    eager = fd.flash_decode_gqa1(q, k4, v4, 1, qs, qe, lo, hi)
    torch.cuda.synchronize()
    assert torch.equal(static, eager)
    _close(static, fd.flash_decode_gqa1_plain(q, k4, v4, 1, qs, qe, lo, hi))


@pytest.mark.parametrize("S,pos", [(8, [0, 200]), (32, [1000, 40]),
                                   (64, [2936, 1000]), (128, [2880, 8]),
                                   (64, [3000, 3016])])
def test_kernel_c_matches_plain(cuda, S, pos):
    """The last case overshoots the slab: both writes clamp to T - S."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    L, B, T, H, Dh = 2, 2, 3008, 16, 64
    q = _rnd(gen, B, S, H, Dh)
    nk, nv = _rnd(gen, B, S, H * Dh), _rnd(gen, B, S, H * Dh)
    k4, v4 = _rnd(gen, L, B, T, H * Dh), _rnd(gen, L, B, T, H * Dh)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    q_end = p[:, None] + 8 * (torch.arange(S, device=cuda,
                                           dtype=torch.int32)[None] // 8 + 1)
    kk, vk = k4.clone(), v4.clone()
    out = fd.flash_decode_update_bounded(q, nk, nv, kk, vk, 1, p, q_end,
                                         p.max() + S)
    ref = fd.flash_decode_update_bounded_plain(q, nk, nv, k4, v4, 1, p, q_end,
                                               p.max() + S)
    torch.cuda.synchronize()
    assert torch.equal(kk, k4) and torch.equal(vk, v4)
    _close(out, ref)


@pytest.mark.parametrize("B,S,pos", [
    (8, 128, [2760, 2700, 40, 0, 1480, 2872, 8, 512]),  # ragged; 1480 straddles
    (1, 128, [128]),      # fresh rows [128, 256) straddle the split edge at 192
    (2, 64, [350, 740]),  # both streams straddle edges of 384-slot splits
])
def test_kernel_c_batched_and_split_edges(cuda, B, S, pos):
    """Kernel C at the batched vocoder shape and where the fresh rows cross
    a split boundary: the split that covers a fresh row writes it, every
    split reads it from new_k/new_v."""
    gen = torch.Generator(device=cuda).manual_seed(B * 1000 + S)
    L, T, H, Dh = 2, 3008, 16, 64
    edges = [lo for lo, _ in fd.split_ranges(T, B, H)][1:]
    assert any(any(p < e < p + S for e in edges) for p in pos)
    q = _rnd(gen, B, S, H, Dh)
    nk, nv = _rnd(gen, B, S, H * Dh), _rnd(gen, B, S, H * Dh)
    k4, v4 = _rnd(gen, L, B, T, H * Dh), _rnd(gen, L, B, T, H * Dh)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    q_end = p[:, None] + 8 * (torch.arange(S, device=cuda,
                                           dtype=torch.int32)[None] // 8 + 1)
    kk, vk = k4.clone(), v4.clone()
    for _ in range(2):        # the merge counts are left zero for the next call
        out = fd.flash_decode_update_bounded(q, nk, nv, kk, vk, 0, p, q_end,
                                             p.max() + S)
    ref = fd.flash_decode_update_bounded_plain(q, nk, nv, k4, v4, 0, p, q_end,
                                               p.max() + S)
    torch.cuda.synchronize()
    assert torch.equal(kk, k4) and torch.equal(vk, v4)
    _close(out, ref)


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    """float32 CUDA tensors are not what the kernels take: the wrappers
    raise, they never run the plain version on the card."""
    q = torch.zeros((1, 12, 128), device=cuda)
    k4 = torch.zeros((1, 1, 512, 256), device=cuda)
    z = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        fd.flash_decode_gqa1(q, k4, k4, 0, z, z + 1, 0, 1)
    q = torch.zeros((1, 8, 16, 64), device=cuda)
    k4 = torch.zeros((1, 1, 64, 1024), device=cuda)
    new = torch.zeros((1, 8, 1024), device=cuda)
    with pytest.raises(ValueError):
        fd.flash_decode_update_bounded(q, new, new, k4, k4, 0, z,
                                       torch.full((1, 8), 8, device=cuda), 8)


def _small_gpu_config():
    """Tiny engine widths the kernels take: a qwen-200m backbone (Dh=128)
    and a vocoder with Dh=64, in bf16."""
    from fireredtts2_tpu_torch.config import (
        AcousticDecoderConfig, RVQConfig, tiny_engine_config,
    )
    cfg = tiny_engine_config()
    llm = dataclasses.replace(cfg.llm, backbone_flavor="qwen-200m",
                              dtype="bfloat16")
    codec = dataclasses.replace(
        cfg.codec, dtype="bfloat16", upsample_embed_dim=128,
        rvq=RVQConfig(input_dim=32, rvq_dim=32, output_dim=128,
                      num_quantizers=4, codebook_size=64, codebook_dim=8),
        acoustic_decoder=AcousticDecoderConfig(
            embed_dim=128, num_layers=2, num_heads=2, hop_length=240,
            causal=True, max_stream_latents=256))
    return dataclasses.replace(cfg, llm=llm, codec=codec)


def test_small_engine_on_card(cuda):
    """generate and generate_stream on the card sample the same frames for
    one utterance seed, through both kernels, with finite audio of one
    chunk per frame."""
    from fireredtts2_tpu_torch.engine import FireRedTTS2Engine

    eng = FireRedTTS2Engine(_small_gpu_config(), seed=0, device=cuda)
    fd.reset_launch_counts()
    a = eng.generate("Hello.", "[S1]", max_audio_length_ms=1600, utt_seed=9)
    loop_tokens = eng.last_tokens
    counts = fd.launch_counts()
    assert counts["flash_decode_gqa1"] > 0
    assert counts["flash_decode_update_bounded"] > 0
    s = np.concatenate(list(eng.generate_stream(
        "Hello.", "[S1]", max_audio_length_ms=1600, utt_seed=9)))
    np.testing.assert_array_equal(eng.last_tokens, loop_tokens)
    assert np.isfinite(a).all() and np.isfinite(s).all()
    assert len(a) == len(s) == len(loop_tokens) * 1920


# ---------------------------------------------------------------------------
# Kernels B (fused depth chain), E (int4 matmul) and F (decode attention on
# kernel A's code). Kernel B's logits, with the same tokens forced into
# both, agree to 5e-2 of the plain version's peak: both round to bf16 at the
# TPU kernel's points but sum in other orders, and a bf16 rounding step
# (2^-8) that differs compounds through 4 layers and the 16-slot store.
# ---------------------------------------------------------------------------

B_TOL = 5e-2


def _small_depth_cfg(monkeypatch, plan):
    """A two-layer depth decoder at Dh = 128 (the kernel's head dim) over
    the tiny backbone, 16 codebooks, bf16."""
    from fireredtts2_tpu_torch import config as C
    monkeypatch.setitem(C.FLAVORS, "gpu-depth", C.TransformerConfig(
        vocab_size=0, num_layers=2, num_heads=4, num_kv_heads=2,
        embed_dim=512, intermediate_dim=1024))
    return C.LLMConfig(backbone_flavor="tiny", decoder_flavor="gpu-depth",
                       text_vocab_size=300, audio_vocab_size=300,
                       audio_num_codebooks=16, max_seq_len=256,
                       dtype="bfloat16", fused_depth_plan=plan)


@pytest.mark.parametrize("plan", ["gate=r8,up=s8,down=s8",
                                  "gate=r4,up=s8,down=s8",
                                  "gate=r8a8,up=s8a8,down=s8"])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_kernel_b_matches_plain(cuda, monkeypatch, plan, B):
    from fireredtts2_tpu_torch.models.lm.model import init_lm_params
    from fireredtts2_tpu_torch.ops import depth_chain as dc

    cfg = _small_depth_cfg(monkeypatch, plan)
    gen = torch.Generator(device=cuda).manual_seed(B)
    bundle = dc.prepare_depth_chain(
        init_lm_params(gen, cfg, torch.bfloat16, cuda), cfg, plan)
    last_h = _rnd(gen, B, cfg.backbone.embed_dim)
    c0 = torch.randint(0, 300, (B,), generator=gen, device=cuda)
    noise = torch.empty((B, 16, 300), device=cuda).exponential_(generator=gen)
    ref, ref_logits = dc.fused_depth_decode_plain(bundle, cfg, last_h, c0,
                                                  noise, plan=plan)
    before = dc.fused_depth_decode.launches
    out, logits = dc.fused_depth_decode(bundle, cfg, last_h, c0, noise,
                                        plan=plan, forced=ref,
                                        return_logits=True)
    torch.cuda.synchronize()
    assert dc.fused_depth_decode.launches == before + 1
    assert torch.isfinite(logits).all()
    peak = float(ref_logits.abs().max())
    assert float((logits - ref_logits).abs().max()) <= B_TOL * peak
    assert torch.equal(out[:, 0], c0.to(torch.int32))
    assert bool(((out >= 0) & (out < 300)).all())
    # two free launches back to back: the barrier words and the mbarrier
    # phases come back to their start, so both sample the same tokens
    first = dc.fused_depth_decode(bundle, cfg, last_h, c0, noise, plan=plan)
    second = dc.fused_depth_decode(bundle, cfg, last_h, c0, noise, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("B", [1, 8])
def test_kernel_b_flagship_preset(cuda, B):
    """The serving preset at the flagship depth decoder (qwen-200m, 16
    codebooks of 2051): logits with the plain version's tokens forced
    within B_TOL of its peak, two free launches back to back sampling the
    same tokens, and the grid barriers of a launch (the barrier words'
    count of them) as barriers_per_frame counts them, with the words back
    at zero."""
    from fireredtts2_tpu_torch.ops import depth_chain as dc
    from fireredtts2_tpu_torch.tools import ablate_depth as ad

    plan = "gate=r8,up=s8,down=s8"
    cfg, bundle, gen = ad.random_depth_bundle(cuda, plan)
    last_h, c0, noise = ad.frame_inputs(cfg, B, gen)
    ref, ref_logits = dc.fused_depth_decode_plain(bundle, cfg, last_h, c0,
                                                  noise, plan=plan)
    _, logits = dc.fused_depth_decode(bundle, cfg, last_h, c0, noise,
                                      plan=plan, forced=ref, return_logits=True)
    bar = dc._barrier(cuda)
    passed = int(bar[3])
    first = dc.fused_depth_decode(bundle, cfg, last_h, c0, noise, plan=plan)
    torch.cuda.synchronize()
    assert (int(bar[3]) - passed) % 2 ** 32 == dc.barriers_per_frame(cfg) == 351
    assert bar[:3].tolist() == [0, 0, 0]
    second = dc.fused_depth_decode(bundle, cfg, last_h, c0, noise, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.isfinite(logits).all()
    peak = float(ref_logits.abs().max())
    assert float((logits - ref_logits).abs().max()) <= B_TOL * peak
    # the layout the launches used: the library's, 16 ring stages at B=1
    # and 8 at B=8
    used = dc.fused_depth_decode.last_layout
    assert used == dc.library_layout(cfg, B, plan)
    assert used["stages"] == {1: 16, 8: 8}[B]


def test_kernel_b_flagship_preset_at_b16(cuda):
    """The 16-slot pool's B=16 at the flagship depth decoder: the wrapper
    splits the batch into two launches of 8 streams, each a full chain
    (two barrier counts); logits with the plain version's tokens forced
    within B_TOL of its peak, and two free calls sample the same tokens."""
    from fireredtts2_tpu_torch.ops import depth_chain as dc
    from fireredtts2_tpu_torch.tools import ablate_depth as ad

    plan = "gate=r8,up=s8,down=s8"
    B = 16
    cfg, bundle, gen = ad.random_depth_bundle(cuda, plan)
    last_h, c0, noise = ad.frame_inputs(cfg, B, gen)
    ref, ref_logits = dc.fused_depth_decode_plain(bundle, cfg, last_h, c0,
                                                  noise, plan=plan)
    _, logits = dc.fused_depth_decode(bundle, cfg, last_h, c0, noise,
                                      plan=plan, forced=ref, return_logits=True)
    bar = dc._barrier(cuda)
    torch.cuda.synchronize()
    passed = int(bar[3])
    before = dc.fused_depth_decode.launches
    first = dc.fused_depth_decode(bundle, cfg, last_h, c0, noise, plan=plan)
    torch.cuda.synchronize()
    assert dc.fused_depth_decode.launches == before + 2
    assert (int(bar[3]) - passed) % 2 ** 32 == 2 * dc.barriers_per_frame(cfg)
    second = dc.fused_depth_decode(bundle, cfg, last_h, c0, noise, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.isfinite(logits).all()
    peak = float(ref_logits.abs().max())
    assert float((logits - ref_logits).abs().max()) <= B_TOL * peak
    assert torch.equal(first[:, 0], c0.to(torch.int32))


@pytest.mark.parametrize("plan", ["gate=r8,up=s8,down=s8",
                                  "gate=r4,up=s8,down=r4",
                                  "gate=r8a8,up=s8a8,down=s8a8"])
def test_kernel_b_library_layout_matches_reference(cuda, plan):
    """The library decides each launch's layout and partition
    (frt_depth_chain_plan, tile_range); ops/depth_chain.py's chain_layout
    and tile_range, which the CPU tests check, must be the same numbers:
    at the flagship depth decoder for B = 1..8, a grid of one block per SM,
    and the tiles of every matrix height over the CPU tests' grids."""
    from fireredtts2_tpu_torch.config import LLMConfig
    from fireredtts2_tpu_torch.ops import depth_chain as dc

    cfg = LLMConfig(fused_depth_plan=plan)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for B in range(1, 9):
        ref = dc.chain_layout(cfg, B, plan)
        assert dc.library_layout(cfg, B, plan) == dict(
            grid=sms, stages=ref["stages"], act_bytes=ref["act_bytes"])
    d = cfg.decoder
    heights = {d.embed_dim, d.intermediate_dim, cfg.audio_vocab_size,
               (d.num_heads + 2 * d.num_kv_heads) * d.head_dim}
    for grid in (1, 7, 66, 132, 264):
        for O in heights:
            for b in range(grid):
                assert dc.library_tiles(O, b, grid) == dc.tile_range(O, b, grid)


@pytest.mark.parametrize("M", [1, 2, 5, 16, 17, 32])
def test_kernel_e_matches_plain(cuda, M):
    """int4 x at depth-decoder shapes (K = 1536, group 128): the kernel and
    its plain version round alike and differ in fp32 summation order. M <= 16
    is one m-tile of the tensor-core products (1, 2 and 5 ragged), 17 and 32
    two (17 ragged)."""
    from fireredtts2_tpu_torch.models.lm.transformer import (
        quantize_transformer_int4,
    )
    from fireredtts2_tpu_torch.ops import int4 as i4

    gen = torch.Generator(device=cuda).manual_seed(M)
    w = torch.randn((1, 1536, 256), generator=gen, device=cuda) * 0.02
    q = quantize_transformer_int4({"wq": w})
    x = _rnd(gen, M, 1536)
    before = i4.int4_matmul.launches
    out = i4.int4_matmul(x, q["wq"][0], q["wq_scale4"][0])
    torch.cuda.synchronize()
    assert i4.int4_matmul.launches == before + 1
    _close(out, i4.int4_matmul_plain(x, q["wq"][0], q["wq_scale4"][0]))


@pytest.mark.parametrize("M,K,O", [(1, 8960, 1536), (16, 8960, 1536),
                                   (5, 1568, 196), (17, 1568, 196),
                                   (40, 1568, 196)])
def test_kernel_e_at_ragged_shapes(cuda, M, K, O):
    """The down matrix (70 k-blocks, split over the warps of a block), and
    K/2 = 784 (a last k-block of 16 packed rows in 64, scale group 32) with
    O = 196 (a last n-tile of 4 columns); M = 40 takes two blocks of rows."""
    from fireredtts2_tpu_torch.models.lm.transformer import (
        quantize_transformer_int4,
    )
    from fireredtts2_tpu_torch.ops import int4 as i4

    gen = torch.Generator(device=cuda).manual_seed(M * K + O)
    w = torch.randn((1, K, O), generator=gen, device=cuda) * 0.02
    q = quantize_transformer_int4({"wq": w})
    packed, scales = q["wq"][0], q["wq_scale4"][0]
    pt, st = i4.output_major_int4(packed, scales)
    x = _rnd(gen, M, K)
    out = i4.int4_matmul(x, packed, scales, pt, st)
    torch.cuda.synchronize()
    _close(out, i4.int4_matmul_plain(x, packed, scales))


def test_kernel_f_matches_plain(cuda):
    """Unmerged (B, T, Hkv, D) slabs, left-padded windows, on kernel A's
    code."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    B, T, Hkv, G, D = 3, 1024, 2, 6, 128
    q = _rnd(gen, B, Hkv * G, D)
    k, v = _rnd(gen, B, T, Hkv, D), _rnd(gen, B, T, Hkv, D)
    start = torch.tensor([0, 37, 300], dtype=torch.int32, device=cuda)
    end = torch.tensor([200, 1024, 777], dtype=torch.int32, device=cuda)
    before = fd.pallas_decode_attention.launches
    out = fd.pallas_decode_attention(q, k, v, start, end)
    torch.cuda.synchronize()
    assert fd.pallas_decode_attention.launches == before + 1
    _close(out, fd.pallas_decode_attention_plain(q, k, v, start, end))


def test_preset_engine_launches_kernel_b_once_per_frame(cuda):
    """The serving preset (int8 backbone, fused depth chain) on a small
    engine: kernel B once per generated frame, and stream == generate."""
    from fireredtts2_tpu_torch.engine import FireRedTTS2Engine
    from fireredtts2_tpu_torch.ops import depth_chain as dc

    cfg = _small_gpu_config()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, decoder_flavor="qwen-200m", quantize_backbone=True,
        fused_depth_plan="gate=r8,up=s8,down=s8"))
    eng = FireRedTTS2Engine(cfg, seed=0, device=cuda)
    dc.fused_depth_decode.launches = 0
    a = eng.generate("Hello.", "[S1]", max_audio_length_ms=800, utt_seed=4)
    frames = len(eng.last_tokens)
    assert dc.fused_depth_decode.launches == frames + (frames < 10)
    loop_tokens = eng.last_tokens
    list(eng.generate_stream("Hello.", "[S1]", max_audio_length_ms=800,
                             utt_seed=4))
    np.testing.assert_array_equal(eng.last_tokens, loop_tokens)
    assert np.isfinite(a).all()


def test_pool_of_8_on_card_identical_greedy_requests(cuda):
    """An 8-slot continuous batcher over the serving preset on a small
    engine: four identical requests (top-1 codebook 0, one utterance seed)
    admitted in one burst (``burst()``) beside four sampled ones give
    identical frames
    and audio, every stream finite with one 1920-sample chunk per frame,
    kernels A, B and C launched."""
    from fireredtts2_tpu_torch.engine import FireRedTTS2Engine
    from fireredtts2_tpu_torch.ops import depth_chain as dc
    from fireredtts2_tpu_torch.runtime.batcher import ContinuousBatcher

    cfg = _small_gpu_config()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, decoder_flavor="qwen-200m", quantize_backbone=True,
        fused_depth_plan="gate=r8,up=s8,down=s8"))
    eng = FireRedTTS2Engine(cfg, seed=0, device=cuda)
    b = ContinuousBatcher(eng, max_streams=8)
    b.start()
    try:
        assert b.wait_ready(timeout=600)
        fd.reset_launch_counts()
        dc.fused_depth_decode.launches = 0
        with b.burst():
            hs = [b.submit("Serve these twins.", "[S1]", temperature=1.0,
                           topk=1, max_audio_length_ms=960, utt_seed=9)
                  for _ in range(4)]
            hs += [b.submit(f"Sampled neighbour {i}.", "[S1]", topk=10,
                            max_audio_length_ms=960) for i in range(4)]
        audios = [np.concatenate(list(h)) for h in hs]
    finally:
        b.stop()
    for h, a in zip(hs, audios):
        assert len(a) == len(h.tokens) * 1920 > 0 and np.isfinite(a).all()
    for h, a in zip(hs[1:4], audios[1:4]):
        np.testing.assert_array_equal(h.tokens, hs[0].tokens)
        np.testing.assert_array_equal(a, audios[0])
    assert fd.flash_decode_gqa1.launches > 0
    assert fd.flash_decode_update_bounded.launches > 0
    assert dc.fused_depth_decode.launches > 0


# ---------------------------------------------------------------------------
# Kernel P (the GEMV probes) and kernel B's ablation builds. Kernel P's y
# form as every kernel above (both round an fp32 sum to bf16); its sum form
# within 1e-4 of the sum of |y| (fp32 sums in other orders, atomics across
# blocks).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("load", ["direct", "staged"])
@pytest.mark.parametrize("mode", ["bf16", "int8", "int4", "s8s8", "s8s8q"])
@pytest.mark.parametrize("M", [5, 16, 32])
def test_kernel_p_matches_plain(cuda, mode, load, M):
    """chip_smoke.py's kernel P cases, y and sum forms against the plain
    version: small matrices; matrices of thousands of rows, sized from the
    grid so that a warp's tiles run with every row count 1..R; and (not
    the s8s8 modes) inputs too large for shared memory, read from global
    memory. Two launches a case, both counted."""
    import chip_smoke
    from fireredtts2_tpu_torch.ops import gemv_probe as gp

    before = gp.gemv_probe.launches
    rows = chip_smoke.check_kernel_p(cuda, ms=(M,), modes=(mode,), loads=(load,))
    assert {r["case"] for r in rows} == (
        {"small", "tiles"} if mode.startswith("s8") else {"small", "tiles", "global x"})
    assert [r for r in rows if not r["ok"]] == []
    assert gp.gemv_probe.launches == before + 2 * len(rows)


def test_activation_quantisers_same_on_card_and_cpu(cuda):
    """The a8 quantisers' plain versions give the same scales and integers on
    the card as on the CPU (where tests/test_torch_probes.py holds them to
    the JAX quantiser as XLA compiles it), and kernel P's s8s8 products on
    those inputs equal its plain version's exactly."""
    from fireredtts2_tpu_torch.ops import depth_chain as dc
    from fireredtts2_tpu_torch.ops import gemv_probe as gp

    gen = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn((32, 384), generator=gen, device=cuda)
         * torch.rand((32, 1), generator=gen, device=cuda) * 10).to(torch.bfloat16)
    for quant in (gp.quantize_rows, dc._quant_act):
        q, sc = quant(x)
        qc, scc = quant(x.cpu())
        assert torch.equal(q.cpu(), qc) and torch.equal(sc.cpu(), scc)
    w = torch.randint(-127, 128, (300, 384), generator=gen, device=cuda,
                      dtype=torch.int8)
    mats = [gp.Mat(w, None, 0)]
    y = gp.gemv_probe(mats, [x], "s8s8", form="y")
    assert torch.equal(y, gp.gemv_probe_plain(mats, [x], "s8s8", form="y"))


def test_kernel_p_barrier_and_empty_launch(cuda):
    """No matrices: S grid barriers, and an empty cooperative launch."""
    from fireredtts2_tpu_torch.ops import gemv_probe as gp

    for steps, sync in ((0, "none"), (50, "step")):
        out = gp.ProbeCall([], [], "int8", steps=steps, sync=sync).launch()
        torch.cuda.synchronize()
        assert float(out.abs().max()) == 0.0


def _small_depth_run(monkeypatch, cuda, B=2):
    from fireredtts2_tpu_torch.models.lm.model import init_lm_params
    from fireredtts2_tpu_torch.ops import depth_chain as dc

    plan = "gate=r8,up=s8,down=s8"
    cfg = _small_depth_cfg(monkeypatch, plan)
    gen = torch.Generator(device=cuda).manual_seed(5)
    bundle = dc.prepare_depth_chain(
        init_lm_params(gen, cfg, torch.bfloat16, cuda), cfg, plan)
    inputs = (_rnd(gen, B, cfg.backbone.embed_dim),
              torch.randint(0, 300, (B,), generator=gen, device=cuda),
              torch.empty((B, 16, 300), device=cuda).exponential_(generator=gen))
    return cfg, bundle, inputs, plan


def test_kernel_b_abl0_build_identical_to_serving_build(cuda, monkeypatch):
    from fireredtts2_tpu_torch.ops import depth_chain as dc
    from fireredtts2_tpu_torch.tools import ablate_depth as ad

    cfg, bundle, inputs, plan = _small_depth_run(monkeypatch, cuda)
    before = dc.fused_depth_decode.launches
    res = ad.abl0_matches_serving(bundle, cfg, inputs, plan)
    assert (res["samples_equal"], res["forced_equal"], res["logits_equal"]) == (
        True, True, True)
    assert res["plain_max_abs_err"] <= B_TOL * res["plain_peak"]
    # the serving build's one launch counts, the FRT_ABL=0 build's two do not
    assert dc.fused_depth_decode.launches == before + 1


def test_kernel_b_trace_build_samples_as_serving_and_stamps(cuda, monkeypatch):
    """The trace build keeps the serving build's numbers, and each traced
    block stamps every phase barrier (1 + 5 L a micro-step) and every
    logits barrier (one a micro-step after the first) in and out once."""
    from fireredtts2_tpu_torch.tools import ablate_depth as ad

    cfg, bundle, _, plan = _small_depth_run(monkeypatch, cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    tr = ad.trace_frame(bundle, cfg, 2, gen, plan)
    assert tr["samples_equal"]
    ncb, L = cfg.audio_num_codebooks, cfg.decoder.num_layers
    for r in tr["blocks"]:
        c = r["counts"]
        assert c["bar_in"] == c["bar_out"] == ncb * (1 + 5 * L)
        assert c["samp_in"] == c["samp_out"] == ncb - 1
        assert c["attn_in"] == c["attn_out"] == ncb * L
        assert c["tile_in"] == c["tile_out"]
        assert 0 < r["span_us"] and r["split_us"]["barrier"] > 0


@pytest.mark.parametrize("name", ["half", "tiny", "noload", "noattn",
                                  "nosample", "nosync", "noattncore"])
def test_kernel_b_ablation_builds_launch_and_finish(cuda, monkeypatch, name):
    from fireredtts2_tpu_torch.tools import ablate_depth as ad

    cfg, bundle, inputs, plan = _small_depth_run(monkeypatch, cuda)
    out = ad.run_variant(ad.BITS[name], bundle, cfg, inputs, plan)
    torch.cuda.synchronize()
    assert out.shape == (2, 16) and out.dtype == torch.int32


# ---------------------------------------------------------------------------
# Voice cloning and dialogue: the fp32 precision policy (no TF32 in an fp32
# encode, whatever PyTorch's process-wide flags say) and the dialogue's
# stream == batch on the card. Codes must equal the CPU's; a frame may
# differ only where the CPU's best-vs-second distance gap is below 1e-5
# relative (models/codec/rvq.py: code_mismatches).
# ---------------------------------------------------------------------------


@pytest.fixture
def tf32_on():
    """PyTorch's process-wide TF32 flags on for the test, restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_precision_policy_keeps_fp32_products_exact(cuda, tf32_on):
    """Inside fp32_exact the conv and matmul of fp32 operands agree with the
    CPU to fp32 rounding; the caller's flags are back after it."""
    import torch.nn.functional as F
    from fireredtts2_tpu_torch.ops.precision import fp32_exact, pconv1d, peinsum

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 1, 4000), generator=gen)
    w = torch.randn((402, 1, 400), generator=gen)
    a, b = torch.randn((300, 256), generator=gen), torch.randn((256, 2048),
                                                               generator=gen)
    ref_c = F.conv1d(x, w, stride=160)
    ref_m = a @ b
    got_c = pconv1d(x.to(cuda), w.to(cuda), stride=160).cpu()
    got_m = peinsum("ij,jk->ik", a.to(cuda), b.to(cuda)).cpu()
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    for got, ref in ((got_c, ref_c), (got_m, ref_m)):
        assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5
    with fp32_exact():
        assert not torch.backends.cudnn.allow_tf32


def _encode_codec(name):
    from fireredtts2_tpu_torch.config import CodecConfig, tiny_engine_config
    if name == "tiny":
        return tiny_engine_config().codec
    base = CodecConfig()
    one = dict(num_layers=1)
    return dataclasses.replace(
        base, dtype="float32",
        ssl=dataclasses.replace(base.ssl, **one),
        ssl_adaptor=dataclasses.replace(base.ssl_adaptor, **one),
        acoustic_encoder=dataclasses.replace(base.acoustic_encoder, **one),
        acoustic_decoder=dataclasses.replace(base.acoustic_decoder, **one))


def _to(tree, dev):
    return {k: _to(v, dev) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree.to(dev)


def _encode_audio(cfg):
    """10 s of voiced audio at 16 kHz, and it cut into two 6 s windows
    (the second zero-padded) with their lengths."""
    rng = np.random.default_rng(0)
    n = 160_000
    t = np.arange(n) / 16_000
    audio = (0.3 * np.sin(2 * np.pi * 180 * t) * np.sin(2 * np.pi * 2 * t)
             + 0.02 * rng.standard_normal(n)).astype(np.float32)
    win = cfg.encode_chunk_seconds * cfg.input_sample_rate
    batch = np.zeros((2, win), np.float32)
    batch[0], batch[1, :n - win] = audio[:win], audio[win:]
    return audio, batch, torch.full((2,), win, dtype=torch.int32)


def _cpu_codes(cpu, cfg, batch, lengths):
    """The CPU's codes of the windows and their best-vs-second gaps."""
    from fireredtts2_tpu_torch.models.codec.model import encode_features
    from fireredtts2_tpu_torch.models.codec.rvq import code_gaps, rvq_encode

    with torch.inference_mode():
        feats = encode_features(cpu, cfg, torch.from_numpy(batch), lengths)
        want = rvq_encode(cpu["rvq"], cfg.rvq, feats)
        return want.numpy(), code_gaps(cpu["rvq"], cfg.rvq, feats, want).numpy()


@pytest.mark.parametrize("name", ["tiny", "flagship_widths"])
def test_fp32_encode_on_card_matches_cpu(cuda, tf32_on, name):
    """An fp32 codec (the tiny one, and one layer of each encoder at the
    flagship widths with the full RVQ) encodes two windows on the card and
    on the CPU, TF32 allowed process-wide: equal codes up to counted
    near-ties, and codec_encode's tokens likewise."""
    from fireredtts2_tpu_torch.models.codec.model import (
        codec_encode, encode_window, init_codec_params,
    )
    from fireredtts2_tpu_torch.models.codec.rvq import code_mismatches

    cfg = _encode_codec(name)
    cpu = init_codec_params(torch.Generator().manual_seed(3), cfg)
    card = _to(cpu, cuda)
    audio, batch, lengths = _encode_audio(cfg)
    want, gaps = _cpu_codes(cpu, cfg, batch, lengths)
    with torch.inference_mode():
        got = encode_window(card, cfg, torch.from_numpy(batch).to(cuda),
                            lengths.to(cuda)).cpu()
        diff, bad = code_mismatches(want, got.numpy(), gaps)
        assert bad == 0, (diff, bad)
        codes, tlen = codec_encode(card, cfg, audio[None])
    assert list(tlen) == [125]
    flat = np.concatenate([got[:, 0].numpy(), got[:, 1].numpy()], axis=-1)
    np.testing.assert_array_equal(codes[0], flat[:, :125])


def test_encode_beside_a_stream_keeps_cpu_codes_and_flags(cuda, tf32_on):
    """One thread streams on a small bf16 engine (its vocoder's fp32 iSTFT
    products enter and leave the precision scope every block) while
    another encodes on the fp32 flagship-width codec, TF32 allowed
    process-wide by the caller: every encode gives the CPU's codes up to
    counted near-ties, and the caller's flags are unchanged after."""
    import threading

    from fireredtts2_tpu_torch.engine import FireRedTTS2Engine
    from fireredtts2_tpu_torch.models.codec.model import (
        encode_window, init_codec_params,
    )
    from fireredtts2_tpu_torch.models.codec.rvq import code_mismatches

    cfg = _encode_codec("flagship_widths")
    cpu = init_codec_params(torch.Generator().manual_seed(3), cfg)
    card = _to(cpu, cuda)
    _, batch, lengths = _encode_audio(cfg)
    want, gaps = _cpu_codes(cpu, cfg, batch, lengths)
    eng = FireRedTTS2Engine(_small_gpu_config(), seed=0, device=cuda)
    stop, errors, blocks = threading.Event(), [], []

    def stream():
        try:
            while not stop.is_set():
                for chunk in eng.generate_stream(
                        "Hello there, how are you today?", "[S1]",
                        max_audio_length_ms=1600, utt_seed=1):
                    blocks.append(len(chunk))
        except Exception as e:                 # reported by the main thread
            errors.append(e)

    th = threading.Thread(target=stream)
    th.start()
    try:
        for _ in range(4):
            with torch.inference_mode():
                got = encode_window(card, cfg, torch.from_numpy(batch).to(cuda),
                                    lengths.to(cuda)).cpu().numpy()
            diff, bad = code_mismatches(want, got, gaps)
            assert bad == 0, (diff, bad)
    finally:
        stop.set()
        th.join(300)
    assert not th.is_alive() and not errors, errors
    assert blocks
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_dialogue_stream_equals_batch_on_card(cuda):
    """A 2-turn dialogue with a prompt on a small engine in bf16, through
    kernels A and C, with finite audio: turn 0's streamed frames equal
    generate_dialogue's on the same seeds, and what re-entered after it
    was its streamed audio (its encode is then cached). In bf16 the
    streamed and offline decodes round differently, so turn 1 may
    differ from the batch's."""
    import tempfile

    from scipy.io import wavfile
    from fireredtts2_tpu_torch.engine import FireRedTTS2Engine
    from fireredtts2_tpu_torch.utils.audio_io import resample

    eng = FireRedTTS2Engine(_small_gpu_config(), seed=0, device=cuda)
    rng = np.random.default_rng(1)
    t = np.arange(8000) / 16_000
    prompt = (0.3 * np.sin(2 * np.pi * 150 * t)
              + 0.02 * rng.standard_normal(8000)).astype(np.float32)
    texts = ["[S1]Hello there.", "[S2]Hi, nice to meet you."]
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/p.wav"
        wavfile.write(path, 16_000, (prompt * 32767).astype(np.int16))
        kw = dict(prompt_wav_list=[path], prompt_text_list=["[S1]My voice."],
                  max_utterance_ms=640, utt_seed=5)
        fd.reset_launch_counts()
        audio = eng.generate_dialogue(list(texts), **kw)
        counts = fd.launch_counts()
        batch = list(eng.last_turn_tokens)
        pieces = list(eng.generate_dialogue_stream(list(texts), **kw))
    assert counts["flash_decode_gqa1"] > 0
    assert counts["flash_decode_update_bounded"] > 0
    assert len(batch) == len(eng.last_turn_tokens) == 2
    np.testing.assert_array_equal(batch[0], eng.last_turn_tokens[0])
    calls = eng.encode_calls
    heard = np.concatenate([c for i, c in pieces if i == 0])
    eng.encode_prompt_tokens(resample(heard, eng.output_sample_rate,
                                      eng.sample_rate))
    assert eng.encode_calls == calls
    assert np.isfinite(audio).all() and len(audio) > 0
    assert np.isfinite(np.concatenate([c for _, c in pieces])).all()


# ---------------------------------------------------------------------------
# Training on the card (no kernel of its own): the tiny LM's train_step
# ---------------------------------------------------------------------------


def test_train_step_on_card_matches_cpu_and_remat(cuda):
    """A tiny LM's train_step on the card at f32 gives the CPU's loss
    within 1e-4 relative (the same depth subset passed to both); at bf16
    compute remat "dots" gives a loss bitwise equal to no remat."""
    from fireredtts2_tpu_torch.config import tiny_engine_config
    from fireredtts2_tpu_torch.models.lm.model import init_lm_params
    from fireredtts2_tpu_torch.train import loop as tl
    from fireredtts2_tpu_torch.train import step as ts

    cfg = tiny_engine_config().llm
    gen = torch.Generator().manual_seed(0)
    params = init_lm_params(gen, cfg, torch.float32, "cpu")
    tok, msk = next(tl.synthetic_batches(cfg, tl.TrainConfig(
        batch_size=4, seq_len=64), seed=1))
    idx = torch.multinomial(torch.ones(4 * 64), 32, replacement=True,
                            generator=gen)
    losses = {}
    for dev, remat, dt in (("cpu", "", None), (cuda, "", None),
                           (cuda, "", torch.bfloat16),
                           (cuda, "dots", torch.bfloat16)):
        opt = ts.make_optimizer(1e-3, 1, 10)
        state = ts.init_train_state(ts.tree_map(lambda p: p.to(dev), params),
                                    opt)
        _, m = ts.train_step(
            state, torch.from_numpy(tok).to(dev), torch.from_numpy(msk).to(dev),
            cfg=dataclasses.replace(cfg, train_remat=remat), optimizer=opt,
            compute_dtype=dt, depth_indices=[idx.to(dev)])
        assert torch.isfinite(m["grad_norm"])
        losses[(str(dev), remat, dt)] = m["loss"].cpu()
    cpu, card = losses[("cpu", "", None)], losses[("cuda", "", None)]
    torch.testing.assert_close(card, cpu, rtol=1e-4, atol=0)
    assert torch.equal(losses[("cuda", "dots", torch.bfloat16)],
                       losses[("cuda", "", torch.bfloat16)])


def test_asr_full_width_two_layers_on_card_matches_cpu(cuda):
    """Whisper at whisper-large-v3's widths with 2 + 2 layers, fp32: the
    card's greedy transcription of a 3 s clip equals the CPU's token for
    token, and one S > 1 forward over the prompt and those tokens picks
    them again (where its top-2 logit gap is at least 1e-3)."""
    from fireredtts2_tpu_torch.asr import (
        ASRConfig, WhisperASR, WhisperASRModelConfig, init_asr_params,
    )
    from fireredtts2_tpu_torch.asr import model as am

    cfg = dataclasses.replace(WhisperASRModelConfig(), encoder_layers=2,
                              decoder_layers=2)
    params = init_asr_params(torch.Generator().manual_seed(3), cfg)
    conf = ASRConfig(max_new_tokens=16, fallback_temperatures=())
    t = np.arange(48_000) / 16_000
    audio = (0.3 * np.sin(2 * np.pi * (150 + 40 * t) * t)
             * (0.5 + 0.5 * np.sin(2 * np.pi * 2 * t) ** 2)).astype(np.float32)
    on = {d: WhisperASR(conf, params=params, model_cfg=cfg, warmup=False,
                        device=d) for d in ("cpu", cuda)}
    ids = {d: [i for s in a.transcribe(audio).segments for i in s["tokens"]]
           for d, a in on.items()}
    assert ids["cpu"] and ids["cpu"] == ids[cuda]
    asr = on[cuda]
    mel, mel_len = asr._mel(audio)
    prompt = torch.from_numpy(asr._prompt_ids(None)[0]).to(cuda)
    cross, enc_len = am.encoder_context(asr.params, cfg, mel, mel_len)
    full = torch.cat([prompt[0], torch.tensor(ids[cuda], device=cuda)])[None]
    logits, _ = am.asr_decoder_forward(
        asr.params, cfg, full, am.init_asr_decode_state(cfg, 1, device=cuda),
        cross, enc_len)
    P, n = prompt.shape[1], len(ids[cuda])
    pred = logits[0, P - 1: P - 1 + n]
    top2 = pred.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu()
    held = next((i for i in range(n) if gap[i] < 1e-3), n)
    assert pred.argmax(-1)[:held].tolist() == ids[cuda][:held]


def test_asr_beam_search_two_layers_on_card_matches_cpu(cuda):
    """Beam search (W=3) at whisper-large-v3's widths with 2 + 2 layers,
    fp32, on the card and on the CPU: tokens, n_tokens and n_finished
    equal; sum_logprob within 1e-4 relative."""
    from fireredtts2_tpu_torch.asr import (
        WhisperASR, WhisperASRModelConfig, asr_beam_decode, init_asr_params,
    )

    cfg = dataclasses.replace(WhisperASRModelConfig(), encoder_layers=2,
                              decoder_layers=2)
    params = init_asr_params(torch.Generator().manual_seed(5), cfg)
    t = np.arange(48_000) / 16_000
    audio = (0.3 * np.sin(2 * np.pi * (150 + 40 * t) * t)).astype(np.float32)
    res = {}
    for d in ("cpu", "cuda"):
        asr = WhisperASR(params=params, model_cfg=cfg, warmup=False, device=d)
        mel, mel_len = asr._mel(audio)
        prompt = torch.from_numpy(asr._prompt_ids(None)[0]).to(d)
        res[d] = asr_beam_decode(asr.params, cfg, mel, mel_len, prompt, 12, 3)
    cpu, card = res["cpu"], res["cuda"]
    for f in ("tokens", "n_tokens", "n_finished"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    torch.testing.assert_close(card.sum_logprob.cpu(), cpu.sum_logprob,
                               rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# Speculative (Jacobi) depth and the one-token vocoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [128, 256])
@pytest.mark.parametrize("K,O", [(1536, 8960), (8960, 1536)])
def test_kernel_e_at_speculative_rows(cuda, M, K, O):
    """Kernel E at the rows speculative depth gives it (16 a stream, B = 8
    and 16): the grid-y blocks past 32 rows, against the plain version."""
    from fireredtts2_tpu_torch.models.lm.transformer import (
        quantize_transformer_int4,
    )
    from fireredtts2_tpu_torch.ops import int4 as i4

    gen = torch.Generator(device=cuda).manual_seed(M + K)
    w = torch.randn((1, K, O), generator=gen, device=cuda) * 0.02
    q = quantize_transformer_int4({"w_gate": w})
    packed, scales = q["w_gate"][0], q["w_gate_scale4"][0]
    x = _rnd(gen, M, K)
    before = i4.int4_matmul.launches
    out = i4.int4_matmul(x, packed, scales)
    torch.cuda.synchronize()
    assert i4.int4_matmul.launches == before + 1
    _close(out, i4.int4_matmul_plain(x, packed, scales))


@pytest.mark.parametrize("quant", ["bf16", "int4"])
def test_jacobi_on_card_equals_sequential_up_to_near_ties(cuda, quant):
    """The flagship depth decoder (random bf16 weights; int4 through kernel
    E at 16 rows a stream): Jacobi on each of 6 frames at B=8 against the
    sequential loop's chain on the same inputs. A row may differ only at a
    near-tie of the two forwards' logits (chip_smoke.verify_jacobi)."""
    import chip_smoke
    from fireredtts2_tpu_torch.config import LLMConfig
    from fireredtts2_tpu_torch.models.lm import model as lm
    from fireredtts2_tpu_torch.models.lm.transformer import (
        quantize_transformer_int4,
    )
    from fireredtts2_tpu_torch.ops import int4 as i4
    from fireredtts2_tpu_torch.tools.spec_depth_rounds import depth_params

    cfg = LLMConfig()
    params = depth_params(cfg, torch.bfloat16, cuda)
    if quant == "int4":
        params["decoder"] = i4.prepare_int4_layout(
            quantize_transformer_int4(params["decoder"]))
    gen = torch.Generator(device=cuda).manual_seed(4)
    ncb, V = cfg.audio_num_codebooks, cfg.audio_vocab_size
    calls = []
    for _ in range(6):
        last_h = _rnd(gen, 8, cfg.backbone.embed_dim)
        c0 = torch.randint(0, V, (8,), generator=gen, device=cuda,
                           dtype=torch.int32)
        noise = torch.empty((8, ncb, V), device=cuda).exponential_(generator=gen)
        seq = lm._depth_decode(params, cfg, last_h, c0, noise, 10, 0.75)
        calls.append((params, cfg, last_h, c0, noise, 10, 0.75, seq))
    before = i4.int4_matmul.launches
    ver = chip_smoke.verify_jacobi(calls)
    assert ver["explained"], ver["flips"]
    assert 1 <= ver["rounds_max"] <= ncb - 1
    assert (i4.int4_matmul.launches > before) == (quant == "int4")


def test_one_token_chain_on_card_matches_codec_decode(cuda):
    """stream_decode_step over 24 tokens on the small card codec (kernel C
    at S=8, once a layer a token) against codec_decode of the same tokens:
    within chip_smoke.py's stream-vs-generate bound, as a share of the
    peak."""
    import chip_smoke
    from fireredtts2_tpu_torch.models.codec import (
        codec_decode, init_codec_params, stream_decode_init,
        stream_decode_step,
    )

    cfg = _small_gpu_config().codec
    params = init_codec_params(torch.Generator(device=cuda).manual_seed(0),
                               cfg, torch.bfloat16, cuda)
    L = 24
    toks = torch.randint(0, cfg.rvq.codebook_size,
                         (1, cfg.rvq.num_quantizers, L), device=cuda)
    fd.reset_launch_counts()
    with torch.inference_mode():
        state = stream_decode_init(cfg, 1, torch.bfloat16, device=cuda)
        pieces = []
        for t in range(L):
            a, state = stream_decode_step(params, cfg, toks[:, :, t:t + 1],
                                          state, t == 0, t == L - 1)
            pieces.append(a)
        one = torch.cat(pieces, dim=1).float().cpu().numpy()
        batch = codec_decode(params, cfg, toks).float().cpu().numpy()
    assert fd.launch_counts()["flash_decode_update_bounded"] == \
        L * cfg.acoustic_decoder.num_layers
    assert one.shape == batch.shape == (1, L * 1920)
    assert np.isfinite(one).all()
    gap = np.abs(one - batch).max() / np.abs(batch).max()
    assert gap <= chip_smoke.STREAM_GAP_TOL, gap
