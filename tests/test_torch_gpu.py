"""PyTorch port on the card: the CUDA kernels against their plain PyTorch
versions, and a small engine through both kernels. Marked `gpu`; each test
skips when no CUDA device is present.

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


@pytest.mark.parametrize("B,q_start,q_end", [
    (1, [0], [200]),
    (3, [0, 37, 511], [3000, 1024, 3584]),   # ragged; chunk edge; slab end
])
def test_kernel_a_matches_plain(cuda, B, q_start, q_end):
    gen = torch.Generator(device=cuda).manual_seed(B)
    L, T, Hkv, G, Dh = 3, 3584, 2, 6, 128
    q = _rnd(gen, B, Hkv * G, Dh)
    k4, v4 = _rnd(gen, L, B, T, Hkv * Dh), _rnd(gen, L, B, T, Hkv * Dh)
    qs = torch.tensor(q_start, dtype=torch.int32, device=cuda)
    qe = torch.tensor(q_end, dtype=torch.int32, device=cuda)
    before = fd.flash_decode_gqa1.launches
    out = fd.flash_decode_gqa1(q, k4, v4, 2, qs, qe, min(q_start), max(q_end))
    torch.cuda.synchronize()
    assert fd.flash_decode_gqa1.launches == before + 1
    _close(out, fd.flash_decode_gqa1_plain(q, k4, v4, 2, qs, qe,
                                           min(q_start), max(q_end)))


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
@pytest.mark.parametrize("B", [1, 3])
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


@pytest.mark.parametrize("M", [1, 16])
def test_kernel_e_matches_plain(cuda, M):
    """int4 x at depth-decoder shapes (K = 1536, group 128): the kernel and
    its plain version round alike and differ in fp32 summation order."""
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


@pytest.mark.parametrize("name", ["half", "tiny", "noload", "noattn",
                                  "nosample", "nosync"])
def test_kernel_b_ablation_builds_launch_and_finish(cuda, monkeypatch, name):
    from fireredtts2_tpu_torch.tools import ablate_depth as ad

    cfg, bundle, inputs, plan = _small_depth_run(monkeypatch, cuda)
    out = ad.run_variant(ad.BITS[name], bundle, cfg, inputs, plan)
    torch.cuda.synchronize()
    assert out.shape == (2, 16) and out.dtype == torch.int32
