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
