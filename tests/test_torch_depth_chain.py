"""PyTorch port, kernel B (the fused depth chain, ops/depth_chain.py) held
against the JAX package's fused_depth_decode (Pallas, interpret mode) on the
CPU at float32, tiny widths, with the same parameters and the same noise.

Tolerances: quantised values bit for bit; sampled tokens exactly (the
port's plain version repeats the TPU kernel's arithmetic in fp32, with
JAX's fold_in draws injected as the noise); waveforms to 1e-4 of their
peak (fp32 summation order).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireredtts2_tpu.config import LLMConfig as JLLM
from fireredtts2_tpu.config import tiny_engine_config as j_tiny
from fireredtts2_tpu.models.codec.model import init_codec_params as j_init_codec
from fireredtts2_tpu.models.lm import model as jmodel
from fireredtts2_tpu.ops import pallas_depth as jpd

from fireredtts2_tpu_torch.config import LLMConfig as TLLM
from fireredtts2_tpu_torch.config import tiny_engine_config as t_tiny
from fireredtts2_tpu_torch.engine import FireRedTTS2Engine as TEngine
from fireredtts2_tpu_torch.models.lm import model as tmodel
from fireredtts2_tpu_torch.ops import depth_chain as tdc
from fireredtts2_tpu_torch.weights import from_jax

from _torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    jax_engine, jax_init, one_torch_thread, to_t, wave_close,
)

PLANS = ["", "gate=r4,up=s8,down=s8", "gate=s8,up=r4,down=r4",
         "gate=s8,up=s8,down=s8"]
A8_PLANS = ["gate=r8a8,up=r8a8,down=r8a8", "gate=r8a8,up=s8a8,down=s8"]
PRESET = "gate=r8,up=s8,down=s8"
_KW = dict(backbone_flavor="tiny", decoder_flavor="tiny-deep",
           text_vocab_size=300, audio_vocab_size=64, audio_num_codebooks=4,
           max_seq_len=256, dtype="float32")


def _cfgs(plan=""):
    return JLLM(**_KW, fused_depth_plan=plan), TLLM(**_KW, fused_depth_plan=plan)


def _depth_noise(key, B, ncb, V) -> torch.Tensor:
    """The Exp(1) draws JAX's depth chain makes from `key` (fold_in(key, i)
    for codebook i; column 0 unused) as (B, ncb, V)."""
    rows = [np.ones((B, V), np.float32)]
    rows += [np.asarray(jax.random.exponential(jax.random.fold_in(key, i),
                                               (B, V), jnp.float32))
             for i in range(1, ncb)]
    return to_t(np.stack(rows, axis=1))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    params = jax_init(jmodel.init_lm_params, jax.random.PRNGKey(0), jcfg)
    B = 3
    last_h = jax.random.normal(jax.random.PRNGKey(1),
                               (B, jcfg.backbone.embed_dim), jnp.float32)
    c0 = jax.random.randint(jax.random.PRNGKey(2), (B,), 0,
                            jcfg.audio_vocab_size)
    return jcfg, tcfg, params, from_jax(params), last_h, c0


@pytest.mark.parametrize("plan,want", [
    ("", {"w_gate": "r8", "w_up": "r8", "w_down": "r8"}),
    ("gate=r4,down=s8", {"w_gate": "r4", "w_up": "r8", "w_down": "s8"}),
    ("gate=r8a8,up=s8a8", {"w_gate": "r8a8", "w_up": "s8a8", "w_down": "r8"}),
    ("gate:r8", None), ("proj=r8", None), ("gate=r9", None), ("gate", None),
    ("up=,down=s8", None),
])
def test_parse_plan(plan, want):
    """The JAX grammar; malformed strings raise a ValueError naming it, as
    JAX's parse_plan does."""
    if want is None:
        with pytest.raises(ValueError, match="expected"):
            tdc.parse_plan(plan)
        with pytest.raises(ValueError):
            jpd.parse_plan(plan)
    else:
        assert tdc.parse_plan(plan) == jpd.parse_plan(plan) == want


def _jax_layout(name: str, t: torch.Tensor, mode: str) -> np.ndarray:
    """A port bundle leaf in the JAX bundle's layout."""
    a = t.numpy()
    if name.endswith("_s4"):
        return np.swapaxes(a, -1, -2)
    if name.endswith("_s"):
        return a[:, None, :]
    if name in ("w_gate", "w_up") and mode in ("s8", "s8a8"):
        return a                       # JAX streams these transposed too
    return np.swapaxes(a, -1, -2)


@pytest.mark.parametrize("plan", [PRESET, "gate=r4,up=s8a8,down=r4"])
def test_bundle_matches_jax_bit_for_bit(setup, plan):
    """A JAX enable_fused_depth tree, bridged by from_jax (int8 leaves and
    the bundle's), holds the same quantised values as the port's own
    prepare_depth_chain of the same raw parameters: its bundle, and the
    quantised decoder it returns when asked. The port's serving tree holds
    the bundle and no decoder."""
    _, _, params, tparams, _, _ = setup
    jcfg, tcfg = _cfgs(plan)
    jtree = from_jax(jpd.enable_fused_depth(dict(params), jcfg))
    ttree = tdc.enable_fused_depth(dict(tparams), tcfg)
    assert "decoder" not in ttree and "xla_decoder" not in ttree["depth_chain"]
    tdec = tdc.prepare_depth_chain(tparams, tcfg, plan,
                                   with_decoder=True)["xla_decoder"]
    assert sorted(jtree["decoder"]) == sorted(tdec)
    for k, v in jtree["decoder"].items():
        assert v.dtype == tdec[k].dtype, k
        assert torch.equal(v, tdec[k]), k
    jb, tb = jtree["depth_chain"], ttree["depth_chain"]
    modes = tdc.parse_plan(plan)
    names = ["wqkv", "wqkv_s", "wo", "wo_s"]
    for m in ("w_gate", "w_up", "w_down"):
        names += [m, m + ("_s4" if modes[m] == "r4" else "_s")]
    for n in names:
        want = jb[n].numpy()
        got = _jax_layout(n, tb[n], modes.get(n.rsplit("_s", 1)[0], "r8"))
        assert got.dtype == (np.float32 if n.endswith("_s4") else want.dtype), n
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=n)
    V, ncb = tcfg.audio_vocab_size, tcfg.audio_num_codebooks
    np.testing.assert_array_equal(tb["emb_rows"].numpy(),
                                  jb["emb_rows"].numpy()[: (ncb - 1) * V])
    np.testing.assert_array_equal(np.swapaxes(tb["head_t"].numpy(), 1, 2),
                                  jb["head_steps"].numpy()[:, :, :V])
    np.testing.assert_array_equal(tb["proj_t"].numpy().T, jb["proj"].numpy())
    np.testing.assert_array_equal(tb["bqkv"].numpy(), jb["bqkv"].numpy()[:, 0])
    for n in ("rope_cos", "rope_sin"):
        np.testing.assert_allclose(tb[n].numpy(), jb[n].numpy(), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("plan", PLANS + A8_PLANS)
def test_plain_samples_jax_kernel_tokens(setup, plan):
    """Kernel B's plain version samples the JAX kernel's tokens (B = 3,
    which JAX pads to 8 rows), with c0 in column 0."""
    jcfg, tcfg, params, tparams, last_h, c0 = setup
    key = jax.random.PRNGKey(7)
    want = np.asarray(jpd.fused_depth_decode(
        jpd.prepare_depth_chain(params, jcfg, plan), jcfg, last_h, c0, key,
        10, 0.75, plan=plan, interpret=True))
    B, ncb, V = want.shape[0], tcfg.audio_num_codebooks, tcfg.audio_vocab_size
    got = tdc.fused_depth_decode(
        tdc.prepare_depth_chain(tparams, tcfg, plan), tcfg, to_t(last_h),
        to_t(c0), _depth_noise(key, B, ncb, V), 10, 0.75, plan=plan)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:, 0], np.asarray(c0))


@pytest.mark.parametrize("plan", ["", "gate=r4,up=s8,down=s8"])
def test_greedy_equals_topk1_and_jax(setup, plan):
    jcfg, tcfg, params, tparams, last_h, c0 = setup
    key = jax.random.PRNGKey(3)
    want = np.asarray(jpd.fused_depth_decode(
        jpd.prepare_depth_chain(params, jcfg, plan), jcfg, last_h, c0, key,
        greedy=True, plan=plan, interpret=True))
    bundle = tdc.prepare_depth_chain(tparams, tcfg, plan)
    noise = _depth_noise(key, 3, tcfg.audio_num_codebooks,
                         tcfg.audio_vocab_size)
    greedy = tdc.fused_depth_decode(bundle, tcfg, to_t(last_h), to_t(c0),
                                    noise, greedy=True, plan=plan)
    top1 = tdc.fused_depth_decode(bundle, tcfg, to_t(last_h), to_t(c0),
                                  noise, 1, 0.75, plan=plan)
    np.testing.assert_array_equal(greedy.numpy(), want)
    np.testing.assert_array_equal(top1.numpy(), want)


@functools.lru_cache(maxsize=None)
def _ablation_tool():
    """tools/_ablate_depth_kernel.py (not a package), loaded by path once."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / \
        "_ablate_depth_kernel.py"
    spec = importlib.util.spec_from_file_location("jax_ablate_depth_kernel", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("plan", [PRESET, "gate=r4,up=s8,down=r4"])
def test_plain_matches_jax_ablation_kernel_unablated(setup, monkeypatch, plan):
    """The JAX ablation copy of the depth kernel (the TPU twin of kernel B's
    FRT_ABL builds) with no ablation, in interpret mode, samples the port's
    plain version's greedy tokens."""
    jcfg, tcfg, params, tparams, last_h, c0 = setup
    abl = _ablation_tool()
    monkeypatch.setattr(abl, "_ABL", set())
    want = np.asarray(abl.fused_depth_decode(
        abl.prepare_depth_chain(params, dataclasses.replace(jcfg, fused_depth_plan=plan),
                                plan),
        jcfg, last_h, c0, jax.random.PRNGKey(0), greedy=True, plan=plan,
        interpret=True))
    got, _ = tdc.fused_depth_decode_plain(
        tdc.prepare_depth_chain(tparams, tcfg, plan), tcfg, to_t(last_h),
        to_t(c0), torch.ones((3, tcfg.audio_num_codebooks, tcfg.audio_vocab_size)),
        greedy=True, plan=plan)
    np.testing.assert_array_equal(got.numpy(), want)


def test_batch_rows_independent_and_forced_tokens(setup):
    """A stream's samples do not depend on the others of its batch; with
    its own samples forced, the chain and its logits are unchanged."""
    _, tcfg, _, tparams, last_h, c0 = setup
    bundle = tdc.prepare_depth_chain(tparams, tcfg, PRESET)
    noise = _depth_noise(jax.random.PRNGKey(9), 3, tcfg.audio_num_codebooks,
                         tcfg.audio_vocab_size)
    full, logits = tdc.fused_depth_decode(bundle, tcfg, to_t(last_h),
                                          to_t(c0), noise, plan=PRESET,
                                          return_logits=True)
    one = tdc.fused_depth_decode(bundle, tcfg, to_t(last_h)[:1], to_t(c0)[:1],
                                 noise[:1], plan=PRESET)
    np.testing.assert_array_equal(full.numpy()[:1], one.numpy())
    forced, flogits = tdc.fused_depth_decode(
        bundle, tcfg, to_t(last_h), to_t(c0), noise, plan=PRESET,
        forced=full, return_logits=True)
    np.testing.assert_array_equal(forced.numpy(), full.numpy())
    assert torch.equal(flogits, logits) and bool((logits[:, 0] == 0).all())


@pytest.mark.parametrize("plan", ["", PRESET])
def test_plain_equals_port_depth_loop_on_quantised_tree(setup, plan):
    """As tests/test_pallas_depth.py holds in JAX: the chain equals the
    port's step-by-step _depth_decode over the bundle's quantised decoder
    tree. (int4 plans are held against the JAX kernel above: the port's
    int4 matmuls take kernel E's bf16 rounding, which the chain's r4 mode
    does not take at float32.)"""
    _, tcfg, _, tparams, last_h, c0 = setup
    bundle = tdc.prepare_depth_chain(tparams, tcfg, plan, with_decoder=True)
    noise = _depth_noise(jax.random.PRNGKey(5), 3, tcfg.audio_num_codebooks,
                         tcfg.audio_vocab_size)
    loop = tmodel._depth_decode(dict(tparams, decoder=bundle["xla_decoder"]),
                                tcfg, to_t(last_h), to_t(c0), noise, 10, 0.75)
    chain = tdc.fused_depth_decode(bundle, tcfg, to_t(last_h), to_t(c0),
                                   noise, 10, 0.75, plan=plan)
    np.testing.assert_array_equal(chain.numpy(), loop.numpy())


def test_lm_generate_frame_routes_through_bundle(setup):
    """lm_generate_frame with the bundle installed samples the JAX frame
    (JAX's draws for its key injected as the noise)."""
    _, _, params, tparams, _, _ = setup
    plan = "gate=r4,up=s8,down=s8"
    jcfg, tcfg = _cfgs(plan)
    jp = jpd.enable_fused_depth(dict(params), jcfg)
    tp = tdc.enable_fused_depth(dict(tparams), tcfg)
    B, S = 2, 8
    ncb, V = tcfg.audio_num_codebooks, tcfg.audio_vocab_size
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(11),
                                           (B, S, tcfg.num_columns), 1, 60))
    tmask, valid = np.ones((B, S, tcfg.num_columns), bool), np.ones((B, S), bool)
    kf = jax.random.PRNGKey(12)
    _, want = jax.jit(jmodel.lm_generate_frame, static_argnums=(1,))(
        jp, jcfg, jmodel.init_lm_state(jcfg, B, jnp.float32),
        jnp.asarray(tokens), jnp.asarray(tmask), jnp.asarray(valid), kf)
    k_c0, k_depth = jax.random.split(kf)
    noise = _depth_noise(k_depth, B, ncb, V)
    noise[:, 0] = to_t(jax.random.exponential(k_c0, (B, V), jnp.float32))
    before = tdc.fused_depth_decode.launches
    _, got = tmodel.lm_generate_frame(
        tp, tcfg, tmodel.init_lm_state(tcfg, B), to_t(tokens), to_t(tmask),
        to_t(valid), noise)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tdc.fused_depth_decode.launches == before      # CPU: plain version


def _preset_engines():
    """A JAX engine with the serving preset (int8 backbone + fused depth
    chain) and a port engine given the same raw parameters, float32, with
    a top-1 depth chain."""
    def cfg(make):
        c = make(depth_topk=1)
        return dataclasses.replace(c, llm=dataclasses.replace(
            c.llm, dtype="float32", quantize_backbone=True,
            fused_depth_plan=PRESET))
    jcfg, tcfg = cfg(j_tiny), cfg(t_tiny)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    jeng = jax_engine(config=jcfg, seed=3)
    teng = TEngine(tcfg, device="cpu",
                   lm_params=from_jax(jax_init(jmodel.init_lm_params, k1,
                                               jcfg.llm)),
                   codec_params=from_jax(jax_init(j_init_codec, k2,
                                                  jcfg.codec)))
    return jeng, teng


def test_engine_preset_matches_jax_engine_and_streams_the_same():
    """The serving preset on both engines (greedy): the port's generate
    gives the JAX engine's audio, and its generate_stream the same frames
    and audio as its generate."""
    jeng, teng = _preset_engines()
    assert "depth_chain" in teng.lm_params
    assert teng.lm_params["backbone"]["wq"].dtype == torch.int8
    want = jeng.generate("Good morning.", "[S1]", [], max_audio_length_ms=480,
                         temperature=1.0, topk=1)
    got = teng.generate("Good morning.", "[S1]", max_audio_length_ms=480,
                        temperature=1.0, topk=1, utt_seed=5)
    assert got.shape == want.shape == (6 * 1920,)
    wave_close(got, want, "preset greedy audio")
    tokens = teng.last_tokens
    stream = np.concatenate(list(teng.generate_stream(
        "Good morning.", "[S1]", max_audio_length_ms=480, temperature=1.0,
        topk=1, utt_seed=5)))
    np.testing.assert_array_equal(teng.last_tokens, tokens)
    wave_close(stream, got, "preset stream vs generate")
