"""PyTorch port, codec training: the straight-through RVQ, the spectral and
semantic losses, the batch acoustic decoder (causal and non-causal), istft,
codec_decode, codec_train_forward and codec_train_step, held against the
JAX package on the CPU (tiny config, float32; each JAX function jitted
once). The codec tree is drawn by the port's initialiser, semantic decoder
included, and handed to JAX as the same arrays: JAX's jitted initialiser
alone would cost ~10 s of this module's compile time. JAX's optimizer runs
on the raveled trainable tree (its update is elementwise, its clip's norm
global), which compiles in a second where the 136-leaf tree takes ~9 s.

Tolerances (fp32 summation order through convs, attention and the DFTs):
codes equal; features, waveforms and spectra within 1e-4 of the
reference's peak; losses within 1e-4 relative; gradients per leaf
|port - JAX| <= 1e-5 + 1e-3 * max |JAX| (the log-mel of a near-silent
random decoder amplifies the order of the sums); 3 steps (the first has
lr 0): every step's loss within 1e-4 relative, so step 3's holds step 2's
update to JAX's, and the parameters after them within 4 lr + 1e-6
absolute, as for the LM. The frozen SSL teacher and mel filterbank:
bitwise unchanged.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.flatten_util import ravel_pytree
import torch

from fireredtts2_tpu.config import tiny_engine_config as j_tiny
from fireredtts2_tpu.models.codec import decoder as jdec
from fireredtts2_tpu.models.codec import model as jcm
from fireredtts2_tpu.ops import stft as jstft
from fireredtts2_tpu.train import codec_losses as jloss
from fireredtts2_tpu.train import codec_step as jcs

from fireredtts2_tpu_torch.config import tiny_engine_config as t_tiny
from fireredtts2_tpu_torch.models.codec import decoder as tdec
from fireredtts2_tpu_torch.models.codec import model as tcm
from fireredtts2_tpu_torch.ops import stft as tstft
from fireredtts2_tpu_torch.train import codec_losses as tloss
from fireredtts2_tpu_torch.train import codec_step as tcs
from fireredtts2_tpu_torch.train.step import tree_leaves, tree_map

from _torch_parity import one_torch_thread, to_t  # noqa: F401

JCFG, TCFG = j_tiny().codec, t_tiny().codec
LR = 1e-3
T16 = 5120                       # 4 tokens at 16 kHz


def peak_close(got, want, rel, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    peak = float(np.abs(want).max())
    assert peak > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * peak, err_msg=what)


def grads_close(got: dict, want: dict, path=""):
    for k, w in want.items():
        if isinstance(w, dict):
            grads_close(got[k], w, f"{path}{k}.")
            continue
        w = np.asarray(w)
        g = got[k].detach().numpy()
        tol = 1e-5 + 1e-3 * float(np.abs(w).max())
        assert np.abs(g - w).max() <= tol, (path + k, np.abs(g - w).max(), tol)


def with_grad(tree):
    return tree_map(lambda p: p.clone().requires_grad_(True), tree)


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def codec():
    """(the codec tree as JAX arrays, the port's) at float32."""
    tc = tcm.init_codec_params(torch.Generator().manual_seed(7), TCFG,
                               semantic_head=True)
    return to_jax(tc), tc


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    audio = (0.1 * rng.standard_normal((2, T16))).astype(np.float32)
    audio[1, 4000:] = 0.0
    lengths = np.array([T16, 4000], np.int32)
    target = (0.1 * rng.standard_normal((2, T16 * 3 // 2))).astype(np.float32)
    return audio, lengths, target


def test_rvq_encode_st_matches_jax(rng, codec):
    """Codes, features and VQ losses; gradients of a weighted sum of the
    features and the losses to z and to the RVQ's leaves."""
    jc, tc = codec
    z = rng.standard_normal((2, 6, JCFG.rvq.input_dim)).astype(np.float32)
    r = rng.standard_normal((2, 6, JCFG.rvq.resolved_output_dim)).astype(np.float32)

    def jf(p, zz):
        out, codes, losses = jloss.rvq_encode_st(p, JCFG.rvq, zz)
        obj = (jnp.sum(out * r) + losses["commit_loss"]
               + 2.0 * losses["codebook_loss"])
        return obj, (out, codes, losses)
    (_, (jo, jcodes, jl)), (jgp, jgz) = jax.jit(
        jax.value_and_grad(jf, argnums=(0, 1), has_aux=True))(
        jc["rvq"], jnp.asarray(z))
    tp, tz = with_grad(tc["rvq"]), to_t(z).requires_grad_(True)
    to, tcodes, tl = tloss.rvq_encode_st(tp, TCFG.rvq, tz)
    obj = (to * to_t(r)).sum() + tl["commit_loss"] + 2.0 * tl["codebook_loss"]
    leaves = tree_leaves(tp)
    g = torch.autograd.grad(obj, leaves + [tz])
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    peak_close(to, jo, 1e-5, "features")
    for k in ("commit_loss", "codebook_loss"):
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]),
                                   rtol=1e-5)
    grads_close({"rvq": dict(zip(tp, g[:-1])), "z": g[-1]},
                {"rvq": jgp, "z": jgz})


def test_spectral_and_semantic_losses_match_jax(rng):
    pred = (0.2 * rng.standard_normal((2, 7680))).astype(np.float32)
    tgt = (0.2 * rng.standard_normal((2, 7680))).astype(np.float32)
    a, b = rng.standard_normal((2, 2, 12, 32)).astype(np.float32)
    lens = np.array([12, 7], np.int32)
    want = jax.jit(lambda p, t, x, y, n: (
        jloss.multiscale_mel_loss(p, t), jloss.waveform_l1(p, t),
        jloss.semantic_distill_loss(x, y, n),
        jloss.semantic_distill_loss(x, y)))(pred, tgt, a, b, lens)
    got = (tloss.multiscale_mel_loss(to_t(pred), to_t(tgt)),
           tloss.waveform_l1(to_t(pred), to_t(tgt[:, :7000])),
           tloss.semantic_distill_loss(to_t(a), to_t(b), to_t(lens)),
           tloss.semantic_distill_loss(to_t(a), to_t(b)))
    w_l1 = float(jloss.waveform_l1(jnp.asarray(pred), jnp.asarray(tgt[:, :7000])))
    for name, g, w in zip(("mel", "l1", "semantic", "semantic unmasked"), got,
                          (want[0], w_l1, want[2], want[3])):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, err_msg=name)


def test_istft_matches_jax(rng):
    re, im = rng.standard_normal((2, 2, 481, 24)).astype(np.float32)
    want = jstft.istft(jnp.asarray(re), jnp.asarray(im), 960, 240)
    got = tstft.istft(to_t(re), to_t(im), 960, 240)
    assert got.shape == (2, 24 * 240)
    peak_close(got, want, 1e-5, "istft")


def test_stft_constants_first_made_in_inference_mode_serve_training(rng):
    """The cached DFT bases and window envelope, first asked for inside
    inference mode (as serving does), still let autograd save them: a
    backward through istft and stft_power afterwards does not raise."""
    re, im = rng.standard_normal((2, 1, 33, 6)).astype(np.float32)
    audio = rng.standard_normal((1, 400)).astype(np.float32)
    with torch.inference_mode():           # n_fft 64: no other test's size
        tstft.istft(to_t(re), to_t(im), 64, 16)
        tstft.stft_power(to_t(audio), 64, 16)
    x = to_t(re).requires_grad_(True)
    a = to_t(audio).requires_grad_(True)
    (tstft.istft(x, to_t(im), 64, 16).sum()
     + tstft.stft_power(a, 64, 16).sum()).backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(a.grad).all()


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_acoustic_decoder_forward_matches_jax(rng, codec, causal):
    """The batch decoder over ragged lengths; the non-causal decoder's
    tree from the port's initialiser at that config, its norms and biases
    perturbed."""
    cfg = dataclasses.replace(JCFG.acoustic_decoder, causal=causal)
    tcfg = dataclasses.replace(TCFG.acoustic_decoder, causal=causal)
    if causal:
        tp = codec[1]["acoustic_decoder"]
    else:
        gen = torch.Generator().manual_seed(4)
        tp = tree_map(lambda a: a + 0.05 * torch.randn(a.shape, generator=gen),
                      tdec.init_acoustic_decoder(gen, tcfg))
        assert "gn1_w" in tp["prior0"]
    x = rng.standard_normal((2, 16, cfg.embed_dim)).astype(np.float32)
    lens = np.array([16, 11], np.int32)
    wa, wl = jax.jit(partial(jdec.acoustic_decoder_forward, cfg=cfg))(
        to_jax(tp), x=jnp.asarray(x), lengths=jnp.asarray(lens))
    ta, tl = tdec.acoustic_decoder_forward(tp, tcfg, to_t(x), to_t(lens))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(wl))
    peak_close(ta, wa, 1e-4, f"decoder causal={causal}")


def test_codec_decode_matches_jax_and_port_streaming(rng, codec):
    """The batch decode of whole utterances against JAX, and against the
    port's own streaming decode (batch == streaming for the causal
    decoder)."""
    jc, tc = codec
    toks = rng.integers(0, JCFG.rvq.codebook_size,
                        (2, JCFG.rvq.num_quantizers, 8)).astype(np.int32)
    want = jax.jit(partial(jcm.codec_decode, cfg=JCFG))(jc, tokens=jnp.asarray(toks))
    got = tcm.codec_decode(tc, TCFG, to_t(toks))
    assert got.shape == (2, 8 * 1920) and not got.requires_grad
    peak_close(got, want, 1e-4, "codec_decode")
    mids, tails = tcm.codec_decode_chunks(tc, TCFG, to_t(toks))
    stream = tcm.assemble_chunks(mids.numpy(), tails.numpy(), 8, 240, 960)
    peak_close(got, stream, 1e-4, "batch vs streaming")


@pytest.fixture(scope="module")
def jax_codec_grad(codec, batch):
    """JAX's codec loss and its gradient over the trainable subtree,
    jitted once: codec_train_step's own value_and_grad."""
    trainable, frozen = jcs.split_codec_params(codec[0])

    @jax.jit
    def vag(tr, audio, lengths, target):
        def loss_fn(t):
            out = jcs.codec_train_forward({**t, **frozen}, JCFG, audio,
                                          lengths, target)
            return out["loss"], out
        return jax.value_and_grad(loss_fn, has_aux=True)(tr)
    return trainable, vag


def test_codec_train_forward_matches_jax(codec, batch, jax_codec_grad):
    trainable, vag = jax_codec_grad
    (_, jout), jg = vag(trainable, *map(jnp.asarray, batch))
    ttr, tfrozen = tcs.split_codec_params(codec[1])
    ttr = with_grad(ttr)
    out = tcs.codec_train_forward({**ttr, **tfrozen}, TCFG, *map(to_t, batch))
    assert set(out) == set(jout)
    for k, v in jout.items():
        np.testing.assert_allclose(float(out[k].detach()), float(v), rtol=1e-4,
                                   err_msg=k)
    names = [("acoustic_decoder", "head_w"), ("acoustic_decoder", "up1_w"),
             ("semantic_decoder", "out_proj_w"), ("rvq", "codebook"),
             ("downsample", "gate_w"), ("acoustic_encoder", "conv1")]
    leaves = [ttr[a][b]["w"] if b == "conv1" else ttr[a][b] for a, b in names]
    g = torch.autograd.grad(out["loss"], leaves)
    for (a, b), gg in zip(names, g):
        want = jg[a][b]["w"] if b == "conv1" else jg[a][b]
        grads_close({b: gg}, {b: want}, a + ".")
    assert all(p.grad is None for p in tree_leaves(tfrozen))


def test_codec_train_steps_match_jax_and_keep_frozen(codec, batch,
                                                     jax_codec_grad):
    """Three steps against JAX's codec_train_step (its value_and_grad
    above, then its optimizer's update); step 3's loss is taken after step
    2's update, the first with lr > 0. The SSL teacher and the mel
    filterbank bitwise unchanged, and outside the optimizer state."""
    trainable, vag = jax_codec_grad
    jopt = jcs.make_codec_optimizer(LR, 1, 10)
    _, unravel = ravel_pytree(trainable)
    ravel, unravel = jax.jit(lambda t: ravel_pytree(t)[0]), jax.jit(unravel)

    @jax.jit
    def jupdate(g, st, p):
        u, st = jopt.update(g, st, p)
        return optax.apply_updates(p, u), st

    jp = ravel(trainable)
    jst = jopt.init(jp)
    jmetrics = []
    for _ in range(3):
        (_, m), g = vag(unravel(jp), *map(jnp.asarray, batch))
        g = ravel(g)
        jmetrics.append((float(m["loss"]), float(jnp.linalg.norm(g))))
        jp, jst = jupdate(g, jst, jp)
    jp = unravel(jp)
    assert jmetrics[2][0] != jmetrics[1][0]

    topt = tcs.make_codec_optimizer(LR, 1, 10)
    assert topt.b2 == 0.95
    state = tcs.init_codec_train_state(codec[1], topt)
    frozen0 = tree_map(torch.clone, state.frozen)
    assert set(state.frozen) == {"ssl", "mel_filters"}
    assert "ssl" not in state.opt_state["mu"]
    for i in range(3):
        state, m = tcs.codec_train_step(state, *map(to_t, batch), cfg=TCFG,
                                        optimizer=topt)
        np.testing.assert_allclose(float(m["loss"]), jmetrics[i][0], rtol=1e-4,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]), jmetrics[i][1],
                                   rtol=1e-3, err_msg=f"step {i}")
    for a, b in zip(tree_leaves(state.frozen), tree_leaves(frozen0)):
        assert torch.equal(a, b)
    moved = tree_map(lambda a, b: float(np.abs(a.detach().numpy()
                                               - np.asarray(b)).max()),
                     state.params, jp)
    assert max(tree_leaves(moved)) <= 4 * LR + 1e-6, moved
