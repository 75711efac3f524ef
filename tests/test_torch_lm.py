"""PyTorch port, LM: the transformer and the generation loop held against
the JAX package on the CPU at float32, with parameters from the JAX
initialisers bridged by weights.from_jax.

Tolerances: hidden states 1e-5 absolute (fp32 summation order only);
greedy tokens exact; sampled tokens exact with JAX's fold_in draws injected
as the port's noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireredtts2_tpu.config import TransformerConfig as JTC
from fireredtts2_tpu.models.lm import model as jmodel
from fireredtts2_tpu.models.lm import transformer as jtr
from fireredtts2_tpu.ops.masks import decode_step_mask as j_step_mask

from fireredtts2_tpu_torch.config import TransformerConfig as TTC
from fireredtts2_tpu_torch.models.lm import model as tmodel
from fireredtts2_tpu_torch.models.lm import transformer as ttr
from fireredtts2_tpu_torch.ops import flash_decode as tfd
from fireredtts2_tpu_torch.weights import from_jax

from _torch_parity import jax_frame_noise, one_torch_thread, tiny_params, to_t  # noqa: F401


def test_transformer_prefill_then_decode_matches_jax(rng, monkeypatch):
    """A left-padded S=24 prefill (dense masked path) and four S=1 decode
    steps (kernel A's plain version vs the Pallas kernel in interpret mode)
    through a 3-layer GQA stack with per-stream positions."""
    monkeypatch.setenv("FRTTS2_FLASH_LM", "interpret")
    kw = dict(vocab_size=64, num_layers=3, num_heads=4, num_kv_heads=2,
              embed_dim=64, intermediate_dim=128, max_seq_len=512)
    jc, tc = JTC(**kw), TTC(**kw)
    B, S, T = 2, 24, 512
    jp = jtr.init_transformer_params(jax.random.PRNGKey(3), jc, jnp.float32)
    tp = from_jax(jp)
    jcache = jtr.init_kv_cache(jc, B, T, jnp.float32)
    tcache = ttr.init_kv_cache(tc, B, T)
    start = np.array([0, 9], np.int32)            # stream 1 left-padded
    valid = np.arange(T)[None] >= start[:, None]

    h = rng.standard_normal((B, S, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    mask = (np.arange(T)[None, None] <= pos[:, :, None]) & valid[:, None]
    jo, jcache = jtr.transformer_forward(
        jp, jc, jnp.asarray(h), jnp.asarray(pos), jnp.asarray(mask), jcache,
        jnp.zeros((B,), jnp.int32))
    to, _ = ttr.transformer_forward(tp, tc, to_t(h), to_t(pos), to_t(mask),
                                    tcache, torch.zeros((B,), dtype=torch.int32))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)

    p = np.full((B,), S, np.int32)
    for step in range(4):
        h = rng.standard_normal((B, 1, 64)).astype(np.float32)
        positions = p[:, None]
        mask = (np.arange(T)[None, None] <= positions[:, :, None]) & valid[:, None]
        jo, jcache = jtr.transformer_forward(
            jp, jc, jnp.asarray(h), jnp.asarray(positions), jnp.asarray(mask),
            jcache, jnp.asarray(p),
            live_window=(jnp.asarray(start), jnp.asarray(p + 1)))
        to, _ = ttr.transformer_forward(
            tp, tc, to_t(h), to_t(positions), None, tcache, to_t(p),
            live_window=(to_t(start), to_t(p + 1)))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                                   atol=1e-5, err_msg=f"decode step {step}")
        p = p + 1
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=0, atol=1e-5)
    assert tfd.flash_decode_gqa1.launches == 0     # CPU: plain version


def _prompt(cfg, B, bucket, rng, lengths):
    ncols = cfg.llm.num_columns
    tokens = np.zeros((B, bucket, ncols), np.int32)
    mask = np.zeros((B, bucket, ncols), bool)
    valid = np.zeros((B, bucket), bool)
    for b, L in enumerate(lengths):
        tokens[b, bucket - L:, -1] = rng.integers(1, 256, L)
        mask[b, bucket - L:, -1] = True
        valid[b, bucket - L:] = True
    return tokens, mask, valid


@pytest.mark.parametrize("sampled", [False, True])
def test_lm_generate_loop_matches_jax(rng, sampled):
    """Greedy (top-1 at both levels): the same frames with no noise shared.
    Sampled (caller and depth top-k): the same frames when the port gets
    JAX's fold_in(key, t) draws as its noise."""
    jcfg, tcfg, jlm, _, tlm, _ = tiny_params()
    B, bucket, max_frames, cap = 2, 32, 12, 12
    tokens, mask, valid = _prompt(jcfg, B, bucket, rng, [20, 32])
    key = jax.random.PRNGKey(11)
    samp = (dict(temperature=0.9, topk=20, depth_topk=10, depth_temperature=0.75)
            if sampled else
            dict(temperature=1.0, topk=1, depth_topk=1, depth_temperature=0.75))
    jstate = jmodel.init_lm_state(jcfg.llm, B, jnp.float32)
    _, jbuf, jn = jmodel.lm_generate_loop(
        jlm, jcfg.llm, jstate, jnp.asarray(tokens), jnp.asarray(mask),
        jnp.asarray(valid), key, max_frames, jnp.int32(cap), **samp)

    ncb, V = tcfg.llm.audio_num_codebooks, tcfg.llm.audio_vocab_size
    if sampled:
        def noise_fn(t):
            return jax_frame_noise(key, t, B, ncb, V)
    else:   # top-1 ignores the noise: any Exp(1) draws will do
        gen = torch.Generator().manual_seed(0)

        def noise_fn(t):
            return torch.empty((B, ncb, V)).exponential_(generator=gen)
    tstate = tmodel.init_lm_state(tcfg.llm, B)
    _, tbuf, tn = tmodel.lm_generate_loop(
        tlm, tcfg.llm, tstate, to_t(tokens), to_t(mask), to_t(valid), noise_fn,
        max_frames, cap, **samp)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    assert int(tn.min()) > 0
