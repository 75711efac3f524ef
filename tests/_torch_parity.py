"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
tiny-config parameters from the JAX package's own initialisers, bridged
into the port, a JAX engine built on those initialisers jitted, the JAX
sampling draws of a frame as the port's noise tensor, a prompt-like test
waveform, and the one-thread fixture every such module imports.

The JAX initialisers run jitted (``jax_init``): one compile per config
and dtype for the process, where running them op by op compiles each op
at each new shape (~23 s for the tiny LM and codec on this suite's CPU,
against ~12 s). The values are the initialisers' own, as XLA compiles
them as one program; both sides of a parity test take the same tree."""

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireredtts2_tpu.config import tiny_engine_config as j_tiny
from fireredtts2_tpu.engine import engine as j_engine
from fireredtts2_tpu.models.codec.model import init_codec_params as j_init_codec
from fireredtts2_tpu.models.lm.model import init_lm_params as j_init_lm

from fireredtts2_tpu_torch.config import tiny_engine_config as t_tiny
from fireredtts2_tpu_torch.weights import from_jax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the module's tests with PyTorch on one CPU thread: the tiny
    shapes gain nothing from more, and the suite's parallel workers share
    the machine's cores (each worker's default of one thread per core
    oversubscribes them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@lru_cache(maxsize=None)
def _jitted_init(fn, cfg, dtype):
    return jax.jit(lambda key: fn(key, cfg, dtype))


# Config fields the JAX initialisers do not read (serving, decode and
# training knobs; the dtype comes as an argument): configs that differ only
# in them share one compiled initialiser.
_INIT_IGNORES = ("quantize_backbone", "quantize_depth", "quantize_depth_bits",
                 "fused_depth_plan", "quantize_vocoder", "max_seq_len",
                 "max_batch_size", "dtype", "train_remat")


def _init_cfg(cfg):
    return dataclasses.replace(cfg, **{
        f.name: f.default for f in dataclasses.fields(cfg)
        if f.name in _INIT_IGNORES})


def jax_init(fn, key, cfg, dtype=jnp.float32):
    """fn(key, cfg, dtype) for a JAX initialiser fn (init_lm_params,
    init_codec_params), jitted once per (fn, the cfg's shape fields,
    dtype)."""
    return _jitted_init(fn, _init_cfg(cfg), dtype)(key)


def jax_engine(**kw):
    """The JAX package's FireRedTTS2Engine(**kw), its parameter
    initialisers run through ``jax_init``."""
    with pytest.MonkeyPatch.context() as mp:
        for name, fn in (("init_lm_params", j_init_lm),
                         ("init_codec_params", j_init_codec)):
            mp.setattr(j_engine, name,
                       lambda key, cfg, dtype, fn=fn: jax_init(fn, key, cfg, dtype))
        return j_engine.FireRedTTS2Engine(**kw)


@lru_cache(maxsize=None)
def tiny_params(seed: int = 0):
    """(jax_cfg, port_cfg, jax lm params, jax codec params, port lm params,
    port codec params) at float32, from the JAX initialisers."""
    jcfg, tcfg = j_tiny(), t_tiny()
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    jlm = jax_init(j_init_lm, k1, jcfg.llm)
    jcodec = jax_init(j_init_codec, k2, jcfg.codec)
    return jcfg, tcfg, jlm, jcodec, from_jax(jlm), from_jax(jcodec)


def jax_frame_noise(key, t: int, B: int, ncb: int, V: int) -> torch.Tensor:
    """The Exp(1) draws JAX's lm_generate_frame makes for frame t of an
    utterance key (fold_in(key, t), then codebook 0 from the first split
    and codebook i from fold_in(second split, i)) as (B, ncb, V)."""
    k_c0, k_depth = jax.random.split(jax.random.fold_in(key, t))
    rows = [jax.random.exponential(k_c0, (B, V), jnp.float32)]
    rows += [jax.random.exponential(jax.random.fold_in(k_depth, i), (B, V),
                                    jnp.float32) for i in range(1, ncb)]
    return to_t(np.stack([np.asarray(r) for r in rows], axis=1))


def wave_close(got, want, what=""):
    """Waveforms equal to 1e-4 of the reference's peak (fp32 summation
    order through the conv, attention and iSTFT stages)."""
    got, want = np.asarray(got), np.asarray(want)
    peak = float(np.abs(want).max())
    assert peak > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * peak,
                               err_msg=what)


def voiced(n: int, seed: int, sr: int = 16_000) -> np.ndarray:
    """A voiced-like test signal: a few harmonics of a gliding pitch, an
    amplitude envelope and a little noise, float32 in [-1, 1]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f0 = 120 + 40 * np.sin(2 * np.pi * 0.7 * t) + rng.uniform(0, 60)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(k * phase) / k for k in range(1, 6))
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * 2.5 * t) ** 2
    x += 0.02 * rng.standard_normal(n)
    return (0.3 * x / np.abs(x).max()).astype(np.float32)
