"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
tiny-config parameters from the JAX package's own initialisers, bridged
into the port, the JAX sampling draws of a frame as the port's noise
tensor, and the one-thread fixture every such module imports."""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireredtts2_tpu.config import tiny_engine_config as j_tiny
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
def tiny_params(seed: int = 0):
    """(jax_cfg, port_cfg, jax lm params, jax codec params, port lm params,
    port codec params) at float32, from the JAX initialisers."""
    jcfg, tcfg = j_tiny(), t_tiny()
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    jlm = j_init_lm(k1, jcfg.llm, jnp.float32)
    jcodec = j_init_codec(k2, jcfg.codec, jnp.float32)
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
