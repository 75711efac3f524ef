"""PyTorch port, kernel P (ops/gemv_probe.py, the GEMV probes beside kernel
B) held on the CPU against the JAX package's probe tools:

- its plain version in every mode against a jnp transcription of the TPU
  probes' kernel bodies (jax.lax.dot_general with the probes' dtypes and
  preferred_element_type; the float-math int4 unpack of
  tools/probe_depth_kernel.py:122-129), on random inputs;
- the JAX tools' own functions (tools/probe_depth_kernel.py,
  probe_dequant.py, probe_s8_chunked.py) in Pallas interpret mode, at sizes
  made small by patching their module constants, against the plain version
  on the same all-ones inputs;
- the build variants of ops/cuda_build.py (a library per set of defines).

Tolerances: s8s8 integer sums and quantisation exact; bf16, int8 and int4
products and sums to rtol 1e-5 (fp32 sums in another order), with an
absolute floor of 1e-5 of the largest value for sums that cancel; the bf16
y form to one bf16 ulp (both round an fp32 sum).
"""

import functools
import importlib.util
import pathlib
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from fireredtts2_tpu.ops import pallas_depth as pdp
from fireredtts2_tpu_torch.ops import cuda_build
from fireredtts2_tpu_torch.ops import depth_chain as tdc
from fireredtts2_tpu_torch.ops import gemv_probe as gp

from _torch_parity import one_torch_thread  # noqa: F401  (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _load_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


P1 = _load_tool("probe_depth_kernel")
P3 = _load_tool("probe_dequant")
P4 = _load_tool("probe_s8_chunked")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# The plain version against a transcription of the TPU kernels' bodies
# ---------------------------------------------------------------------------


def _dot(x, w, out=jnp.float32):
    """(M, K) @ (K, O) as the TPU probes write it."""
    return jax.lax.dot_general(x, w, (((1,), (0,)), ((), ())),
                               precision=jax.lax.Precision.DEFAULT,
                               preferred_element_type=out)


def _unpack4_float(p8, s):
    """tools/probe_depth_kernel.py:122-129: halves-packed int4 (K/2, O)
    and (K/g, O) scales -> bf16 (K, O) by float arithmetic."""
    p = p8.astype(jnp.float32)
    hi = jnp.floor(p * 0.0625)
    u = p - 16.0 * hi
    lo = u - 16.0 * (u >= 8.0).astype(jnp.float32)
    wf = jnp.concatenate([lo, hi], axis=0)
    return ((wf.reshape(s.shape[0], -1, wf.shape[1]) * s[:, None, :])
            .reshape(wf.shape)).astype(jnp.bfloat16)


@jax.jit
def _quant_rows(x):
    """The per-row quantisation of tools/probe_s8_chunked.py:105-108, as XLA
    compiles it (the division by 127 becomes a product with 1/127)."""
    xf = x.astype(jnp.float32)
    s = jnp.maximum(jnp.max(jnp.abs(xf), axis=1, keepdims=True), 1e-30) / 127.0
    return jnp.clip(jnp.round(xf / s), -127, 127).astype(jnp.int8), s


@functools.partial(jax.jit, static_argnames=("mode", "which"))
def _transcribe(xs, scs, ws, ss, mode, which):
    """The step's dots, jitted; the s8s8 inputs come quantised (xs int8,
    scs their scales)."""
    ys, ints = [], []
    for w, s, j in zip(ws, ss, which):
        x = xs[j]
        if mode in ("bf16", "int8"):
            y = _dot(x.astype(jnp.bfloat16), w.astype(jnp.bfloat16))
        elif mode == "int4":
            y = _dot(x.astype(jnp.bfloat16), _unpack4_float(w, s))
        else:
            yi = _dot(x, w, jnp.int32)
            ints.append(yi)
            y = yi.astype(jnp.float32) * scs[j]
        ys.append(y)
    return ys, ints


def _transcribed_products(mode, xs, ws, ss, which):
    """Every y of one step in the JAX layout, fp32 (and the int32 sums of
    the s8s8 modes)."""
    scs = ()
    if mode in ("s8s8", "s8s8q"):
        q = [_quant_rows(jnp.asarray(x, jnp.bfloat16)) for x in xs]
        xs, scs = [a for a, _ in q], tuple(b for _, b in q)
    ys, ints = _transcribe(tuple(xs), scs, tuple(ws), tuple(ss), mode,
                           tuple(which))
    return [np.asarray(y) for y in ys], [np.asarray(i) for i in ints]


@pytest.fixture(scope="module")
def random_probe():
    """Random inputs of every mode: three matrices, two of them on input 0
    (K = 256), one on input 1 (K = 128), M in {1, 8, 16}, O up to 512."""
    rng = np.random.default_rng(0)
    out = {}
    shapes = [(256, 512, 0), (256, 96, 0), (128, 160, 1)]
    for M in (1, 8, 16):
        xs = [rng.standard_normal((M, k)).astype(np.float32) for k in (256, 128)]
        xs = [np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
              for x in xs]
        for mode in gp.MODES:
            ws, ss = [], []
            for K, O, _ in shapes:
                if mode == "bf16":
                    w = np.asarray(jnp.asarray(rng.standard_normal((K, O)),
                                               jnp.bfloat16).astype(jnp.float32))
                    s = None
                elif mode == "int4":
                    w = rng.integers(-128, 128, (K // 2, O)).astype(np.int8)
                    s = (rng.random((K // 128, O)) * 0.02).astype(np.float32)
                else:
                    w = rng.integers(-127, 128, (K, O)).astype(np.int8)
                    s = None
                ws.append(w)
                ss.append(s)
            out[(mode, M)] = (xs, ws, ss, [j for *_, j in shapes])
    return out


def _port_probe(mode, xs, ws, ss, which):
    """The same probe for the port: output-major weights, bf16 inputs."""
    wdt = torch.bfloat16 if mode == "bf16" else torch.int8
    mats = [gp.Mat(_t(w).T.contiguous().to(wdt),
                   None if s is None else _t(s).T.contiguous(), j)
            for w, s, j in zip(ws, ss, which)]
    return mats, [_t(x).to(torch.bfloat16) for x in xs]


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("mode", gp.MODES)
def test_plain_matches_transcribed_tpu_body(random_probe, mode, M):
    """Products, y form and the sum over 3 steps of the port's plain
    version against the TPU probes' arithmetic."""
    xs, ws, ss, which = random_probe[(mode, M)]
    want, ints = _transcribed_products(mode, xs, ws, ss, which)
    mats, txs = _port_probe(mode, xs, ws, ss, which)
    got = gp.probe_products(mats, txs, mode)
    if mode in ("s8s8", "s8s8q"):
        for x in txs:                       # the same quantisation, exactly
            q, sc = gp.quantize_rows(x)
            wq, wsc = _quant_rows(jnp.asarray(x.float().numpy(), jnp.bfloat16))
            np.testing.assert_array_equal(q.numpy(), np.asarray(wq, np.float64))
            np.testing.assert_array_equal(sc.numpy(), np.asarray(wsc))
        for m, yi in zip(mats, ints):          # the integer sums, exactly
            q = gp.quantize_rows(txs[m.x])[0]
            np.testing.assert_array_equal(
                (q @ m.w.to(torch.float64).T).numpy(), yi.astype(np.float64))
        for g, w in zip(got, want):            # int32 -> fp32 times the scale
            np.testing.assert_array_equal(g.numpy(), w)
    else:
        for g, w in zip(got, want):
            _close(g.numpy(), w)
    y = gp.gemv_probe(mats, txs, mode, form="y")
    assert y.dtype == torch.bfloat16 and y.shape == (M, 512 + 96 + 160)
    # one bf16 ulp (2^-7 relative at most): both round fp32 sums to bf16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(
        jnp.asarray(np.concatenate(want, axis=1), jnp.bfloat16).astype(jnp.float32)),
        rtol=2 ** -7, atol=1e-5)
    acc = np.zeros((M, 1), np.float32)
    for _ in range(3):                       # the TPU probes' fori_loop
        acc = acc + sum(np.asarray(jnp.sum(jnp.asarray(w), axis=1, keepdims=True))
                        for w in want)
    _close(gp.gemv_probe(mats, txs, mode, steps=3).numpy(), acc)


@pytest.mark.parametrize("port_quantiser", [gp.quantize_rows, tdc._quant_act],
                         ids=["gemv_probe", "depth_chain"])
def test_activation_quantiser_matches_jax_as_compiled(port_quantiser):
    """The port's a8 activation quantisers against the TPU kernel's
    (pallas_depth.py:_quant_act) jitted and inside a pallas_call in
    interpret mode, on rows where max / 127 and max * fp32(1/127) differ:
    both JAX runs multiply by the reciprocal, and so does the port."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((256, 384)) * rng.uniform(0.01, 10, (256, 1))
         ).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    m = np.maximum(np.abs(np.asarray(xb, np.float32)).max(-1, keepdims=True),
                   np.float32(1e-30))
    div, rec = m / np.float32(127), m * (np.float32(1) / np.float32(127))
    assert (div != rec).sum() >= 5                    # the inputs tell them apart

    def kernel(x_ref, q_ref, s_ref):
        q_ref[...], s_ref[...] = pdp._quant_act(x_ref[...])
    interp = pl.pallas_call(kernel, interpret=True, out_shape=(
        jax.ShapeDtypeStruct(x.shape, jnp.int8),
        jax.ShapeDtypeStruct((x.shape[0], 1), jnp.float32)))
    q, sc = port_quantiser(_t(np.asarray(xb, np.float32)).to(torch.bfloat16))
    np.testing.assert_array_equal(sc.numpy(), rec)
    for jq, js in (jax.jit(pdp._quant_act)(xb), jax.jit(interp)(xb)):
        np.testing.assert_array_equal(np.asarray(js), rec)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq, np.float64))


# ---------------------------------------------------------------------------
# The JAX tools' own functions in interpret mode
# ---------------------------------------------------------------------------


class _InterpretPallas:
    """The tools' `pl` with every pallas_call in interpret mode."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kw):
        return pl.pallas_call(*args, interpret=True, **kw)


@pytest.fixture
def jax_tool(monkeypatch):
    """patch(module, **constants) -> the outputs its calls of _time see."""
    def patch(mod, **consts):
        seen = []

        def capture(fn, *args):
            seen.append(np.asarray(fn(*args)))
            return 1.0
        monkeypatch.setattr(mod, "pl", _InterpretPallas())
        monkeypatch.setattr(mod, "_time", capture)
        for k, v in consts.items():
            monkeypatch.setattr(mod, k, v)
        return seen
    return patch


def _ones_mat(mode, O, K, x=0, group=128):
    if mode == "int4":
        return gp.Mat(torch.ones((O, K // 2), dtype=torch.int8),
                      torch.ones((O, K // group)), x)
    dt = torch.bfloat16 if mode == "bf16" else torch.int8
    return gp.Mat(torch.ones((O, K), dtype=dt), None, x)


def _ones_x(M, K):
    return torch.ones((M, K), dtype=torch.bfloat16)


# probe_vmem_capacity is held by the transcription alone: its sizes (32 to
# 120 MB) are literals inside the function, too large for interpret mode.
@pytest.mark.parametrize("probe,mode,mb,kw", [
    ("probe_int8_reuse", "int8", Fraction(3, 1024), {}),         # O = 2
    ("probe_int4_reuse", "int4", Fraction(3, 2048), {}),         # O = 2
    ("probe_streamed_int8", "int8", Fraction(3, 512),            # O = 4,
     {"chunk_mb": Fraction(3, 1024)}),                           # 2 chunks
])
def test_probe_depth_kernel_interpret_matches_plain(jax_tool, probe, mode, mb, kw):
    seen = jax_tool(P1, STEPS=2)
    getattr(P1, probe)(mb, **kw)
    per_col = 768 if mode == "int4" else 1536
    O = int(mb * (1 << 20)) // per_col
    want = gp.gemv_probe_plain([_ones_mat(mode, O, 1536)], [_ones_x(8, 1536)],
                               mode, steps=2)
    assert len(seen) == 1
    _close(seen[0], want.numpy())


@pytest.mark.parametrize("probe,mode", [("probe_bf16_reuse", "bf16"),
                                        ("probe_int8_reuse", "int8"),
                                        ("probe_s8s8_reuse", "s8s8")])
def test_probe_dequant_interpret_matches_plain(jax_tool, probe, mode):
    """1 MB of int8-equivalent weights as 2 output columns of D = 2^19 (the
    tool prints its size as an integer), 2 steps. The JAX s8s8 probe feeds
    int8 ones unscaled; the port quantises bf16 ones (q = 127, scale
    1/127)."""
    D = 1 << 19
    seen = jax_tool(P3, STEPS=2, D=D)
    getattr(P3, probe)(1)
    want = gp.gemv_probe_plain([_ones_mat(mode, 2, D)], [_ones_x(8, D)],
                               mode, steps=2)
    assert len(seen) == 1
    _close(seen[0], want.numpy())


# probe_step (P4b) runs pltpu.repeat, which interpret mode does not lower;
# its counterpart on the card is kernel B's ablation builds, held against
# the JAX ablation kernel in tests/test_torch_depth_chain.py.
def test_probe_s8_chunked_interpret_matches_plain(jax_tool):
    """Kernel B's MLP schedule at D = 64, halves (32, 16), 2 layers, 2
    steps, every mode, M = 8."""
    seen = jax_tool(P4, D=64, SPLITS=(32, 16), LAYERS=2, REPS=2)
    xs = [_ones_x(8, 64)] + [_ones_x(8, w) for w in (32, 16)]
    for mode in ("bf16", "int8", "s8s8", "s8s8q"):
        P4.probe(mode, 8)
        layer = []
        for i, w in enumerate((32, 16)):
            wm = "bf16" if mode == "bf16" else "int8"
            layer += [_ones_mat(wm, w, 64), _ones_mat(wm, w, 64),
                      _ones_mat(wm, 64, w, x=i + 1)]
        want = gp.gemv_probe_plain(layer * 2, xs, mode, steps=2)
        _close(seen[-1], want.numpy())
    assert len(seen) == 4


# ---------------------------------------------------------------------------
# Build variants
# ---------------------------------------------------------------------------


def test_build_variants_get_their_own_library():
    """A library per set of defines, the same one without defines; the
    defines are in the library's name."""
    base = cuda_build._lib_path("fused_depth_decode")
    assert base == cuda_build._lib_path("fused_depth_decode", ())
    variants = {cuda_build._lib_path("fused_depth_decode", (f"FRT_ABL={b}",))
                for b in (0, 1, 2, 4, 8, 16, 32)}
    assert len(variants) == 7 and base not in variants
    assert all("FRT_ABL" in p.name for p in variants)
    assert cuda_build.label("gemv_probe") == "gemv_probe"
    assert cuda_build.label("x", ("A=1",)) == "x[A=1]"
