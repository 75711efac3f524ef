"""Kernel P: the weight-streaming GEMV probes beside kernel B.

Counterpart of the Pallas kernels of the JAX package's probe tools
(``tools/probe_depth_kernel.py``, ``tools/probe_dequant.py``,
``tools/probe_s8_chunked.py``). They time, at kernel B's shapes, what one
weight costs per use: in which storage mode, resident or streamed, with or
without a barrier between matrices. The probe tools of this package
(``fireredtts2_tpu_torch/tools/``) call it; the engine never does.

A probe is a list of matrices W_i, each stored output-major (O_i, K_i)
(int4: (O_i, K_i/2) halves-packed bytes with (O_i, K_i/g) fp32 scales), each
against one of the inputs x_j (M, K_i) bf16, and S steps. Every step
computes y_i = x_i @ deq(W_i)^T in fp32. The call returns y of one step,
(M, sum O_i) bf16 (``form="y"``), or the fp32 sum over steps, matrices and
outputs, (M, 1) (``form="sum"``), as the TPU probes accumulate it.

Modes: ``bf16``; ``int8`` (converted to float per use, no scale, as the
TPU probes' astype); ``int4`` (q * scale rounded to bf16, kernel E's and
kernel B's unpack); ``s8s8`` (each input quantised per row once a step,
scale = max(|x|, 1e-30) * fp32(1/127) (the JAX quantiser as XLA compiles
it), q = clip(round-half-even(x / scale), -127, 127), int32 dot products,
times the scale) and ``s8s8q`` (the same, re-quantised at every group of
``qgroup`` matrices; the same numbers).

``gemv_probe`` runs the CUDA kernel (``csrc/gemv_probe.cu``) on CUDA
tensors and ``gemv_probe_plain`` on CPU tensors; it never falls back on the
card. ``ProbeCall`` checks and packs a probe once, so that timed launches
repeat no host work.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from fireredtts2_tpu_torch.ops import cuda_build
from fireredtts2_tpu_torch.ops.int4 import unpack_int4
from fireredtts2_tpu_torch.ops.quant import INV127

MODES = ("bf16", "int8", "int4", "s8s8", "s8s8q")
LOADS = ("direct", "staged")
SYNCS = ("none", "matrix", "step")
_STATIC_SMEM = 4096            # the kernel's static shared memory, rounded up


class Mat(NamedTuple):
    """One matrix of a probe: output-major weights, int4 scales (else
    None), and the index of its input."""
    w: torch.Tensor
    scales: torch.Tensor | None
    x: int


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of x (M, K): (q as float64 integers, exact in
    a float64 product; (M, 1) fp32 scales)."""
    xf = x.to(torch.float32)
    m = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-30)
    sc = m * INV127
    return torch.clamp(torch.round(xf / sc), -127, 127).to(torch.float64), sc


def probe_products(mats: list[Mat], xs: list[torch.Tensor], mode: str
                   ) -> list[torch.Tensor]:
    """Every y_i = x_i @ deq(W_i)^T of one step, fp32 (M, O_i)."""
    if mode not in MODES:
        raise ValueError(f"gemv_probe: mode {mode!r} not in {MODES}")
    out = []
    for m in mats:
        x = xs[m.x]
        if mode in ("s8s8", "s8s8q"):
            q, sc = quantize_rows(x)
            y = (q @ m.w.to(torch.float64).T).to(torch.float32) * sc
        else:
            w = (unpack_int4(m.w, m.scales, axis=-1).to(torch.bfloat16)
                 if mode == "int4" else m.w)
            y = x.to(torch.float32) @ w.to(torch.float32).T
        out.append(y)
    return out


def gemv_probe_plain(mats: list[Mat], xs: list[torch.Tensor], mode: str,
                     steps: int = 1, form: str = "sum") -> torch.Tensor:
    """Kernel P's plain version: y (M, sum O_i) bf16, or the fp32 sum over
    steps, matrices and outputs, (M, 1), every step computed anew as the
    TPU probes' loops do."""
    if form == "y":
        return torch.cat(probe_products(mats, xs, mode), dim=1).to(torch.bfloat16)
    M = xs[0].shape[0] if xs else 1
    dev = xs[0].device if xs else torch.device("cpu")
    acc = torch.zeros((M, 1), dtype=torch.float32, device=dev)
    for _ in range(steps):
        for y in probe_products(mats, xs, mode):
            acc = acc + y.sum(dim=1, keepdim=True)
    return acc


def weight_bytes(mats: list[Mat]) -> int:
    """Bytes of the probe's weights (with int4 scales), counted once."""
    seen, n = set(), 0
    for m in mats:
        for t in (m.w, m.scales):
            if t is not None and t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                n += t.numel() * t.element_size()
    return n


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

_PTRS = ("mats", "xs", "out_sum", "out_y", "bar")
_INTS = ("nmat", "nx", "ytot", "M", "steps", "mode", "sync", "staged",
         "xs_bytes", "qgroup")
_barriers: dict = {}


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("gemv_probe")
    if lib.frt_gemv_probe.argtypes is None:
        n_p, n_i = ctypes.c_int(), ctypes.c_int()
        lib.frt_gemv_probe_counts(ctypes.byref(n_p), ctypes.byref(n_i))
        if (n_p.value, n_i.value) != (len(_PTRS), len(_INTS)):
            raise RuntimeError(f"gemv_probe.cu takes {n_p.value} pointers and "
                               f"{n_i.value} ints, the wrapper passes "
                               f"{len(_PTRS)} and {len(_INTS)}")
        lib.frt_gemv_probe_smem_optin.argtypes = []
        lib.frt_gemv_probe_smem_optin.restype = ctypes.c_int
        lib.frt_gemv_probe_smem.argtypes = [ctypes.c_int] * 3
        lib.frt_gemv_probe_smem.restype = ctypes.c_int
        lib.frt_gemv_probe_grid.argtypes = [ctypes.c_int] * 4
        lib.frt_gemv_probe_grid.restype = ctypes.c_int
        lib.frt_gemv_probe.argtypes = [ctypes.c_void_p] * 3
        lib.frt_gemv_probe.restype = ctypes.c_int
    return lib


def smem_optin() -> int:
    """Shared memory the card lets one block opt in to, in bytes."""
    v = _lib().frt_gemv_probe_smem_optin()
    if v < 0:
        raise RuntimeError("cudaDevAttrMaxSharedMemoryPerBlockOptin query failed")
    return v


def grid_blocks(M: int = 8, mode: str = "int8", load: str = "direct",
                xs_bytes: int = 0) -> int:
    """Blocks of the kernel's cooperative grid, with `xs_bytes` of inputs
    staged in shared memory (``ProbeCall.xs_bytes``)."""
    lib = _lib()
    staged = int(load == "staged")
    smem = lib.frt_gemv_probe_smem(M, staged, xs_bytes)
    g = lib.frt_gemv_probe_grid(M, MODES.index(mode), staged, smem)
    if g < 0:
        raise RuntimeError(f"gemv_probe grid query failed: CUDA error {-g}")
    return g


def _barrier(dev: torch.device) -> torch.Tensor:
    """The grid-barrier words on `dev`, zero once; each launch leaves them
    ready for the next (launches on one stream)."""
    key = (dev.type, dev.index)
    if key not in _barriers:
        _barriers[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return _barriers[key]


class ProbeCall:
    """One probe, checked and packed for the kernel: ``launch()`` enqueues
    it and returns its output (zeroed first for the sum form, unless
    ``zero=False``)."""

    def __init__(self, mats: list[Mat], xs: list[torch.Tensor], mode: str,
                 steps: int = 1, form: str = "sum", sync: str = "none",
                 load: str = "direct", qgroup: int = 0):
        if mode not in MODES or load not in LOADS or sync not in SYNCS \
                or form not in ("sum", "y"):
            raise ValueError(f"gemv_probe: mode {mode!r}, load {load!r}, sync "
                             f"{sync!r}, form {form!r}: expected {MODES}, "
                             f"{LOADS}, {SYNCS}, ('sum', 'y')")
        dev = xs[0].device if xs else torch.device("cuda", torch.cuda.current_device())
        if dev.type != "cuda":
            raise ValueError(f"gemv_probe: unsupported device {dev}")
        M = xs[0].shape[0] if xs else 1
        if not 1 <= M <= 32 or steps < 0:
            raise ValueError(f"gemv_probe: M = {M} (1..32), steps = {steps}")
        s8 = mode in ("s8s8", "s8s8q")
        wdt = torch.bfloat16 if mode == "bf16" else torch.int8
        xs_bytes, offs = 0, []
        for x in xs:
            if (x.device != dev or x.dtype != torch.bfloat16 or x.ndim != 2
                    or x.shape[0] != M or x.shape[1] % 32 or not x.is_contiguous()):
                raise ValueError(f"gemv_probe: input {x.dtype} {tuple(x.shape)} on "
                                 f"{x.device}, expected contiguous bf16 (M={M}, "
                                 f"K % 32 == 0) on {dev}")
            offs.append(xs_bytes)
            xs_bytes += -(-M * x.shape[1] * (1 if s8 else 2) // 16) * 16
        rows, ytot = [], 0
        for m in mats:
            K = xs[m.x].shape[1]
            O = m.w.shape[0]
            kw = K // 2 if mode == "int4" else K
            if (m.w.device != dev or m.w.dtype != wdt or tuple(m.w.shape) != (O, kw)
                    or not m.w.is_contiguous()):
                raise ValueError(f"gemv_probe: weights {m.w.dtype} {tuple(m.w.shape)} "
                                 f"on {m.w.device}, expected contiguous {wdt} "
                                 f"({O}, {kw}) on {dev}")
            g = 0
            if mode == "int4":
                s = m.scales
                if (s is None or s.device != dev or s.dtype != torch.float32
                        or s.ndim != 2 or s.shape[0] != O or K % s.shape[1]
                        or (K // s.shape[1]) % 16 or not s.is_contiguous()):
                    raise ValueError("gemv_probe: int4 scales must be contiguous fp32 "
                                     "(O, K/g) on the card with g % 16 == 0")
                g = K // s.shape[1]
            if s8 and K * 127 * 127 >= 2 ** 31:
                raise ValueError(f"gemv_probe: K = {K} overflows the int32 sums")
            rows.append([m.w.data_ptr(), m.scales.data_ptr() if g else 0, m.x,
                         O, K, g, ytot, 0])
            ytot += O
        lib = _lib()
        budget = smem_optin() - _STATIC_SMEM
        ring = lib.frt_gemv_probe_smem(M, int(load == "staged"), 0)
        self.x_staged = bool(xs) and xs_bytes + ring <= budget
        if s8 and not self.x_staged:
            raise ValueError(f"gemv_probe: the s8s8 modes quantise their inputs in "
                             f"shared memory: {xs_bytes} + {ring} bytes exceed "
                             f"{budget}")
        self.xs_bytes = xs_bytes if self.x_staged else 0
        self.grid = grid_blocks(M, mode, load, self.xs_bytes)
        self.dev, self.M, self.form = dev, M, form
        self._keep = (list(mats), list(xs))
        self.mats = torch.tensor(rows or [[0] * 8], dtype=torch.int64, device=dev)
        self.xtab = torch.tensor([[x.data_ptr(), x.shape[1], o, 0]
                                  for x, o in zip(xs, offs)] or [[0] * 4],
                                 dtype=torch.int64, device=dev)
        self.out = (torch.zeros((M, 1), dtype=torch.float32, device=dev)
                    if form == "sum" else
                    torch.empty((M, ytot), dtype=torch.bfloat16, device=dev))
        t = dict(mats=self.mats, xs=self.xtab, bar=_barrier(dev),
                 out_sum=self.out if form == "sum" else None,
                 out_y=self.out if form == "y" else None)
        ints = dict(nmat=len(mats), nx=len(xs), ytot=ytot, M=M, steps=steps,
                    mode=MODES.index(mode), sync=SYNCS.index(sync),
                    staged=int(load == "staged"),
                    xs_bytes=self.xs_bytes, qgroup=qgroup)
        self._ptrs = (ctypes.c_void_p * len(_PTRS))(
            *[0 if t[n] is None else t[n].data_ptr() for n in _PTRS])
        self._ints = (ctypes.c_int * len(_INTS))(*[ints[n] for n in _INTS])
        self._lib = lib

    def launch(self, zero: bool = True) -> torch.Tensor:
        if zero and self.form == "sum":
            self.out.zero_()
        err = self._lib.frt_gemv_probe(
            ctypes.cast(self._ptrs, ctypes.c_void_p),
            ctypes.cast(self._ints, ctypes.c_void_p),
            torch.cuda.current_stream(self.dev).cuda_stream)
        if err:
            raise RuntimeError(f"gemv_probe launch failed: CUDA error {err}")
        gemv_probe.launches += 1
        return self.out


def gemv_probe(mats: list[Mat], xs: list[torch.Tensor], mode: str,
               steps: int = 1, form: str = "sum", sync: str = "none",
               load: str = "direct", qgroup: int = 0) -> torch.Tensor:
    """Run one probe (see the module's docstring): the kernel on CUDA
    tensors, the plain version on CPU tensors (where `sync`, `load` and
    `qgroup` change nothing)."""
    if xs and xs[0].device.type == "cpu":
        return gemv_probe_plain(mats, xs, mode, steps, form)
    return ProbeCall(mats, xs, mode, steps, form, sync, load, qgroup).launch()


gemv_probe.launches = 0
