"""Int4 weight-only matmul: kernel E.

Counterpart of ``fireredtts2_tpu/ops/pallas_int4.py: int4_matmul``. The
weights are halves-packed int4 (packed row i holds input row i in its low
nibble and row i + I/2 in its high nibble, sign-extended) with group-wise
scales ``(I/g, O)``, as ``models/lm/transformer.py:
quantize_transformer_int4`` makes them. Numerics are the TPU kernel's: the
weights dequantise as q * scale in fp32 and round to bf16, x rounds to
bf16, products sum in fp32, the output is in x's dtype.

The CUDA kernel (``csrc/int4_matmul.cu``) reads the weights output-major,
``(O, I/2)`` bytes and ``(O, I/g)`` fp32 scales: 16 contiguous bytes of
one output column are 16 packed rows, which it turns into the B fragments
of bf16 ``mma.sync`` tiles (x's rows are the A rows) at every M.
``output_major_int4`` makes that layout; ``prepare_int4_layout`` adds it to
a quantised tree once, so that the matmuls do not transpose per call. The
public function keeps the JAX layout.

On CPU tensors the wrapper runs the plain version; on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from fireredtts2_tpu_torch.ops import cuda_build

_P, _I = ctypes.c_void_p, ctypes.c_int


def unpack_int4(packed: torch.Tensor, scales: torch.Tensor, axis: int = -2
                ) -> torch.Tensor:
    """Halves-packed int4 -> float32 weights q * scale. `axis` is the input
    axis: -2 for the JAX layout ((I/2, O) packed, (I/g, O) scales ->
    (I, O); transformer.py: _unpack_int4 in float32), -1 for the
    output-major one ((O, I/2), (O, I/g) -> (O, I))."""
    p = packed.to(torch.int16)
    lo = ((p & 15) ^ 8) - 8                  # rows [0, I/2)
    hi = p >> 4                              # rows [I/2, I), arithmetic
    q = torch.cat([lo, hi], dim=axis).to(torch.float32)
    g = q.shape[axis] // scales.shape[axis]
    return q * scales.to(torch.float32).repeat_interleave(g, dim=axis)


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """Kernel E's plain version: the weights dequantised in fp32 and
    rounded to bf16, x rounded to bf16, an fp32 product, out in x.dtype."""
    w = unpack_int4(packed, scales).to(torch.bfloat16).to(torch.float32)
    xb = x.to(torch.bfloat16).to(torch.float32)
    return (xb @ w).to(x.dtype)


def output_major_int4(packed: torch.Tensor, scales: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's layout of (..., I/2, O) packed and (..., I/g, O) scales:
    (..., O, I/2) int8 and (..., O, I/g) float32, contiguous."""
    return (packed.transpose(-1, -2).contiguous(),
            scales.to(torch.float32).transpose(-1, -2).contiguous())


def prepare_int4_layout(tree: dict) -> dict:
    """A copy of a quantised transformer tree with, beside every int4
    matrix ``name`` (``name + "_scale4"`` present), its output-major layout
    under ``name + "_t4"`` and ``name + "_s4t"``."""
    out = dict(tree)
    for k in list(tree):
        if k + "_scale4" in tree:
            out[k + "_t4"], out[k + "_s4t"] = output_major_int4(
                tree[k], tree[k + "_scale4"])
    return out


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("int4_matmul")
    if lib.frt_int4_matmul.argtypes is None:
        lib.frt_int4_matmul.argtypes = [_P] * 4 + [_I] * 4 + [_P]
        lib.frt_int4_matmul.restype = _I
    return lib


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                packed_t: torch.Tensor | None = None,
                scales_t: torch.Tensor | None = None) -> torch.Tensor:
    """x (..., I) @ int4-packed W (I/2, O) with group scales (I/g, O).

    packed_t / scales_t: the same weights in the kernel's output-major
    layout (``output_major_int4``); made per call when absent. Returns
    (..., O) in x.dtype.
    """
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scales)
    dev = x.device
    if not x.is_cuda:
        raise ValueError(f"int4_matmul: unsupported device {dev}")
    I2, O = packed.shape
    I = 2 * I2
    if x.dtype != torch.bfloat16:
        raise ValueError(f"int4_matmul: x dtype {x.dtype}, the kernel takes bfloat16")
    if x.shape[-1] != I:
        raise ValueError(f"int4_matmul: x {tuple(x.shape)} vs packed {tuple(packed.shape)}")
    if packed.dtype != torch.int8 or scales.ndim != 2 or scales.shape[1] != O:
        raise ValueError(f"int4_matmul: packed {packed.dtype} {tuple(packed.shape)}, "
                         f"scales {tuple(scales.shape)}")
    g = I // scales.shape[0]
    if packed_t is None or scales_t is None:
        packed_t, scales_t = output_major_int4(packed, scales)
    for name, t, shape, dt in (("packed_t", packed_t, (O, I2), torch.int8),
                               ("scales_t", scales_t, (O, I // g), torch.float32)):
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"int4_matmul: {name} {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected contiguous {dt} {shape} on {dev}")
    x2 = x.reshape(-1, I).contiguous()
    if x2.data_ptr() % 16:                  # the kernel reads 16-byte vectors
        x2 = x2.clone()
    out = torch.empty((x2.shape[0], O), dtype=x.dtype, device=dev)
    err = _lib().frt_int4_matmul(
        x2.data_ptr(), packed_t.data_ptr(), scales_t.data_ptr(), out.data_ptr(),
        x2.shape[0], I, O, g, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"int4_matmul launch failed: CUDA error {err}")
    int4_matmul.launches += 1
    return out.reshape(*x.shape[:-1], O)


int4_matmul.launches = 0
