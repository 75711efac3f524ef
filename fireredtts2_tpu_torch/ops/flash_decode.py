"""Flash-decode attention kernels over merged KV slabs: kernels A and C.

Counterpart of ``fireredtts2_tpu/ops/pallas_flash.py``. Each Pallas TPU
kernel there is a hand-written CUDA C++ kernel here (``csrc/``), behind a
wrapper that

- runs the kernel's plain PyTorch version when its tensors lie on the CPU;
- on CUDA tensors checks device, dtype, shape and contiguity, allocates its
  outputs and scratch with ``torch.empty``, launches the kernel on the
  current stream, raises if the launch failed, and adds one to its launch
  count. It never falls back to the plain version on a CUDA tensor.

Kernels:
- A ``flash_decode_gqa1``: S=1 GQA decode over one layer of the LM's
  (L, B, T, Hkv*Dh) slab (read-only; the LM's slab write stays a plain
  index copy in models/lm/transformer.py);
- C ``flash_decode_update_bounded``: writes the vocoder's fresh K/V rows
  into one layer of its (L, B, T, H*Dh) slab in place, then bounded
  attention with per-query bounds;
- D ``flash_decode_bounded``: kernel C's read-only mode over a
  (B, T, H*Dh) slab with optional lower bounds;
- F ``pallas_decode_attention``: S=1 GQA decode over unmerged
  (B, T, Hkv, Dh) slabs with a per-stream window. It computes what kernel A
  computes, so it runs kernel A's CUDA code over a (1, B, T, Hkv*Dh) view
  of the slabs (no copy). In the JAX package it is an opt-in
  (FRTTS2_PALLAS=1) that the measured default does not take; here, too, no
  model path calls it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from fireredtts2_tpu_torch.ops import cuda_build
from fireredtts2_tpu_torch.ops.attention import gqa_attention_bounded

_CHUNK_TARGET = 768
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def pick_chunk(T: int) -> int | None:
    """Largest divisor of T that is <= 768 and a multiple of 16: the live
    chunk granularity of the batch-wide range (pallas_flash.py:pick_chunk).
    None when T has none."""
    best = None
    for c in range(16, min(T, _CHUNK_TARGET) + 1, 16):
        if T % c == 0:
            best = c
    return best


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def _index(t: torch.Tensor, shape: tuple, name: str, device) -> torch.Tensor:
    """An int32 contiguous index tensor of the given shape on `device`."""
    _require(tuple(t.shape) == shape, f"{name}: shape {tuple(t.shape)} != {shape}")
    _require(t.device == device, f"{name}: on {t.device}, expected {device}")
    return t.to(torch.int32).contiguous()


def _scalar(x, device) -> torch.Tensor:
    """A 0-d int32 tensor on device from an int or a one-element tensor
    (a device tensor of that type passes through with no copy)."""
    if torch.is_tensor(x):
        _require(x.numel() == 1 and x.device == device,
                 f"bound: {tuple(x.shape)} on {x.device}, expected one value on {device}")
        return x.reshape(()).to(torch.int32)
    return torch.tensor(int(x), dtype=torch.int32, device=device)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_slab(name: str, t: torch.Tensor, device, ndim: int) -> None:
    _require(t.device == device, f"{name}: on {t.device}, expected {device}")
    _require(t.dtype == torch.bfloat16, f"{name}: dtype {t.dtype}, kernel takes bfloat16")
    _require(t.ndim == ndim, f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    _require(t.is_contiguous(), f"{name}: not contiguous")


_counters: dict = {}   # (kernel, device) -> int32 merge counts, zero between calls


def _merge_counters(device, n: int, kernel: str) -> torch.Tensor:
    """Merge counts of kernel A (one per stream and kv head) or C (one per
    stream, head and query block): zeros that the kernel leaves zero after
    each call, allocated once per kernel and device (and again, larger,
    when a call needs more; warm a shape before capturing it in a CUDA
    graph)."""
    c = _counters.get((kernel, device))
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[(kernel, device)] = c
    return c


# ---------------------------------------------------------------------------
# Kernel A: S=1 GQA decode over one layer of a carried (L, B, T, Hkv*Dh) slab
# ---------------------------------------------------------------------------


def flash_decode_gqa1_plain(q, k4, v4, layer: int, q_start, q_end,
                            live_lo, live_hi) -> torch.Tensor:
    """Kernel A's plain version: gqa_attention_bounded on the layer's slab."""
    attn = gqa_attention_bounded(
        q[:, None], k4[layer].to(q.dtype), v4[layer].to(q.dtype),
        q_end[:, None], live_hi, q_start=q_start[:, None], live_lo=live_lo)
    return attn[:, 0]


def _gqa1_lib(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """csrc/flash_decode_gqa1.cu, or a variant built with `defines`
    (FRT_GQA1_SPLIT=<slots>, FRT_GQA1_NOGROW, FRT_GQA1_TRACE: the builds
    of tools/sweep_gqa1.py; the wrappers load the serving build)."""
    lib = cuda_build.load("flash_decode_gqa1", defines)
    if lib.frt_flash_decode_gqa1.argtypes is None:
        lib.frt_gqa1_plan.argtypes = [_I] * 5 + [_P] * 4
        lib.frt_gqa1_plan.restype = _I
        lib.frt_flash_decode_gqa1.argtypes = [_P] * 10 + [_I] * 9 + [_F, _P]
        lib.frt_flash_decode_gqa1.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def gqa1_plan(B: int, Hkv: int, G: int, T: int, Dh: int, device_index: int = 0,
              defines: tuple[str, ...] = ()) -> tuple[int, int, int, int]:
    """Kernel A's launch plan from its library (frt_gqa1_plan): the split in
    slab slots, the number of splits, the launch's dynamic shared memory in
    bytes and the fp32 scratch a call needs. The library sizes them from
    (B, Hkv, G, T, Dh) and the card it runs on; the live length stays on
    the device."""
    lib = _gqa1_lib(defines)
    split, ns, smem, scratch = _I(), _I(), _I(), ctypes.c_longlong()
    with torch.cuda.device(device_index):
        err = lib.frt_gqa1_plan(B, Hkv, G, T, Dh, ctypes.byref(split),
                                ctypes.byref(ns), ctypes.byref(smem),
                                ctypes.byref(scratch))
    _require(err == 0, f"kernel A takes no plan for B={B}, Hkv={Hkv}, G={G}, "
             f"T={T}, Dh={Dh} (CUDA error {err})")
    return split.value, ns.value, smem.value, scratch.value


def _gqa1_launch(q, k3, v3, q_start, q_end, live_lo, live_hi,
                 defines: tuple[str, ...] = ()) -> torch.Tensor:
    """Shared launch of csrc/flash_decode_gqa1.cu on (B, T, Hkv*Dh) views
    of one layer's slabs: one CUDA launch, its fp32 scratch in one
    torch.empty, its merge counts in a per-device buffer the kernel leaves
    zero. Nothing is copied from or to the host."""
    dev = q.device
    B, Hq, Dh = q.shape
    _, T, W = k3.shape
    Hkv = W // Dh
    G = Hq // Hkv
    C = pick_chunk(T)
    _require(C is not None, f"slab length {T} has no 16-aligned chunking")
    split, ns, smem, scratch = gqa1_plan(B, Hkv, G, T, Dh, dev.index or 0,
                                         defines)
    q_start = _index(q_start, (B,), "q_start", dev)
    q_end = _index(q_end, (B,), "q_end", dev)
    lo, hi = _scalar(live_lo, dev), _scalar(live_hi, dev)
    part = torch.empty(scratch, dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    err = _gqa1_lib(defines).frt_flash_decode_gqa1(
        q.data_ptr(), k3.data_ptr(), v3.data_ptr(),
        q_start.data_ptr(), q_end.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        part.data_ptr(), _merge_counters(dev, B * Hkv, "gqa1").data_ptr(),
        out.data_ptr(), B, Hkv, G, Dh, T, C, split, ns, smem,
        1.0 / math.sqrt(Dh), _stream(dev))
    if err:
        raise RuntimeError(f"flash_decode_gqa1 launch failed: CUDA error {err}")
    return out


def flash_decode_gqa1(q: torch.Tensor, k4: torch.Tensor, v4: torch.Tensor,
                      layer: int, q_start: torch.Tensor, q_end: torch.Tensor,
                      live_lo, live_hi) -> torch.Tensor:
    """Single-token GQA decode attention over layer `layer` of merged
    (L, B, T, Hkv*Dh) slabs (fresh rows already written).

    Args:
        q: (B, Hq, Dh) post-RoPE queries; query head h reads kv head
            h // (Hq // Hkv).
        q_start / q_end: (B,) int per-stream window [start, end).
        live_lo / live_hi: int or 0-d tensor, the batch's min start and max
            end; they fix the chunk range the kernel may read (clamped to T).
    Returns:
        (B, Hq, Dh) in q's dtype.
    """
    if q.device.type == "cpu":
        return flash_decode_gqa1_plain(q, k4, v4, layer, q_start, q_end,
                                       live_lo, live_hi)
    dev = q.device
    _require(q.is_cuda, f"flash_decode_gqa1: unsupported device {dev}")
    _check_slab("q", q, dev, 3)
    _check_slab("k4", k4, dev, 4)
    _check_slab("v4", v4, dev, 4)
    B, Hq, Dh = q.shape
    L, Bk, T, W = k4.shape
    _require(v4.shape == k4.shape, f"v4 {tuple(v4.shape)} != k4 {tuple(k4.shape)}")
    _require(Bk == B, f"slab batch {Bk} != q batch {B}")
    _require(Dh in (64, 128) and W % Dh == 0, f"head dim {Dh}, slab width {W}")
    Hkv = W // Dh
    _require(Hq % Hkv == 0, f"Hq {Hq} not a multiple of Hkv {Hkv}")
    _require(0 <= layer < L, f"layer {layer} outside [0, {L})")
    out = _gqa1_launch(q, k4[layer], v4[layer], q_start, q_end, live_lo, live_hi)
    flash_decode_gqa1.launches += 1
    return out


flash_decode_gqa1.launches = 0


# ---------------------------------------------------------------------------
# Kernels C and D: bounded attention over a merged MHA slab, with (C) or
# without (D) the in-place write of the fresh rows
# ---------------------------------------------------------------------------


def flash_decode_update_bounded_plain(q, new_k, new_v, k4, v4, layer: int,
                                      pos, q_end, live_hi) -> torch.Tensor:
    """Kernel C's plain version: an index-copy write at min(pos, T - Sw)
    into slab[layer] (in place), then gqa_attention_bounded."""
    B = q.shape[0]
    T = k4.shape[2]
    Sw = new_k.shape[1]
    start = pos.to(torch.int64).clamp(min=0, max=T - Sw)
    rows = start[:, None] + torch.arange(Sw, device=pos.device)[None, :]
    bidx = torch.arange(B, device=pos.device)[:, None]
    k4[layer, bidx, rows] = new_k.reshape(B, Sw, -1).to(k4.dtype)
    v4[layer, bidx, rows] = new_v.reshape(B, Sw, -1).to(v4.dtype)
    return gqa_attention_bounded(q, k4[layer].to(q.dtype),
                                 v4[layer].to(q.dtype), q_end, live_hi)


def _update_lib() -> ctypes.CDLL:
    lib = cuda_build.load("flash_decode_update")
    if lib.frt_flash_decode_update.argtypes is None:
        for fn in (lib.frt_bounded_tile, lib.frt_bounded_max_queries,
                   lib.frt_bounded_max_splits):
            fn.argtypes, fn.restype = [], _I
        lib.frt_flash_decode_update.argtypes = [_P] * 15 + [_I] * 10 + [_F, _P]
        lib.frt_flash_decode_update.restype = _I
        _require(lib.frt_bounded_tile() == BOUNDED_TILE
                 and lib.frt_bounded_max_queries() == BOUNDED_QUERIES
                 and lib.frt_bounded_max_splits() == BOUNDED_MAX_SPLITS,
                 "csrc/flash_decode_update.cu disagrees with its wrapper's "
                 "tile, query block or split count")
    return lib


BOUNDED_TILE = 64          # slab slots per K/V tile of kernel C
BOUNDED_QUERIES = 128      # queries per block of kernel C
BOUNDED_MAX_SPLITS = 48    # splits kernel C's merge holds in shared memory
_TARGET_BLOCKS = 264       # two blocks per SM of an H100 (132 SMs)


@functools.lru_cache(maxsize=None)
def bounded_split(T: int, B: int, H: int) -> int:
    """Kernel C's split size in slab slots: a multiple of its 64-slot tile,
    chosen so that the grid of B * H * ceil(T / split) blocks (one per
    stream, head and split) fills one wave of two blocks per SM (264) as
    far as the slab allows, with at most 48 splits. Split s covers slots
    [s * split, min((s + 1) * split, T)). At the vocoder's T=3008, H=16:
    192 slots (16 splits) at B=1, 1536 (2) at B=8."""
    tiles = -(-T // BOUNDED_TILE)
    want = min(tiles, max(1, _TARGET_BLOCKS // (B * H)), BOUNDED_MAX_SPLITS)
    return -(-tiles // want) * BOUNDED_TILE


def split_ranges(T: int, B: int, H: int) -> list[tuple[int, int]]:
    """The [start, end) slot range of each of kernel C's splits."""
    sp = bounded_split(T, B, H)
    return [(s, min(s + sp, T)) for s in range(0, T, sp)]




def _bounded_launch(q, new_k, new_v, k3, v3, pos, q_end, q_start, live_lo,
                    live_hi, Sw: int, write: bool) -> torch.Tensor:
    """Shared launch of csrc/flash_decode_update.cu on one layer's
    (B, T, H*Dh) slab views: one CUDA launch (write, attention and the
    merge of the splits). live_lo None means 0 and is passed as a null
    pointer: a device scalar made from a Python int would cost a blocking
    host-to-device copy per call."""
    B, S, H, Dh = q.shape
    T = k3.shape[1]
    C = pick_chunk(T)
    _require(C is not None, f"slab length {T} has no 16-aligned chunking")
    _require(Dh == 64, f"head dim {Dh}: the kernel takes 64")
    lib = _update_lib()
    SP = bounded_split(T, B, H)
    NS = -(-T // SP)
    null = 0
    part = [null] * 4
    if NS > 1:
        # one fp32 scratch: part_m and part_l (B, H, NS, S) each, then
        # part_acc (B, H, NS, S, Dh) from a 16-byte boundary
        n = B * H * NS * S
        acc0 = -(-2 * n // 4) * 4
        scratch = torch.empty(acc0 + n * Dh, dtype=torch.float32, device=q.device)
        p0 = scratch.data_ptr()
        nq = -(-S // BOUNDED_QUERIES)
        part = [p0, p0 + 4 * n, p0 + 4 * acc0,
                _merge_counters(q.device, B * H * nq, "c").data_ptr()]
    out = torch.empty_like(q)
    err = lib.frt_flash_decode_update(
        q.data_ptr(),
        new_k.data_ptr() if write else null,
        new_v.data_ptr() if write else null,
        k3.data_ptr(), v3.data_ptr(),
        pos.data_ptr() if write else null,
        q_end.data_ptr(),
        q_start.data_ptr() if q_start is not None else null,
        live_lo.data_ptr() if live_lo is not None else null,
        live_hi.data_ptr(), *part, out.data_ptr(),
        B, S, Sw, H, Dh, T, C, SP, NS, int(write), 1.0 / math.sqrt(Dh),
        _stream(q.device))
    if err:
        raise RuntimeError(f"flash-decode bounded launch failed: CUDA error {err}")
    return out


def flash_decode_update_bounded(q: torch.Tensor, new_k: torch.Tensor,
                                new_v: torch.Tensor, k4: torch.Tensor,
                                v4: torch.Tensor, layer: int,
                                pos: torch.Tensor, q_end: torch.Tensor,
                                live_hi) -> torch.Tensor:
    """Fused slab write + bounded attention for layer `layer` of a
    (L, B, T, H*Dh) slab pair.

    Writes new_k/new_v (B, Sw, H*Dh) at rows [p_b, p_b + Sw) of
    slab[layer, b] IN PLACE, p_b = min(pos_b, T - Sw) (pos 8-aligned), then
    attends with per-query exclusive bounds q_end (B, S) that may cover the
    fresh rows. live_hi (int or 0-d tensor) is the batch's max live slot.

    Returns (B, S, H, Dh) in q's dtype. The JAX kernel returns the slabs as
    well (aliased outputs); here k4/v4 themselves are updated.
    """
    if q.device.type == "cpu":
        return flash_decode_update_bounded_plain(q, new_k, new_v, k4, v4,
                                                 layer, pos, q_end, live_hi)
    dev = q.device
    _require(q.is_cuda, f"flash_decode_update_bounded: unsupported device {dev}")
    B, S, H, Dh = q.shape
    for name, t, nd in (("q", q, 4), ("new_k", new_k, 3), ("new_v", new_v, 3),
                        ("k4", k4, 4), ("v4", v4, 4)):
        _check_slab(name, t, dev, nd)
    L, Bk, T, D = k4.shape
    Sw = new_k.shape[1]
    _require(v4.shape == k4.shape, f"v4 {tuple(v4.shape)} != k4 {tuple(k4.shape)}")
    _require(Bk == B and D == H * Dh, f"slab {tuple(k4.shape)} vs q {tuple(q.shape)}")
    _require(new_k.shape == (B, Sw, D) and new_v.shape == new_k.shape,
             f"new rows {tuple(new_k.shape)}, {tuple(new_v.shape)}")
    _require(Sw % 8 == 0 and 0 < Sw <= T, f"row count {Sw} not 8-aligned in (0, {T}]")
    _require(0 <= layer < L, f"layer {layer} outside [0, {L})")
    pos = _index(pos, (B,), "pos", dev)
    q_end = _index(q_end, (B, S), "q_end", dev)
    out = _bounded_launch(q, new_k, new_v, k4[layer], v4[layer], pos, q_end,
                          None, None, _scalar(live_hi, dev), Sw, write=True)
    flash_decode_update_bounded.launches += 1
    return out


flash_decode_update_bounded.launches = 0


def flash_decode_bounded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_end: torch.Tensor, live_hi,
                         q_start: torch.Tensor | None = None,
                         live_lo=None) -> torch.Tensor:
    """Kernel C's read-only mode: bounded attention over merged
    (B, T, H*Dh) slabs with optional inclusive lower bounds
    (pallas_flash.py:flash_decode_bounded). Returns (B, S, H, Dh)."""
    if q.device.type == "cpu":
        return gqa_attention_bounded(q, k.to(q.dtype), v.to(q.dtype), q_end,
                                     live_hi, q_start=q_start, live_lo=live_lo)
    dev = q.device
    _require(q.is_cuda, f"flash_decode_bounded: unsupported device {dev}")
    B, S, H, Dh = q.shape
    for name, t, nd in (("q", q, 4), ("k", k, 3), ("v", v, 3)):
        _check_slab(name, t, dev, nd)
    _require(k.shape == v.shape and k.shape[0] == B and k.shape[2] == H * Dh,
             f"slab {tuple(k.shape)} vs q {tuple(q.shape)}")
    q_end = _index(q_end, (B, S), "q_end", dev)
    if q_start is not None:
        q_start = _index(q_start, (B, S), "q_start", dev)
    out = _bounded_launch(q, None, None, k, v, None, q_end, q_start,
                          None if live_lo is None else _scalar(live_lo, dev),
                          _scalar(live_hi, dev), 0, write=False)
    flash_decode_bounded.launches += 1
    return out


flash_decode_bounded.launches = 0

# ---------------------------------------------------------------------------
# Kernel F: S=1 GQA decode over unmerged (B, T, Hkv, Dh) slabs, on kernel A
# ---------------------------------------------------------------------------


def pallas_decode_attention_plain(q, k_slab, v_slab, start, end) -> torch.Tensor:
    """Kernel F's plain version (pallas_attention.py:_decode_attn_kernel):
    fp32 scores over the window [start, end) of each stream, -1e30 outside,
    softmax, an fp32 product with V, the output in q's dtype."""
    B, Hq, D = q.shape
    T, Hkv = k_slab.shape[1], k_slab.shape[2]
    G = Hq // Hkv
    qf = q.to(torch.float32).reshape(B, Hkv, G, D) * (1.0 / math.sqrt(D))
    kf = k_slab.to(torch.float32)
    vf = v_slab.to(torch.float32)
    s = torch.einsum("bhgd,bthd->bhgt", qf, kf)
    t = torch.arange(T, device=q.device)
    valid = (t[None] >= start.to(torch.int64)[:, None]) \
        & (t[None] < end.to(torch.int64)[:, None])
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgt,bthd->bhgd", p, vf)
    return o.reshape(B, Hq, D).to(q.dtype)


def pallas_decode_attention(q: torch.Tensor, k_slab: torch.Tensor,
                            v_slab: torch.Tensor, start: torch.Tensor,
                            end: torch.Tensor) -> torch.Tensor:
    """Single-token GQA decode attention over each stream's live window.

    Args:
        q: (B, Hq, D) queries; query head h reads kv head h // (Hq // Hkv).
        k_slab / v_slab: (B, T, Hkv, D) slabs.
        start / end: (B,) int first live slot and one past the newest.
    Returns:
        (B, Hq, D) in q's dtype.

    On the card it runs kernel A's code over (1, B, T, Hkv*D) views, with
    q_start = start, q_end = end, live_lo = min(start), live_hi = max(end)
    (both reduced on the device). Kernel A rounds the probabilities to bf16
    before the product with V, as pallas_flash.py does; the plain version
    keeps them in fp32, as pallas_attention.py does.
    """
    if q.device.type == "cpu":
        return pallas_decode_attention_plain(q, k_slab, v_slab, start, end)
    dev = q.device
    _require(q.is_cuda, f"pallas_decode_attention: unsupported device {dev}")
    _check_slab("q", q, dev, 3)
    _check_slab("k_slab", k_slab, dev, 4)
    _check_slab("v_slab", v_slab, dev, 4)
    B, Hq, D = q.shape
    _, T, Hkv, Dk = k_slab.shape
    _require(v_slab.shape == k_slab.shape and k_slab.shape[0] == B and Dk == D,
             f"slabs {tuple(k_slab.shape)}, {tuple(v_slab.shape)} vs q {tuple(q.shape)}")
    _require(D in (64, 128) and Hq % Hkv == 0, f"head dim {D}, heads {Hq}/{Hkv}")
    start = _index(start, (B,), "start", dev)
    end = _index(end, (B,), "end", dev)
    out = _gqa1_launch(q, k_slab.view(B, T, Hkv * D), v_slab.view(B, T, Hkv * D),
                       start, end, start.min(), end.max())
    pallas_decode_attention.launches += 1
    return out


pallas_decode_attention.launches = 0

KERNELS = (flash_decode_gqa1, flash_decode_update_bounded, flash_decode_bounded,
           pallas_decode_attention)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}
