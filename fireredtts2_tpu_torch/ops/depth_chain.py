"""The fused depth chain: kernel B, one frame's depth decode in one launch.

Counterpart of ``fireredtts2_tpu/ops/pallas_depth.py``. The depth decoder
(qwen-200m, 4 layers) runs 16 micro-steps per frame: step 0 consumes the
backbone's last hidden state, step p >= 1 the embedding of the token
sampled at step p - 1 (codebook p - 1), each through the layers with a
16-slot K/V store, then the final norm, the audio head of codebook p and
temperature + top-k + exponential-race sampling. The noise is an input,
(B, ncb, V) Exp(1) draws; step p reads ``noise[:, p]``.

Weights come in a bundle made once by ``prepare_depth_chain`` from the
unquantised decoder, per a plan (``parse_plan``) of the three MLP matrices:
- ``r8`` / ``s8``: weight-only int8 with per-output-channel scales. On the
  TPU they differ in where the weights live (VMEM-resident or streamed from
  HBM); on the card both stream from device memory, so both names take the
  same route;
- ``r4``: group-wise int4, halves-packed (the nibble code is kernel E's);
- ``r8a8`` / ``s8a8``: int8 weights and int8 activations quantised per row,
  an int32-accumulated int8 dot. Their numerics differ from weight-only
  int8.
The attention projections are always int8 (Q, K and V merged into one
matrix). Every quantised matrix of the bundle is stored output-major,
(out, in) or (out, in/2) for int4, which is what the CUDA kernel streams.
Asked for (``with_decoder=True``), ``prepare_depth_chain`` also returns,
under ``xla_decoder``, the same quantised decoder in the JAX tree's
layout, with which ``models/lm/model.py: _depth_decode`` computes the same
numbers without the bundle. The serving tree holds the bundle only.

``fused_depth_decode`` runs the CUDA kernel (``csrc/fused_depth_decode.cu``)
on CUDA tensors and its plain version on CPU tensors; it never falls back
on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any

import torch

from fireredtts2_tpu_torch.config import LLMConfig
from fireredtts2_tpu_torch.ops import cuda_build
from fireredtts2_tpu_torch.ops.int4 import unpack_int4
from fireredtts2_tpu_torch.ops.quant import quantize_int4, quantize_int8

_NEG = -1e30
_MATMUL = ("wq", "wk", "wv", "wo")
_MLP = ("w_gate", "w_up", "w_down")
_MODE_ID = {"r8": 0, "s8": 0, "r8a8": 1, "s8a8": 1, "r4": 2}
_BMAX = 8                 # streams per kernel launch


def parse_plan(plan: str) -> dict[str, str]:
    """"gate=r4,up=s8,down=s8" -> {"w_gate": "r4", ...}. Empty -> all r8.
    A malformed string raises ValueError naming the grammar."""
    names = {"gate": "w_gate", "up": "w_up", "down": "w_down"}
    modes = ("r8", "r4", "s8", "r8a8", "s8a8")
    out = {"w_gate": "r8", "w_up": "r8", "w_down": "r8"}
    if plan:
        for part in plan.split(","):
            k, eq, v = part.partition("=")
            k, v = k.strip(), v.strip()
            if not eq or k not in names or v not in modes:
                raise ValueError(
                    f"bad fused-depth plan entry {part!r}: expected "
                    f"<tensor>=<mode> with tensor in {sorted(names)} and "
                    f"mode in {modes} (r8/s8 = int8 weights, r4 = int4 "
                    f"weights, r8a8/s8a8 = int8 weights and int8 "
                    f"activations, which changes the numerics), e.g. "
                    f"'gate=r8,up=s8,down=s8'")
            out[names[k]] = v
    return out


def _om(t: torch.Tensor) -> torch.Tensor:
    """(..., in, out) -> contiguous (..., out, in)."""
    return t.transpose(-1, -2).contiguous()


def prepare_depth_chain(params: dict[str, Any], cfg: LLMConfig,
                        plan: str = "", group: int = 128,
                        with_decoder: bool = False) -> dict[str, Any]:
    """The kernel's bundle from an LM tree whose ``decoder`` is not
    quantised, with the quantised values of pallas_depth.py:
    prepare_depth_chain (bit for bit) in output-major layout:

    - ``wqkv`` (L, Hq*Dh + 2*Hkv*Dh, Dd) int8, ``wqkv_s`` (L, that) fp32;
      ``wo`` (L, Dd, Hq*Dh), ``wo_s`` (L, Dd);
    - each MLP matrix, int8 (L, out, in) with ``_s`` (L, out), or int4
      (L, out, in/2) with ``_s4`` (L, out, in/g) (scales rounded to the
      model dtype, as the JAX bundle stores them);
    - norms and the QKV bias, ``proj_t`` (Dd, Db), ``emb_rows`` (the flat
      audio embeddings of codebooks 0..ncb-2), ``head_t`` (ncb-1, V, Dd),
      RoPE tables ``rope_cos``/``rope_sin`` (ncb, Dh/2) fp32;
    - with ``with_decoder``, ``xla_decoder``: the quantised decoder in the
      JAX layout.
    """
    dec = params["decoder"]
    if dec["wq"].dtype == torch.int8:
        raise ValueError("prepare_depth_chain needs the unquantised decoder")
    p = parse_plan(plan)
    ncb, V = cfg.audio_num_codebooks, cfg.audio_vocab_size
    dcfg = cfg.decoder
    dtype = params["projection"].dtype

    bundle: dict[str, Any] = {}
    xla: dict[str, Any] = {}
    for k, v in dec.items():
        if k in _MATMUL:
            xla[k], xla[k + "_scale"] = quantize_int8(v)
        elif k in _MLP and p[k] == "r4":
            q, s4 = quantize_int4(v, group, v.shape[1] // 2)
            s4 = s4.to(dtype)
            xla[k], xla[k + "_scale4"] = q, s4
            bundle[k], bundle[k + "_s4"] = _om(q), _om(s4.to(torch.float32))
        elif k in _MLP:
            q, s = quantize_int8(v)
            xla[k], xla[k + "_scale"] = q, s
            bundle[k], bundle[k + "_s"] = _om(q), s[:, 0].contiguous()
        else:
            xla[k] = v
    bundle["wqkv"] = _om(torch.cat([xla["wq"], xla["wk"], xla["wv"]], dim=-1))
    bundle["wqkv_s"] = torch.cat([xla["wq_scale"], xla["wk_scale"],
                                  xla["wv_scale"]], dim=-1)[:, 0].contiguous()
    bundle["wo"] = _om(xla["wo"])
    bundle["wo_s"] = xla["wo_scale"][:, 0].contiguous()
    bundle["attn_norm"] = dec["attn_norm"]
    bundle["mlp_norm"] = dec["mlp_norm"]
    bundle["final_norm"] = dec["final_norm"]
    bundle["bqkv"] = torch.cat([dec["bq"], dec["bk"], dec["bv"]], dim=-1)
    bundle["proj_t"] = _om(params["projection"])
    bundle["emb_rows"] = params["audio_embeddings"][: (ncb - 1) * V].to(dtype)
    bundle["head_t"] = _om(params["audio_head"].to(dtype))

    half = dcfg.head_dim // 2
    dev = params["projection"].device
    inv = 1.0 / (dcfg.rope_base ** (
        torch.arange(0, half, dtype=torch.float32, device=dev) * 2.0
        / dcfg.head_dim))
    ang = torch.arange(ncb, dtype=torch.float32, device=dev)[:, None] * inv
    bundle["rope_cos"], bundle["rope_sin"] = torch.cos(ang), torch.sin(ang)
    if with_decoder:
        bundle["xla_decoder"] = xla
    return bundle


def enable_fused_depth(params: dict[str, Any], cfg: LLMConfig
                       ) -> dict[str, Any]:
    """Serving transform: install the bundle for ``cfg.fused_depth_plan``
    as ``depth_chain`` in place of the decoder, which the fused path never
    reads (the JAX package keeps a quantised decoder beside the bundle for
    its XLA fallback; the port has none)."""
    if not cfg.fused_depth_plan:
        raise ValueError("set LLMConfig.fused_depth_plan first")
    out = {k: v for k, v in params.items() if k != "decoder"}
    out["depth_chain"] = prepare_depth_chain(params, cfg, cfg.fused_depth_plan)
    return out


# ---------------------------------------------------------------------------
# The plain version (the CPU route and the card's reference)
# ---------------------------------------------------------------------------


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    s = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * s).to(x.dtype) * w.to(x.dtype)


def _dot(x: torch.Tensor, w_om: torch.Tensor) -> torch.Tensor:
    """fp32 x (B, K) @ w_om (O, K)^T of values held in any dtype."""
    return x.to(torch.float32) @ w_om.to(torch.float32).T


def _quant_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of activations (as float64 integers, exact
    in a float64 product) and the (B, 1) fp32 scales."""
    xf = x.to(torch.float32)
    sc = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-30) / 127.0
    return torch.round(xf / sc).to(torch.float64), sc


def _dot_s8(xq: torch.Tensor, w_om: torch.Tensor) -> torch.Tensor:
    """int8 x int8 dot with exact integer sums, as fp32."""
    return (xq @ w_om.to(torch.float64).T).to(torch.float32)


def fused_depth_decode_plain(bundle: dict[str, Any], cfg: LLMConfig,
                             last_h: torch.Tensor, c0: torch.Tensor,
                             noise: torch.Tensor, depth_topk: int = 10,
                             depth_temperature: float = 0.75,
                             greedy: bool = False, plan: str = "",
                             forced: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B's plain version, step by step as _depth_chain_kernel
    computes it, in last_h's dtype. forced (B, ncb): feed forced[:, p] to
    step p + 1 instead of the sample. Returns ((B, ncb) int32 samples with
    c0 in column 0, (B, ncb, V) fp32 logits, row 0 zero)."""
    dcfg = cfg.decoder
    ncb, V = cfg.audio_num_codebooks, cfg.audio_vocab_size
    L, Hq, Hkv, Dh = (dcfg.num_layers, dcfg.num_heads, dcfg.num_kv_heads,
                      dcfg.head_dim)
    G, eps = Hq // Hkv, dcfg.norm_eps
    I = dcfg.intermediate_dim
    Ih = I // 2
    B = last_h.shape[0]
    dtype, dev = last_h.dtype, last_h.device
    p_modes = parse_plan(plan)

    def deq4(name: str, l: int) -> torch.Tensor:
        """q * scale in fp32 rounded to dtype (pallas_depth.py:_unpack4_rows)."""
        return unpack_int4(bundle[name][l], bundle[name + "_s4"][l],
                           axis=-1).to(dtype)

    def mlp_in(name: str, x2: torch.Tensor, l: int) -> torch.Tensor:
        mode = p_modes[name]
        if mode == "r4":
            return _dot(x2, deq4(name, l)).to(dtype)
        if mode in ("r8a8", "s8a8"):
            xq, xs = _quant_act(x2)
            y = (_dot_s8(xq, bundle[name][l]) * xs).to(dtype)
        else:
            y = _dot(x2, bundle[name][l]).to(dtype)
        return y * bundle[name + "_s"][l].to(dtype)

    def mlp_down(t: torch.Tensor, l: int) -> torch.Tensor:
        mode = p_modes["w_down"]
        w = deq4("w_down", l) if mode == "r4" else bundle["w_down"][l]
        acc = torch.zeros((B, w.shape[0]), dtype=torch.float32, device=dev)
        for half in range(2):
            th, wh = t[:, half * Ih:(half + 1) * Ih], w[:, half * Ih:(half + 1) * Ih]
            if mode in ("r8a8", "s8a8"):
                tq, ts = _quant_act(th)
                acc = acc + _dot_s8(tq, wh) * ts
            else:
                acc = acc + _dot(th, wh)
        d = acc.to(dtype)
        if mode != "r4":
            d = d * bundle["w_down_s"][l].to(dtype)
        return d

    def mm8(x: torch.Tensor, name: str, l: int) -> torch.Tensor:
        y = _dot(x, bundle[name][l]).to(dtype)
        return y * bundle[name + "_s"][l].to(dtype)

    def rope(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        x1, x2 = xf[..., : Dh // 2], xf[..., Dh // 2:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)

    k_store = torch.zeros((L, B, ncb, Hkv, Dh), dtype=dtype, device=dev)
    v_store = torch.zeros_like(k_store)
    samples = torch.zeros((B, ncb), dtype=torch.int32, device=dev)
    logits_all = torch.zeros((B, ncb, V), dtype=torch.float32, device=dev)
    samples[:, 0] = c0.to(torch.int32)
    prev = c0.to(torch.int64)
    Wq, Wkv = Hq * Dh, Hkv * Dh
    for p in range(ncb):
        if p == 0:
            src = last_h
        else:
            src = bundle["emb_rows"][prev.clamp(0, V - 1) + (p - 1) * V]
        h = _dot(src.to(dtype), bundle["proj_t"]).to(dtype)
        c, s = bundle["rope_cos"][p], bundle["rope_sin"][p]
        for l in range(L):
            x = _rms(h, bundle["attn_norm"][l], eps)
            qkv = mm8(x, "wqkv", l) + bundle["bqkv"][l].to(dtype)
            q = rope(qkv[:, :Wq].reshape(B, Hq, Dh), c, s)
            k = rope(qkv[:, Wq:Wq + Wkv].reshape(B, Hkv, Dh), c, s)
            k_store[l, :, p] = k
            v_store[l, :, p] = qkv[:, Wq + Wkv:].reshape(B, Hkv, Dh)
            qf = q.to(torch.float32).reshape(B, Hkv, G, Dh) * (1.0 / (Dh ** 0.5))
            kf = k_store[l, :, : p + 1].to(torch.float32)     # (B, t, Hkv, Dh)
            sc = torch.einsum("bhgd,bthd->bhgt", qf, kf)
            ex = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
            probs = (ex / ex.sum(dim=-1, keepdim=True)).to(dtype)
            o = torch.einsum("bhgt,bthd->bhgd", probs.to(torch.float32),
                             v_store[l, :, : p + 1].to(torch.float32))
            h = h + mm8(o.to(dtype).reshape(B, Wq), "wo", l).to(dtype)
            x2 = _rms(h, bundle["mlp_norm"][l], eps)
            g_act = torch.nn.functional.silu(
                mlp_in("w_gate", x2, l).to(torch.float32)).to(dtype)
            h = h + mlp_down(g_act * mlp_in("w_up", x2, l), l)
        if p == 0:
            continue
        hh = _rms(h, bundle["final_norm"], eps)
        logits = _dot(hh, bundle["head_t"][p - 1])
        logits_all[:, p] = logits
        if greedy:
            tok = torch.argmax(logits, dim=-1)
        else:
            lf = logits / depth_temperature
            cur = lf
            for _ in range(depth_topk - 1):
                cur = torch.where(cur >= cur.amax(dim=-1, keepdim=True),
                                  torch.full_like(cur, _NEG), cur)
            kth = cur.amax(dim=-1, keepdim=True)
            filt = torch.where(lf < kth, torch.full_like(lf, _NEG), lf)
            ex2 = torch.exp(filt - filt.amax(dim=-1, keepdim=True))
            pr = ex2 / ex2.sum(dim=-1, keepdim=True)
            tok = torch.argmax(pr / noise[:, p].to(torch.float32), dim=-1)
        samples[:, p] = tok.to(torch.int32)
        prev = forced[:, p].to(torch.int64) if forced is not None else tok
    return samples, logits_all


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

# Argument order of csrc/fused_depth_decode.cu: frt_fused_depth_decode.
_PTRS = ("last_h", "c0", "noise", "forced", "proj_t", "emb_rows", "head_t",
         "rope_cos", "rope_sin", "attn_norm", "mlp_norm", "final_norm", "bqkv",
         "wqkv", "wqkv_s", "wo", "wo_s", "w_gate", "w_gate_s", "w_up", "w_up_s",
         "w_down", "w_down_s", "samples", "logits_out", "h", "qkv", "t",
         "k_store", "v_store", "tok", "logits", "barrier")
_INTS = ("B", "Db", "Dd", "Hq", "Hkv", "Dh", "I", "V", "ncb", "L", "g_gate",
         "g_up", "g_down", "m_gate", "m_up", "m_down", "topk", "greedy", "kmax",
         "xs_bytes")
_barriers: dict = {}


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("fused_depth_decode")
    if lib.frt_fused_depth_decode.argtypes is None:
        n_p, n_i = ctypes.c_int(), ctypes.c_int()
        lib.frt_depth_chain_counts(ctypes.byref(n_p), ctypes.byref(n_i))
        if (n_p.value, n_i.value) != (len(_PTRS), len(_INTS)):
            raise RuntimeError(f"fused_depth_decode.cu takes {n_p.value} pointers "
                               f"and {n_i.value} ints, the wrapper passes "
                               f"{len(_PTRS)} and {len(_INTS)}")
        lib.frt_depth_chain_grid.argtypes = [ctypes.c_int]
        lib.frt_depth_chain_grid.restype = ctypes.c_int
        lib.frt_fused_depth_decode.argtypes = [ctypes.c_void_p] * 4
        lib.frt_fused_depth_decode.restype = ctypes.c_int
    return lib


def _barrier(dev: torch.device) -> torch.Tensor:
    """The kernel's grid-barrier words on `dev` (count, generation). Made
    zero once; each launch leaves the count at zero again. Launches of the
    kernel on one device must therefore not overlap (one stream)."""
    key = (dev.type, dev.index)
    if key not in _barriers:
        _barriers[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return _barriers[key]


def _launch(bd: dict, cfg: LLMConfig, modes: dict, groups: dict,
            last_h, c0, noise, forced, topk, temperature, greedy,
            logits_out) -> torch.Tensor:
    dcfg = cfg.decoder
    dev = last_h.device
    B, Db = last_h.shape
    ncb, V = cfg.audio_num_codebooks, cfg.audio_vocab_size
    Dd, I, L = dcfg.embed_dim, dcfg.intermediate_dim, dcfg.num_layers
    Hq, Hkv, Dh = dcfg.num_heads, dcfg.num_kv_heads, dcfg.head_dim
    kmax = max(Db, Dd, Hq * Dh, I)
    xs_bytes = -(-max(B * kmax * 2, 8 * V) // 16) * 16
    f32, bf = torch.float32, torch.bfloat16
    t = dict(bd)
    t.update(
        last_h=last_h, c0=c0, noise=noise, forced=forced, logits_out=logits_out,
        samples=torch.empty((B, ncb), dtype=torch.int32, device=dev),
        h=torch.empty((B, Dd), dtype=f32, device=dev),
        qkv=torch.empty((B, (Hq + 2 * Hkv) * Dh), dtype=f32, device=dev),
        t=torch.empty((B, I), dtype=bf, device=dev),
        k_store=torch.empty((L, ncb, B, Hkv, Dh), dtype=bf, device=dev),
        v_store=torch.empty((L, ncb, B, Hkv, Dh), dtype=bf, device=dev),
        tok=torch.empty((B,), dtype=torch.int32, device=dev),
        logits=torch.empty((B, V), dtype=f32, device=dev),
        barrier=_barrier(dev))
    for m in _MLP:
        if modes[m] == "r4":
            t[m + "_s"] = t[m + "_s4"]
    ints = dict(B=B, Db=Db, Dd=Dd, Hq=Hq, Hkv=Hkv, Dh=Dh, I=I, V=V, ncb=ncb, L=L,
                g_gate=groups["w_gate"], g_up=groups["w_up"],
                g_down=groups["w_down"], m_gate=_MODE_ID[modes["w_gate"]],
                m_up=_MODE_ID[modes["w_up"]], m_down=_MODE_ID[modes["w_down"]],
                topk=topk, greedy=int(greedy), kmax=kmax, xs_bytes=xs_bytes)
    ptrs = (ctypes.c_void_p * len(_PTRS))(
        *[0 if t[n] is None else t[n].data_ptr() for n in _PTRS])
    ints_c = (ctypes.c_int * len(_INTS))(*[ints[n] for n in _INTS])
    floats = (ctypes.c_float * 3)(temperature, dcfg.norm_eps, 1.0 / math.sqrt(Dh))
    err = _lib().frt_fused_depth_decode(
        ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(ints_c, ctypes.c_void_p),
        ctypes.cast(floats, ctypes.c_void_p),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fused_depth_decode launch failed: CUDA error {err}")
    fused_depth_decode.launches += 1
    return t["samples"]


def _check(name: str, t: torch.Tensor, dev, dtype, shape) -> None:
    if (t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"fused_depth_decode: {name} {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}, expected contiguous "
                         f"{dtype} {tuple(shape)} on {dev}")


def fused_depth_decode(bundle: dict[str, Any], cfg: LLMConfig,
                       last_h: torch.Tensor, c0: torch.Tensor,
                       noise: torch.Tensor, depth_topk: int = 10,
                       depth_temperature: float = 0.75, greedy: bool = False,
                       plan: str = "", forced: torch.Tensor | None = None,
                       return_logits: bool = False):
    """Sample codebooks 0..ncb-1 of one frame (c0 in column 0) with the
    fused chain: one kernel launch per frame for up to 8 streams.

    Args:
        bundle: from ``prepare_depth_chain`` for the same plan.
        last_h: (B, Db) backbone hidden state; c0: (B,) codebook-0 tokens;
        noise: (B, ncb, V) Exp(1) draws, step p reads noise[:, p].
        forced: optional (B, ncb) tokens fed to the next step instead of the
            samples (a test hook: it keeps a comparison on logits from being
            derailed by one near-tie).
        return_logits: also return the (B, ncb, V) fp32 logits (row 0 zero).
    Returns:
        (B, ncb) int32 samples, or (samples, logits).
    """
    if last_h.device.type == "cpu":
        samples, logits = fused_depth_decode_plain(
            bundle, cfg, last_h, c0, noise, depth_topk, depth_temperature,
            greedy, plan, forced)
        return (samples, logits) if return_logits else samples
    dev = last_h.device
    if not last_h.is_cuda:
        raise ValueError(f"fused_depth_decode: unsupported device {dev}")
    dcfg = cfg.decoder
    ncb, V = cfg.audio_num_codebooks, cfg.audio_vocab_size
    Dd, I, L = dcfg.embed_dim, dcfg.intermediate_dim, dcfg.num_layers
    Hq, Hkv, Dh = dcfg.num_heads, dcfg.num_kv_heads, dcfg.head_dim
    Wqkv = (Hq + 2 * Hkv) * Dh
    B, Db = last_h.shape
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    if Dh != 128 or any(d % 32 for d in (Db, Dd, I, Hq * Dh)) or ncb > 16:
        raise ValueError(f"fused_depth_decode: the kernel takes Dh = 128, widths "
                         f"that are multiples of 32 and <= 16 codebooks, got "
                         f"Dh={Dh}, Db={Db}, Dd={Dd}, I={I}, ncb={ncb}")
    modes = parse_plan(plan)
    last_h, noise = last_h.contiguous(), noise.contiguous()
    _check("last_h", last_h, dev, bf, (B, Db))
    c0 = c0.to(torch.int32).contiguous()
    _check("c0", c0, dev, torch.int32, (B,))
    _check("noise", noise, dev, f32, (B, ncb, V))
    if forced is not None:
        forced = forced.to(torch.int32).contiguous()
        _check("forced", forced, dev, torch.int32, (B, ncb))
    for name, dt, shape in (
            ("proj_t", bf, (Dd, Db)), ("emb_rows", bf, ((ncb - 1) * V, Db)),
            ("head_t", bf, (ncb - 1, V, Dd)), ("rope_cos", f32, (ncb, Dh // 2)),
            ("rope_sin", f32, (ncb, Dh // 2)), ("attn_norm", bf, (L, Dd)),
            ("mlp_norm", bf, (L, Dd)), ("final_norm", bf, (Dd,)),
            ("bqkv", bf, (L, Wqkv)), ("wqkv", i8, (L, Wqkv, Dd)),
            ("wqkv_s", f32, (L, Wqkv)), ("wo", i8, (L, Dd, Hq * Dh)),
            ("wo_s", f32, (L, Dd))):
        _check(name, bundle[name], dev, dt, shape)
    groups = {}
    for m, (O, K) in (("w_gate", (I, Dd)), ("w_up", (I, Dd)), ("w_down", (Dd, I))):
        if modes[m] == "r4":
            ng = bundle[m + "_s4"].shape[-1]
            groups[m] = K // ng
            if groups[m] % 16 or K % groups[m]:
                raise ValueError(f"fused_depth_decode: {m} int4 group "
                                 f"{groups[m]} must be a multiple of 16")
            _check(m, bundle[m], dev, i8, (L, O, K // 2))
            _check(m + "_s4", bundle[m + "_s4"], dev, f32, (L, O, ng))
        else:
            groups[m] = 0
            _check(m, bundle[m], dev, i8, (L, O, K))
            _check(m + "_s", bundle[m + "_s"], dev, f32, (L, O))
    parts, logit_parts = [], []
    for i in range(0, B, _BMAX):
        sl = slice(i, min(B, i + _BMAX))
        lo = (torch.zeros((sl.stop - i, ncb, V), dtype=f32, device=dev)
              if return_logits else None)
        parts.append(_launch(
            bundle, cfg, modes, groups, last_h[sl], c0[sl], noise[sl],
            None if forced is None else forced[sl], depth_topk,
            depth_temperature, greedy, lo))
        logit_parts.append(lo)
    samples = torch.cat(parts) if len(parts) > 1 else parts[0]
    if return_logits:
        return samples, torch.cat(logit_parts)
    return samples


fused_depth_decode.launches = 0
