"""Qwen2-family decoder-only transformer as plain functions over a dict tree.

Counterpart of ``fireredtts2_tpu/models/lm/transformer.py``. Parameters keep
the JAX layout: layer weights stacked on a leading L axis, matmul weights
(in, out). The KV cache is a preallocated MERGED (L, B, T, Hkv*Dh) slab
pair; where the JAX package threads the slabs through its layer scan as a
carry, this port writes the fresh rows into them IN PLACE. Without a cache
the stack runs stateless (training's forward), each layer optionally under
``ops.remat``.

Routing inside a cached layer:
- S > 1 (prefill) and the depth decoder's small cache: dense masked
  attention over the layer's slab (``ops.attention.gqa_attention``);
- S = 1 with a live window (the backbone's decode step): kernel A,
  ``ops.flash_decode.flash_decode_gqa1``, which reads only the live chunks.

Weight-only quantisation (``quantize_transformer_int8`` / ``_int4``) and
the matmul route follow the JAX package; both live in ``ops.quant``
(int8: a plain dequant matmul; int4: kernel E).

Tensor parallelism (a serving mesh with tp > 1, ``parallel.mesh``): the
layer weights are the rank's Megatron shards. wq/wk/wv, w_gate and w_up
give the rank's columns; the fresh K/V rows (B, S, Hkv*Dh) are gathered
whole over tp before RoPE and the slab write, since the slab is
tp-replicated (the rows, never the slab, cross ranks); the rank attends
with its own query heads over its kv-head window of the slab (kernel A's
tp route at S = 1); wo and w_down end in a tp sum (``parallel.layers``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from fireredtts2_tpu_torch.config import TransformerConfig
from fireredtts2_tpu_torch.ops.attention import gqa_attention
from fireredtts2_tpu_torch.ops.flash_decode import (
    flash_decode_gqa1, flash_decode_gqa1_shard,
)
from fireredtts2_tpu_torch.ops.quant import quantize_tree, quantized_matmul
from fireredtts2_tpu_torch.ops.remat import remat_layer
from fireredtts2_tpu_torch.ops.rope import apply_rope, rope_angles
from fireredtts2_tpu_torch.parallel.layers import (
    gather_cols, head_window, row_matmul,
)
from fireredtts2_tpu_torch.parallel.mesh import tp_mesh

Params = dict[str, Any]
KVCache = dict[str, torch.Tensor]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * weight.to(x.dtype)


def _normal(gen: torch.Generator, shape, std: float, dtype, device):
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * std).to(dtype)


def init_transformer_params(gen: torch.Generator, cfg: TransformerConfig,
                            dtype=torch.float32, device=None) -> Params:
    """Random init with the JAX tree's shapes and scales (normal * 0.02
    matmuls, zero biases, unit norms), drawn from `gen`."""
    L, D, I = cfg.num_layers, cfg.embed_dim, cfg.intermediate_dim
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def w(*shape):
        return _normal(gen, shape, 0.02, dtype, device)

    def const(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "wq": w(L, D, Hq * Dh), "bq": const(0.0, L, Hq * Dh),
        "wk": w(L, D, Hkv * Dh), "bk": const(0.0, L, Hkv * Dh),
        "wv": w(L, D, Hkv * Dh), "bv": const(0.0, L, Hkv * Dh),
        "wo": w(L, Hq * Dh, D),
        "w_gate": w(L, D, I), "w_up": w(L, D, I), "w_down": w(L, I, D),
        "attn_norm": const(1.0, L, D), "mlp_norm": const(1.0, L, D),
        "final_norm": const(1.0, D),
    }


def init_kv_cache(cfg: TransformerConfig, batch_size: int, max_seq_len: int,
                  dtype=torch.float32, device=None) -> KVCache:
    """Zeroed MERGED (L, B, T_max, Hkv*Dh) slabs for k and v."""
    shape = (cfg.num_layers, batch_size, max_seq_len,
             cfg.num_kv_heads * cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_transformer_int8(params: Params) -> Params:
    """Weight-only int8, per-output-channel symmetric, for a stacked tree:
    each matmul becomes int8 plus ``name + "_scale"`` (L, 1, out) float32.
    Norms and biases stay."""
    return quantize_tree(params, _MATMUL_KEYS, bits=8)


def quantize_transformer_int4(params: Params, group: int = 128) -> Params:
    """Weight-only int4, group-wise symmetric over `group` input rows (the
    largest power-of-two divisor of I at most `group`), two nibbles per
    byte: packed row i holds input rows i (low) and i + I/2 (high). Each
    matmul becomes (L, I/2, O) int8 plus ``name + "_scale4"`` (L, I/g, O)
    float32."""
    return quantize_tree(params, _MATMUL_KEYS, bits=4, group=group)


def slab_write_rows(cache_pos: torch.Tensor, S: int, T: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Where each stream's rows [cache_pos, cache_pos + S) go in a slab of
    T rows -> (rows (B, S) int64, keep (B, S) bool).

    Rows at or past T are dropped, as the JAX package's scatter drops them
    (``.at[...].set``): they are sent to distinct rows below T that this
    window does not write, [T - S, cache_pos), and rewrite what those rows
    hold (``keep`` False), so a stream stepping past its slab's end (an
    idle batcher slot) changes no row. No value is read back to the host."""
    ar = torch.arange(S, device=cache_pos.device)
    pos = cache_pos.to(torch.int64)[:, None]
    rows = pos + ar[None]
    keep = rows < T
    n_keep = (T - pos).clamp(0, S)
    return torch.where(keep, rows, (T - S) + ar[None] - n_keep), keep


def _qkv(h: torch.Tensor, lp: Params, cfg: TransformerConfig,
         cos: torch.Tensor, sin: torch.Tensor):
    """The layer's pre-norm and roped q, k and v, (B, S, H, Dh): q with
    the rank's query heads (all of them without tp, or where its columns
    are not whole heads), k and v with every kv head."""
    B, S, _ = h.shape
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    q = quantized_matmul(x, lp, "wq") + lp["bq"]
    k = gather_cols(quantized_matmul(x, lp, "wk") + lp["bk"], Hkv * Dh)
    v = gather_cols(quantized_matmul(x, lp, "wv") + lp["bv"], Hkv * Dh)
    if q.shape[-1] % Dh or head_window(q.shape[-1] // Dh, Hq, Hkv) is None:
        q = gather_cols(q, Hq * Dh)
    q = q.reshape(B, S, -1, Dh)
    k = k.reshape(B, S, Hkv, Dh)
    v = v.reshape(B, S, Hkv, Dh)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _attend_window(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask, cfg: TransformerConfig) -> torch.Tensor:
    """Dense attention of q's heads over the kv heads they read: the
    rank's window of k/v (B, T, Hkv, Dh) under tp, all of them without."""
    kv0, hkv = head_window(q.shape[2], cfg.num_heads, cfg.num_kv_heads)
    return gqa_attention(q, k[:, :, kv0:kv0 + hkv], v[:, :, kv0:kv0 + hkv],
                         mask)


def _out_mlp(h: torch.Tensor, attn: torch.Tensor, lp: Params,
             cfg: TransformerConfig) -> torch.Tensor:
    """The attention output projection and the SwiGLU MLP, residuals
    included; under tp wo and w_down are row-parallel (a tp sum each)."""
    B, S, _ = h.shape
    Hq, Dh, I = cfg.num_heads, cfg.head_dim, cfg.intermediate_dim
    h = h + row_matmul(attn.reshape(B, S, -1), lp, "wo", Hq * Dh).to(h.dtype)
    x = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    gate = F.silu(quantized_matmul(x, lp, "w_gate").to(torch.float32)).to(h.dtype)
    up = quantized_matmul(x, lp, "w_up")
    return h + row_matmul(gate * up, lp, "w_down", I).to(h.dtype)


def _layer(h: torch.Tensor, lp: Params, cfg: TransformerConfig,
           cos: torch.Tensor, sin: torch.Tensor, mask: Optional[torch.Tensor],
           k4: torch.Tensor, v4: torch.Tensor, layer: int, cache_pos,
           bounded, write=None) -> torch.Tensor:
    """One layer. This call's K/V rows are written into slab[layer] in
    place at cache_pos (an int = the same slot for every stream; a (B,)
    tensor = per-stream slots, placed by `write`: rows, keep and the
    slabs' current values at those rows, from :func:`slab_write_rows`),
    then attention reads the slab."""
    B, S, _ = h.shape
    Hkv, Dh = cfg.num_kv_heads, cfg.head_dim
    q, k, v = _qkv(h, lp, cfg, cos, sin)

    kw = k.reshape(B, S, Hkv * Dh).to(k4.dtype)
    vw = v.reshape(B, S, Hkv * Dh).to(v4.dtype)
    if write is not None:
        bidx, rows, keep, old_k, old_v = write
        k4[layer, bidx, rows] = torch.where(keep[..., None], kw, old_k[layer])
        v4[layer, bidx, rows] = torch.where(keep[..., None], vw, old_v[layer])
    else:
        k4[layer, :, cache_pos:cache_pos + S] = kw
        v4[layer, :, cache_pos:cache_pos + S] = vw

    m = tp_mesh()
    if bounded is not None and S == 1:
        q_start, q_end, live_lo, live_hi = bounded
        if m is not None and q.shape[2] < cfg.num_heads:
            attn = flash_decode_gqa1_shard(m, q[:, 0], k4, v4, layer, q_start,
                                           q_end, live_lo, live_hi)[:, None]
        else:
            attn = flash_decode_gqa1(q[:, 0], k4, v4, layer, q_start, q_end,
                                     live_lo, live_hi)[:, None]
    else:
        T = k4.shape[2]
        attn = _attend_window(
            q, k4[layer].reshape(B, T, Hkv, Dh).to(h.dtype),
            v4[layer].reshape(B, T, Hkv, Dh).to(h.dtype), mask, cfg)
    return _out_mlp(h, attn, lp, cfg)


def _layer_stateless(h: torch.Tensor, lp: Params, cfg: TransformerConfig,
                     cos: torch.Tensor, sin: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """One layer without a cache: attention over this call's own K/V
    (plain ``gqa_attention``, as JAX runs it as plain XLA)."""
    q, k, v = _qkv(h, lp, cfg, cos, sin)
    return _out_mlp(h, _attend_window(q, k, v, mask, cfg), lp, cfg)


def transformer_forward(params: Params, cfg: TransformerConfig,
                        h: torch.Tensor, positions: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        cache: Optional[KVCache] = None, cache_pos=None,
                        live_window: Optional[tuple] = None,
                        remat: Optional[str] = None,
                        ) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder stack.

    Args:
        h: (B, S, D) input embeddings; positions: (B, S) RoPE positions.
        mask: bool, True = attend. Without a cache (B, S, S); with one
            (B, S, T_max) slab rows, unused (None) for S = 1 with a live
            window.
        cache: KV slabs from :func:`init_kv_cache`, updated in place; None
            = the stateless forward (training), which returns no cache.
        cache_pos: int or (B,) tensor, the slot of this call's first token;
            with a tensor, rows at or past the slab's end are dropped.
        live_window: ((B,) start, (B,) end) live region of each stream's
            slab; with S = 1 attention runs in kernel A over it.
        remat: "full" | "dots" | None, per-layer rematerialization of the
            stateless forward (``ops.remat``); values are unchanged.
    Returns:
        (h_out (B, S, D) after the final norm, the cache or None).
    """
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_base)
    # one unbind per stacked leaf: its backward stacks the layers' gradients
    # once, where a slice per layer would add L full-size zero-padded ones
    names = [n for n in params if n != "final_norm"]
    layers = [dict(zip(names, per_layer)) for per_layer in
              zip(*(params[n].unbind(0) for n in names))]
    if cache is None:
        body = _layer_stateless
        if remat:
            body = remat_layer(body, remat)
        for lp in layers:
            h = body(h, lp, cfg, cos, sin, mask)
        return rms_norm(h, params["final_norm"], cfg.norm_eps), None

    bounded = None
    if live_window is not None and h.shape[1] == 1:
        start, end = live_window
        bounded = (start, positions[:, 0].to(torch.int32) + 1,
                   start.min(), end.max())
    k4, v4 = cache["k"], cache["v"]
    write = None
    if torch.is_tensor(cache_pos):
        B, S = h.shape[:2]
        rows, keep = slab_write_rows(cache_pos, S, k4.shape[2])
        bidx = torch.arange(B, device=h.device)[:, None]
        write = (bidx, rows, keep, k4[:, bidx, rows], v4[:, bidx, rows])
    for layer, lp in enumerate(layers):
        h = _layer(h, lp, cfg, cos, sin, mask, k4, v4, layer, cache_pos,
                   bounded, write)
    return rms_norm(h, params["final_norm"], cfg.norm_eps), cache
