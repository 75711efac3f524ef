"""Whisper-style pre-LN transformer layers: the vocoder backbone's slab
decode.

Counterpart of ``fireredtts2_tpu/models/codec/whisper_nn.py`` (the slab
path; the encoders belong to prompt encoding, a later slice). Layer
parameters are stacked on a leading L axis; k has no bias, q/v/out do.
The streaming KV cache is a MERGED (L, B, T, H*Dh) slab pair written in
place by kernel C (``ops.flash_decode.flash_decode_update_bounded``).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from fireredtts2_tpu_torch.ops.flash_decode import flash_decode_update_bounded

Params = dict[str, Any]


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def init_whisper_layers(gen: torch.Generator, num_layers: int, dim: int,
                        ffn_dim: int, dtype=torch.float32, device=None
                        ) -> Params:
    """Stacked (L, ...) random params in the JAX tree layout."""
    L, D, Fd = num_layers, dim, ffn_dim

    def w(*shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * 0.02).to(dtype)

    def const(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "wq": w(L, D, D), "bq": const(0.0, L, D),
        "wk": w(L, D, D),
        "wv": w(L, D, D), "bv": const(0.0, L, D),
        "wo": w(L, D, D), "bo": const(0.0, L, D),
        "attn_ln_w": const(1.0, L, D), "attn_ln_b": const(0.0, L, D),
        "fc1_w": w(L, D, Fd), "fc1_b": const(0.0, L, Fd),
        "fc2_w": w(L, Fd, D), "fc2_b": const(0.0, L, D),
        "ffn_ln_w": const(1.0, L, D), "ffn_ln_b": const(0.0, L, D),
    }


def _whisper_layer_slab4(h: torch.Tensor, lp: Params, layer: int,
                         num_heads: int, k4: torch.Tensor, v4: torch.Tensor,
                         pos: torch.Tensor, q_end: torch.Tensor, live_hi
                         ) -> torch.Tensor:
    """One slab-decode layer: this chunk's K/V rows go into slab[layer] in
    place (kernel C writes them, then attends)."""
    B, S, D = h.shape
    Dh = D // num_heads
    x = layer_norm(h, lp["attn_ln_w"], lp["attn_ln_b"])
    q = (x @ lp["wq"] + lp["bq"]).reshape(B, S, num_heads, Dh)
    kw = x @ lp["wk"]
    vw = x @ lp["wv"] + lp["bv"]
    attn = flash_decode_update_bounded(q, kw, vw, k4, v4, layer, pos, q_end,
                                       live_hi)
    h = h + (attn.reshape(B, S, D) @ lp["wo"] + lp["bo"]).to(h.dtype)
    x = layer_norm(h, lp["ffn_ln_w"], lp["ffn_ln_b"])
    x = F.gelu(x @ lp["fc1_w"] + lp["fc1_b"])
    return h + (x @ lp["fc2_w"] + lp["fc2_b"]).to(h.dtype)


def whisper_layers_forward(params: Params, num_heads: int, h: torch.Tensor,
                           cache: dict[str, torch.Tensor], cache_pos: torch.Tensor,
                           q_end: torch.Tensor, live_hi
                           ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Slab decode through the layer stack. cache: (L, B, T, H*Dh) k/v
    slabs (updated in place); cache_pos (B,) int32 per-stream write slots;
    q_end (B, S) exclusive per-query bounds; live_hi the batch's max live
    slot (every query must see >= 1 slot)."""
    assert cache_pos.ndim == 1, "slab decode needs (B,) positions"
    L = params["wq"].shape[0]
    for layer in range(L):
        lp = {name: t[layer] for name, t in params.items()}
        h = _whisper_layer_slab4(h, lp, layer, num_heads, cache["k"],
                                 cache["v"], cache_pos, q_end, live_hi)
    return h, cache


def init_kv_slab(num_layers: int, batch: int, max_len: int, num_heads: int,
                 head_dim: int, dtype=torch.float32, device=None
                 ) -> dict[str, torch.Tensor]:
    """Zeroed MERGED (L, B, T, H*Dh) k and v slabs."""
    shape = (num_layers, batch, max_len, num_heads * head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
