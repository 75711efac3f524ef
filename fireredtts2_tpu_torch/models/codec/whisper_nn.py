"""Whisper-style pre-LN transformer layers: the vocoder backbone's slab
decode and the codec's encoders.

Counterpart of ``fireredtts2_tpu/models/codec/whisper_nn.py``. Layer
parameters are stacked on a leading L axis; k has no bias, q/v/out do.
- Slab decode (the streaming vocoder): the KV cache is a MERGED
  (L, B, T, H*Dh) slab pair written in place by kernel C
  (``ops.flash_decode.flash_decode_update_bounded``).
- Stateless (the SSL and acoustic encoders, the SSL adaptor): masked
  attention over the whole window, plain PyTorch (``ops.attention.
  mha_attention``), as the JAX package runs it as plain XLA. The encoders
  take fp32 log-mels, so with bf16 weights their activations stay fp32:
  mixed products promote, as JAX's type promotion does.

``quantize_whisper_layers_int8`` makes the vocoder's matmuls weight-only
int8; they then take ``ops.quant.quantized_matmul``'s plain dequant route,
as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from fireredtts2_tpu_torch.ops.attention import mha_attention
from fireredtts2_tpu_torch.ops.flash_decode import flash_decode_update_bounded
from fireredtts2_tpu_torch.ops.precision import pconv1d
from fireredtts2_tpu_torch.ops.quant import quantize_tree, quantized_matmul

Params = dict[str, Any]


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def sinusoids(length: int, channels: int, max_timescale: float = 10_000.0
              ) -> np.ndarray:
    """Whisper's sinusoidal position table, (length, channels) float32."""
    assert channels % 2 == 0
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


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


_WHISPER_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "fc1_w", "fc2_w")


def quantize_whisper_layers_int8(params: Params) -> Params:
    """Weight-only int8 (per-output-channel symmetric) for a stacked
    whisper layer tree: each matmul becomes int8 plus ``name + "_scale"``
    (L, 1, out) float32. Norms and biases stay."""
    return quantize_tree(params, _WHISPER_MATMUL_KEYS, bits=8)


def _whisper_layer(h: torch.Tensor, lp: Params, num_heads: int,
                   mask: torch.Tensor | None) -> torch.Tensor:
    """One stateless layer over the whole window; mask (B, S, S) bool,
    True = attend."""
    B, S, D = h.shape
    Dh = D // num_heads
    x = layer_norm(h, lp["attn_ln_w"], lp["attn_ln_b"])
    q = (quantized_matmul(x, lp, "wq") + lp["bq"]).reshape(B, S, num_heads, Dh)
    k = quantized_matmul(x, lp, "wk").reshape(B, S, num_heads, Dh)
    v = (quantized_matmul(x, lp, "wv") + lp["bv"]).reshape(B, S, num_heads, Dh)
    attn = mha_attention(q, k, v, mask)
    o = quantized_matmul(attn.reshape(B, S, D), lp, "wo")
    h = h + (o + lp["bo"]).to(h.dtype)
    x = layer_norm(h, lp["ffn_ln_w"], lp["ffn_ln_b"])
    x = F.gelu(quantized_matmul(x, lp, "fc1_w") + lp["fc1_b"])
    return h + (quantized_matmul(x, lp, "fc2_w") + lp["fc2_b"]).to(h.dtype)


def _whisper_layer_slab4(h: torch.Tensor, lp: Params, layer: int,
                         num_heads: int, k4: torch.Tensor, v4: torch.Tensor,
                         pos: torch.Tensor, q_end: torch.Tensor, live_hi
                         ) -> torch.Tensor:
    """One slab-decode layer: this chunk's K/V rows go into slab[layer] in
    place (kernel C writes them, then attends)."""
    B, S, D = h.shape
    Dh = D // num_heads
    x = layer_norm(h, lp["attn_ln_w"], lp["attn_ln_b"])
    q = (quantized_matmul(x, lp, "wq") + lp["bq"]).reshape(B, S, num_heads, Dh)
    kw = quantized_matmul(x, lp, "wk")
    vw = quantized_matmul(x, lp, "wv") + lp["bv"]
    attn = flash_decode_update_bounded(q, kw, vw, k4, v4, layer, pos, q_end,
                                       live_hi)
    o = quantized_matmul(attn.reshape(B, S, D), lp, "wo")
    h = h + (o + lp["bo"]).to(h.dtype)
    x = layer_norm(h, lp["ffn_ln_w"], lp["ffn_ln_b"])
    x = F.gelu(quantized_matmul(x, lp, "fc1_w") + lp["fc1_b"])
    return h + (quantized_matmul(x, lp, "fc2_w") + lp["fc2_b"]).to(h.dtype)


def whisper_layers_forward(params: Params, num_heads: int, h: torch.Tensor,
                           cache: dict[str, torch.Tensor] | None = None,
                           cache_pos: torch.Tensor | None = None,
                           q_end: torch.Tensor | None = None, live_hi=None,
                           mask: torch.Tensor | None = None,
                           ) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
    """Run the layer stack.

    Without a cache: stateless, every layer attends over the whole window
    under `mask` (B, S, S) (the encoders). With one: slab decode. cache:
    (L, B, T, H*Dh) k/v slabs (updated in place); cache_pos (B,) int32
    per-stream write slots; q_end (B, S) exclusive per-query bounds;
    live_hi the batch's max live slot (every query must see >= 1 slot)."""
    L = params["wq"].shape[0]
    if cache is None:
        for layer in range(L):
            h = _whisper_layer(h, {name: t[layer] for name, t in params.items()},
                               num_heads, mask)
        return h, None
    assert cache_pos.ndim == 1, "slab decode needs (B,) positions"
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


# ---------------------------------------------------------------------------
# Full whisper encoder (conv frontend + positions + layers + final LN)
# ---------------------------------------------------------------------------


def init_conv1d(gen: torch.Generator, in_ch: int, out_ch: int, k: int,
                dtype=torch.float32, device=None, bias: bool = True) -> Params:
    """Torch-layout (out, in, k) weights, normal * 0.02; zero bias."""
    w = (torch.randn((out_ch, in_ch, k), generator=gen, dtype=torch.float32,
                     device=device) * 0.02).to(dtype)
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((out_ch,), dtype=dtype, device=device)
    return p


def conv1d(x: torch.Tensor, p: Params, stride: int = 1, padding: int = 0
           ) -> torch.Tensor:
    """x (B, C, T) -> (B, C', T'); weights cast to x's dtype, full fp32 for
    fp32 x (``ops.precision``), the bias added in the output's dtype."""
    y = pconv1d(x, p["w"].to(x.dtype), stride, padding)
    if "b" in p:
        y = y + p["b"].to(y.dtype)[None, :, None]
    return y


def init_whisper_encoder(gen: torch.Generator, in_dim: int, embed_dim: int,
                         num_layers: int, num_heads: int, ffn_dim: int,
                         max_positions: int, dtype=torch.float32, device=None
                         ) -> Params:
    """Random encoder params in the JAX tree layout."""
    return {
        "conv1": init_conv1d(gen, in_dim, embed_dim, 3, dtype, device),
        "conv2": init_conv1d(gen, embed_dim, embed_dim, 3, dtype, device),
        "pos": torch.from_numpy(sinusoids(max_positions, embed_dim))
        .to(device=device, dtype=dtype),
        "layers": init_whisper_layers(gen, num_layers, embed_dim, ffn_dim,
                                      dtype, device),
        "ln_w": torch.ones((embed_dim,), dtype=dtype, device=device),
        "ln_b": torch.zeros((embed_dim,), dtype=dtype, device=device),
    }


def whisper_encoder_forward(params: Params, num_heads: int, mel: torch.Tensor,
                            mel_lengths: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """mel (B, T, n_mels) -> ((B, T//2, D), lengths // 2): two GELU convs
    (k3 p1; k3 s2 p1), sinusoid positions, the layers with padded keys
    masked out, a final layer norm."""
    x = mel.transpose(1, 2)                              # (B, n_mels, T)
    x = F.gelu(conv1d(x, params["conv1"], 1, 1))
    x = F.gelu(conv1d(x, params["conv2"], 2, 1))
    x = x.transpose(1, 2)                                # (B, T', D)
    lengths = mel_lengths // 2
    x = x + params["pos"][None, :x.shape[1], :].to(x.dtype)
    T = x.shape[1]
    valid = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
    mask = valid[:, None, :].expand(-1, T, -1)           # keys masked
    h, _ = whisper_layers_forward(params["layers"], num_heads, x, mask=mask)
    return layer_norm(h, params["ln_w"], params["ln_b"]), lengths
