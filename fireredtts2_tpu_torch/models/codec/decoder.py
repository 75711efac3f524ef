"""Acoustic decoder / streaming vocoder: UpConv, causal Vocos backbone,
iSTFT head.

Counterpart of ``fireredtts2_tpu/models/codec/decoder.py``: the batch
decoder (``acoustic_decoder_forward``, causal and non-causal: whole
utterances, training and offline decode, plain PyTorch as JAX runs it as
plain XLA) and the causal streaming path. Every streaming cache has a
fixed shape; the attention cache is a preallocated MERGED (L, B, T, H*Dh)
slab that kernel C writes in place. Streaming decodes K tokens per backbone
pass (``stream_decode_block_batched``, ``stream_decode_scan``) or one
(``stream_decode_chunk``, the reference's one-token route). The small
conv and iSTFT caches are replaced by new tensors per chunk.
Layout: features (B, T, C); convs transpose internally; conv weights keep
the torch (out, in, k) / transposed-conv (in, out, k) layouts the JAX
package stores.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch
import torch.nn.functional as F

from fireredtts2_tpu_torch.config import AcousticDecoderConfig
from fireredtts2_tpu_torch.weights import host_to_device
from fireredtts2_tpu_torch.ops import masks as mask_ops
from fireredtts2_tpu_torch.ops.stft import (
    hann_tensor, irfft_frames, istft, istft_chunk, overlap_add,
    window_envelope,
)
from fireredtts2_tpu_torch.models.codec.whisper_nn import (
    conv1d as wconv1d, init_kv_slab, init_whisper_layers, layer_norm,
    whisper_layers_forward,
)

Params = dict[str, Any]

VOCODER_CHUNK = 8  # 100 Hz latents per 12.5 Hz token


# ---------------------------------------------------------------------------
# Primitive convs
# ---------------------------------------------------------------------------


def conv1d(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Valid conv, stride 1: x (B, C, T) -> (B, C', T - k + 1); weights
    (out, in, k). The bias is added after the conv, in x's dtype, as in the
    JAX package."""
    return F.conv1d(x, p["w"].to(x.dtype)) + p["b"].to(x.dtype)[None, :, None]


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, stride: int,
                     bias: torch.Tensor) -> torch.Tensor:
    """Torch-semantics ConvTranspose1d, padding 0. x (B, C_in, T); w
    (C_in, C_out, K) -> (B, C_out, (T-1)*stride + K)."""
    y = F.conv_transpose1d(x, w.to(x.dtype), None, stride)
    return y + bias.to(y.dtype)[None, :, None]


def causal_conv1d(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Batch causal conv: left-pad k-1 zeros, then a valid conv (full fp32
    for fp32 x, ``ops.precision``). x (B, C, T) -> (B, C', T)."""
    k = p["w"].shape[-1]
    return wconv1d(F.pad(x, (k - 1, 0)), p, 1, 0)


def causal_conv1d_chunk(x: torch.Tensor, p: Params, cache: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming causal conv: cache (B, C, k-1) holds the previous tail;
    a zero cache equals the batch path's zero left-pad."""
    k = p["w"].shape[-1]
    xin = torch.cat([cache.to(x.dtype), x], dim=-1)
    return conv1d(xin, p), xin[..., -(k - 1):]


def _init_conv1d(gen, in_ch, out_ch, k, dtype, device) -> Params:
    w = torch.randn((out_ch, in_ch, k), generator=gen, dtype=torch.float32,
                    device=device) * 0.02
    return {"w": w.to(dtype),
            "b": torch.zeros((out_ch,), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# UpConv (12.5 Hz tokens -> 50 Hz latents)
# ---------------------------------------------------------------------------


def init_upconv(gen: torch.Generator, embed_dim: int, stride: int,
                dtype=torch.float32, device=None) -> Params:
    d, s = embed_dim, stride

    def w(*shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * 0.02).to(dtype)

    return {"in_proj_w": w(d, s * d),
            "in_proj_b": torch.zeros((s * d,), dtype=dtype, device=device),
            "up_conv_w": w(s * d, d, s)}


def upconv_forward(params: Params, stride: int, x: torch.Tensor
                   ) -> torch.Tensor:
    """x (B, T, D) -> (B, T*stride, D): kernel == stride, so each input step
    produces `stride` outputs by one matmul."""
    B, T, D = x.shape
    h = x @ params["in_proj_w"] + params["in_proj_b"]
    y = torch.einsum("bti,ioj->btjo", h, params["up_conv_w"].to(h.dtype))
    return y.reshape(B, T * stride, D)


# ---------------------------------------------------------------------------
# Causal resnet block (LN -> SiLU -> CausalConv, twice)
# ---------------------------------------------------------------------------


def init_causal_resnet(gen, dim: int, dtype=torch.float32, device=None
                       ) -> Params:
    def const(value):
        return torch.full((dim,), value, dtype=dtype, device=device)

    return {"ln1_w": const(1.0), "ln1_b": const(0.0),
            "conv1": _init_conv1d(gen, dim, dim, 3, dtype, device),
            "ln2_w": const(1.0), "ln2_b": const(0.0),
            "conv2": _init_conv1d(gen, dim, dim, 3, dtype, device)}


def causal_resnet_forward(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Batch causal resnet block, x (B, T, C)."""
    h = F.silu(layer_norm(x, p["ln1_w"], p["ln1_b"]))
    h = causal_conv1d(h.transpose(1, 2), p["conv1"]).transpose(1, 2)
    h = F.silu(layer_norm(h, p["ln2_w"], p["ln2_b"]))
    h = causal_conv1d(h.transpose(1, 2), p["conv2"]).transpose(1, 2)
    return x + h


def causal_resnet_chunk(p: Params, x: torch.Tensor, cache1: torch.Tensor,
                        cache2: torch.Tensor):
    h = F.silu(layer_norm(x, p["ln1_w"], p["ln1_b"]))
    h, c1 = causal_conv1d_chunk(h.transpose(1, 2), p["conv1"], cache1)
    h = F.silu(layer_norm(h.transpose(1, 2), p["ln2_w"], p["ln2_b"]))
    h, c2 = causal_conv1d_chunk(h.transpose(1, 2), p["conv2"], cache2)
    return x + h.transpose(1, 2), c1, c2


# ---------------------------------------------------------------------------
# Acoustic decoder
# ---------------------------------------------------------------------------


def group_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over the channels of (B, C, T), in fp32."""
    B, C, T = x.shape
    xf = x.to(torch.float32).reshape(B, groups, C // groups, T)
    mu = xf.mean(dim=(2, 3), keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=(2, 3), keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(B, C, T)
    return (y * w.to(torch.float32)[None, :, None]
            + b.to(torch.float32)[None, :, None]).to(x.dtype)


def init_resnet(gen, dim: int, dtype=torch.float32, device=None) -> Params:
    """Non-causal resnet block: GroupNorm -> SiLU -> Conv(k3, p1), twice."""
    def const(value):
        return torch.full((dim,), value, dtype=dtype, device=device)

    return {"gn1_w": const(1.0), "gn1_b": const(0.0),
            "conv1": _init_conv1d(gen, dim, dim, 3, dtype, device),
            "gn2_w": const(1.0), "gn2_b": const(0.0),
            "conv2": _init_conv1d(gen, dim, dim, 3, dtype, device)}


def resnet_forward(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Non-causal resnet block, x (B, T, C)."""
    h = x.transpose(1, 2)
    h = wconv1d(F.silu(group_norm(h, p["gn1_w"], p["gn1_b"])), p["conv1"], 1, 1)
    h = wconv1d(F.silu(group_norm(h, p["gn2_w"], p["gn2_b"])), p["conv2"], 1, 1)
    return x + h.transpose(1, 2)


def init_acoustic_decoder(gen: torch.Generator, cfg: AcousticDecoderConfig,
                          dtype=torch.float32, device=None) -> Params:
    """Random params of the decoder in the JAX tree layout: causal resnets
    (LayerNorm) for the causal decoder, GroupNorm ones otherwise."""
    d = cfg.embed_dim
    resnet = init_causal_resnet if cfg.causal else init_resnet

    def w(*shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * 0.02).to(dtype)

    def const(value, n):
        return torch.full((n,), value, dtype=dtype, device=device)

    return {
        "up1_w": w(d, d, 3), "up1_b": const(0.0, d),
        "up2_w": w(d, d, 3), "up2_b": const(0.0, d),
        "in_proj": _init_conv1d(gen, d, d, 7, dtype, device),
        "prior0": resnet(gen, d, dtype, device),
        "prior1": resnet(gen, d, dtype, device),
        "layers": init_whisper_layers(gen, cfg.num_layers, d, 4 * d, dtype,
                                      device),
        "post0": resnet(gen, d, dtype, device),
        "post1": resnet(gen, d, dtype, device),
        "final_ln_w": const(1.0, d), "final_ln_b": const(0.0, d),
        "head_w": w(d, cfg.n_fft + 2), "head_b": const(0.0, cfg.n_fft + 2),
    }


def _upsample_batch(params: Params, x: torch.Tensor) -> torch.Tensor:
    """50 -> 100 Hz: ConvT(k3, s2) + GELU + ConvT(k3, s1) + GELU, trimmed
    to 2T. x (B, T, D) -> (B, 2T, D)."""
    target = 2 * x.shape[1]
    h = x.transpose(1, 2)
    h = F.gelu(conv_transpose1d(h, params["up1_w"], 2, params["up1_b"]))
    h = F.gelu(conv_transpose1d(h, params["up2_w"], 1, params["up2_b"]))
    return h.transpose(1, 2)[:, :target]


def _head_spectrum(params: Params, x: torch.Tensor):
    """Vocos iSTFT head: hidden -> (re, im), each (B, F, T) float32."""
    pred = (x @ params["head_w"] + params["head_b"]).to(torch.float32)
    pred = pred.transpose(1, 2)
    F_ = pred.shape[1] // 2
    mag = torch.clamp(torch.exp(pred[:, :F_]), max=1e2)
    phase = pred[:, F_:]
    return mag * torch.cos(phase), mag * torch.sin(phase)


def acoustic_decoder_forward(params: Params, cfg: AcousticDecoderConfig,
                             x: torch.Tensor, lengths: torch.Tensor,
                             remat: str | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch decode: x (B, T50, D) 50 Hz latents, lengths at 50 Hz ->
    ((B, T50 * 2 * hop) audio, lengths * 2 * hop). The causal decoder's
    attention is 8-block-causal, so batch equals streaming; the non-causal
    one (same-padded convs, GroupNorm resnets) attends to every non-pad
    key. `remat` applies per layer to the attention stack."""
    h = _upsample_batch(params, x)
    T = h.shape[1]
    lengths = lengths * 2
    hc = h.transpose(1, 2)
    if cfg.causal:
        hc = causal_conv1d(hc, params["in_proj"]).transpose(1, 2)
        block = causal_resnet_forward
        mask = mask_ops.block_causal_mask(lengths, T, VOCODER_CHUNK)
    else:
        hc = wconv1d(hc, params["in_proj"], 1, 3).transpose(1, 2)
        block = resnet_forward
        mask = mask_ops.nonpad_mask(lengths, T)[:, None, :].expand(-1, T, -1)
    hc = block(params["prior1"], block(params["prior0"], hc))
    hc, _ = whisper_layers_forward(params["layers"], cfg.num_heads, hc,
                                   mask=mask, remat=remat)
    hc = block(params["post1"], block(params["post0"], hc))
    hc = layer_norm(hc, params["final_ln_w"], params["final_ln_b"], eps=1e-6)
    re, im = _head_spectrum(params, hc)
    return istft(re, im, cfg.n_fft, cfg.hop_length), lengths * cfg.hop_length


# ---------------------------------------------------------------------------
# Streaming
# ---------------------------------------------------------------------------


@dataclass
class VocoderStreamState:
    """Fixed-shape streaming state. kv_k/kv_v are written in place; the
    other caches are replaced by new tensors every chunk."""
    up1_cache: torch.Tensor      # (B, D, 1) acoustic ConvT k3 s2 input tail
    up2_cache: torch.Tensor      # (B, D, 2) acoustic ConvT k3 s1 input tail
    in_proj_cache: torch.Tensor  # (B, D, 6) backbone CausalConv k7
    rb_caches: torch.Tensor      # (4, 2, B, D, 2) four resnets x two convs
    kv_k: torch.Tensor           # (L, B, T_max, H*Dh) merged attention slab
    kv_v: torch.Tensor
    istft_cache: torch.Tensor    # (B, n_fft, 3) trailing windowed frames
    pos: torch.Tensor            # (B,) int32 latents written so far


def stream_state_init(cfg: AcousticDecoderConfig, batch: int,
                      dtype=torch.float32, device=None,
                      latents: int | None = None) -> VocoderStreamState:
    """latents: the KV capacity in 100 Hz latents, 8 per 12.5 Hz token
    (default cfg.max_stream_latents; a pool capped at F frames needs 8F).
    It must be a multiple of 16."""
    d = cfg.embed_dim
    cap = latents or cfg.max_stream_latents
    if cap % 16:
        raise ValueError(f"vocoder latent capacity {cap} not 16-aligned")
    slab = init_kv_slab(cfg.num_layers, batch, cap, cfg.num_heads,
                        d // cfg.num_heads, dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return VocoderStreamState(
        up1_cache=zeros(batch, d, 1), up2_cache=zeros(batch, d, 2),
        in_proj_cache=zeros(batch, d, 6), rb_caches=zeros(4, 2, batch, d, 2),
        kv_k=slab["k"], kv_v=slab["v"],
        istft_cache=zeros(batch, cfg.n_fft, 3),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def reset_vocoder_slots(state: VocoderStreamState, bs) -> VocoderStreamState:
    """Zero a vector of slots' caches (new streams claim them): the conv
    and iSTFT caches as new tensors, the addressed rows of the KV slabs in
    place, their positions 0. Ids equal to B are padding and dropped."""
    B = state.pos.shape[0]
    bs = torch.as_tensor(bs).to(torch.int64).reshape(-1)
    ids = host_to_device(bs[(bs >= 0) & (bs < B)], state.pos.device)

    def zero_rows(t: torch.Tensor, dim: int) -> torch.Tensor:
        return t.index_fill(dim, ids, 0)

    state.kv_k.index_fill_(1, ids, 0)
    state.kv_v.index_fill_(1, ids, 0)
    return replace(state, up1_cache=zero_rows(state.up1_cache, 0),
                   up2_cache=zero_rows(state.up2_cache, 0),
                   in_proj_cache=zero_rows(state.in_proj_cache, 0),
                   rb_caches=zero_rows(state.rb_caches, 2),
                   istft_cache=zero_rows(state.istft_cache, 0),
                   pos=zero_rows(state.pos, 0))


def reset_vocoder_slot(state: VocoderStreamState, b: int) -> VocoderStreamState:
    """Zero one slot's caches (:func:`reset_vocoder_slots` of [b])."""
    return reset_vocoder_slots(state, [b])


def _upsample_chunk(params: Params, x: torch.Tensor, up1_cache, up2_cache):
    """Streaming 50->100 Hz upsample of 4*G latents: (B, 4G, D) ->
    (B, 8G, D); zero caches reproduce the first-chunk path."""
    h = x.transpose(1, 2)
    hin = torch.cat([up1_cache.to(h.dtype), h], dim=-1)
    new_up1 = hin[..., -1:]
    y = conv_transpose1d(hin, params["up1_w"], 2, params["up1_b"])[..., :-1]
    y = F.gelu(y[..., 2:])
    yin = torch.cat([up2_cache.to(y.dtype), y], dim=-1)
    new_up2 = yin[..., -2:]
    z = conv_transpose1d(yin, params["up2_w"], 1, params["up2_b"])[..., :-2]
    z = F.gelu(z[..., 2:])
    return z.transpose(1, 2), new_up1, new_up2


def stream_decode_chunk(params: Params, cfg: AcousticDecoderConfig,
                        x: torch.Tensor, state: VocoderStreamState,
                        first: bool, last: bool
                        ) -> tuple[torch.Tensor, VocoderStreamState]:
    """Decode one token's latents to ~80 ms of audio: the reference's
    one-token ``decode_one_token`` route.

    x: (B, 4, D) 50 Hz latents of ONE 12.5 Hz token (from UpConv); first /
    last: the chunk's place in the utterance, which only sets how much of
    the fully overlapped iSTFT output is emitted (``ops.stft.istft_chunk``).
    The 8 latents attend 8-block-causally through kernel C at S=8 (slab
    rows written at min(pos, T - 8), as the other vocoder routes write).
    Returns (audio (B, n), the new state); the chained outputs concatenate
    to the batch decoder's waveform."""
    (re, im), new_state = _vocoder_spectra(params, cfg, x, state)
    audio, istft_cache = istft_chunk(
        re, im, None if first else state.istft_cache.to(re.dtype),
        cfg.n_fft, cfg.hop_length, last_chunk=last)
    return audio, replace(new_state,
                          istft_cache=istft_cache.to(state.istft_cache.dtype))


def _vocoder_spectra(params: Params, cfg: AcousticDecoderConfig,
                     x: torch.Tensor, state: VocoderStreamState):
    """Streaming front (upsample, convs, attention, head) for whole tokens:
    x (B, 4G, D) -> the head's spectra ((B, F, 8G) re, im, float32), and
    the new state but its istft_cache. The attention is 8-block-causal:
    latent q of the chunk sees slots < pos + 8*(q//8 + 1)."""
    h, up1, up2 = _upsample_chunk(params, x, state.up1_cache, state.up2_cache)
    S = h.shape[1]
    hc, in_cache = causal_conv1d_chunk(h.transpose(1, 2), params["in_proj"],
                                       state.in_proj_cache)
    hc = hc.transpose(1, 2)
    rb = state.rb_caches
    hc, c0a, c0b = causal_resnet_chunk(params["prior0"], hc, rb[0, 0], rb[0, 1])
    hc, c1a, c1b = causal_resnet_chunk(params["prior1"], hc, rb[1, 0], rb[1, 1])
    ar = torch.arange(S, dtype=torch.int32, device=x.device)
    q_end = state.pos[:, None] + ((ar[None, :] // VOCODER_CHUNK) + 1) \
        * VOCODER_CHUNK
    hc, _ = whisper_layers_forward(
        params["layers"], cfg.num_heads, hc,
        {"k": state.kv_k, "v": state.kv_v}, state.pos, q_end,
        state.pos.max() + S)
    hc, c2a, c2b = causal_resnet_chunk(params["post0"], hc, rb[2, 0], rb[2, 1])
    hc, c3a, c3b = causal_resnet_chunk(params["post1"], hc, rb[3, 0], rb[3, 1])
    hc = layer_norm(hc, params["final_ln_w"], params["final_ln_b"], eps=1e-6)
    rbc = torch.stack([torch.stack([c0a, c0b]), torch.stack([c1a, c1b]),
                       torch.stack([c2a, c2b]), torch.stack([c3a, c3b])])
    new_state = replace(
        state, up1_cache=up1, up2_cache=up2, in_proj_cache=in_cache,
        rb_caches=rbc.to(state.rb_caches.dtype), pos=state.pos + S)
    return _head_spectrum(params, hc), new_state


def _vocoder_backbone_chunk(params: Params, cfg: AcousticDecoderConfig,
                            x: torch.Tensor, state: VocoderStreamState
                            ) -> tuple[torch.Tensor, VocoderStreamState]:
    """:func:`_vocoder_spectra`, then the windowed ifft frames (B, n_fft,
    8G), with the new state's istft_cache = the trailing frames."""
    (re, im), new_state = _vocoder_spectra(params, cfg, x, state)
    w = hann_tensor(cfg.n_fft, torch.float32, x.device)
    frames = irfft_frames(re, im, cfg.n_fft) * w[None, :, None]
    r_1 = cfg.n_fft // cfg.hop_length - 1
    return frames, replace(
        new_state, istft_cache=frames[..., -r_1:].to(state.istft_cache.dtype))


def _norm_ola(frames: torch.Tensor, hop: int, n_fft: int) -> torch.Tensor:
    y = overlap_add(frames, hop)
    env = window_envelope(n_fft, hop, frames.shape[-1], dtype=y.dtype,
                          device=y.device)
    return y / torch.clamp(env[None, :], min=1e-11)


def _cut_tail(win: torch.Tensor, hop: int, n_fft: int) -> torch.Tensor:
    """The closing samples after a cut, from the r-1 windowed frames
    before it: (B, n_fft, r-1) -> (B, (n_fft - hop) - pad)."""
    pad = (n_fft - hop) // 2
    y = _norm_ola(win.to(torch.float32), hop, n_fft)
    start = win.shape[-1] * hop
    return y[:, start:start + (n_fft - hop) - pad]


def stream_decode_block_batched(params: Params, cfg: AcousticDecoderConfig,
                                x: torch.Tensor, state: VocoderStreamState,
                                is_first: torch.Tensor):
    """K tokens per slot in ONE backbone pass.

    Args:
        x: (B, 4K, D) 50 Hz latents; is_first: (B,) bool, a slot's first
            block.
    Returns:
        (middle (B, K*8*hop) -- for first blocks the leading `lead` samples
         are zero padding; tails (K, B, (n_fft-hop) - pad) -- tails[j] is
         the closing emission if token j were the slot's last; new state).
    """
    n_fft, hop = cfg.n_fft, cfg.hop_length
    pad = (n_fft - hop) // 2
    r_1 = n_fft // hop - 1
    K = x.shape[1] // 4
    prev_cache = state.istft_cache
    frames, new_state = _vocoder_backbone_chunk(params, cfg, x, state)

    frames_cat = torch.cat([prev_cache.to(frames.dtype), frames], dim=-1)
    mid_rest = _norm_ola(frames_cat, hop, n_fft)[:, (n_fft - hop):-(n_fft - hop)]
    mid_first = _norm_ola(frames, hop, n_fft)[:, pad:-(n_fft - hop)]
    lead = mid_rest.shape[1] - mid_first.shape[1]
    mid_first = F.pad(mid_first, (lead, 0))
    middle = torch.where(is_first[:, None], mid_first, mid_rest)
    tails = torch.stack([_cut_tail(frames[..., 8 * j + 8 - r_1: 8 * j + 8],
                                   hop, n_fft) for j in range(K)])
    return middle, tails, new_state


def stream_decode_tail(cfg: AcousticDecoderConfig, state: VocoderStreamState
                       ) -> torch.Tensor:
    """The closing samples held back after the last chunk, from the cached
    trailing frames: (B, (n_fft - hop) - pad)."""
    return _cut_tail(state.istft_cache, cfg.hop_length, cfg.n_fft)


def stream_decode_scan(params: Params, cfg: AcousticDecoderConfig,
                       latents: torch.Tensor, group: int = 8):
    """Decode many tokens' latents with exact streaming semantics, `group`
    tokens (8*group queries) per backbone pass.

    Per token t: middle[t] (B, 8*hop) -- for t == 0 only the trailing
    samples are valid (left zero-padded) -- and tail[t] (B, (n_fft-hop) -
    pad), the closing emission if t were the last real token. Assembly for
    true length T: concat(middle[0][lead:], middle[1:T], tail[T-1]).

    Args:
        latents: (B, L*4, D) 50 Hz latents (L tokens); L % group == 0, else
            group falls back to 1.
    Returns:
        (middles (L, B, 8*hop), tails (L, B, n_fft-hop-pad)).
    """
    B = latents.shape[0]
    L = latents.shape[1] // 4
    if L % group:
        group = 1
    G = group
    n_fft, hop = cfg.n_fft, cfg.hop_length
    pad = (n_fft - hop) // 2
    r_1 = n_fft // hop - 1
    state = stream_state_init(cfg, B, latents.dtype, device=latents.device)

    def emit(y_frames, first: bool):
        y = _norm_ola(y_frames, hop, n_fft)
        if first:
            middle = y[:, pad:-(n_fft - hop)]
            middle = F.pad(middle, (VOCODER_CHUNK * hop - middle.shape[1], 0))
        else:
            middle = y[:, (n_fft - hop):-(n_fft - hop)]
        return middle, y[:, -(n_fft - hop):-pad]

    mids, tls = [], []
    for t in range(L // G):
        x = latents[:, 4 * G * t: 4 * G * (t + 1)]
        prev_cache = state.istft_cache
        frames, state = _vocoder_backbone_chunk(params, cfg, x, state)
        frames_cat = torch.cat([prev_cache.to(frames.dtype), frames], dim=-1)
        for g in range(G):
            if g == 0 and t == 0:
                middle, tail = emit(frames[..., :8], first=True)
            else:
                middle, tail = emit(frames_cat[..., 8 * g: 8 * g + 8 + r_1],
                                    first=False)
            mids.append(middle)
            tls.append(tail)
    return torch.stack(mids), torch.stack(tls)
