"""Dual-transformer text-speech LM (backbone + depth decoder): the main
generation path.

Counterpart of ``fireredtts2_tpu/models/lm/model.py`` (generation subset:
no training loss, speculative depth, fused depth kernel, slot admission or
append-prefill yet). Frames interleave audio_num_codebooks audio columns
and one text column; the backbone samples codebook 0, the depth decoder
codebooks 1..N-1.

Sampling noise is an input: every frame takes a (B, ncb, V_audio) tensor of
Exp(1) draws, column 0 for codebook 0 and column i for depth codebook i.
The engine makes it from a generator seeded by (utterance seed, frame
index), so the whole-utterance loop and the streaming blocks sample the
same tokens.

KV slabs and the slot-validity map are updated IN PLACE (the JAX package
threads them as immutable state); ``LMState`` keeps pointing at the same
tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from fireredtts2_tpu_torch.config import LLMConfig
from fireredtts2_tpu_torch.ops import masks as mask_ops
from fireredtts2_tpu_torch.ops.sampling import sample_topk
from fireredtts2_tpu_torch.models.lm.transformer import (
    _normal, init_kv_cache, init_transformer_params, transformer_forward,
)

Params = dict[str, Any]


@dataclass
class LMState:
    """Decode state; the tensors are updated in place."""
    cache_k: torch.Tensor     # (L, B, T_max, Hkv*Dh) merged slab
    cache_v: torch.Tensor
    slot_valid: torch.Tensor  # (B, T_max) bool, which slots hold real tokens
    pos: torch.Tensor         # (B,) int32, next slab slot to write


def init_lm_params(gen: torch.Generator, cfg: LLMConfig, dtype=torch.float32,
                   device=None) -> Params:
    """Random weights in the JAX tree layout, drawn from `gen`: embeddings
    normal * 0.02, linear heads uniform(+-1/sqrt(in))."""
    bb, dec = cfg.backbone, cfg.decoder

    def emb(n, d):
        return _normal(gen, (n, d), 0.02, dtype, device)

    def lin(i, *out):
        bound = 1.0 / math.sqrt(i)
        u = torch.rand((i, *out), generator=gen, dtype=torch.float32,
                       device=device)
        return ((u * 2.0 - 1.0) * bound).to(dtype)

    ncb, V = cfg.audio_num_codebooks, cfg.audio_vocab_size
    return {
        "backbone": init_transformer_params(gen, bb, dtype, device),
        "decoder": init_transformer_params(gen, dec, dtype, device),
        "text_embeddings": emb(cfg.text_vocab_size, bb.embed_dim),
        "audio_embeddings": emb(V * ncb, bb.embed_dim),
        "projection": lin(bb.embed_dim, dec.embed_dim),
        "codebook0_head": lin(bb.embed_dim, V),
        "text_head": lin(bb.embed_dim, cfg.text_vocab_size),
        # (ncb-1, D_dec, V_audio), as the JAX tree stores it
        "audio_head": lin(dec.embed_dim, (ncb - 1) * V)
        .reshape(dec.embed_dim, ncb - 1, V).permute(1, 0, 2).contiguous(),
    }


KV_ALIGN = 512


def kv_capacity(max_seq_len: int) -> int:
    """Physical KV slab length: the logical cap rounded up to KV_ALIGN
    (3100 -> 3584)."""
    return -(-max_seq_len // KV_ALIGN) * KV_ALIGN


def init_lm_state(cfg: LLMConfig, batch_size: int, dtype=torch.float32,
                  device=None) -> LMState:
    cap = kv_capacity(cfg.max_seq_len)
    cache = init_kv_cache(cfg.backbone, batch_size, cap, dtype, device)
    return LMState(
        cache_k=cache["k"], cache_v=cache["v"],
        slot_valid=torch.zeros((batch_size, cap), dtype=torch.bool,
                               device=device),
        pos=torch.zeros((batch_size,), dtype=torch.int32, device=device),
    )


def embed_audio(params: Params, cfg: LLMConfig, codebook, tokens: torch.Tensor
                ) -> torch.Tensor:
    """Embeddings of audio tokens of one codebook (flat table with a
    per-codebook offset)."""
    idx = tokens.to(torch.int64) + codebook * cfg.audio_vocab_size
    return params["audio_embeddings"][idx]


def embed_tokens(params: Params, cfg: LLMConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """(B, S, C+1) int tokens -> (B, S, C+1, D) per-column embeddings. Text
    ids are clamped into the table, as JAX's gather clamps."""
    tokens = tokens.to(torch.int64)
    table = params["text_embeddings"]
    text = table[tokens[..., -1].clamp(0, table.shape[0] - 1)][..., None, :]
    offsets = torch.arange(cfg.audio_num_codebooks, device=tokens.device) \
        * cfg.audio_vocab_size
    audio = params["audio_embeddings"][tokens[..., :-1] + offsets]
    return torch.cat([audio, text], dim=-2)


def frame_hidden(params: Params, cfg: LLMConfig, tokens: torch.Tensor,
                 tokens_mask: torch.Tensor, dtype) -> torch.Tensor:
    """Masked sum of per-column embeddings -> (B, S, D)."""
    embeds = embed_tokens(params, cfg, tokens)
    return (embeds * tokens_mask[..., None].to(embeds.dtype)).sum(-2).to(dtype)


def _depth_decode(params: Params, cfg: LLMConfig, last_h: torch.Tensor,
                  c0: torch.Tensor, noise: torch.Tensor, depth_topk: int,
                  depth_temperature: float) -> torch.Tensor:
    """Sample codebooks 1..N-1 with the depth transformer over a fresh
    16-slot cache: an S=2 prefill of [last_h, embed(c0)], then single steps.
    Plain PyTorch (the JAX package's XLA loop; its fused Pallas chain is an
    opt-in serving preset, not ported yet). Returns (B, ncb) int32."""
    dec_cfg = cfg.decoder
    ncb = cfg.audio_num_codebooks
    B = last_h.shape[0]
    dtype, dev = last_h.dtype, last_h.device
    proj = params["projection"]
    heads = params["audio_head"]
    cache = init_kv_cache(dec_cfg, B, ncb, dtype, dev)

    e0 = embed_audio(params, cfg, 0, c0).to(dtype)
    h01 = torch.stack([last_h, e0], dim=1) @ proj
    pos01 = torch.arange(2, dtype=torch.int32, device=dev).expand(B, 2)
    hh, cache = transformer_forward(params["decoder"], dec_cfg, h01, pos01,
                                    mask_ops.decode_step_mask(pos01, ncb),
                                    cache, 0)
    logits = hh[:, -1].to(torch.float32) @ heads[0].to(torch.float32)
    prev = sample_topk(logits, depth_topk, depth_temperature, noise[:, 1])
    samples = [c0.to(torch.int32), prev]
    for i in range(2, ncb):
        emb = embed_audio(params, cfg, i - 1, prev).to(dtype)
        h = (emb @ proj)[:, None, :]
        pos = torch.full((B, 1), i, dtype=torch.int32, device=dev)
        hh, cache = transformer_forward(params["decoder"], dec_cfg, h, pos,
                                        mask_ops.decode_step_mask(pos, ncb),
                                        cache, i)
        logits = hh[:, -1].to(torch.float32) @ heads[i - 1].to(torch.float32)
        prev = sample_topk(logits, depth_topk, depth_temperature, noise[:, i])
        samples.append(prev)
    return torch.stack(samples, dim=1)


def lm_generate_frame(params: Params, cfg: LLMConfig, state: LMState,
                      tokens: torch.Tensor, tokens_mask: torch.Tensor,
                      valid: torch.Tensor, noise: torch.Tensor,
                      temperature: float = 0.9, topk: int = 20,
                      depth_topk: int = 10, depth_temperature: float = 0.75,
                      ) -> tuple[LMState, torch.Tensor]:
    """One AR step: consume a token window (B, S, C+1) -- a left-padded
    prompt bucket (prefill) or one frame (S = 1) -- and sample the next
    frame (B, ncb) int32. noise: (B, ncb, V_audio) Exp(1) draws."""
    B, S, _ = tokens.shape
    dtype = state.cache_k.dtype
    dev = tokens.device
    h = frame_hidden(params, cfg, tokens, tokens_mask, dtype)

    positions = state.pos[:, None] + torch.arange(S, dtype=torch.int32,
                                                  device=dev)[None]
    # Mark this window's real slots (in place; the start clamps like
    # dynamic_update_slice).
    T = state.slot_valid.shape[1]
    start = state.pos.to(torch.int64).clamp(max=T - S)
    rows = start[:, None] + torch.arange(S, device=dev)[None]
    state.slot_valid.scatter_(1, rows, valid.to(torch.bool))
    # Valid slots are contiguous: [first valid, pos + S).
    live_start = torch.argmax(state.slot_valid.to(torch.int8), dim=1) \
        .to(torch.int32)
    live_end = state.pos + S
    mask = None
    if S > 1:
        mask = (mask_ops.decode_step_mask(positions, T)
                & state.slot_valid[:, None, :])

    h_out, _ = transformer_forward(
        params["backbone"], cfg.backbone, h, positions, mask,
        {"k": state.cache_k, "v": state.cache_v}, state.pos,
        live_window=(live_start, live_end))

    last_h = h_out[:, -1, :]
    c0_logits = (last_h.to(torch.float32)
                 @ params["codebook0_head"].to(torch.float32))
    c0 = sample_topk(c0_logits, topk, temperature, noise[:, 0])
    samples = _depth_decode(params, cfg, last_h, c0, noise, depth_topk,
                            depth_temperature)
    new_state = LMState(cache_k=state.cache_k, cache_v=state.cache_v,
                        slot_valid=state.slot_valid, pos=state.pos + S)
    return new_state, samples


def build_step_frame(cfg: LLMConfig, frame: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sampled frame (B, ncb) -> next AR input ((B, 1, C+1) tokens, mask):
    audio columns filled, text column zero and masked out."""
    B = frame.shape[0]
    zeros = torch.zeros((B, 1), dtype=torch.int32, device=frame.device)
    tokens = torch.cat([frame.to(torch.int32), zeros], dim=1)[:, None, :]
    mask = torch.zeros((B, 1, cfg.num_columns), dtype=torch.bool,
                       device=frame.device)
    mask[:, :, :cfg.audio_num_codebooks] = True
    return tokens, mask


def lm_generate_loop(params: Params, cfg: LLMConfig, state: LMState,
                     tokens: torch.Tensor, tokens_mask: torch.Tensor,
                     valid: torch.Tensor,
                     noise_fn: Callable[[int], torch.Tensor],
                     max_frames: int, frame_cap: int,
                     temperature: float = 0.9, topk: int = 20,
                     depth_topk: int = 10, depth_temperature: float = 0.75,
                     ) -> tuple[LMState, torch.Tensor, torch.Tensor]:
    """Whole-utterance generation: prefill, then one decode frame per
    host-loop iteration until every stream has emitted EOS (the all-zero
    frame) or min(max_frames, frame_cap) frames exist. The EOS check reads
    the device once per frame. noise_fn(t) gives frame t's noise (prefill
    is t = 0).

    Returns (state, frames (B, max_frames, ncb) int32 zeroed after each
    stream's EOS, n_frames (B,) int32 with the EOS frame excluded)."""
    B = tokens.shape[0]
    ncb = cfg.audio_num_codebooks
    dev = tokens.device
    kw = dict(temperature=temperature, topk=topk, depth_topk=depth_topk,
              depth_temperature=depth_temperature)
    state, frame = lm_generate_frame(params, cfg, state, tokens, tokens_mask,
                                     valid, noise_fn(0), **kw)
    buf = torch.zeros((B, max_frames, ncb), dtype=torch.int32, device=dev)
    n_frames = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)

    def record(frame, t):
        nonlocal done
        is_eos = (frame == 0).all(dim=-1)
        live = ~done & ~is_eos
        buf[:, t] = torch.where(live[:, None], frame, 0)
        n_frames.add_(live.to(torch.int32))
        done = done | is_eos

    record(frame, 0)
    step_valid = torch.ones((B, 1), dtype=torch.bool, device=dev)
    t = 1
    while t < min(max_frames, frame_cap) and not bool(done.all()):
        st_tokens, st_mask = build_step_frame(cfg, frame)
        state, frame = lm_generate_frame(params, cfg, state, st_tokens,
                                         st_mask, step_valid, noise_fn(t),
                                         **kw)
        record(frame, t)
        t += 1
    return state, buf, n_frames
