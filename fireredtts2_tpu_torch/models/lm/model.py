"""Dual-transformer text-speech LM (backbone + depth decoder): the main
generation path.

Counterpart of ``fireredtts2_tpu/models/lm/model.py`` (generation,
append-prefill, rewind, the continuous batcher's slot admission, the
training loss ``lm_loss`` and speculative depth). With a fused-depth plan
and a ``depth_chain`` bundle in the tree the depth decode is one launch of
kernel B per frame (``ops.depth_chain``); else, with
``cfg.speculative_depth``, Jacobi rounds (``depth_decode_jacobi``); else
15 sequential steps.
Frames interleave audio_num_codebooks audio columns and one text column;
the backbone samples codebook 0, the depth decoder codebooks 1..N-1.

Sampling noise is an input: every frame takes a (B, ncb, V_audio) tensor of
Exp(1) draws, column 0 for codebook 0 and column i for depth codebook i.
The engine makes it from a generator seeded by (utterance seed, frame
index), so the whole-utterance loop and the streaming blocks sample the
same tokens.

KV slabs and the slot-validity map are updated IN PLACE (the JAX package
threads them as immutable state); ``LMState`` keeps pointing at the same
tensors, so a state kept for later (the engine's voice-state cache) is
handed out as a :func:`clone_lm_state`.

Valid slots stay contiguous, [first valid, pos + S), which kernel A relies
on (it reads every slot of that window unmasked): a left-padded prompt
starts with pad and then only real slots; a right-padded append window
(``real_len``) leaves its pad past pos + real_len, where the next decode
step or window writes; :func:`rewind_lm_state` invalidates every slot from
pos on.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

from fireredtts2_tpu_torch.config import LLMConfig
from fireredtts2_tpu_torch.ops import masks as mask_ops
from fireredtts2_tpu_torch.ops.depth_chain import fused_depth_decode
from fireredtts2_tpu_torch.ops.sampling import sample_topk
from fireredtts2_tpu_torch.weights import host_to_device
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
        **({"depth_draft": init_draft_head(gen, cfg, dtype, device)}
           if cfg.depth_draft_head else {}),
    }


def init_draft_head(gen: torch.Generator, cfg: LLMConfig, dtype=torch.float32,
                    device=None) -> Params:
    """The MTP-style draft head lm_loss trains when the tree has one: a
    trunk from [last_h, embed(c0)] (uniform +-1/sqrt(2 D_backbone)) plus
    zero per-position offsets, decoded through the audio heads."""
    bb, dec = cfg.backbone, cfg.decoder
    bound = 1.0 / math.sqrt(2 * bb.embed_dim)
    u = torch.rand((2 * bb.embed_dim, dec.embed_dim), generator=gen,
                   dtype=torch.float32, device=device)
    return {"trunk": ((u * 2.0 - 1.0) * bound).to(dtype),
            "pos": torch.zeros((cfg.audio_num_codebooks - 1, dec.embed_dim),
                               dtype=dtype, device=device)}


KV_ALIGN = 512


def kv_capacity(max_seq_len: int) -> int:
    """Physical KV slab length: the logical cap rounded up to KV_ALIGN
    (3100 -> 3584)."""
    return -(-max_seq_len // KV_ALIGN) * KV_ALIGN


def init_lm_state(cfg: LLMConfig, batch_size: int, dtype=torch.float32,
                  device=None, capacity: int | None = None) -> LMState:
    """capacity: a logical position cap below cfg.max_seq_len, for a
    serving pool whose utterances are bounded (a capacity class of
    ``runtime.batcher``): a smaller slab, and a cheaper attention read."""
    cap = kv_capacity(capacity or cfg.max_seq_len)
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


def draft_depth_tokens(params: Params, cfg: LLMConfig, last_h: torch.Tensor,
                       c0: torch.Tensor) -> torch.Tensor:
    """Greedy draft of codebooks 1..ncb-1 in one parallel shot from the
    ``depth_draft`` head, (B, ncb-1) int32: the Jacobi init when the tree
    has a trained head. The argmax is over fp32 logits, first index on
    ties, as jnp.argmax takes it."""
    dh = params["depth_draft"]
    e0 = embed_audio(params, cfg, 0, c0).to(last_h.dtype)
    h = torch.cat([last_h, e0], dim=-1) @ dh["trunk"]          # (B, D_dec)
    hp = h[:, None, :] + dh["pos"][None]                       # (B, ncb-1, D)
    logits = torch.einsum("nsd,sdv->nsv", hp.to(torch.float32),
                          params["audio_head"].to(torch.float32))
    return torch.argmax(logits, dim=-1).to(torch.int32)


def depth_decode_jacobi(params: Params, cfg: LLMConfig, last_h: torch.Tensor,
                        c0: torch.Tensor, noise: torch.Tensor, depth_topk: int,
                        depth_temperature: float,
                        init: torch.Tensor | None = None,
                        ) -> tuple[torch.Tensor, int]:
    """Speculative depth decode by Jacobi iteration: each round is one
    stateless 16-position forward of the depth decoder over [last_h,
    embed(guess[:, :15])] @ projection under a causal mask (lm_loss's depth
    input), which re-samples every position 1..ncb-1 from the same noise
    rows ``noise[:, i]`` the sequential loop uses; the longest
    self-consistent prefix is kept. Each round verifies at least one more
    token, so at most ncb-1 rounds run and the tokens are the sequential
    chain's, wherever the parallel forward rounds as the S=1 steps do
    (exact at f32; bf16 on the card may flip a near-tie).

    The stop condition lives on the device in JAX (a while_loop); here it
    is read on the host once a round. ``depth_decode_jacobi.calls`` /
    ``.rounds`` / ``.max_rounds`` count frames and rounds in this process.

    noise: (B, ncb, V) Exp(1) draws (column 0 unused); init: an optional
    (B, ncb-1) first guess. Returns (samples (B, ncb) int32, rounds)."""
    dec_cfg = cfg.decoder
    ncb, V = cfg.audio_num_codebooks, cfg.audio_vocab_size
    B = last_h.shape[0]
    dtype, dev = last_h.dtype, last_h.device
    proj = params["projection"]
    heads = params["audio_head"].to(torch.float32)     # (ncb-1, D_dec, V)
    offs = torch.arange(ncb - 1, device=dev) * V
    pos = torch.arange(ncb, dtype=torch.int32, device=dev).expand(B, ncb)
    attn = mask_ops.causal_mask(ncb, dev).expand(B, ncb, ncb)
    ipos = torch.arange(1, ncb, dtype=torch.int32, device=dev)[None]
    depth_noise = noise[:, 1:ncb]

    def forward(tok):
        """Every position 1..ncb-1 sampled, each conditioned on the current
        guess of the positions before it."""
        c_emb = params["audio_embeddings"][tok[:, :ncb - 1].to(torch.int64)
                                           + offs].to(dtype)
        dec_in = torch.cat([last_h[:, None, :], c_emb], dim=1) @ proj
        dec_h, _ = transformer_forward(params["decoder"], dec_cfg, dec_in, pos,
                                       attn)
        logits = torch.einsum("nsd,sdv->nsv", dec_h[:, 1:].to(torch.float32),
                              heads)
        return sample_topk(logits, depth_topk, depth_temperature, depth_noise)

    tok = torch.zeros((B, ncb), dtype=torch.int32, device=dev)
    tok[:, 0] = c0
    if init is not None:
        tok[:, 1:] = init
    p = torch.zeros((B,), dtype=torch.int32, device=dev)
    rounds = 0
    while True:
        sampled = forward(tok)
        # Positions <= p are verified: their inputs are true, so `sampled`
        # reproduces them. The first later position where the old guess
        # disagrees is corrected by this round's sample (its inputs all
        # verified or matching) and becomes the new frontier.
        match = tok[:, 1:] == sampled
        blocked = ~match & (ipos > p[:, None])
        first = torch.argmax(blocked.to(torch.int8), dim=1).to(torch.int32) + 1
        new_p = torch.where(blocked.any(dim=1), first, ncb - 1)
        tok[:, 1:] = torch.where(ipos <= p[:, None], tok[:, 1:], sampled)
        p = torch.maximum(p, new_p)
        rounds += 1
        if rounds >= ncb or not bool((p < ncb - 1).any()):
            break
    depth_decode_jacobi.calls += 1
    depth_decode_jacobi.rounds += rounds
    depth_decode_jacobi.max_rounds = max(depth_decode_jacobi.max_rounds, rounds)
    return tok, rounds


def reset_jacobi_counts() -> None:
    """Set depth_decode_jacobi's frame and round counts to 0."""
    depth_decode_jacobi.calls = 0
    depth_decode_jacobi.rounds = 0
    depth_decode_jacobi.max_rounds = 0


reset_jacobi_counts()


def _depth_decode(params: Params, cfg: LLMConfig, last_h: torch.Tensor,
                  c0: torch.Tensor, noise: torch.Tensor, depth_topk: int,
                  depth_temperature: float,
                  spec_init: torch.Tensor | None = None) -> torch.Tensor:
    """Sample codebooks 1..N-1 with the depth transformer over a fresh
    16-slot cache: an S=2 prefill of [last_h, embed(c0)], then single steps,
    in plain PyTorch (the JAX package's XLA loop). When the tree carries a
    ``depth_chain`` bundle for ``cfg.fused_depth_plan``, the whole chain is
    kernel B instead, with the same noise; that takes precedence over
    ``cfg.speculative_depth``, which otherwise runs the Jacobi rounds from
    the draft head's guess when the tree has one, else from `spec_init`.
    Returns (B, ncb) int32."""
    if cfg.fused_depth_plan and "depth_chain" in params:
        return fused_depth_decode(params["depth_chain"], cfg, last_h, c0, noise,
                                  depth_topk, depth_temperature,
                                  plan=cfg.fused_depth_plan)
    if cfg.speculative_depth:
        if "depth_draft" in params:
            spec_init = draft_depth_tokens(params, cfg, last_h, c0)
        samples, _ = depth_decode_jacobi(params, cfg, last_h, c0, noise,
                                         depth_topk, depth_temperature,
                                         init=spec_init)
        return samples
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
                      temperature=0.9, topk=20,
                      depth_topk: int = 10, depth_temperature: float = 0.75,
                      real_len: torch.Tensor | None = None,
                      ) -> tuple[LMState, torch.Tensor]:
    """One AR step: consume a token window (B, S, C+1) -- a left-padded
    prompt bucket (prefill) or one frame (S = 1) -- and sample the next
    frame (B, ncb) int32. noise: (B, ncb, V_audio) Exp(1) draws.

    temperature / topk of codebook 0: a float and an int, or per row a
    (B, 1) float tensor and a (B,) int tensor (the continuous batcher's
    per-request sampling). The depth decoder keeps its scalar depth_topk
    and depth_temperature, as the JAX package's does.

    real_len: (B,) int, append-prefill. The window is RIGHT-padded instead
    (content left-aligned, real_len real slots): the frame samples from
    slot real_len - 1 and pos advances by real_len only, so the next step
    overwrites the pad slots and the slab has no interior gap."""
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

    if real_len is None:
        last_h = h_out[:, -1, :]     # right-aligned content: the newest
        last_tok = tokens[:, -1]
    else:
        idx = (real_len.to(torch.int64) - 1)[:, None, None]
        last_h = torch.gather(
            h_out, 1, idx.expand(-1, 1, h_out.shape[-1]))[:, 0]
        last_tok = torch.gather(
            tokens, 1, idx.expand(-1, 1, tokens.shape[-1]))[:, 0]
    c0_logits = (last_h.to(torch.float32)
                 @ params["codebook0_head"].to(torch.float32))
    c0 = sample_topk(c0_logits, topk, temperature, noise[:, 0])
    # The speculative init: the window's last frame's depth chain. RVQ codes
    # are correlated in time, so it is a free draft; it changes only the
    # Jacobi rounds, never the tokens.
    ncb = cfg.audio_num_codebooks
    spec_init = (last_tok[:, 1:ncb].clamp(0, cfg.audio_vocab_size - 1)
                 .to(torch.int32) if cfg.speculative_depth else None)
    samples = _depth_decode(params, cfg, last_h, c0, noise, depth_topk,
                            depth_temperature, spec_init=spec_init)
    step = S if real_len is None else real_len.to(torch.int32)
    new_state = LMState(cache_k=state.cache_k, cache_v=state.cache_v,
                        slot_valid=state.slot_valid, pos=state.pos + step)
    return new_state, samples


def rewind_lm_state(state: LMState, pos: torch.Tensor) -> LMState:
    """Roll every stream back to absolute position pos (B,): slots at and
    beyond pos are invalidated in place (their K/V stays; masking hides it
    until the next window overwrites it). Incremental dialogue replaces
    an utterance's decode-era KV with its re-encoded audio this way."""
    idx = torch.arange(state.slot_valid.shape[1], device=pos.device)
    state.slot_valid &= idx[None, :] < pos[:, None]
    return LMState(cache_k=state.cache_k, cache_v=state.cache_v,
                   slot_valid=state.slot_valid, pos=pos.to(torch.int32))


def clone_lm_state(state: LMState) -> LMState:
    """A copy whose tensors later in-place steps leave untouched."""
    return LMState(cache_k=state.cache_k.clone(),
                   cache_v=state.cache_v.clone(),
                   slot_valid=state.slot_valid.clone(), pos=state.pos.clone())


def _slot_ids(bs, B: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(slot ids, their places in `bs`) of the entries of `bs` that name a
    slot of a B-slot state. Ids outside [0, B) -- the padding id B -- are
    dropped, as the JAX package's ``mode="drop"`` scatters drop them. Ids
    given on the host (a list, numpy, a CPU tensor) are filtered there;
    ids on the device cost one read back."""
    bs = torch.as_tensor(bs).to(torch.int64).reshape(-1)
    keep = ((bs >= 0) & (bs < B)).nonzero()[:, 0]
    return host_to_device(bs[keep], device), host_to_device(keep, device)


def reset_lm_slots(state: LMState, bs) -> LMState:
    """Free a vector of stream slots: their slot-validity rows cleared (in
    place) and their positions 0; the K/V stays (masking hides it). Ids
    equal to B are padding and dropped."""
    ids, _ = _slot_ids(bs, state.pos.shape[0], state.pos.device)
    state.slot_valid.index_fill_(0, ids, False)
    return LMState(cache_k=state.cache_k, cache_v=state.cache_v,
                   slot_valid=state.slot_valid,
                   pos=state.pos.index_fill(0, ids, 0))


def reset_lm_slot(state: LMState, b: int) -> LMState:
    """Free one stream slot (:func:`reset_lm_slots` of [b])."""
    return reset_lm_slots(state, [b])


def _scatter_rows(state: LMState, small: LMState, bs) -> LMState:
    """Copy the rows of `small` into slots `bs` of `state` (in place; ids
    equal to B dropped with their rows)."""
    ids, keep = _slot_ids(bs, state.pos.shape[0], state.pos.device)
    state.cache_k[:, ids] = small.cache_k[:, keep]
    state.cache_v[:, ids] = small.cache_v[:, keep]
    state.slot_valid[ids] = small.slot_valid[keep]
    pos = state.pos.clone()
    pos[ids] = small.pos[keep]
    return LMState(cache_k=state.cache_k, cache_v=state.cache_v,
                   slot_valid=state.slot_valid, pos=pos)


def prefill_into_slots(params: Params, cfg: LLMConfig, state: LMState, bs,
                       tokens: torch.Tensor, tokens_mask: torch.Tensor,
                       valid: torch.Tensor, noise: torch.Tensor,
                       temperature=0.9, topk=20, depth_topk: int = 10,
                       depth_temperature: float = 0.75,
                       ) -> tuple[LMState, torch.Tensor]:
    """Prefill N prompts into slots `bs` of a batched decode state in one
    pass (burst admission while other slots keep decoding).

    bs: (N,) slot ids, distinct; an id equal to B pads the burst to a
    fixed row count and is dropped with its row. tokens / tokens_mask
    (N, S, C+1) and valid (N, S): left-padded buckets; noise (N, ncb, V);
    temperature / topk: scalars or per row (N, 1) / (N,). The prompts run
    in a fresh N-stream state of the target's slab length, whose rows are
    then copied into the slots. Returns (state, first frames (N, ncb))."""
    small = init_lm_state(cfg, tokens.shape[0], state.cache_k.dtype,
                          device=state.cache_k.device,
                          capacity=state.cache_k.shape[2])
    small, frames = lm_generate_frame(params, cfg, small, tokens, tokens_mask,
                                      valid, noise, temperature, topk,
                                      depth_topk, depth_temperature)
    return _scatter_rows(state, small, bs), frames


def prefill_into_slot(params: Params, cfg: LLMConfig, state: LMState, b: int,
                      tokens: torch.Tensor, tokens_mask: torch.Tensor,
                      valid: torch.Tensor, noise: torch.Tensor,
                      temperature=0.9, topk=20, depth_topk: int = 10,
                      depth_temperature: float = 0.75,
                      ) -> tuple[LMState, torch.Tensor]:
    """Prefill one prompt (a (1, S, C+1) bucket) into slot b
    (:func:`prefill_into_slots` of [b]); the frame is (1, ncb)."""
    return prefill_into_slots(params, cfg, state, [b], tokens, tokens_mask,
                              valid, noise, temperature, topk, depth_topk,
                              depth_temperature)


def prefill_into_slot_prefix(params: Params, cfg: LLMConfig, state: LMState,
                             b: int, pk: torch.Tensor, pv: torch.Tensor,
                             plen: torch.Tensor, tokens: torch.Tensor,
                             tokens_mask: torch.Tensor, valid: torch.Tensor,
                             real_len: torch.Tensor, noise: torch.Tensor,
                             temperature=0.9, topk=20, depth_topk: int = 10,
                             depth_temperature: float = 0.75,
                             ) -> tuple[LMState, torch.Tensor]:
    """Admit one stream into slot b from a cached KV prefix: the slot
    starts with the context rows in place and only the new window is
    append-prefilled.

    pk / pv: (Lyr, 1, P, W) prefix rows (P a 128-aligned crop); plen (1,)
    their true length (rows [plen, P) are marked invalid). tokens /
    tokens_mask / valid: a RIGHT-padded (1, S, C+1) window with real_len
    (1,) real slots, which lands at positions [plen, plen + real_len).
    Returns (state, first frame (1, ncb))."""
    dev = state.cache_k.device
    cap = state.cache_k.shape[2]
    P = pk.shape[2]
    small = init_lm_state(cfg, 1, state.cache_k.dtype, device=dev,
                          capacity=cap)
    small.cache_k[:, :, :P] = pk.to(small.cache_k.dtype)
    small.cache_v[:, :, :P] = pv.to(small.cache_v.dtype)
    plen = plen.to(device=dev, dtype=torch.int32)
    rows = torch.arange(cap, device=dev)[None, :]
    small = LMState(cache_k=small.cache_k, cache_v=small.cache_v,
                    slot_valid=rows < plen[:, None], pos=plen)
    small, frame = lm_generate_frame(params, cfg, small, tokens, tokens_mask,
                                     valid, noise, temperature, topk,
                                     depth_topk, depth_temperature,
                                     real_len=real_len)
    return _scatter_rows(state, small, [b]), frame


def slot_kv_prefix(state: LMState, b: int, P: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Copies of slot b's first P K/V rows, (Lyr, 1, P, W) each: the
    :func:`prefill_into_slot_prefix` input of the next dialogue turn."""
    return (state.cache_k[:, b:b + 1, :P].clone(),
            state.cache_v[:, b:b + 1, :P].clone())


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
                     real_len: torch.Tensor | None = None,
                     stats: dict | None = None,
                     ) -> tuple[LMState, torch.Tensor, torch.Tensor]:
    """Whole-utterance generation: prefill, then one decode frame per
    host-loop iteration until every stream has emitted EOS (the all-zero
    frame) or min(max_frames, frame_cap) frames exist. The EOS check reads
    the device once per frame. noise_fn(t) gives frame t's noise (prefill
    is t = 0). real_len: append-prefill of a right-padded window onto a
    live state (see lm_generate_frame). stats: when given, receives
    "prefill_s", the host seconds up to the first EOS read (which waits
    for the prefill's frame).

    Returns (state, frames (B, max_frames, ncb) int32 zeroed after each
    stream's EOS, n_frames (B,) int32 with the EOS frame excluded)."""
    B = tokens.shape[0]
    ncb = cfg.audio_num_codebooks
    dev = tokens.device
    kw = dict(temperature=temperature, topk=topk, depth_topk=depth_topk,
              depth_temperature=depth_temperature)
    t0 = time.perf_counter()
    state, frame = lm_generate_frame(params, cfg, state, tokens, tokens_mask,
                                     valid, noise_fn(0), real_len=real_len,
                                     **kw)
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
    all_done = bool(done.all())
    if stats is not None:
        stats["prefill_s"] = time.perf_counter() - t0
    step_valid = torch.ones((B, 1), dtype=torch.bool, device=dev)
    t = 1
    while t < min(max_frames, frame_cap) and not all_done:
        st_tokens, st_mask = build_step_frame(cfg, frame)
        state, frame = lm_generate_frame(params, cfg, state, st_tokens,
                                         st_mask, step_valid, noise_fn(t),
                                         **kw)
        record(frame, t)
        all_done = bool(done.all())
        t += 1
    return state, buf, n_frames


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------


def _masked_ce(logits: torch.Tensor, targets: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean cross-entropy in fp32."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].to(torch.int64))[..., 0]
    w = weights.to(torch.float32)
    return (nll * w).sum() / w.sum().clamp(min=1.0)


def _roll_left(x: torch.Tensor) -> torch.Tensor:
    """x shifted one position left along dim 1 (the last wraps to the end,
    as jnp.roll(x, -1, axis=1))."""
    return torch.roll(x, -1, dims=1)


def lm_loss(params: Params, cfg: LLMConfig, tokens: torch.Tensor,
            tokens_mask: torch.Tensor, gen: torch.Generator | None = None,
            depth_indices: torch.Tensor | None = None
            ) -> dict[str, torch.Tensor]:
    """Training loss of the JAX package's lm_loss (the reference model's
    forward).

    Args:
        tokens: (B, S, C+1) int interleaved frames; tokens_mask the same
            shape, bool.
        gen: the generator of the depth decoder's random subset of
            (B*S)//8 positions, on the tokens' device.
        depth_indices: (N,) flat B*S positions that replace the draw.

    Returns dict(loss, text_loss, c0_loss, depth_loss), with draft_loss
    when the tree has a ``depth_draft`` head. Logits and losses are fp32.
    """
    bb_cfg, dec_cfg = cfg.backbone, cfg.decoder
    B, S, _ = tokens.shape
    ncb, V = cfg.audio_num_codebooks, cfg.audio_vocab_size
    dtype, dev = params["projection"].dtype, tokens.device
    tokens = tokens.to(torch.int64)
    tokens_mask = tokens_mask.to(torch.bool)

    h = frame_hidden(params, cfg, tokens, tokens_mask, dtype)
    audio_mask = tokens_mask[:, :, 0]
    text_mask = tokens_mask[:, :, -1]
    padding_mask = audio_mask | text_mask

    # causal over non-pad positions, plus self
    causal = mask_ops.causal_mask(S, dev)[None]
    pair = padding_mask[:, :, None] & padding_mask[:, None, :]
    attn = (causal & pair) | torch.eye(S, dtype=torch.bool, device=dev)[None]
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    remat = cfg.train_remat or None
    h_out, _ = transformer_forward(params["backbone"], bb_cfg, h, positions,
                                   attn, remat=remat)
    h32 = h_out.to(torch.float32)

    # codebook 0: position p predicts the audio frame at p + 1
    c0_pred_mask = _roll_left(audio_mask)
    c0_pred_mask[:, -1] = False
    c0_logits = h32 @ params["codebook0_head"].to(torch.float32)
    c0_loss = _masked_ce(c0_logits, _roll_left(tokens[:, :, 0]), c0_pred_mask)

    # text: positions whose next token is text predict it; id 0 is ignored
    text_target_mask = _roll_left(text_mask)
    text_target_mask[:, -1] = False
    text_targets = _roll_left(tokens[:, :, -1])
    text_logits = h32 @ params["text_head"].to(torch.float32)
    text_loss = _masked_ce(text_logits, text_targets,
                           text_target_mask & (text_targets != 0))

    # the depth decoder on a random subset of the audio positions
    flat_w = c0_pred_mask.reshape(-1).to(torch.float32)
    if depth_indices is not None:
        idx = depth_indices.to(device=dev, dtype=torch.int64)
    else:
        # with no weighted position the draw is uniform; its picks weigh 0
        probs = torch.where(flat_w.sum() > 0, flat_w, torch.ones_like(flat_w))
        idx = torch.multinomial(probs, max(B * S // 8, 1), replacement=True,
                                generator=gen)
    n_sub = idx.shape[0]
    sub_w = flat_w[idx]
    sub_h = h_out.reshape(B * S, -1)[idx]
    sub_frame = _roll_left(tokens).reshape(B * S, -1)[idx]

    # depth input: [h, embed(c_0), ..., embed(c_{ncb-2})]
    offs = torch.arange(ncb - 1, device=dev) * V
    c_embeds = params["audio_embeddings"][sub_frame[:, :ncb - 1] + offs]
    dec_in = torch.cat([sub_h[:, None, :], c_embeds.to(dtype)], dim=1) \
        @ params["projection"]
    dec_pos = torch.arange(ncb, dtype=torch.int32, device=dev).expand(n_sub, ncb)
    dec_attn = mask_ops.causal_mask(ncb, dev).expand(n_sub, ncb, ncb)
    dec_h, _ = transformer_forward(params["decoder"], dec_cfg, dec_in, dec_pos,
                                   dec_attn, remat=remat)
    # position i (1..ncb-1) predicts codebook i through audio_head[i-1]
    heads = params["audio_head"].to(torch.float32)
    dep_logits = torch.einsum("nsd,sdv->nsv", dec_h[:, 1:].to(torch.float32),
                              heads)
    dep_targets = sub_frame[:, 1:ncb]
    dep_w = sub_w[:, None].expand_as(dep_targets)
    depth_loss = _masked_ce(dep_logits, dep_targets, dep_w)

    w = cfg.decoder_loss_weight
    loss = 2.0 * ((1.0 - w) * c0_loss + w * depth_loss)
    if cfg.use_text_loss:
        loss = loss + 0.01 * text_loss
    out = {"loss": loss, "text_loss": text_loss, "c0_loss": c0_loss,
           "depth_loss": depth_loss}

    # the draft head's CE on the same subset
    if "depth_draft" in params:
        dh = params["depth_draft"]
        e0 = params["audio_embeddings"][sub_frame[:, 0]].to(dtype)
        trunk = torch.cat([sub_h.to(dtype), e0], dim=-1) @ dh["trunk"]
        hp = trunk[:, None, :] + dh["pos"][None]
        draft_logits = torch.einsum("nsd,sdv->nsv", hp.to(torch.float32), heads)
        draft_loss = _masked_ce(draft_logits, dep_targets, dep_w)
        out["draft_loss"] = draft_loss
        out["loss"] = loss + cfg.draft_loss_weight * draft_loss
    return out
