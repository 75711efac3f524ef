"""Whisper encoder-decoder ASR model in PyTorch.

Counterpart of ``fireredtts2_tpu/asr/model.py``. The encoder is the codec's
whisper encoder (``models.codec.whisper_nn``); this module adds the text
decoder (self-attention over a static KV slab, cross-attention over encoder
K/V computed once per utterance) and the greedy / sampled transcription
loop. Parameter trees keep the JAX layout: stacked (L, ...) layers, (in,
out) matmuls, the tied token embedding.

No kernel: JAX runs this model as plain XLA (its attention is the plain
``mha_attention``), so the port runs it as plain PyTorch under the fp32
precision policy (``ops.precision``: no TF32), with weight-only int8 as
the opt-in (``quantize_asr_params_int8``, ``ops.quant.quantized_matmul``'s
dequant route).

Where JAX runs the whole decode as one ``lax.while_loop`` and tests
``all(done)`` on the device, ``_sample_loop`` is a host loop: one decoder
call per token and one read of ``done`` per token, which waits for the
card each time. It gives the same tokens, counts and log-probabilities.
Sampling at T > 0 is a Gumbel-max over a noise tensor that the caller
draws (``noise(t)``), as ``jax.random.categorical`` is a Gumbel-max over
its own draws. The searches follow JAX's: best-of-N
(``asr_sample_best_of``) and beam search (``asr_beam_decode``) decode
their candidates as rows of one batch against one encoder pass, beam
search with the same float32 order of operations, tie rules and host
read of its stop condition once a step; ``asr_alignment_probs`` gives the
teacher-forced alignment maps of word timestamps.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from fireredtts2_tpu_torch.models.codec.whisper_nn import (
    init_whisper_encoder, layer_norm, quantize_whisper_layers_int8,
    whisper_encoder_forward,
)
from fireredtts2_tpu_torch.ops.attention import mha_attention
from fireredtts2_tpu_torch.ops.precision import pmatmul
from fireredtts2_tpu_torch.ops.quant import quantize_tree, quantized_matmul

Params = dict[str, Any]


@dataclass(frozen=True)
class WhisperASRModelConfig:
    """Dims and special-token ids of a Whisper checkpoint. Defaults are
    whisper-large-v3 (HF openai/whisper-large-v3 config.json)."""

    n_mels: int = 128
    vocab_size: int = 51_866
    encoder_layers: int = 32
    decoder_layers: int = 32
    num_heads: int = 20
    embed_dim: int = 1280
    ffn_dim: int = 5120
    max_source_positions: int = 1500   # 30 s of 50 Hz encoder frames
    max_target_positions: int = 448
    # special tokens (large-v3 multilingual vocab)
    sot_id: int = 50_258               # <|startoftranscript|>
    eot_id: int = 50_257               # <|endoftext|>
    transcribe_id: int = 50_360        # <|transcribe|>
    translate_id: int = 50_359         # <|translate|>
    no_timestamps_id: int = 50_364     # <|notimestamps|>
    no_speech_id: int = 50_362         # <|nospeech|>
    sot_prev_id: int = 50_361          # <|startofprev|> (text conditioning)
    first_language_id: int = 50_259    # <|en|>; languages are contiguous
    num_languages: int = 100

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


TINY_ASR = WhisperASRModelConfig(
    n_mels=16, vocab_size=64, encoder_layers=2, decoder_layers=2,
    num_heads=2, embed_dim=32, ffn_dim=64, max_source_positions=32,
    max_target_positions=24, sot_id=60, eot_id=59, transcribe_id=58,
    translate_id=57, no_timestamps_id=56, no_speech_id=55, sot_prev_id=54,
    first_language_id=40, num_languages=8)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _init_decoder_layers(gen: torch.Generator, L: int, D: int, F: int,
                         dtype, device) -> Params:
    def w(*shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * 0.02).to(dtype)

    def const(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        # self-attention (k has no bias, the whisper convention)
        "self_wq": w(L, D, D), "self_bq": const(0.0, L, D),
        "self_wk": w(L, D, D),
        "self_wv": w(L, D, D), "self_bv": const(0.0, L, D),
        "self_wo": w(L, D, D), "self_bo": const(0.0, L, D),
        "self_ln_w": const(1.0, L, D), "self_ln_b": const(0.0, L, D),
        # cross-attention over the encoder states
        "cross_wq": w(L, D, D), "cross_bq": const(0.0, L, D),
        "cross_wk": w(L, D, D),
        "cross_wv": w(L, D, D), "cross_bv": const(0.0, L, D),
        "cross_wo": w(L, D, D), "cross_bo": const(0.0, L, D),
        "cross_ln_w": const(1.0, L, D), "cross_ln_b": const(0.0, L, D),
        # FFN
        "fc1_w": w(L, D, F), "fc1_b": const(0.0, L, F),
        "fc2_w": w(L, F, D), "fc2_b": const(0.0, L, D),
        "ffn_ln_w": const(1.0, L, D), "ffn_ln_b": const(0.0, L, D),
    }


def init_asr_params(gen: torch.Generator, cfg: WhisperASRModelConfig,
                    dtype=torch.float32, device=None) -> Params:
    """Random parameters in the JAX tree layout, every leaf drawn from
    `gen` on `device` (the encoder, then the decoder)."""
    D = cfg.embed_dim
    enc = init_whisper_encoder(gen, cfg.n_mels, D, cfg.encoder_layers,
                               cfg.num_heads, cfg.ffn_dim,
                               cfg.max_source_positions, dtype, device)
    layers = _init_decoder_layers(gen, cfg.decoder_layers, D, cfg.ffn_dim,
                                  dtype, device)

    def emb(n):
        return (torch.randn((n, D), generator=gen, dtype=torch.float32,
                            device=device) * 0.02).to(dtype)

    return {
        "encoder": enc,
        "decoder": {
            "layers": layers,
            "token_emb": emb(cfg.vocab_size),
            "pos_emb": emb(cfg.max_target_positions),
            "ln_w": torch.ones((D,), dtype=dtype, device=device),
            "ln_b": torch.zeros((D,), dtype=dtype, device=device),
        },
    }


_DECODER_INT8_KEYS = ("self_wq", "self_wk", "self_wv", "self_wo",
                      "cross_wq", "cross_wo", "fc1_w", "fc2_w")


def quantize_asr_params_int8(params: Params) -> Params:
    """Weight-only int8 (per output column, symmetric) on the encoder
    stack and the decoder's per-token matmuls. cross_wk / cross_wv run once
    per utterance and stay float, as does the tied token embedding."""
    out = dict(params)
    enc = dict(params["encoder"])
    enc["layers"] = quantize_whisper_layers_int8(enc["layers"])
    out["encoder"] = enc
    dec = dict(params["decoder"])
    dec["layers"] = quantize_tree(dec["layers"], _DECODER_INT8_KEYS, bits=8)
    out["decoder"] = dec
    return out


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


@dataclass
class ASRDecodeState:
    """Self-attention KV slabs and the write position of the text decode.
    The slabs are written in place by each decoder call."""
    cache_k: torch.Tensor      # (L, B, T_ctx, H, Dh)
    cache_v: torch.Tensor
    pos: int                   # shared across the batch (no padding)


def init_asr_decode_state(cfg: WhisperASRModelConfig, batch: int,
                          dtype=torch.float32, device=None) -> ASRDecodeState:
    shape = (cfg.decoder_layers, batch, cfg.max_target_positions,
             cfg.num_heads, cfg.head_dim)
    return ASRDecodeState(torch.zeros(shape, dtype=dtype, device=device),
                          torch.zeros(shape, dtype=dtype, device=device), 0)


def precompute_cross_kv(params: Params, cfg: WhisperASRModelConfig,
                        enc: torch.Tensor) -> dict[str, torch.Tensor]:
    """Encoder states (B, T_enc, D) -> each layer's cross-attention K/V,
    {"k", "v"}: (L, B, T_enc, H, Dh), once per utterance."""
    lp = params["decoder"]["layers"]
    B, T, _ = enc.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    L = lp["cross_wk"].shape[0]
    x = enc[None].to(lp["cross_wk"].dtype)
    k = pmatmul(x, lp["cross_wk"][:, None])
    v = pmatmul(x, lp["cross_wv"][:, None]) + lp["cross_bv"][:, None, None]
    return {"k": k.reshape(L, B, T, H, Dh), "v": v.reshape(L, B, T, H, Dh)}


def decoder_layer_views(params: Params) -> list[Params]:
    """The decoder's stacked layer tree as one dict of views per layer
    (made once per utterance, not once per token)."""
    lp = params["decoder"]["layers"]
    return [dict(zip(lp, per)) for per in zip(*(t.unbind(0) for t in lp.values()))]


def _decoder_layer(h: torch.Tensor, lp: Params, cfg: WhisperASRModelConfig,
                   self_mask: torch.Tensor, cross_k: torch.Tensor,
                   cross_v: torch.Tensor, cross_mask: Optional[torch.Tensor],
                   k_slab: torch.Tensor, v_slab: torch.Tensor, start: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (the layer's output, the state entering its cross-attention
    block, before that block's layer norm)."""
    B, S, D = h.shape
    H, Dh = cfg.num_heads, cfg.head_dim

    # self-attention over the KV slab (written in place at [start, start+S))
    x = layer_norm(h, lp["self_ln_w"], lp["self_ln_b"])
    q = (quantized_matmul(x, lp, "self_wq") + lp["self_bq"]).reshape(B, S, H, Dh)
    k = quantized_matmul(x, lp, "self_wk").reshape(B, S, H, Dh)
    v = (quantized_matmul(x, lp, "self_wv") + lp["self_bv"]).reshape(B, S, H, Dh)
    k_slab[:, start:start + S] = k.to(k_slab.dtype)
    v_slab[:, start:start + S] = v.to(v_slab.dtype)
    attn = mha_attention(q, k_slab.to(h.dtype), v_slab.to(h.dtype), self_mask)
    h = h + (quantized_matmul(attn.reshape(B, S, D), lp, "self_wo")
             + lp["self_bo"]).to(h.dtype)

    # cross-attention over the precomputed encoder K/V
    cross_in = h
    x = layer_norm(h, lp["cross_ln_w"], lp["cross_ln_b"])
    q = (quantized_matmul(x, lp, "cross_wq") + lp["cross_bq"]).reshape(B, S, H, Dh)
    attn = mha_attention(q, cross_k.to(h.dtype), cross_v.to(h.dtype), cross_mask)
    h = h + (quantized_matmul(attn.reshape(B, S, D), lp, "cross_wo")
             + lp["cross_bo"]).to(h.dtype)

    # FFN
    x = layer_norm(h, lp["ffn_ln_w"], lp["ffn_ln_b"])
    x = torch.nn.functional.gelu(quantized_matmul(x, lp, "fc1_w") + lp["fc1_b"])
    return h + (quantized_matmul(x, lp, "fc2_w") + lp["fc2_b"]).to(h.dtype), cross_in


def asr_decoder_forward(params: Params, cfg: WhisperASRModelConfig,
                        tokens: torch.Tensor, state: ASRDecodeState,
                        cross_kv: dict[str, torch.Tensor],
                        enc_len: Optional[torch.Tensor] = None,
                        layers: Optional[list[Params]] = None,
                        collect_cross_inputs: bool = False):
    """Decode a window of tokens (B, S) at positions [pos, pos + S): the
    prompt's prefill (S > 1) and the AR steps (S = 1) in one function.
    Returns (logits (B, S, V) float32, the state advanced by S; its slabs
    are the same tensors, written in place). `layers`: the per-layer views
    of ``decoder_layer_views`` when the caller made them already. With
    collect_cross_inputs a third output holds each layer's cross-attention
    input states (L, B, S, D), from which ``asr_alignment_probs``
    re-projects the alignment heads.

    As JAX's dynamic slices do, the position-table read and the slab write
    start at most at their table's length minus S."""
    dec = params["decoder"]
    B, S = tokens.shape
    dtype = dec["token_emb"].dtype
    pos = state.pos
    T_ctx = state.cache_k.shape[2]
    dev = tokens.device

    p0 = min(max(pos, 0), dec["pos_emb"].shape[0] - S)
    h = (dec["token_emb"][tokens] + dec["pos_emb"][p0:p0 + S][None]).to(dtype)

    # causal over the slab: the query at absolute position p sees slots <= p
    qpos = pos + torch.arange(S, device=dev)
    self_mask = (torch.arange(T_ctx, device=dev)[None, :] <= qpos[:, None])
    self_mask = self_mask[None].expand(B, S, T_ctx)
    cross_mask = None
    if enc_len is not None:
        T_enc = cross_kv["k"].shape[2]
        cross_mask = (torch.arange(T_enc, device=dev)[None, :]
                      < enc_len[:, None])[:, None, :].expand(B, S, T_enc)

    start = min(max(pos, 0), T_ctx - S)
    cross_in = []
    for i, lp in enumerate(layers if layers is not None
                           else decoder_layer_views(params)):
        h, xin = _decoder_layer(h, lp, cfg, self_mask, cross_kv["k"][i],
                                cross_kv["v"][i], cross_mask, state.cache_k[i],
                                state.cache_v[i], start)
        if collect_cross_inputs:
            cross_in.append(xin)
    h = layer_norm(h, dec["ln_w"], dec["ln_b"])
    logits = pmatmul(h.to(torch.float32), dec["token_emb"].t().to(torch.float32))
    state = dataclasses.replace(state, pos=pos + S)
    if collect_cross_inputs:
        return logits, state, torch.stack(cross_in)
    return logits, state


# ---------------------------------------------------------------------------
# Transcription
# ---------------------------------------------------------------------------


def asr_encode(params: Params, cfg: WhisperASRModelConfig, mel: torch.Tensor,
               mel_len: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T_mel, n_mels) log-mel -> (B, T_enc, D) encoder states and their
    lengths."""
    return whisper_encoder_forward(params["encoder"], cfg.num_heads, mel,
                                   mel_len)


class GreedyResult(NamedTuple):
    tokens: torch.Tensor          # (B, max_new) int32, EOT-padded
    n_tokens: torch.Tensor        # (B,) int32, tokens before EOT
    sum_logprob: torch.Tensor     # (B,) float32, sum of the picked logprobs
    no_speech_prob: torch.Tensor  # (B,) float32, p(<|nospeech|>) at the SOT


Noise = Callable[[int], torch.Tensor]


def _pick(logp: torch.Tensor, temperature: float, noise: Optional[Noise],
          t: int) -> torch.Tensor:
    """argmax at T = 0; at T > 0 the Gumbel-max sample argmax(logp / T + g)
    with g = noise(t), (B, V) standard Gumbel draws."""
    if temperature <= 0.0:
        return logp.argmax(dim=-1)
    if noise is None:
        raise ValueError("sampling at temperature > 0 needs noise")
    g = noise(t).to(device=logp.device, dtype=logp.dtype)
    return (logp / max(temperature, 1e-4) + g).argmax(dim=-1)


def _sample_loop(params: Params, cfg: WhisperASRModelConfig,
                 cross: dict[str, torch.Tensor], enc_len: torch.Tensor,
                 state: ASRDecodeState, prompt: torch.Tensor, max_new: int,
                 temperature: float = 0.0, noise: Optional[Noise] = None,
                 sot_index: int = 0) -> GreedyResult:
    """Greedy or sampled AR decode of the prompt rows against a prepared
    encoder context (cross K/V, lengths, a fresh slab state). Finished rows
    keep being fed EOT, as in JAX; the loop ends when every row is done
    (one host read a token) or after max_new tokens."""
    B = prompt.shape[0]
    eot = cfg.eot_id
    layers = decoder_layer_views(params)
    logits, state = asr_decoder_forward(params, cfg, prompt, state, cross,
                                        enc_len, layers)
    # p(no-speech) at the SOT position, read before sampling begins
    # (sot_index > 0 when <|startofprev|> tokens precede the SOT block)
    no_speech = torch.softmax(logits[:, sot_index], dim=-1)[:, cfg.no_speech_id]

    logp = torch.log_softmax(logits[:, -1], dim=-1)
    tok = _pick(logp, temperature, noise, 0)
    sum_lp = logp.gather(1, tok[:, None])[:, 0]
    buf = torch.full((B, max_new), eot, dtype=torch.int64, device=prompt.device)
    done = tok == eot
    buf[:, 0] = torch.where(done, eot, tok)
    n = (~done).to(torch.int32)
    t = 1
    while t < max_new and not bool(done.all()):
        logits, state = asr_decoder_forward(params, cfg, tok[:, None], state,
                                            cross, enc_len, layers)
        logp = torch.log_softmax(logits[:, -1], dim=-1)
        nxt = _pick(logp, temperature, noise, t)
        lp_t = logp.gather(1, nxt[:, None])[:, 0]
        is_eot = nxt == eot
        live = ~done & ~is_eot
        buf[:, t] = torch.where(live, nxt, eot)
        n = n + live.to(torch.int32)
        sum_lp = sum_lp + torch.where(done, torch.zeros_like(lp_t), lp_t)
        tok = torch.where(done, eot, nxt)
        done = done | is_eot
        t += 1
    return GreedyResult(tokens=buf.to(torch.int32), n_tokens=n,
                        sum_logprob=sum_lp, no_speech_prob=no_speech)


def encoder_context(params: Params, cfg: WhisperASRModelConfig,
                    mel: torch.Tensor, mel_len: torch.Tensor
                    ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """The encoder pass of an utterance: (cross K/V, encoder lengths)."""
    enc, enc_len = asr_encode(params, cfg, mel, mel_len)
    return precompute_cross_kv(params, cfg, enc), enc_len


def asr_greedy_decode(params: Params, cfg: WhisperASRModelConfig,
                      mel: torch.Tensor, mel_len: torch.Tensor,
                      prompt: torch.Tensor, max_new: int,
                      temperature: float = 0.0, noise: Optional[Noise] = None,
                      sot_index: int = 0) -> GreedyResult:
    """Whole-utterance transcription: encode, then decode up to max_new
    tokens after the forced `prompt` (B, P) (e.g. [sot, lang, transcribe,
    notimestamps]). temperature 0 is greedy; above 0 each token is sampled
    from softmax(logp / T) with noise(t)'s Gumbel draws."""
    cross, enc_len = encoder_context(params, cfg, mel, mel_len)
    state = init_asr_decode_state(cfg, prompt.shape[0], cross["k"].dtype,
                                  prompt.device)
    return _sample_loop(params, cfg, cross, enc_len, state, prompt, max_new,
                        temperature, noise, sot_index)


def _tile_beams(cross: dict[str, torch.Tensor], enc_len: torch.Tensor, n: int
                ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """The encoder context of each utterance repeated for n rows (row
    r = b·n + j, JAX's ``jnp.repeat``): one encoder pass serves every
    candidate or beam. The copies are fresh storage."""
    return ({k: v.repeat_interleave(n, dim=1) for k, v in cross.items()},
            enc_len.repeat_interleave(n, dim=0))


def _best_of_loop(params: Params, cfg: WhisperASRModelConfig,
                  cross: dict[str, torch.Tensor], enc_len: torch.Tensor,
                  prompt: torch.Tensor, max_new: int, best_of: int,
                  temperature: float, noise: Optional[Noise],
                  sot_index: int = 0) -> GreedyResult:
    """best-of-N against a prepared encoder context: N sampled rows an
    utterance in one batch (noise(t): (B·N, V) draws), then the row with
    the best sum/(n+1) wins (the first on a tie); p(no speech) is row
    b·N's."""
    B = prompt.shape[0]
    cross, enc_len = _tile_beams(cross, enc_len, best_of)
    state = init_asr_decode_state(cfg, B * best_of, cross["k"].dtype,
                                  prompt.device)
    res = _sample_loop(params, cfg, cross, enc_len, state,
                       prompt.repeat_interleave(best_of, dim=0), max_new,
                       temperature, noise, sot_index)
    avg = (res.sum_logprob / (res.n_tokens.to(torch.float32) + 1.0)
           ).reshape(B, best_of)
    rows = torch.arange(B, device=prompt.device) * best_of + avg.argmax(dim=1)
    return GreedyResult(tokens=res.tokens[rows], n_tokens=res.n_tokens[rows],
                        sum_logprob=res.sum_logprob[rows],
                        no_speech_prob=res.no_speech_prob[::best_of])


def asr_sample_best_of(params: Params, cfg: WhisperASRModelConfig,
                       mel: torch.Tensor, mel_len: torch.Tensor,
                       prompt: torch.Tensor, max_new: int, best_of: int,
                       temperature: float, noise: Optional[Noise] = None,
                       sot_index: int = 0) -> GreedyResult:
    """best-of-N sampled transcription: one encoder pass, N independent
    samples an utterance decoded as rows of one batch, and per utterance
    the candidate with the best length-normalised log-probability
    sum/(n+1), the measure the service's confidence gate reads."""
    cross, enc_len = encoder_context(params, cfg, mel, mel_len)
    return _best_of_loop(params, cfg, cross, enc_len, prompt, max_new,
                         best_of, temperature, noise, sot_index)


class BeamResult(NamedTuple):
    tokens: torch.Tensor          # (B, max_new) int32, the best hypothesis
    n_tokens: torch.Tensor        # (B,) int32, tokens before EOT
    sum_logprob: torch.Tensor     # (B,) float32, the closing EOT's included
    no_speech_prob: torch.Tensor  # (B,) float32
    n_finished: torch.Tensor      # (B,) int32, hypotheses closed by EOT


def _pool_insert(pool: list, order: torch.Tensor, valid: torch.Tensor,
                 score: torch.Tensor, seqs: torch.Tensor, length,
                 W: int) -> None:
    """Move candidates into each utterance's finished pool in `order`
    (B, W): candidate j enters slot fin_cnt when valid[b, j] and the pool
    has room. pool: [fin_tok (B, W, max_new), fin_sum (B, W), fin_n (B, W),
    fin_cnt (B,)], updated in place."""
    ft, fs, fn, fc = pool
    b = torch.arange(order.shape[0], device=order.device)
    for i in range(W):
        j = order[:, i]
        ok = valid[b, j] & (fc < W)
        slot = fc.clamp(max=W - 1)
        fs[b, slot] = torch.where(ok, score[b, j], fs[b, slot])
        ft[b, slot] = torch.where(ok[:, None], seqs[b, j], ft[b, slot])
        fn[b, slot] = torch.where(ok, torch.as_tensor(length, dtype=fn.dtype,
                                                      device=fn.device),
                                  fn[b, slot])
        fc += ok.to(fc.dtype)


def _beam_loop(params: Params, cfg: WhisperASRModelConfig,
               cross: dict[str, torch.Tensor], enc_len: torch.Tensor,
               prompt: torch.Tensor, max_new: int, beam_size: int,
               sot_index: int = 0) -> BeamResult:
    """Beam search against a prepared encoder context (see
    ``asr_beam_decode``)."""
    B = prompt.shape[0]
    W, V, eot = beam_size, cfg.vocab_size, cfg.eot_id
    R = B * W
    NEG = -1e9
    dev = prompt.device
    f32 = torch.float32
    cross, enc_lenR = _tile_beams(cross, enc_len, W)
    state = init_asr_decode_state(cfg, R, cross["k"].dtype, dev)
    layers = decoder_layer_views(params)
    logits, state = asr_decoder_forward(params, cfg,
                                        prompt.repeat_interleave(W, dim=0),
                                        state, cross, enc_lenR, layers)
    no_speech = torch.softmax(logits[::W, sot_index], dim=-1)[:, cfg.no_speech_id]
    logp = torch.log_softmax(logits[:, -1], dim=-1).reshape(B, W, V)

    barange = torch.arange(B, device=dev)
    eot_onehot = torch.zeros(V, dtype=f32, device=dev)
    eot_onehot[eot] = 1.0
    beam_tok = torch.full((B, W, max_new), eot, dtype=torch.int64, device=dev)
    beam_sum = torch.full((B, W), NEG, dtype=f32, device=dev)
    beam_sum[:, 0] = 0.0
    pool = [torch.full((B, W, max_new), eot, dtype=torch.int64, device=dev),
            torch.full((B, W), NEG, dtype=f32, device=dev),
            torch.zeros((B, W), dtype=torch.int32, device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev)]

    t = 0
    while True:
        # EOT proposals: one a beam, valid only inside that beam's own
        # top-(W+1) and on a live beam; best first into the pool
        live = beam_sum > NEG / 2
        kth = torch.topk(logp, min(W + 1, V), dim=-1, sorted=True).values[..., -1]
        eot_lp = logp[..., eot]
        eot_valid = (eot_lp >= kth) & live
        eot_score = beam_sum + eot_lp
        order = torch.argsort(-torch.where(eot_valid, eot_score,
                                           torch.full_like(eot_score, NEG)),
                              dim=1, stable=True)
        _pool_insert(pool, order, eot_valid, eot_score, beam_tok, t, W)

        # continuations: the top W of the W·V non-EOT candidates. A stable
        # descending sort takes the lower index first on a tie, as
        # lax.top_k does (torch.topk leaves the order of ties open).
        cand = beam_sum[..., None] + logp - eot_onehot * 1e9
        top_s, top_i = torch.sort(cand.reshape(B, W * V), dim=1,
                                  descending=True, stable=True)
        top_s, top_i = top_s[:, :W], top_i[:, :W]
        parent = top_i // V
        tok = top_i % V
        beam_tok = beam_tok[barange[:, None], parent]
        beam_tok[:, :, t] = tok
        beam_sum = top_s
        # reorder the slabs: the parents' rows gathered into fresh storage
        # (the next decoder call writes the slabs in place)
        rows = (barange[:, None] * W + parent).reshape(R)
        state = ASRDecodeState(state.cache_k.index_select(1, rows),
                               state.cache_v.index_select(1, rows), state.pos)
        t += 1
        # JAX's loop condition, read on the host once a step
        if t >= max_new or bool((pool[3] >= W).all()):
            break
        logits, state = asr_decoder_forward(params, cfg, tok.reshape(R, 1),
                                            state, cross, enc_lenR, layers)
        logp = torch.log_softmax(logits[:, -1], dim=-1).reshape(B, W, V)

    n_finished = pool[3].clamp(max=W)
    # finalize: a pool not full is padded with the running beams, best
    # score first, each of length t
    order = torch.argsort(-beam_sum, dim=1, stable=True)
    _pool_insert(pool, order, torch.ones_like(beam_sum, dtype=torch.bool),
                 beam_sum, beam_tok, t, W)
    fin_tok, fin_sum, fin_n, _ = pool
    best = (fin_sum / (fin_n.to(f32) + 1.0)).argmax(dim=1)
    return BeamResult(tokens=fin_tok[barange, best].to(torch.int32),
                      n_tokens=fin_n[barange, best],
                      sum_logprob=fin_sum[barange, best],
                      no_speech_prob=no_speech, n_finished=n_finished)


def asr_beam_decode(params: Params, cfg: WhisperASRModelConfig,
                    mel: torch.Tensor, mel_len: torch.Tensor,
                    prompt: torch.Tensor, max_new: int, beam_size: int,
                    sot_index: int = 0) -> BeamResult:
    """Beam-search transcription (openai whisper's BeamSearchDecoder with
    patience 1, as JAX's ``asr_beam_decode`` runs it):

    - beams are rows of the decode batch (row r = b·W + w); reordering the
      beams gathers their slab rows;
    - every step each live beam proposes EOT when EOT is inside its own
      top-(W+1); proposals enter the utterance's finished pool best first,
      at most W hypotheses; the best W non-EOT continuations of all beams
      become the next beams;
    - the search ends when every pool is full or the token budget is
      spent; a pool not full is then padded with the running beams;
    - the hypothesis with the best sum/(n+1) wins.
    """
    cross, enc_len = encoder_context(params, cfg, mel, mel_len)
    return _beam_loop(params, cfg, cross, enc_len, prompt, max_new,
                      beam_size, sot_index)


def asr_alignment_probs(params: Params, cfg: WhisperASRModelConfig,
                        mel: torch.Tensor, mel_len: torch.Tensor,
                        tokens: torch.Tensor,
                        heads: tuple[tuple[int, int], ...]
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced cross-attention maps of the alignment heads, for
    word timestamps (openai whisper's timing.find_alignment). One forward
    over `tokens` (B, S) keeps each layer's cross-attention input; only
    the selected (layer, head) pairs are re-projected, so K maps of
    (S, T_enc) exist rather than every head's.

    Returns (probs (B, K, S, T_enc) float32, each head's softmax masked to
    the real encoder frames; token_logprob (B, S) float32, log p(tokens[i]
    | tokens[<i]) under teacher forcing, 0 at position 0)."""
    cross, enc_len = encoder_context(params, cfg, mel, mel_len)
    return _alignment_loop(params, cfg, cross, enc_len, tokens, heads)


def _alignment_loop(params: Params, cfg: WhisperASRModelConfig,
                    cross: dict[str, torch.Tensor], enc_len: torch.Tensor,
                    tokens: torch.Tensor, heads: tuple[tuple[int, int], ...]
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``asr_alignment_probs`` against a prepared encoder context."""
    B, S = tokens.shape
    state = init_asr_decode_state(cfg, B, cross["k"].dtype, tokens.device)
    layers = decoder_layer_views(params)
    logits, _, xin = asr_decoder_forward(params, cfg, tokens, state, cross,
                                         enc_len, layers,
                                         collect_cross_inputs=True)
    lp_all = torch.log_softmax(logits, dim=-1)
    tok_lp = lp_all[:, :-1].gather(2, tokens[:, 1:, None].long())[:, :, 0]
    token_logprob = torch.cat(
        [torch.zeros((B, 1), dtype=torch.float32, device=tokens.device),
         tok_lp], dim=1)

    H, Dh = cfg.num_heads, cfg.head_dim
    T = cross["k"].shape[2]
    frame_ok = (torch.arange(T, device=tokens.device)[None, None, :]
                < enc_len[:, None, None])
    scale = torch.sqrt(torch.tensor(Dh, dtype=torch.float32))
    q_of: dict[int, torch.Tensor] = {}
    maps = []
    for l, h in heads:
        if l not in q_of:          # one projection a layer, for all its heads
            lp = layers[l]
            x = layer_norm(xin[l], lp["cross_ln_w"], lp["cross_ln_b"])
            q_of[l] = (quantized_matmul(x, lp, "cross_wq")
                       + lp["cross_bq"]).reshape(B, S, H, Dh)
        q = q_of[l][:, :, h].to(torch.float32)
        k = cross["k"][l][:, :, h].to(torch.float32)          # (B, T, Dh)
        scores = pmatmul(q, k.transpose(1, 2)) / scale.to(q.device)
        scores = torch.where(frame_ok, scores,
                             torch.full_like(scores, -1e30))
        maps.append(torch.softmax(scores, dim=-1))
    return torch.stack(maps, dim=1), token_logprob


def asr_detect_language(params: Params, cfg: WhisperASRModelConfig,
                        mel: torch.Tensor, mel_len: torch.Tensor
                        ) -> torch.Tensor:
    """One decode step from [sot]: the softmax over the language-token
    block, (B, num_languages)."""
    B = mel.shape[0]
    cross, enc_len = encoder_context(params, cfg, mel, mel_len)
    state = init_asr_decode_state(cfg, B, cross["k"].dtype, mel.device)
    sot = torch.full((B, 1), cfg.sot_id, dtype=torch.int64, device=mel.device)
    logits, _ = asr_decoder_forward(params, cfg, sot, state, cross, enc_len)
    lo = cfg.first_language_id
    return torch.softmax(logits[:, 0, lo:lo + cfg.num_languages], dim=-1)
