"""RedCodec: 16 kHz waveform -> 12.5 Hz RVQ tokens -> 24 kHz audio.

Counterpart of ``fireredtts2_tpu/models/codec/model.py``:
- encode: log-mel -> SSL encoder (32 layers x 1280 at full width) +
  adaptor (semantic) | acoustic encoder -> concat -> 4x GLU downsample ->
  RVQ codes, in 6 s windows (``encode_window``, ``codec_encode``;
  token_length = ceil(samples / 1280));
- decode: RVQ decode -> UpConv x4 -> streaming acoustic decoder
  (``codec_decode_chunks``), or the batch decoder over the whole
  utterance (``codec_decode``, offline).
The encode runs on fp32 log-mels, so its activations are fp32 whatever the
weights' dtype, every fp32 product in full fp32 (``ops.precision``). The
semantic decoder (the SSL reconstruction head) serves training only: it is
in the tree only when training asks for it.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch

from fireredtts2_tpu_torch.config import CodecConfig
from fireredtts2_tpu_torch.models.codec.encoder import (
    down_conv_forward, init_down_conv, init_ssl_adaptor, ssl_adaptor_forward,
)
from fireredtts2_tpu_torch.models.codec.rvq import (
    init_rvq_params, rvq_decode, rvq_encode,
)
from fireredtts2_tpu_torch.models.codec.decoder import (
    VocoderStreamState, acoustic_decoder_forward, init_acoustic_decoder,
    init_upconv, stream_decode_scan, stream_state_init, upconv_forward,
)
from fireredtts2_tpu_torch.models.codec.whisper_nn import (
    init_whisper_encoder, whisper_encoder_forward,
)
from fireredtts2_tpu_torch.ops.audio import (
    log_mel_spectrogram, whisper_mel_filters,
)

Params = dict[str, Any]


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def init_codec_params(gen: torch.Generator, cfg: CodecConfig,
                      dtype=torch.float32, device=None,
                      semantic_head: bool = False) -> Params:
    """Random params in the JAX tree layout: the decode side ("rvq",
    "upsample", "acoustic_decoder") drawn first, then the encoders ("ssl",
    "ssl_adaptor", "acoustic_encoder", "downsample"), plus the host-built
    fp32 "mel_filters"; with semantic_head, training's "semantic_decoder"
    drawn last."""
    def encoder(c):
        return init_whisper_encoder(gen, c.in_dim, c.embed_dim, c.num_layers,
                                    c.num_heads, c.resolved_ffn_dim,
                                    c.max_positions, dtype, device)

    m = cfg.mel
    params = {
        "rvq": init_rvq_params(gen, cfg.rvq, dtype, device),
        "upsample": init_upconv(gen, cfg.upsample_embed_dim,
                                cfg.upsample_stride, dtype, device),
        "acoustic_decoder": init_acoustic_decoder(gen, cfg.acoustic_decoder,
                                                  dtype, device),
        "ssl": encoder(cfg.ssl),
        "ssl_adaptor": init_ssl_adaptor(gen, cfg.ssl_adaptor, dtype, device),
        "acoustic_encoder": encoder(cfg.acoustic_encoder),
        "downsample": init_down_conv(gen, cfg.downsample_embed_dim,
                                     cfg.downsample_factor, dtype, device),
        "mel_filters": torch.from_numpy(whisper_mel_filters(
            m.num_mels, m.n_fft, m.sampling_rate, m.fmin, m.fmax)).to(device),
    }
    if semantic_head:
        params["semantic_decoder"] = init_ssl_adaptor(
            gen, cfg.semantic_decoder, dtype, device)
    return params


def _mel(params: Params, cfg: CodecConfig, audio16k: torch.Tensor,
         lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> ((B, T, n_mels) fp32 log-mel, mel lengths)."""
    mel = log_mel_spectrogram(audio16k, params["mel_filters"],
                              cfg.mel.n_fft, cfg.mel.hop_length)
    return mel.transpose(1, 2), lengths // cfg.mel.hop_length


def encode_features(params: Params, cfg: CodecConfig, audio16k: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """The RVQ's input for a batch of windows: mel -> (SSL encoder +
    adaptor | acoustic encoder) -> concat -> downsample, (B, T_tokens, D)."""
    mel, mel_len = _mel(params, cfg, audio16k, lengths)
    ssl, ssl_len = whisper_encoder_forward(params["ssl"], cfg.ssl.num_heads,
                                           mel, mel_len)
    sem, _ = ssl_adaptor_forward(params["ssl_adaptor"], cfg.ssl_adaptor,
                                 ssl, ssl_len)
    aco, aco_len = whisper_encoder_forward(
        params["acoustic_encoder"], cfg.acoustic_encoder.num_heads, mel,
        mel_len)
    feats = torch.cat([sem, aco], dim=-1)
    down, _ = down_conv_forward(params["downsample"],
                                cfg.downsample_factor, feats, aco_len)
    return down


def encode_window(params: Params, cfg: CodecConfig, audio16k: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Encode one batch of fixed-size 16 kHz windows: audio16k (B, T) with
    T a multiple of the 6 s window, lengths (B,) valid samples -> (nq, B,
    T_tokens) int32 codes."""
    return rvq_encode(params["rvq"], cfg.rvq,
                      encode_features(params, cfg, audio16k, lengths))


def codec_encode(params: Params, cfg: CodecConfig, audio16k: np.ndarray,
                 lengths: Optional[np.ndarray] = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Host-orchestrated full encode on the params' device: every stream
    is cut into 6 s windows, the windows go through :func:`encode_window`
    in sub-batches of at most ``cfg.encode_max_batch`` padded up to powers
    of two (zero windows), and each stream's codes are cut to
    ceil(samples / 1280) tokens (12.5 Hz).

    Returns (codes (B, nq, L) int32, token_lengths (B,) int64)."""
    audio16k = np.asarray(audio16k, np.float32)
    B, T = audio16k.shape
    if lengths is None:
        lengths = np.full((B,), T, np.int64)
    win = cfg.encode_chunk_seconds * cfg.input_sample_rate
    device = params["mel_filters"].device

    chunks, owners = [], []
    for b in range(B):
        n = int(lengths[b])
        n_win = max(1, math.ceil(n / win))
        padded = np.zeros((n_win * win,), np.float32)
        padded[:n] = audio16k[b, :n]
        for c in range(n_win):
            chunks.append(padded[c * win:(c + 1) * win])
            owners.append(b)

    max_b = max(1, cfg.encode_max_batch)
    parts = []
    for i in range(0, len(chunks), max_b):
        sub = np.stack(chunks[i:i + max_b])
        n_sub = sub.shape[0]
        bs = min(max_b, _next_pow2(n_sub))
        if bs > n_sub:
            sub = np.concatenate([sub, np.zeros((bs - n_sub, win), np.float32)])
        out = encode_window(params, cfg, torch.from_numpy(sub).to(device),
                            torch.full((bs,), win, dtype=torch.int32,
                                       device=device))
        parts.append(out[:, :n_sub].cpu().numpy())
    codes = np.concatenate(parts, axis=1)               # (nq, n_chunks, L_win)

    nq = codes.shape[0]
    token_lengths = np.ceil(np.asarray(lengths) / cfg.samples_per_token_16k
                            ).astype(np.int64)
    L = int(token_lengths.max())
    out = np.zeros((B, nq, L), np.int32)
    for b in range(B):
        full = np.concatenate([codes[:, i, :] for i, o in enumerate(owners)
                               if o == b], axis=-1)
        out[b, :, :token_lengths[b]] = full[:, :token_lengths[b]]
    return out, token_lengths


def _upsampled(params: Params, cfg: CodecConfig, tokens: torch.Tensor
               ) -> torch.Tensor:
    """tokens (B, nq, L) -> the decoder's 50 Hz input (B, 4L, D)."""
    feats = rvq_decode(params["rvq"], cfg.rvq, tokens.permute(1, 0, 2))
    dtype = params["upsample"]["in_proj_w"].dtype
    return upconv_forward(params["upsample"], cfg.upsample_stride,
                          feats.to(dtype))


def codec_decode(params: Params, cfg: CodecConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """Batch decode of whole utterances: tokens (B, nq, L) -> (B, L * 1920)
    audio at 24 kHz, through the batch decoder (no gradients kept)."""
    with torch.no_grad():
        up = _upsampled(params, cfg, tokens)
        lengths = torch.full((tokens.shape[0],), up.shape[1],
                             dtype=torch.int32, device=up.device)
        audio, _ = acoustic_decoder_forward(params["acoustic_decoder"],
                                            cfg.acoustic_decoder, up, lengths)
    return audio


def codec_decode_chunks(params: Params, cfg: CodecConfig, tokens: torch.Tensor):
    """Bucket-safe decode: tokens (B, nq, Lpad) -> (middles (L, B, 1920),
    tails (L, B, 360)) with exact streaming semantics, assembled for any
    true length T <= Lpad by :func:`assemble_chunks`."""
    return stream_decode_scan(params["acoustic_decoder"], cfg.acoustic_decoder,
                              _upsampled(params, cfg, tokens))


def assemble_chunks(middles: np.ndarray, tails: np.ndarray, T: int,
                    hop_length: int, n_fft: int) -> np.ndarray:
    """Host assembly of codec_decode_chunks output for true length T.
    Returns (B, T*8*hop) float32."""
    pad = (n_fft - hop_length) // 2
    lead = (n_fft - hop_length) - pad
    parts = [middles[0][:, lead:]]
    for t in range(1, T):
        parts.append(middles[t])
    parts.append(tails[T - 1])
    return np.concatenate(parts, axis=1)


def stream_decode_init(cfg: CodecConfig, batch: int, dtype=torch.float32,
                       device=None, latents: int | None = None
                       ) -> VocoderStreamState:
    return stream_state_init(cfg.acoustic_decoder, batch, dtype, device=device,
                             latents=latents)
