"""Text-to-speech engine on PyTorch: text in, 24 kHz audio out.

Counterpart of ``fireredtts2_tpu/engine/engine.py`` for synthesis without a
voice prompt: ``generate`` (whole utterance, then a bucketed vocoder
pass), ``generate_stream`` (K-frame LM + vocoder blocks, ~80 ms chunks)
and ``generate_batch`` (several texts decoded together). Prompt audio,
voice cloning, dialogue and the voice-state cache come later.

Prompts are left-padded into static buckets, as in the JAX package (RoPE
shift invariance keeps this exact). Sampling noise of global frame t comes
from a generator seeded by (utterance seed, t), so ``generate`` and
``generate_stream`` sample the same tokens for one utterance seed -- the
counterpart of the JAX package's fold_in(key, t).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterator, List, Optional

import numpy as np
import torch

from fireredtts2_tpu_torch.config import EngineConfig
from fireredtts2_tpu_torch.models.codec.model import (
    assemble_chunks, codec_decode_chunks, stream_decode_init,
)
from fireredtts2_tpu_torch.models.lm.model import (
    init_lm_state, lm_generate_frame, lm_generate_loop,
)
from fireredtts2_tpu_torch.models.pipeline import stream_block
from fireredtts2_tpu_torch.utils.tokenizer import load_tokenizer
from fireredtts2_tpu_torch.weights import dtype_of, init_random


def _frame_seed(utt_seed: int, t: int) -> int:
    return (utt_seed * 1_000_003 + t) & ((1 << 63) - 1)


class FireRedTTS2Engine:
    """Single-utterance and streaming synthesis from text."""

    def __init__(self, config: Optional[EngineConfig] = None, seed: int = 0,
                 device=None, lm_params: Optional[dict] = None,
                 codec_params: Optional[dict] = None):
        """config: the model and engine configuration (default: the
        flagship EngineConfig()). device: where weights, state and kernels
        live ("cuda" on the card; default "cuda" when one is available,
        else "cpu"). lm_params / codec_params: parameter trees in the JAX
        layout (e.g. ``weights.from_jax`` of the JAX engine's); when absent
        the engine draws random weights from `seed`."""
        config = config or EngineConfig()
        llm = config.llm
        if (llm.quantize_backbone or llm.quantize_depth or llm.fused_depth_plan
                or llm.speculative_depth or config.codec.quantize_vocoder
                or not config.codec.acoustic_decoder.causal):
            raise NotImplementedError(
                "this configuration needs a path that is not ported yet "
                "(int8/int4 weights, the fused depth kernel, speculative "
                "depth, or the non-causal vocoder)")
        self.config = config
        self.device = torch.device(
            device or ("cuda" if torch.cuda.is_available() else "cpu"))
        if lm_params is None or codec_params is None:
            rand_lm, rand_codec = init_random(config, seed, self.device)
            lm_params = lm_params or rand_lm
            codec_params = codec_params or rand_codec
        self.lm_params, self.codec_params = lm_params, codec_params
        self.tokenizer = load_tokenizer(None)

        acfg = config.codec.acoustic_decoder
        self.max_seq_len = config.max_seq_len
        self.output_sample_rate = config.codec.output_sample_rate
        self._ncb = llm.audio_num_codebooks
        self._ncols = llm.num_columns
        self._chunk_samples = 8 * acfg.hop_length
        self._tail_samples = (acfg.n_fft - acfg.hop_length) \
            - (acfg.n_fft - acfg.hop_length) // 2
        self._lead_samples = self._tail_samples
        self._lock = threading.Lock()
        self._seeds = np.random.default_rng(seed + 17)
        self._first_packet_s: Optional[float] = None
        # The frames (T, ncb) of the last generate / generate_stream call,
        # and the host-clock split of the last generate call.
        self.last_tokens: Optional[np.ndarray] = None
        self.last_stats: dict = {}

    # ------------------------------------------------------------------
    # Prompt building
    # ------------------------------------------------------------------

    def _next_seed(self) -> int:
        with self._lock:
            return int(self._seeds.integers(0, 1 << 31))

    def noise_fn(self, utt_seed: int, B: int) -> Callable[[int], torch.Tensor]:
        """Frame t's sampling noise (B, ncb, V_audio), Exp(1) draws from a
        generator seeded by (utt_seed, t)."""
        shape = (B, self._ncb, self.config.llm.audio_vocab_size)

        def fn(t: int) -> torch.Tensor:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(_frame_seed(utt_seed, t))
            return torch.empty(shape, dtype=torch.float32,
                               device=self.device).exponential_(generator=gen)
        return fn

    def _tokenize_text_segment(self, text: str, speaker: str):
        """-> ((T, ncols) tokens, mask), text ids in the last column."""
        ids = self.tokenizer.encode(f"{speaker}<|text_start|>{text}<|text_end|>")
        frame = np.zeros((len(ids), self._ncols), np.int32)
        mask = np.zeros((len(ids), self._ncols), bool)
        frame[:, -1] = ids
        mask[:, -1] = True
        return frame, mask

    def _build_prompt(self, context: Optional[list], text: str, speaker: str):
        if context:
            raise NotImplementedError("prompt audio / context segments are "
                                      "not ported yet")
        return self._tokenize_text_segment(text, speaker)

    def _bucket(self, length: int) -> int:
        for b in self.config.prefill_buckets:
            if b >= length:
                return b
        raise ValueError(f"prompt too long: {length} > max bucket "
                         f"{self.config.prefill_buckets[-1]}")

    def _bucketize(self, prompts: list):
        """Left-pad B (prompt, mask) pairs into the static bucket of the
        longest -> (bucket, tokens, mask, valid), each with a leading B."""
        bucket = self._bucket(max(p.shape[0] for p, _ in prompts))
        B = len(prompts)
        tokens = np.zeros((B, bucket, self._ncols), np.int32)
        mask = np.zeros((B, bucket, self._ncols), bool)
        valid = np.zeros((B, bucket), bool)
        for i, (p, m) in enumerate(prompts):
            pad = bucket - p.shape[0]
            tokens[i, pad:] = p
            mask[i, pad:] = m
            valid[i, pad:] = True
        return bucket, tokens, mask, valid

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _new_lm_state(self, B: int):
        return init_lm_state(self.config.llm, B, dtype_of(self.config.llm.dtype),
                             device=self.device)

    def _new_vstate(self, B: int):
        return stream_decode_init(self.config.codec, B,
                                  dtype_of(self.config.codec.dtype),
                                  device=self.device)

    # ------------------------------------------------------------------
    # Core generation
    # ------------------------------------------------------------------

    def _sampling(self, temperature: float, topk: int) -> dict:
        return dict(temperature=temperature, topk=topk,
                    depth_topk=self.config.depth_topk,
                    depth_temperature=self.config.depth_temperature)

    @torch.inference_mode()
    def _run_ar(self, prompts: list, max_generation_len: int,
                temperature: float, topk: int,
                utt_seed: Optional[int] = None) -> list[np.ndarray]:
        """AR generation of B utterances together (shared bucket,
        per-stream EOS) -> B arrays of (T_i, ncb) int32 frames."""
        bucket, tokens, mask, valid = self._bucketize(prompts)
        B = len(prompts)
        max_frames = self.max_seq_len - bucket
        cap = min(max_generation_len, max_frames)
        seed = self._next_seed() if utt_seed is None else utt_seed
        _, buf, n_frames = lm_generate_loop(
            self.lm_params, self.config.llm, self._new_lm_state(B),
            self._dev(tokens), self._dev(mask), self._dev(valid),
            self.noise_fn(seed, B), max_frames=max_frames, frame_cap=cap,
            **self._sampling(temperature, topk))
        buf, n_frames = buf.cpu().numpy(), n_frames.cpu().numpy()
        return [buf[i, :n_frames[i]] for i in range(B)]

    @torch.inference_mode()
    def _decode_tokens(self, frames: list[np.ndarray]) -> list[np.ndarray]:
        """B arrays of (T_i, ncb) frames -> B (T_i * 1920,) float32
        waveforms at 24 kHz: one bucket-padded streaming-exact vocoder pass
        (padding cannot leak into the audio)."""
        T_max = max(f.shape[0] for f in frames)
        if T_max == 0:
            return [np.zeros((0,), np.float32) for _ in frames]
        Lpad = ((T_max + 31) // 32) * 32
        toks = np.zeros((len(frames), self._ncb, Lpad), np.int32)
        for i, f in enumerate(frames):
            toks[i, :, :f.shape[0]] = f.T
        middles, tails = codec_decode_chunks(self.codec_params,
                                             self.config.codec, self._dev(toks))
        middles = middles.float().cpu().numpy()
        tails = tails.float().cpu().numpy()
        acfg = self.config.codec.acoustic_decoder
        return [assemble_chunks(middles[:, i:i + 1], tails[:, i:i + 1],
                                f.shape[0], acfg.hop_length, acfg.n_fft)[0]
                .astype(np.float32) if f.shape[0] else np.zeros(0, np.float32)
                for i, f in enumerate(frames)]

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def generate(self, text: str, speaker: str, context: Optional[list] = None,
                 max_audio_length_ms: float = 90_000, temperature: float = 0.9,
                 topk: int = 20, utt_seed: Optional[int] = None) -> np.ndarray:
        """One utterance -> (n,) float32 at 24 kHz. utt_seed fixes the
        sampling noise (default: the engine's seed chain)."""
        prompt = self._build_prompt(context, text, speaker)
        t0 = time.perf_counter()
        [gen] = self._run_ar([prompt], int(max_audio_length_ms / 80),
                             temperature, topk, utt_seed)
        t1 = time.perf_counter()
        [audio] = self._decode_tokens([gen])
        self.last_tokens = gen
        self.last_stats = {"frames": int(gen.shape[0]), "lm_s": t1 - t0,
                           "vocode_s": time.perf_counter() - t1}
        return audio

    def generate_batch(self, texts: List[str], speakers: List[str],
                       max_audio_length_ms: float = 30_000,
                       temperature: float = 0.9, topk: int = 20,
                       utt_seed: Optional[int] = None) -> list[np.ndarray]:
        """Several utterances decoded together (shared bucket, per-stream
        EOS) -> list of (n_i,) float32 waveforms at 24 kHz."""
        if len(texts) != len(speakers):
            raise ValueError(f"{len(texts)} texts but {len(speakers)} speakers")
        prompts = [self._build_prompt(None, t, s) for t, s in zip(texts, speakers)]
        frames = self._run_ar(prompts, int(max_audio_length_ms / 80),
                              temperature, topk, utt_seed)
        return self._decode_tokens(frames)

    def generate_stream(self, text: str, speaker: str,
                        context: Optional[list] = None,
                        max_audio_length_ms: float = 90_000,
                        temperature: float = 0.9, topk: int = 20,
                        utt_seed: Optional[int] = None) -> Iterator[np.ndarray]:
        """Streaming synthesis: yields float32 chunks at 24 kHz.

        The first call prefills the prompt and runs a 1-frame block; blocks
        then grow 1 -> 4 -> 16 (stream_block_cap) frames. Each block is one
        LM + vocoder pass with one packed host copy; the host emits middles
        for live frames and closes with the tail of the last live frame.
        The utterance is capped by the vocoder's KV slab (8 latents per
        frame)."""
        max_len = int(max_audio_length_ms / 80)
        max_len = min(max_len,
                      self.config.codec.acoustic_decoder.max_stream_latents // 8)
        t_start = time.perf_counter()
        self._first_packet_s = None
        self.last_tokens = np.zeros((0, self._ncb), np.int32)
        bucket, tokens, tmask, valid = self._bucketize(
            [self._build_prompt(context, text, speaker)])
        max_len = min(max_len, self.max_seq_len - bucket)
        seed = self._next_seed() if utt_seed is None else utt_seed
        noise_fn = self.noise_fn(seed, 1)
        kw = self._sampling(temperature, topk)
        cs, ts = self._chunk_samples, self._tail_samples
        llm_cfg, codec_cfg = self.config.llm, self.config.codec

        def block_noise(t_base: int, block: int) -> torch.Tensor:
            return torch.stack([noise_fn(t_base + t) for t in range(block)])

        with torch.inference_mode():
            state, vstate = self._new_lm_state(1), self._new_vstate(1)
            state, frame = lm_generate_frame(
                self.lm_params, llm_cfg, state, self._dev(tokens),
                self._dev(tmask), self._dev(valid), noise_fn(0), **kw)
            emitted = torch.zeros((1,), dtype=torch.int32, device=self.device)
            block = 1
            state, vstate, frame, emitted, packed = stream_block(
                self.lm_params, self.codec_params, llm_cfg, codec_cfg, state,
                vstate, frame, emitted, block_noise(1, block), block, **kw)
        n_emitted = 0
        g = 0                     # global index of the pending frame
        last_tail: Optional[np.ndarray] = None
        frames: list[np.ndarray] = []
        while True:
            pk = packed[0].cpu().numpy()
            K = block
            eos = pk[K * (cs + ts): K * (cs + ts) + K] > 0.5
            n = min(int(np.argmax(eos)) if eos.any() else K, max_len - g)
            stop = n < K
            if n > 0:
                toks = pk[K * (cs + ts) + K:].reshape(K, self._ncb)[:n]
                frames.append(toks.astype(np.int32))
                self.last_tokens = np.concatenate(frames)
                span = pk[:n * cs]
                if n_emitted == 0:
                    span = span[self._lead_samples:]
                    if self._first_packet_s is None:
                        self._first_packet_s = time.perf_counter() - t_start
                last_tail = pk[K * cs + (n - 1) * ts: K * cs + n * ts]
                n_emitted += n
                yield span.astype(np.float32)
            g += K
            block = min(block * 4, self.config.stream_block_cap)
            if g >= max_len or stop:
                break
            with torch.inference_mode():
                state, vstate, frame, emitted, packed = stream_block(
                    self.lm_params, self.codec_params, llm_cfg, codec_cfg,
                    state, vstate, frame, emitted, block_noise(g + 1, block),
                    block, **kw)
        if n_emitted > 0 and last_tail is not None:
            yield last_tail.astype(np.float32)
