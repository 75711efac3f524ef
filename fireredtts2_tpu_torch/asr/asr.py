"""Whisper ASR service: transcription, language detection and streaming.

Counterpart of ``fireredtts2_tpu/asr/asr.py``: ``WhisperASR``
(preprocessing to mono float32 16 kHz, peak-normalised; the 30 s static
mel window; the temperature-fallback ladder with beam search on its T = 0
rung when beam_size > 1 and best-of-N on its T > 0 rungs when best_of >
1; the no-speech gate; long audio in fixed 30 s windows with rolling
``<|startofprev|>`` conditioning; word timestamps from the alignment
heads; language detection; performance stats; the ``serve/s2s.py``
transcriber adapter), ``StreamingWhisperASR`` (a background thread over
overlapping chunks) and ``create_asr_interface``. The model is
``asr/model.py``, on the card unless the caller asks for the CPU.

Differences from the JAX service, none of which changes a result:
- each window is encoded once and its encoder context reused by every
  rung of the ladder (JAX's one compiled program re-encodes per rung);
- the T > 0 rungs draw their Gumbel noise from a generator seeded by
  (ASRConfig.seed, attempt, step) (JAX: ``fold_in(fold_in(key(seed),
  attempt), step)``); ``noise_fn`` is the one place that draws it;
- a device fault is logged and raised, not turned into an empty result;
- ``detect_language`` reads the first 30 s window of longer audio;
- word timestamps run the alignment forward over the window's encoder
  context and over the prompt and the tokens alone (JAX re-encodes and
  pads the row with EOT to a static length; the attention is causal, so
  the rows the words read do not depend on the padding);
- the streaming thread keeps the exception that stops it, logs it once
  and re-raises it from ``get_transcription_result`` and
  ``stop_streaming`` (JAX's thread has no handler).
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from fireredtts2_tpu_torch.asr.model import (
    TINY_ASR, WhisperASRModelConfig, _alignment_loop, _beam_loop,
    _best_of_loop, _sample_loop, asr_detect_language, encoder_context,
    init_asr_decode_state, init_asr_params, quantize_asr_params_int8,
)
from fireredtts2_tpu_torch.asr.timestamps import (
    default_alignment_heads, word_timestamps_from_alignment,
)
from fireredtts2_tpu_torch.ops.audio import log_mel_spectrogram, whisper_mel_filters
from fireredtts2_tpu_torch.runtime.checkpoint import _to
from fireredtts2_tpu_torch.utils.audio_io import resample
from fireredtts2_tpu_torch.weights import resolve_device

log = logging.getLogger(__name__)

# Whisper's language inventory, in the model's language-token order
# (<|en|> is first_language_id; the public whisper tokenizer's table).
LANGUAGES: List[str] = [
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
]

@dataclass
class TranscriptionResult:
    text: str
    confidence: float
    language: str
    start_time: float
    end_time: float
    segments: List[Dict[str, Any]]
    processing_time_ms: float
    model_name: str
    is_final: bool = True


@dataclass
class ASRConfig:
    """Decoding knobs, as the JAX package's ASRConfig. The
    temperature-fallback ladder: a window whose transcript is weak (mean
    logprob below logprob_threshold) or repetitive (compression ratio
    above its threshold), and not silence, is decoded again at each higher
    temperature in turn. beam_size > 1: beam search on the T = 0 rung;
    best_of > 1: that many samples on each T > 0 rung, the best kept.
    word_timestamps: a "words" list in each segment (cross-attention
    alignment and DTW, one teacher-forced forward a window). Long audio is
    cut into 30 s windows (at most max_windows); once prev_window tokens
    of context exist, the next window's prompt carries the last
    prev_window of them after <|startofprev|>."""
    model_size: str = "large-v3"
    language: Optional[str] = None       # None = no language token
    task: str = "transcribe"
    temperature: float = 0.0
    beam_size: int = 1
    best_of: int = 1
    word_timestamps: bool = False
    max_windows: int = 120
    no_speech_threshold: float = 0.6
    logprob_threshold: float = -1.0
    max_new_tokens: int = 224
    condition_on_previous_text: bool = True
    prev_window: int = 32
    fallback_temperatures: tuple = (0.2, 0.4, 0.6, 0.8, 1.0)
    compression_ratio_threshold: float = 2.4
    seed: int = 0


def _compression_ratio(text: str) -> float:
    """len(utf8) / len(zlib(utf8)): degenerate repetition compresses well."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


Detokenizer = Callable[[List[int]], str]


def _default_detokenizer(ids: List[int]) -> str:
    """Used when no tokenizer is wired (random-weight dev mode): a token-id
    transcript, not natural text."""
    return " ".join(str(i) for i in ids)


def load_hf_detokenizer(tokenizer_dir: str) -> Detokenizer:
    """A local HF tokenizer dir's decode (``transformers``, local files
    only; imported when called)."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(tokenizer_dir, local_files_only=True)
    return lambda ids: tok.decode(ids, skip_special_tokens=True)


def _step_seed(seed: int, attempt: int, t: int) -> int:
    return ((seed * 1_000_003 + attempt) * 1_000_003 + t) & ((1 << 63) - 1)


def _device_fault(e: BaseException) -> bool:
    """A failure of the card (out of memory, a CUDA error), which a caller
    must see, as against a failure of one request."""
    accel = getattr(torch, "AcceleratorError", None)
    return (isinstance(e, torch.cuda.OutOfMemoryError)
            or (accel is not None and isinstance(e, accel))
            or (isinstance(e, RuntimeError) and "CUDA" in str(e)))


class WhisperASR:
    """Whisper transcription on the card ("cuda" unless `device` names
    another). Without `params` the weights are random, drawn at
    `model_cfg`'s widths (TINY_ASR by default: dev mode) from a generator
    seeded with `seed`; ``asr.convert.load_hf_whisper`` reads a checkpoint.
    alignment_heads: the (layer, head) pairs word timestamps read (default:
    every head of the decoder's top half). quantize_int8: weight-only int8
    on the encoder stack and the decoder's per-token matmuls."""

    def __init__(self, config: Optional[ASRConfig] = None,
                 params: Optional[dict] = None,
                 model_cfg: Optional[WhisperASRModelConfig] = None,
                 detokenizer: Optional[Detokenizer] = None,
                 alignment_heads: Optional[tuple] = None,
                 seed: int = 0, warmup: bool = True,
                 quantize_int8: bool = False, device=None):
        self.config = config or ASRConfig()
        self.model_cfg = model_cfg or TINY_ASR
        # The default budget is whisper-large-v3's (448 target positions);
        # smaller models get what fits after the longest plain prompt
        # (<|sot|> lang task <|notimestamps|> = 4, plus one EOS slot).
        cap = self.model_cfg.max_target_positions - 5
        if self.config.max_new_tokens > cap:
            self.config = dataclasses.replace(self.config,
                                              max_new_tokens=max(cap, 1))
        self.alignment_heads = tuple(
            alignment_heads if alignment_heads is not None
            else default_alignment_heads(self.model_cfg.decoder_layers,
                                         self.model_cfg.num_heads))
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = init_asr_params(gen, self.model_cfg, device=self.device)
        else:
            params = _to(params, self.device)
        if quantize_int8:
            params = quantize_asr_params_int8(params)
        self.params = params
        self.detokenize = detokenizer or _default_detokenizer
        self.model_name = f"whisper-torch-{self.config.model_size}"

        cfg = self.model_cfg
        self._mel_filters = torch.from_numpy(
            whisper_mel_filters(cfg.n_mels)).to(self.device)
        # 30 s of audio -> max_source_positions encoder frames (the second
        # conv halves the 100 Hz mel rate); every window is padded to it
        self._n_samples = cfg.max_source_positions * 2 * 160

        self.total_transcriptions = 0
        self.total_processing_time = 0.0
        self.average_processing_time = 0.0
        self.decode_calls = 0
        if warmup:
            self.transcribe(np.zeros(16_000, np.float32), 16_000)

    # ------------------------------------------------------------ internals

    def noise_fn(self, attempt: int, rows: int = 1
                 ) -> Callable[[int], torch.Tensor]:
        """Step t's sampling noise of ladder attempt `attempt`: (rows, V)
        standard Gumbel draws (a row per decoded candidate) from a
        generator seeded by (ASRConfig.seed, attempt, t)."""
        shape = (rows, self.model_cfg.vocab_size)

        def fn(t: int) -> torch.Tensor:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(_step_seed(self.config.seed, attempt, t))
            e = torch.empty(shape, dtype=torch.float32,
                            device=self.device).exponential_(generator=gen)
            return -torch.log(e.clamp_min_(torch.finfo(torch.float32).tiny))
        return fn

    def _preprocess_audio(self, audio: np.ndarray, sample_rate: int
                          ) -> np.ndarray:
        """Mono float32 at 16 kHz, scaled down to a peak of 1 if louder,
        capped at max_windows windows."""
        if audio.ndim > 1:
            audio = audio.mean(axis=1)
        if audio.dtype == np.int16:
            audio = audio.astype(np.float32) / 32768.0
        elif audio.dtype == np.int32:
            audio = audio.astype(np.float32) / 2147483648.0
        else:
            audio = audio.astype(np.float32)
        if sample_rate != 16_000:
            audio = resample(audio, sample_rate, 16_000)
        peak = np.abs(audio).max() if audio.size else 0.0
        if peak > 1.0:
            audio = audio / peak
        return audio[: self._n_samples * self.config.max_windows]

    def _mel(self, audio16k: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """One window -> ((1, T_mel, n_mels) log-mel of the zero-padded
        30 s window, (1,) its real length in mel frames)."""
        n_real = len(audio16k)
        padded = np.zeros(self._n_samples, np.float32)
        padded[:n_real] = audio16k
        x = torch.from_numpy(padded)[None].to(self.device)
        mel = log_mel_spectrogram(x, self._mel_filters)    # (1, n_mels, T)
        mel_len = torch.tensor([max(n_real // 160, 2)], dtype=torch.int64,
                               device=self.device)
        return mel.transpose(1, 2), mel_len

    def _prompt_ids(self, language: Optional[str],
                    prev_ids: Optional[list] = None) -> tuple[np.ndarray, int]:
        """The forced decoder prompt, [<|startofprev|> + the last
        prev_window context tokens]? <|startoftranscript|> [lang] task
        <|notimestamps|>, and the SOT's index in it. The context enters
        only once prev_window tokens of it exist."""
        cfg = self.model_cfg
        ids: list = []
        W = self.config.prev_window
        if (prev_ids is not None and self.config.condition_on_previous_text
                and len(prev_ids) >= W > 0):
            ids += [cfg.sot_prev_id] + [int(t) for t in prev_ids[-W:]]
        sot_index = len(ids)
        ids.append(cfg.sot_id)
        if language is not None and language in LANGUAGES[:cfg.num_languages]:
            ids.append(cfg.first_language_id + LANGUAGES.index(language))
        task_id = (cfg.translate_id if self.config.task == "translate"
                   else cfg.transcribe_id)
        ids += [task_id, cfg.no_timestamps_id]
        return np.asarray([ids], np.int64), sot_index

    def _check_fits(self, prompt_len: int) -> None:
        if (prompt_len + self.config.max_new_tokens
                > self.model_cfg.max_target_positions):
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens "
                f"({self.config.max_new_tokens}) exceeds max_target_positions "
                f"({self.model_cfg.max_target_positions}); lower "
                f"ASRConfig.prev_window or max_new_tokens")

    def _decode_once(self, context, prompt: torch.Tensor, temperature: float,
                     attempt: int, sot_index: int = 0
                     ) -> tuple[list, float, float]:
        """One ladder rung -> (ids, mean logprob, p(no speech)): beam
        search on a T = 0 rung when beam_size > 1, best-of-N on a T > 0
        rung when best_of > 1, else one greedy or sampled decode."""
        cfg, p, n_new = self.model_cfg, self.params, self.config.max_new_tokens
        cross, enc_len = context
        if temperature <= 0.0 and self.config.beam_size > 1:
            res = _beam_loop(p, cfg, cross, enc_len, prompt, n_new,
                             self.config.beam_size, sot_index)
        elif temperature > 0.0 and self.config.best_of > 1:
            res = _best_of_loop(p, cfg, cross, enc_len, prompt, n_new,
                                self.config.best_of, temperature,
                                self.noise_fn(attempt, self.config.best_of),
                                sot_index)
        else:
            noise = self.noise_fn(attempt) if temperature > 0.0 else None
            state = init_asr_decode_state(cfg, 1, cross["k"].dtype,
                                          self.device)
            res = _sample_loop(p, cfg, cross, enc_len, state, prompt, n_new,
                               temperature, noise, sot_index)
        self.decode_calls += 1
        n = int(res.n_tokens[0])
        ids = [int(t) for t in res.tokens[0, :n].tolist()]
        avg_lp = float(res.sum_logprob[0]) / max(n + 1, 1)
        return ids, avg_lp, float(res.no_speech_prob[0])

    def _transcribe_window(self, win: np.ndarray, lang: Optional[str],
                           prev_ids: Optional[list], attempt_base: int):
        """Ladder-decode one window of at most 30 s: greedy first; while the
        transcript is weak or repetitive, and the window not silence,
        again at each higher temperature; the first decode that clears the
        gates is kept. -> (ids, text, mean logprob, p(no speech), the
        temperature used, (the encoder context, the prompt's ids) for the
        word timestamps)."""
        prompt_np, sot_index = self._prompt_ids(lang, prev_ids)
        self._check_fits(prompt_np.shape[1])
        mel, mel_len = self._mel(win)
        context = encoder_context(self.params, self.model_cfg, mel, mel_len)
        prompt = torch.from_numpy(prompt_np).to(self.device)

        ladder = ((self.config.temperature,)
                  + tuple(t for t in self.config.fallback_temperatures
                          if t > self.config.temperature))
        for attempt, temp in enumerate(ladder):
            ids, avg_lp, no_speech = self._decode_once(
                context, prompt, temp, attempt_base + attempt, sot_index)
            used_temp = temp
            text = self.detokenize(ids) if ids else ""
            is_silence = no_speech > self.config.no_speech_threshold
            weak = avg_lp < self.config.logprob_threshold
            degenerate = (_compression_ratio(text)
                          > self.config.compression_ratio_threshold)
            if is_silence or not (weak or degenerate):
                break       # silence is final; a clean transcript is final
        # the no-speech gate: silence when p(no speech) is high and the
        # transcript's logprob weak
        if (no_speech > self.config.no_speech_threshold
                and avg_lp < self.config.logprob_threshold):
            text, ids = "", []
        return (ids, text, avg_lp, no_speech, used_temp,
                (context, prompt_np[0].tolist()))

    # ------------------------------------------------------------------ API

    def transcribe(self, audio_data: np.ndarray, sample_rate: int = 16_000,
                   language: Optional[str] = None,
                   initial_prompt_ids: Optional[list] = None
                   ) -> TranscriptionResult:
        """Transcribe with the fallback ladder, window by window over 30 s
        windows, one segment per non-silent window. initial_prompt_ids:
        context tokens for <|startofprev|> conditioning. A configuration
        that cannot fit raises ValueError and a device fault raises; any
        other failure is logged and returns an empty result."""
        t0 = time.time()
        lang = language or self.config.language
        probe, _ = self._prompt_ids(lang, initial_prompt_ids)
        self._check_fits(probe.shape[1])
        try:
            audio = self._preprocess_audio(audio_data, sample_rate)
            W = self._n_samples
            n_win = max(1, -(-max(len(audio), 1) // W))
            prev = list(initial_prompt_ids) if initial_prompt_ids else []
            segments: list = []
            texts: list = []
            lp_num = lp_den = 0.0
            avg_lp = 0.0
            for wi in range(n_win):
                off = wi * W
                win = audio[off: off + W]
                cond = prev if self.config.condition_on_previous_text else None
                ids, text, avg_lp, no_speech, used_temp, align_ctx = \
                    self._transcribe_window(win, lang, cond,
                                            attempt_base=wi * 1000)
                if not ids:
                    continue
                t_off = off / 16_000
                seg = {"id": len(segments), "start": t_off,
                       "end": t_off + len(win) / 16_000, "text": text,
                       "tokens": ids, "temperature": used_temp,
                       "avg_logprob": avg_lp,
                       "compression_ratio": _compression_ratio(text),
                       "no_speech_prob": no_speech}
                if self.config.word_timestamps:
                    words = self._word_timestamps(*align_ctx, ids, len(win))
                    for w in words:
                        w["start"] += t_off
                        w["end"] += t_off
                    seg["words"] = words
                segments.append(seg)
                texts.append(text.strip())
                lp_num += avg_lp * (len(ids) + 1)
                lp_den += len(ids) + 1
                # a transcript sampled above T = 0.5 is too noisy to
                # condition the next window on
                if used_temp <= 0.5:
                    prev.extend(ids)
                else:
                    prev = []

            dt = (time.time() - t0) * 1000.0
            self.total_transcriptions += 1
            self.total_processing_time += dt
            self.average_processing_time = (
                self.total_processing_time / self.total_transcriptions)
            mean_lp = lp_num / lp_den if lp_den else avg_lp
            confidence = (float(np.clip(np.exp(mean_lp), 0.0, 1.0))
                          if segments else 0.0)
            return TranscriptionResult(
                text=" ".join(t for t in texts if t), confidence=confidence,
                language=lang or "unknown", start_time=0.0,
                end_time=len(audio) / 16_000, segments=segments,
                processing_time_ms=dt, model_name=self.model_name)
        except Exception as e:
            log.exception("transcription failed")
            if _device_fault(e):
                raise
            return TranscriptionResult(
                text="", confidence=0.0, language="unknown", start_time=0.0,
                end_time=0.0, segments=[],
                processing_time_ms=(time.time() - t0) * 1000.0,
                model_name=self.model_name)

    def _word_timestamps(self, context, prompt_row: list, ids: list,
                         n_samples: int) -> list:
        """A window's word dicts (word, start, end, probability; seconds
        from the window's start): the alignment heads' teacher-forced maps
        over prompt + ids, then DTW (``asr.timestamps``)."""
        tokens = torch.tensor([prompt_row + ids], dtype=torch.int64,
                              device=self.device)
        probs, tok_lp = _alignment_loop(self.params, self.model_cfg, *context,
                                        tokens, self.alignment_heads)
        n_frames = max(n_samples // 320, 1)   # 16 kHz -> 50 Hz encoder frames
        return word_timestamps_from_alignment(
            probs[0].cpu().numpy(), tok_lp[0].cpu().numpy(),
            text_start=len(prompt_row), n_text=len(ids), ids=ids,
            detokenize=self.detokenize, n_frames=n_frames)

    def detect_language(self, audio_data: np.ndarray,
                        sample_rate: int = 16_000) -> Dict[str, Any]:
        """-> {language, confidence, all_probabilities (the top 10)}, from
        the first 30 s window."""
        audio = self._preprocess_audio(audio_data, sample_rate)
        mel, mel_len = self._mel(audio[: self._n_samples])
        probs = asr_detect_language(self.params, self.model_cfg, mel,
                                    mel_len)[0].cpu().numpy()
        n = min(len(LANGUAGES), len(probs))
        order = np.argsort(probs[:n])[::-1]
        return {
            "language": LANGUAGES[int(order[0])],
            "confidence": float(probs[order[0]]),
            "all_probabilities": {
                LANGUAGES[int(i)]: float(probs[i]) for i in order[:10]},
        }

    def get_supported_languages(self) -> List[str]:
        return LANGUAGES[: self.model_cfg.num_languages]

    def get_performance_stats(self) -> Dict[str, Any]:
        return {
            "total_transcriptions": self.total_transcriptions,
            "decode_calls": self.decode_calls,
            "average_processing_time_ms": self.average_processing_time,
            "total_processing_time_ms": self.total_processing_time,
            "model_name": self.model_name,
            "backend": self.device.type,
        }

    def as_transcriber(self) -> Callable[[np.ndarray], str]:
        """Adapter to the serve/s2s.py Transcriber protocol."""
        return lambda audio16k: self.transcribe(audio16k, 16_000).text


class StreamingWhisperASR:
    """Background transcription of a stream of chunks: a thread gathers
    chunk_duration of audio, transcribes it (conditioned on the rolling
    transcript's tokens when condition_on_previous_text is on), keeps
    overlap_duration of it for the next chunk, and queues each non-empty
    result (is_final False). An exception that stops the thread is kept,
    logged once, and raised again by get_transcription_result and
    stop_streaming."""

    def __init__(self, asr: WhisperASR, chunk_duration: float = 2.0,
                 overlap_duration: float = 0.5, sample_rate: int = 16_000):
        self.asr = asr
        self.sample_rate = sample_rate
        self.chunk_size = int(chunk_duration * sample_rate)
        self.overlap_size = int(overlap_duration * sample_rate)
        self.audio_queue: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=64)
        self.result_queue: "queue.Queue[TranscriptionResult]" = \
            queue.Queue(maxsize=16)
        self.audio_buffer: deque = deque()
        self.context_history: deque = deque(maxlen=5)
        # the rolling transcript's tokens, the <|startofprev|> context
        self.context_tokens: deque = deque(maxlen=4 * asr.config.prev_window)
        self.is_streaming = False
        self.error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    def start_streaming(self) -> None:
        if self.is_streaming:
            return
        self.error = None
        self.is_streaming = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop_streaming(self) -> None:
        """Stop the thread; raise the exception that stopped it, if any."""
        self.is_streaming = False
        if self._thread:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def add_audio_chunk(self, audio_data: np.ndarray,
                        sample_rate: int = 16_000) -> None:
        if sample_rate != self.sample_rate:
            audio_data = resample(audio_data.astype(np.float32),
                                  sample_rate, self.sample_rate)
        try:
            self.audio_queue.put(audio_data.astype(np.float32), timeout=0.1)
        except queue.Full:
            pass        # dropped under backpressure, as the JAX service does

    def get_transcription_result(self, timeout: float = 0.1
                                 ) -> Optional[TranscriptionResult]:
        """The next result, None after `timeout`; the kept exception of a
        stopped thread is raised."""
        if self.error is not None:
            raise self.error
        try:
            return self.result_queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def _run(self) -> None:
        try:
            self._loop()
        except Exception as e:
            log.exception("streaming transcription stopped")
            self.error = e
            self.is_streaming = False

    def _loop(self) -> None:
        while self.is_streaming:
            try:
                chunk = self.audio_queue.get(timeout=0.5)
            except queue.Empty:
                continue
            self.audio_buffer.extend(chunk.tolist())
            if len(self.audio_buffer) < self.chunk_size:
                continue
            data = np.asarray(list(self.audio_buffer)[: self.chunk_size],
                              np.float32)
            for _ in range(self.chunk_size - self.overlap_size):
                if self.audio_buffer:
                    self.audio_buffer.popleft()
            prev = (list(self.context_tokens)
                    if self.asr.config.condition_on_previous_text else None)
            res = self.asr.transcribe(data, self.sample_rate,
                                      initial_prompt_ids=prev)
            res.is_final = False
            if res.text.strip():
                self.context_history.append(res)
                for seg in res.segments:
                    self.context_tokens.extend(seg.get("tokens", ()))
                try:
                    self.result_queue.put(res, timeout=0.1)
                except queue.Full:
                    try:
                        self.result_queue.get_nowait()
                        self.result_queue.put_nowait(res)
                    except queue.Empty:
                        pass


def create_asr_interface(asr: Optional[WhisperASR] = None
                         ) -> tuple[WhisperASR, StreamingWhisperASR, dict]:
    """-> (asr, its StreamingWhisperASR, a dict of callables over both).
    Without `asr`, a WhisperASR() on the card (the tiny random-weight dev
    model)."""
    asr = asr or WhisperASR()
    streaming = StreamingWhisperASR(asr)
    interface = {
        "transcribe": lambda audio, sr=16_000, language=None:
            asr.transcribe(audio, sr, language),
        "detect_language": lambda audio, sr=16_000:
            asr.detect_language(audio, sr),
        "start_streaming": streaming.start_streaming,
        "stop_streaming": streaming.stop_streaming,
        "add_audio_chunk": streaming.add_audio_chunk,
        "get_result": streaming.get_transcription_result,
        "get_performance_stats": asr.get_performance_stats,
        "supported_languages": asr.get_supported_languages,
    }
    return asr, streaming, interface
