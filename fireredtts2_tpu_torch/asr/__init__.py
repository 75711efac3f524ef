"""Whisper ASR on the card: the encoder-decoder model, its service, the
streaming drivers and the HF checkpoint reader.

Counterpart of ``fireredtts2_tpu/asr``: greedy and sampled transcription
with the temperature-fallback ladder, beam search and best-of-N, word
timestamps, long audio in 30 s windows with ``<|startofprev|>``
conditioning, language detection and weight-only int8;
``StreamingWhisperASR`` over chunks and the realtime WebSocket server
(``asr.realtime``). The speech-to-speech pipeline (``serve/s2s.py``) and
the server's ``/v1/audio/transcriptions`` take
``WhisperASR.as_transcriber()``.
"""

from fireredtts2_tpu_torch.asr.model import (
    TINY_ASR, BeamResult, WhisperASRModelConfig, asr_alignment_probs,
    asr_beam_decode, asr_decoder_forward, asr_detect_language, asr_encode,
    asr_greedy_decode, asr_sample_best_of, init_asr_params,
    quantize_asr_params_int8,
)
from fireredtts2_tpu_torch.asr.asr import (
    LANGUAGES, ASRConfig, StreamingWhisperASR, TranscriptionResult,
    WhisperASR, create_asr_interface, load_hf_detokenizer,
)
from fireredtts2_tpu_torch.asr.convert import (
    convert_hf_whisper, convert_hf_whisper_encoder, load_hf_whisper,
    write_hf_whisper_dir,
)
from fireredtts2_tpu_torch.asr.timestamps import (
    default_alignment_heads, dtw_path, split_to_words,
    word_timestamps_from_alignment,
)

__all__ = [
    "WhisperASRModelConfig", "TINY_ASR", "init_asr_params",
    "quantize_asr_params_int8", "asr_decoder_forward", "asr_greedy_decode",
    "asr_beam_decode", "asr_sample_best_of", "asr_alignment_probs",
    "BeamResult", "asr_detect_language", "asr_encode",
    "ASRConfig", "TranscriptionResult", "WhisperASR", "StreamingWhisperASR",
    "create_asr_interface", "load_hf_detokenizer", "LANGUAGES",
    "convert_hf_whisper", "convert_hf_whisper_encoder", "load_hf_whisper",
    "write_hf_whisper_dir",
    "default_alignment_heads", "word_timestamps_from_alignment", "dtw_path",
    "split_to_words",
]
