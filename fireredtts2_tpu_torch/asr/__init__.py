"""Whisper ASR on the card: the encoder-decoder model, its service and the
HF checkpoint reader.

Counterpart of ``fireredtts2_tpu/asr``: greedy and sampled transcription
with the temperature-fallback ladder, long audio in 30 s windows with
``<|startofprev|>`` conditioning, language detection and weight-only int8.
The speech-to-speech pipeline (``serve/s2s.py``) and the server's
``/v1/audio/transcriptions`` take ``WhisperASR.as_transcriber()``. Beam
search, best-of-N, word timestamps and the streaming service are not
ported yet (ROADMAP.md queue 1, items 18 and 19).
"""

from fireredtts2_tpu_torch.asr.model import (
    TINY_ASR, WhisperASRModelConfig, asr_decoder_forward, asr_detect_language,
    asr_encode, asr_greedy_decode, init_asr_params, quantize_asr_params_int8,
)
from fireredtts2_tpu_torch.asr.asr import (
    LANGUAGES, ASRConfig, TranscriptionResult, WhisperASR,
)
from fireredtts2_tpu_torch.asr.convert import (
    convert_hf_whisper, convert_hf_whisper_encoder, load_hf_whisper,
    write_hf_whisper_dir,
)

__all__ = [
    "WhisperASRModelConfig", "TINY_ASR", "init_asr_params",
    "quantize_asr_params_int8", "asr_decoder_forward", "asr_greedy_decode",
    "asr_detect_language", "asr_encode",
    "ASRConfig", "TranscriptionResult", "WhisperASR", "LANGUAGES",
    "convert_hf_whisper", "convert_hf_whisper_encoder", "load_hf_whisper",
    "write_hf_whisper_dir",
]
