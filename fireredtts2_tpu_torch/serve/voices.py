"""Voice profile management for zero-shot cloning.

Counterpart of ``fireredtts2_tpu/serve/voices.py``, over the port engine's
``encode_prompt_tokens`` and ``utils/audio_io.py`` (the reference's
`voice_cloning_interface.py`):
VoiceProfile CRUD persisted to disk (:284-470), reference-audio quality
scoring (duration / clipping / silence / dynamic range / SNR, :97-283),
and multi-speaker dialogue mapping (:472-748).
"""

from __future__ import annotations

import json
import os
import time
import uuid
from dataclasses import dataclass, field, asdict
from typing import Optional

import numpy as np

from fireredtts2_tpu_torch.serve.monitor import analyze_audio_quality
from fireredtts2_tpu_torch.utils.audio_io import load_prompt_audio_16k, save_wav


@dataclass
class VoiceProfile:
    profile_id: str
    name: str
    reference_text: str
    wav_path: str
    created_at: float
    quality: dict = field(default_factory=dict)
    metadata: dict = field(default_factory=dict)
    # Pre-encoded RVQ prompt frames (.npz with "frames"/"mask"), written at
    # create time when an encoder is given: clone requests then skip the
    # 32-layer SSL encode (SURVEY §7; the reference re-encodes per call,
    # fireredtts2/fireredtts2.py:90-115).
    tokens_path: Optional[str] = None


def score_reference_audio(audio16k: np.ndarray, sample_rate: int = 16_000) -> dict:
    """Quality gates for a cloning reference (reference
    voice_cloning_interface.py:97-283). Returns metrics + overall score +
    pass/fail reasons."""
    q = analyze_audio_quality(audio16k, sample_rate)
    reasons: list[str] = []
    score = 1.0
    dur = q.get("duration_s", 0.0)
    if dur < 2.0:
        reasons.append("too short (< 2 s)")
        score -= 0.4
    elif dur > 60.0:
        reasons.append("too long (> 60 s)")
        score -= 0.2
    if q.get("clipping_ratio", 0) > 0.001:
        reasons.append("clipping detected")
        score -= 0.3
    if q.get("silence_ratio", 0) > 0.5:
        reasons.append("mostly silence")
        score -= 0.3
    if q.get("snr_db", 0) < 15.0:
        reasons.append("low SNR (< 15 dB)")
        score -= 0.2
    rms = q.get("rms", 0.0)
    if rms < 0.005:
        reasons.append("very quiet recording")
        score -= 0.2
    q["score"] = max(0.0, round(score, 3))
    q["acceptable"] = q["score"] >= 0.5
    q["reasons"] = reasons
    return q


class VoiceProfileManager:
    """CRUD store for voice profiles with JSON + wav persistence."""

    def __init__(self, profile_dir: str):
        self.profile_dir = profile_dir
        os.makedirs(profile_dir, exist_ok=True)
        self._profiles: dict[str, VoiceProfile] = {}
        self._token_cache: dict[str, tuple] = {}
        self._load_all()

    def create_profile(self, name: str, reference_text: str,
                       wav_path: Optional[str] = None,
                       audio16k: Optional[np.ndarray] = None,
                       metadata: Optional[dict] = None,
                       encoder=None) -> VoiceProfile:
        """encoder: optional callable audio16k -> (frames, mask)
        (engine.encode_prompt_tokens). When given, the prompt encode runs
        ONCE here and its tokens persist with the profile."""
        assert (wav_path is None) != (audio16k is None), \
            "give exactly one of wav_path / audio16k"
        if wav_path is not None:
            audio16k = load_prompt_audio_16k(wav_path)
        pid = uuid.uuid4().hex
        stored_wav = os.path.join(self.profile_dir, f"{pid}.wav")
        save_wav(stored_wav, audio16k, 16_000)
        tokens_path = None
        if encoder is not None:
            frames, mask = encoder(audio16k)
            tokens_path = os.path.join(self.profile_dir, f"{pid}.npz")
            np.savez(tokens_path, frames=frames, mask=mask)
        profile = VoiceProfile(
            profile_id=pid, name=name, reference_text=reference_text,
            wav_path=stored_wav, created_at=time.time(),
            quality=score_reference_audio(audio16k),
            metadata=metadata or {}, tokens_path=tokens_path)
        self._profiles[pid] = profile
        self._save(profile)
        return profile

    def prompt_tokens(self, profile_id: str
                      ) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """(frames, mask) stored at create time, or None. Cached in memory
        after first load."""
        p = self.get(profile_id)
        if p is None or not p.tokens_path or not os.path.exists(p.tokens_path):
            return None
        hit = self._token_cache.get(profile_id)
        if hit is None:
            with np.load(p.tokens_path) as z:
                hit = (z["frames"], z["mask"])
            self._token_cache[profile_id] = hit
        return hit

    def get(self, profile_id: str) -> Optional[VoiceProfile]:
        return self._profiles.get(profile_id)

    def by_name(self, name: str) -> Optional[VoiceProfile]:
        for p in self._profiles.values():
            if p.name == name:
                return p
        return None

    def list_profiles(self) -> list[VoiceProfile]:
        return sorted(self._profiles.values(), key=lambda p: p.created_at)

    def delete(self, profile_id: str) -> bool:
        p = self._profiles.pop(profile_id, None)
        if p is None:
            return False
        self._token_cache.pop(profile_id, None)
        for path in (p.wav_path, self._json_path(profile_id), p.tokens_path):
            if not path:
                continue
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
        return True

    # dialogue mapping (reference MultiSpeakerDialogueManager :472)

    def dialogue_prompts(self, speaker_to_profile: dict[str, str]
                         ) -> tuple[list[str], list[str]]:
        """Map [S1]->profile_id,... to (prompt_wav_list, prompt_text_list)
        in engine.generate_dialogue's format."""
        wavs, texts = [], []
        for speaker, pid in sorted(speaker_to_profile.items()):
            p = self.get(pid)
            if p is None:
                raise KeyError(f"unknown voice profile: {pid}")
            wavs.append(p.wav_path)
            text = p.reference_text
            if not text.startswith(speaker):
                text = speaker + text
            texts.append(text)
        return wavs, texts

    # persistence

    def _json_path(self, pid: str) -> str:
        return os.path.join(self.profile_dir, f"{pid}.json")

    def _save(self, p: VoiceProfile) -> None:
        with open(self._json_path(p.profile_id), "w") as f:
            json.dump(asdict(p), f)

    def _load_all(self) -> None:
        for name in os.listdir(self.profile_dir):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.profile_dir, name)) as f:
                    d = json.load(f)
                self._profiles[d["profile_id"]] = VoiceProfile(**d)
            except (json.JSONDecodeError, KeyError, TypeError):
                continue
