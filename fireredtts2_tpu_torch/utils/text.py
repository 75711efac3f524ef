"""Text normalization and splitting for TTS frontends.

Behavioral parity with reference fireredtts2/utils/spliter.py:
- clean_text: CJK punctuation -> ASCII mapping, emoji strip, repeated
  period/comma collapse (spliter.py:59-73);
- split_text: utf8-length-bounded sentence splitting with float protection
  and merge (spliter.py:132-163);
- process_text / process_text_list: speaker-tag-preserving dialogue chunking
  (EN ≤80 words, ZH ≤150 chars; spliter.py:259-289).

Pure host-side Python (no tensors).
"""

from __future__ import annotations

import re
import string

_SYMBOL_MAP = {
    "\n": "", "\t": "",
    "…": ",",
    "“": "'", "”": "'", "‘": "'", "’": "'",
    "【": "", "】": "", "[": "", "]": "",
    "（": "", "）": "", "(": "", ")": "",
    "・": "", "·": "",
    "「": "'", "」": "'", "《": "'", "》": "'",
    "～": "，", "~": "，",
    "：": ",", "；": ",", ";": ",", ":": ",",
    '"': "",
    "！": "，",
    "————": "", "——": "", "—": "",
    "……": "，",
    "*": "",
}

_SYMBOL_RE = re.compile("|".join(re.escape(s) for s in
                                 sorted(_SYMBOL_MAP, key=len, reverse=True)))

_EMOJI_RE = re.compile(
    "["
    "\U0001f600-\U0001f64f"
    "\U0001f300-\U0001f5ff"
    "\U0001f680-\U0001f6ff"
    "\U0001f1e0-\U0001f1ff"
    "]+",
    flags=re.UNICODE,
)

SPEAKER_TAGS = ("[S1]", "[S2]", "[S3]", "[S4]")


def clean_text(text: str) -> str:
    text = text.strip().replace("\xa0", "")
    text = _SYMBOL_RE.sub(lambda m: _SYMBOL_MAP[m.group()], text)
    text = _EMOJI_RE.sub("", text)
    # collapse runs of periods/commas to their first char
    text = re.sub(r"[.,]{2,}", lambda m: m.group()[0], text)
    return text


def _utf8_len(s: str) -> int:
    return len(s.encode("utf-8"))


def _protect_float(s: str) -> str:
    return re.sub(r"(\d+)\.(\d+)", r"<\1_f_\2>", s)


def _unprotect_float(s: str) -> str:
    return re.sub(r"<(\d+)_f_(\d+)>", r"\1.\2", s)


def _break_at(texts, length: int, splits: set[str]):
    for text in texts:
        if _utf8_len(text) <= length:
            yield text
            continue
        cur = ""
        for ch in text:
            cur += ch
            if ch in splits:
                yield cur
                cur = ""
        if cur:
            yield cur


def _break_by_length(texts, length: int):
    for text in texts:
        if _utf8_len(text) <= length:
            yield text
            continue
        cur = ""
        for ch in text:
            cur += ch
            if _utf8_len(cur) >= length:
                yield cur
                cur = ""
        if cur:
            yield cur


def split_text(text: str, length: int) -> list[str]:
    """Split into utf8-bounded segments at sentence/comma/space boundaries,
    then re-merge greedily up to `length` bytes."""
    text = clean_text(text)
    texts = [_protect_float(text)]
    texts = list(_break_at(texts, length, {".", "!", "?", "。", "！", "？"}))
    texts = [_unprotect_float(t) for t in texts]
    texts = list(_break_at(texts, length, {",", "，"}))
    texts = list(_break_at(texts, length, {" "}))
    texts = list(_break_by_length(texts, length))

    segments: list[str] = []
    cur = ""
    for t in texts:
        if _utf8_len(cur) + _utf8_len(t) <= length:
            cur += t
        else:
            _append_clean(cur, segments)
            cur = t
    _append_clean(cur, segments)
    return segments


def _append_clean(cur: str, segments: list[str]) -> None:
    cur = cur.strip()
    if cur and not all(c.isspace() or c in string.punctuation for c in cur):
        segments.append(cur)


def contains_chinese(text: str) -> bool:
    return bool(re.search(r"[一-鿿]", text))


def _split_sentences(text: str, puncts: str) -> list[str]:
    parts = re.split(f"([{puncts}])", text)
    out = []
    for i in range(0, len(parts) - 1, 2):
        s = parts[i].strip()
        if s:
            out.append(s + parts[i + 1])
    if len(parts) % 2 == 1 and parts[-1].strip():
        out.append(parts[-1].strip())
    return out


def _merge(sentences: list[str], limit: int, count, joiner: str) -> list[str]:
    out: list[str] = []
    cur = ""
    for s in sentences:
        if not cur:
            cur = s
        elif count(cur + joiner + s) <= limit:
            cur = cur + joiner + s
        else:
            out.append(cur)
            cur = s
    if cur:
        out.append(cur)
    return out


def process_text(text: str) -> list[str]:
    """Chunk one utterance: EN ≤80 words / ZH ≤150 chars
    (reference spliter.py:259-276)."""
    text = re.sub(r"^\[S\d+\]", "", text).strip()
    if contains_chinese(text):
        if len(text) <= 150:
            return [text]
        return _merge(_split_sentences(text, "。！？"), 150, len, "")
    if len(text.split()) <= 80:
        return [text]
    return _merge(_split_sentences(text, ".!?"), 80,
                  lambda s: len(s.split()), " ")


def process_text_list(text_list: list[str]) -> list[str]:
    """Speaker-tagged dialogue chunking (reference spliter.py:279-289)."""
    out: list[str] = []
    for text in text_list:
        speaker = text[:4]
        if speaker not in SPEAKER_TAGS:
            raise ValueError(f"utterance must start with one of {SPEAKER_TAGS}: {text[:20]!r}")
        for chunk in process_text(text):
            out.append(speaker + chunk)
    return out
