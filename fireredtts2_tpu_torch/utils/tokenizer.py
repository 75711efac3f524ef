"""Text tokenization.

Production path: the Qwen2.5 BPE tokenizer from the pretrained checkpoint
dir, extended with the same ~200 special tokens the reference registers
(fireredtts2/llm/utils.py:62-196). Loaded through HF `transformers`
(host-side; framework-agnostic).

Test/dev path: a self-contained byte-level tokenizer with the same special
tokens, so the full engine runs hermetically (no checkpoint downloads).
"""

from __future__ import annotations

import re
from typing import Protocol

# Same inventory as reference fireredtts2/llm/utils.py:62-187.
ADDITIONAL_SPECIAL_TOKENS: list[str] = (
    ["<|text_start|>", "<|text_end|>"]
    + [f"[S{i}]" for i in range(1, 41)]
    + [f"[S_PODCAST_{i}]" for i in range(1, 11)]
    + [f"[S_DIALOG_{i}]" for i in range(1, 11)]
    + [f"<|emotion_{name}|>" for name in (
        "neutral", "happy", "sad", "concern", "confuse", "angry", "surprise",
        "disgust", "nervous", "apology", "understand", "fear", "comfort",
        "shy", "serious",
    )]
    + [f"<|emotion_extra{i}|>" for i in range(1, 11)]
    + ["<|breath|>", "<|humph|>", "<|laugh_heng|>", "<|hissing|>", "<|sniff|>",
       "<|laugh_he|>", "<|sigh|>", "<|laugh|>", "<|laugh_ha|>",
       "<|quick_breath|>", "<|laugh_hei|>", "<|laugh_speak|>",
       "<|/laugh_speak|>", "<|cry|>", "<|choking|>", "<|cry_speak|>",
       "<|/cry_speak|>", "<|slurp|>", "<|clucking|>", "<|yawning|>",
       "<|cough|>", "<|smack|>", "<|hem|>", "<|stretch|>", "<|sneeze|>"]
    + [f"<|paralinguistic_extra{i}|>" for i in (1, 2, 3, 4, 5, 6, 7, 8,
                                                10, 11, 12, 13)]
)


class TextTokenizer(Protocol):
    def encode(self, text: str) -> list[int]: ...
    @property
    def vocab_size(self) -> int: ...


def load_hf_tokenizer(qwen_tokenizer_path: str):
    """Qwen2.5 tokenizer + special tokens (reference llm/utils.py:190-196)."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(qwen_tokenizer_path)
    tok.add_special_tokens({"additional_special_tokens": ADDITIONAL_SPECIAL_TOKENS})

    class _Wrap:
        vocab_size = len(tok)

        @staticmethod
        def encode(text: str) -> list[int]:
            return tok.encode(text)

    return _Wrap()


class ByteTokenizer:
    """Hermetic byte-level tokenizer with the reference's special tokens.

    ids 0..255 = raw bytes; special tokens follow. Used by the tiny test
    config and any dev run without a Qwen checkpoint.
    """

    def __init__(self) -> None:
        self._special = {t: 256 + i for i, t in enumerate(ADDITIONAL_SPECIAL_TOKENS)}
        self._pattern = re.compile(
            "|".join(re.escape(t) for t in
                     sorted(self._special, key=len, reverse=True)))
        self.vocab_size = 256 + len(self._special)

    def encode(self, text: str) -> list[int]:
        out: list[int] = []
        pos = 0
        for m in self._pattern.finditer(text):
            out.extend(text[pos:m.start()].encode("utf-8"))
            out.append(self._special[m.group()])
            pos = m.end()
        out.extend(text[pos:].encode("utf-8"))
        return out

    def decode(self, ids: list[int]) -> str:
        inv = {v: k for k, v in self._special.items()}
        parts: list[str] = []
        buf = bytearray()
        for i in ids:
            if i < 256:
                buf.append(i)
            else:
                if buf:
                    parts.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                parts.append(inv.get(i, ""))
        if buf:
            parts.append(buf.decode("utf-8", errors="replace"))
        return "".join(parts)


def load_tokenizer(path: str | None):
    """HF tokenizer when a checkpoint dir is given, byte fallback otherwise."""
    if path is None:
        return ByteTokenizer()
    return load_hf_tokenizer(path)
