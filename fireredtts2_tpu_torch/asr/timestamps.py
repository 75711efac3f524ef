"""Word-level timestamps from cross-attention alignment.

Counterpart of ``fireredtts2_tpu/asr/timestamps.py``, kept as the port's
own copy (numpy only; a test pins it to the JAX package's): openai
whisper's timing.find_alignment. The teacher-forced cross-attention maps
of the alignment heads (``asr.model.asr_alignment_probs``) are
standardised over the tokens, median-filtered over time and averaged; a
dynamic-time-warping path through them gives each token's first frame,
and a tokenizer-agnostic prefix-decode split gives the words. The DTW and
the filter are host work in numpy: the matrix is at most (n_tokens,
1500).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

# Whisper encoder frames are 20 ms (50 Hz): 30 s -> 1500 frames.
SECONDS_PER_FRAME = 0.02


def median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter along the LAST axis with reflect padding (matches
    openai whisper's median_filter for odd widths)."""
    if width <= 1 or x.shape[-1] == 0:
        return x
    width = min(width, x.shape[-1] if x.shape[-1] % 2 else x.shape[-1] - 1)
    if width <= 1:
        return x
    half = width // 2
    padded = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(half, half)],
                    mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(padded, width,
                                                       axis=-1)
    return np.median(windows, axis=-1)


def dtw_path(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotonic minimum-cost path through cost (N_tokens, M_frames) with
    diagonal/down/right moves (openai whisper timing.dtw). Returns
    (token_indices, frame_indices) along the path."""
    N, M = cost.shape
    D = np.full((N + 1, M + 1), np.inf, np.float64)
    D[0, 0] = 0.0
    trace = np.zeros((N + 1, M + 1), np.int8)   # 0 diag, 1 up, 2 left
    for i in range(1, N + 1):
        # vectorized over j is not possible (row depends on itself via the
        # left move); the loop body is tiny and N*M is at most ~700k cells.
        row = D[i]
        prev = D[i - 1]
        for j in range(1, M + 1):
            c0, c1, c2 = prev[j - 1], prev[j], row[j - 1]
            m = min(c0, c1, c2)
            row[j] = cost[i - 1, j - 1] + m
            trace[i, j] = 0 if m == c0 else (1 if m == c1 else 2)
    i, j = N, M
    ti, fi = [], []
    while i > 0 and j > 0:
        ti.append(i - 1)
        fi.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(ti[::-1]), np.asarray(fi[::-1])


def split_to_words(ids: Sequence[int],
                   detokenize: Callable[[List[int]], str]
                   ) -> tuple[List[str], List[int]]:
    """Split a token sequence into words -> (words, tokens_per_word).

    Tokenizer-agnostic version of whisper's split_tokens_on_spaces: decode
    every prefix and start a new word when the newly appended text begins
    with whitespace or a CJK character (CJK scripts have no spaces — each
    such token is its own word, as in the reference's zh handling).
    Requires only that detokenize is prefix-monotonic, which BPE decoders
    and the dev id-string detokenizer both are.
    """
    words: List[str] = []
    counts: List[int] = []
    prev_text = ""
    ids = list(ids)
    for i in range(len(ids)):
        text = detokenize(ids[: i + 1])
        piece = text[len(prev_text):]
        prev_text = text
        is_cjk = bool(piece) and any(
            0x4E00 <= ord(c) <= 0x9FFF or 0x3040 <= ord(c) <= 0x30FF
            or 0xAC00 <= ord(c) <= 0xD7AF for c in piece)
        if not words:
            new_word = True
        elif not piece or piece.startswith(("'", "’")):
            new_word = False          # apostrophe suffixes attach
        else:
            new_word = piece[:1].isspace() or is_cjk
        if new_word:
            words.append(piece.strip())
            counts.append(1)
        else:
            words[-1] += piece
            counts[-1] += 1
    # drop empty words produced by pure-whitespace pieces
    out_w, out_c = [], []
    for w, c in zip(words, counts):
        if w:
            out_w.append(w)
            out_c.append(c)
        elif out_c:
            out_c[-1] += c
        else:
            out_w.append(w)
            out_c.append(c)
    return out_w, out_c


def word_timestamps_from_alignment(
        probs: np.ndarray, token_logprob: np.ndarray,
        text_start: int, n_text: int,
        ids: Sequence[int], detokenize: Callable[[List[int]], str],
        n_frames: Optional[int] = None,
        medfilt_width: int = 7) -> List[dict]:
    """probs (K, S, T_enc) + per-token logprobs -> word dicts.

    text_start/n_text locate the generated text tokens inside the
    teacher-forced sequence (after the forced prompt, before EOT).
    Mirrors openai whisper timing.find_alignment: standardize each head's
    map over the token axis, median-filter over time, average heads, DTW
    on the negated matrix, then jump times at word boundaries.
    """
    if n_text == 0:
        return []
    if n_frames is not None:
        probs = probs[:, :, :n_frames]
    mat = probs[:, text_start: text_start + n_text]       # (K, N, T)
    std = mat.std(axis=1, keepdims=True) + 1e-8
    mat = (mat - mat.mean(axis=1, keepdims=True)) / std
    mat = median_filter(mat, medfilt_width)
    matrix = mat.mean(axis=0)                             # (N, T)
    ti, fi = dtw_path(-matrix)

    # first frame index of each token along the path
    jumps = np.pad(np.diff(ti), (1, 0), constant_values=1).astype(bool)
    jump_times = fi[jumps] * SECONDS_PER_FRAME            # (N,)

    words, counts = split_to_words(ids, detokenize)
    bounds = np.concatenate([[0], np.cumsum(counts)])     # (W+1,)
    tok_lp = token_logprob[text_start: text_start + n_text]
    out = []
    for w, word in enumerate(words):
        b0, b1 = int(bounds[w]), int(bounds[w + 1])
        start = float(jump_times[b0])
        end = float(jump_times[b1]) if b1 < len(jump_times) else float(
            (fi[-1] + 1) * SECONDS_PER_FRAME)
        prob = float(np.exp(tok_lp[b0:b1].mean())) if b1 > b0 else 0.0
        out.append({"word": word, "start": start, "end": max(end, start),
                    "probability": prob})
    return out


def default_alignment_heads(decoder_layers: int, num_heads: int
                            ) -> tuple[tuple[int, int], ...]:
    """All heads of the top half of the decoder (openai whisper's fallback
    when a model has no published alignment-head dump, timing.py — models
    with a dump should pass it to WhisperASR(alignment_heads=...))."""
    return tuple((l, h) for l in range(decoder_layers // 2, decoder_layers)
                 for h in range(num_heads))
