"""PyTorch port, voice cloning and dialogue: the engine's context, cache and
dialogue API held against the JAX engine on the CPU at float32 (tiny
config, the JAX engine's weights bridged into the port), and the port's
own invariants (stream == batch per turn, the voice-state cache, the
prompt-token cache).

Greedy comparisons use top-1 sampling for codebook 0 and the depth chain,
so both engines' frames are a function of the weights alone; waveforms are
compared to 1e-4 of the reference's peak (fp32 summation order), frames
exactly.
"""

import dataclasses

import numpy as np
import pytest
from scipy.io import wavfile

from fireredtts2_tpu.config import tiny_engine_config as j_tiny
from fireredtts2_tpu.engine.engine import Segment as JSegment

from fireredtts2_tpu_torch.config import tiny_engine_config as t_tiny
from fireredtts2_tpu_torch.engine import FireRedTTS2Engine as TEngine, Segment
from fireredtts2_tpu_torch.utils.audio_io import load_prompt_audio_16k, resample
from fireredtts2_tpu_torch.weights import from_jax

from _torch_parity import jax_engine, one_torch_thread, voiced, wave_close  # noqa: F401

TEXTS = ["[S1]Hello there, how are you?", "[S2]Fine, thanks.",
         "[S1]Good to hear."]
PROMPT_TEXTS = ["[S1]This is my voice.", "[S2]And this is mine."]


def _greedy(cfg):
    """Top-1 depth chain, a float32 LM, and a vocoder slab of 2048 latents
    (256 frames): the greedy monologue runs 400-frame calls, and a decode
    past the slab clamps its writes in both packages."""
    codec = dataclasses.replace(cfg.codec, acoustic_decoder=dataclasses.replace(
        cfg.codec.acoustic_decoder, max_stream_latents=2048))
    return dataclasses.replace(
        cfg, depth_topk=1, codec=codec,
        llm=dataclasses.replace(cfg.llm, dtype="float32"))


@pytest.fixture(scope="module")
def engines():
    """A JAX engine and a port engine with its weights, both float32 with
    a top-1 depth chain (built once: the JAX engine compiles its programs
    per instance)."""
    jeng = jax_engine(config=_greedy(j_tiny()), seed=5)
    teng = TEngine(_greedy(t_tiny()), device="cpu",
                   lm_params=from_jax(jeng.lm_params),
                   codec_params=from_jax(jeng.codec_params))
    return jeng, teng


@pytest.fixture(scope="module")
def prompt_wavs(tmp_path_factory):
    """Two prompt wavs, 1.2 s at 16 kHz and 0.9 s at 24 kHz (resampled to
    16 kHz on load)."""
    d = tmp_path_factory.mktemp("prompts")
    paths = []
    for i, (n, sr) in enumerate([(19_200, 16_000), (21_600, 24_000)]):
        path = str(d / f"prompt{i}.wav")
        wavfile.write(path, sr, (voiced(n, 10 + i, sr) * 32767).astype(np.int16))
        paths.append(path)
    return paths


def test_greedy_generate_with_context_matches_jax_engine(engines, prompt_wavs):
    """A context segment (text + prompt audio): the first call takes the
    plain left-padded prompt, the second builds the voice state and
    appends the text onto it; each equals the JAX engine's."""
    jeng, teng = engines
    audio = load_prompt_audio_16k(prompt_wavs[0])
    jctx = [JSegment("[S1]", PROMPT_TEXTS[0], audio)]
    tctx = [Segment("[S1]", PROMPT_TEXTS[0], audio)]
    builds = teng.voice_state_builds
    for use in range(2):
        want = jeng.generate("Nice to meet you.", "[S1]", jctx,
                             max_audio_length_ms=800, temperature=1.0, topk=1)
        got = teng.generate("Nice to meet you.", "[S1]", tctx,
                            max_audio_length_ms=800, temperature=1.0, topk=1)
        assert got.shape == want.shape and len(got) > 0
        wave_close(got, want, f"use {use}")
    assert teng.voice_state_builds == builds + 1


def test_greedy_incremental_dialogue_matches_jax_engine(engines, prompt_wavs):
    """Three turns [S1] [S2] [S1] cloned from two prompt wavs: the
    incremental dialogue's audio equals the JAX engine's."""
    jeng, teng = engines
    kw = dict(prompt_wav_list=prompt_wavs, prompt_text_list=PROMPT_TEXTS,
              temperature=1.0, topk=1, max_utterance_ms=640)
    want = jeng.generate_dialogue(list(TEXTS), **kw)
    got = teng.generate_dialogue(list(TEXTS), **kw)
    assert got.shape == want.shape and len(got) > 0
    wave_close(got, want, "dialogue")
    stats = teng.last_turn_stats
    assert len(stats) == 3
    assert [s["live_start"] for s in stats] == [0, 0, 0]
    assert stats[0]["live_end"] < stats[1]["live_end"] < stats[2]["live_end"]


def test_greedy_incremental_dialogue_equals_reprefill(engines, prompt_wavs):
    """Inside the port: the incremental dialogue (append windows, rewinds)
    gives the re-prefill path's audio, which rebuilds the whole
    conversation as one left-padded prompt every turn."""
    _, teng = engines
    kw = dict(prompt_wav_list=prompt_wavs, prompt_text_list=PROMPT_TEXTS,
              temperature=1.0, topk=1, max_utterance_ms=640)
    inc = teng.generate_dialogue(list(TEXTS), incremental=True, **kw)
    inc_frames = list(teng.last_turn_tokens)
    re = teng.generate_dialogue(list(TEXTS), incremental=False, **kw)
    for a, b in zip(teng.last_turn_tokens, inc_frames):
        np.testing.assert_array_equal(a, b)
    wave_close(inc, re, "incremental vs re-prefill")


def test_dialogue_stream_equals_dialogue_sampled(prompt_wavs):
    """Sampled decoding with one utt_seed: generate_dialogue_stream gives
    generate_dialogue's frames turn by turn, and its audio; what re-entered
    the conversation after each turn was the turn's streamed audio (its
    encode is already cached)."""
    eng = TEngine(t_tiny(), seed=1, device="cpu")
    kw = dict(prompt_wav_list=prompt_wavs, prompt_text_list=PROMPT_TEXTS,
              max_utterance_ms=640, utt_seed=77)
    audio = eng.generate_dialogue(list(TEXTS), **kw)
    frames = list(eng.last_turn_tokens)
    pieces = list(eng.generate_dialogue_stream(list(TEXTS), **kw))
    assert sorted({i for i, _ in pieces}) == [0, 1, 2]
    assert [f.shape for f in eng.last_turn_tokens] == [f.shape for f in frames]
    for a, b in zip(eng.last_turn_tokens, frames):
        np.testing.assert_array_equal(a, b)
    wave_close(np.concatenate([c for _, c in pieces]), audio, "stream")
    calls = eng.encode_calls
    for turn in (0, 1):
        heard = np.concatenate([c for i, c in pieces if i == turn])
        eng.encode_prompt_tokens(resample(heard, eng.output_sample_rate,
                                          eng.sample_rate))
    assert eng.encode_calls == calls


def test_voice_state_cache(engines, prompt_wavs):
    """Built on the second use; greedy output with the cache equals the
    output without it (voice_state_cache=0), two hits are equal (a hit is
    a copy: the first hit's decode does not write the cached state), and
    a one-entry cache evicts the older context."""
    _, teng = engines
    audio = load_prompt_audio_16k(prompt_wavs[1])
    ctx = [Segment("[S2]", PROMPT_TEXTS[1], audio)]
    plain = TEngine(dataclasses.replace(teng.config, voice_state_cache=0),
                    device="cpu", lm_params=teng.lm_params,
                    codec_params=teng.codec_params)
    kw = dict(max_audio_length_ms=640, temperature=1.0, topk=1)
    want = plain.generate("Again, please.", "[S2]", ctx, **kw)
    builds = teng.voice_state_builds
    outs = [teng.generate("Again, please.", "[S2]", ctx, **kw)
            for _ in range(3)]
    assert teng.voice_state_builds == builds + 1
    assert plain.voice_state_builds == 0
    for i, got in enumerate(outs):
        wave_close(got, want, f"call {i}")
    np.testing.assert_array_equal(outs[1], outs[2])

    one = TEngine(dataclasses.replace(teng.config, voice_state_cache=1),
                  device="cpu", lm_params=teng.lm_params,
                  codec_params=teng.codec_params)
    other = [Segment("[S1]", PROMPT_TEXTS[0],
                     load_prompt_audio_16k(prompt_wavs[0]))]
    for c in (ctx, ctx, other, other, ctx):
        one.generate("Hi.", c[0].speaker, c, max_audio_length_ms=160)
    assert one.voice_state_builds == 3          # ctx, other, ctx again
    assert len(one._voice_state_cache) == 1


def test_encode_calls_and_monologue_prompt_tokens(engines, prompt_wavs):
    """encode_prompt_tokens encodes a prompt once (the token count is
    ceil(n / 1280) plus the EOS frame); a monologue cloned from its
    pre-encoded tokens encodes nothing and equals the one from the wav;
    it matches the JAX engine's greedy monologue."""
    jeng, teng = engines
    audio = load_prompt_audio_16k(prompt_wavs[0])
    fresh = audio[:-320]                  # content no earlier test encoded
    calls = teng.encode_calls
    frames, mask = teng.encode_prompt_tokens(fresh)
    assert teng.encode_calls == calls + 1
    assert frames.shape == (-(-len(fresh) // 1280) + 1, teng._ncols)
    assert not frames[-1].any() and mask[:, :-1].all() and not mask[:, -1].any()
    again, _ = teng.encode_prompt_tokens(fresh.copy())
    np.testing.assert_array_equal(again, frames)
    assert teng.encode_calls == calls + 1

    kw = dict(prompt_text=PROMPT_TEXTS[0][4:], temperature=1.0, topk=1)
    text = "One more sentence to read."
    from_wav = teng.generate_monologue(text, prompt_wavs[0], **kw)
    tokens = teng.encode_prompt_tokens(audio)
    n = teng.encode_calls
    from_tokens = teng.generate_monologue(text, None, prompt_tokens=tokens,
                                          **kw)
    assert teng.encode_calls == n
    np.testing.assert_array_equal(from_tokens, from_wav)
    want = jeng.generate_monologue(text, prompt_wavs[0], **kw)
    assert from_wav.shape == want.shape and len(want) > 0
    wave_close(from_wav, want, "monologue")


def test_context_overflow_raises(prompt_wavs):
    """A prompt past the largest bucket, and a dialogue whose next window
    does not fit the LM's context, raise ValueError."""
    eng = TEngine(t_tiny(), seed=2, device="cpu")
    ctx = [Segment("[S1]", "[S1]" + "long " * 50,
                   load_prompt_audio_16k(prompt_wavs[0]))]
    with pytest.raises(ValueError, match="prompt too long"):
        eng.generate("Hi.", "[S1]", ctx, max_audio_length_ms=160)
    with pytest.raises(ValueError, match="dialogue context overflow"):
        eng.generate_dialogue(["[S1]" + "a few words " * 9,
                               "[S2]" + "some more words " * 8],
                              max_utterance_ms=160, utt_seed=1)
