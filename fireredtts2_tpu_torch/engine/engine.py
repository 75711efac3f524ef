"""Text-to-speech engine on PyTorch: text (and voice prompts) in, 24 kHz
audio out.

Counterpart of ``fireredtts2_tpu/engine/engine.py``:
- ``generate`` (whole utterance, then a bucketed vocoder pass),
  ``generate_stream`` (K-frame LM + vocoder blocks, ~80 ms chunks) and
  ``generate_batch`` (several texts decoded together), each optionally
  conditioned on context segments (voice cloning);
- ``generate_dialogue`` (incremental KV, or the reference's re-prefill),
  ``generate_dialogue_stream`` and ``generate_monologue``;
- ``encode_prompt_tokens`` / ``prepare_prompt`` and two caches under one
  lock: prompt-audio tokens by content hash, and the voice state (the LM
  state after a context's prefill, built on the context's second use).

Serving transforms (``_apply_serving_transforms``) follow the JAX engine:
a fused-depth plan installs kernel B's bundle, ``quantize_depth`` makes the
depth decoder int8 or int4 (int4 matmuls run kernel E),
``quantize_backbone`` the backbone int8 and ``quantize_vocoder`` the
vocoder's transformer int8. The measured JAX serving preset is
``quantize_backbone=True, fused_depth_plan="gate=r8,up=s8,down=s8"``.

Prompts are left-padded into static buckets, as in the JAX package (RoPE
shift invariance keeps this exact); windows appended onto a live state
(the voice-state cache, incremental dialogue) are right-padded with
``real_len``. Sampling noise of global frame t comes from a generator
seeded by (utterance seed, t), so ``generate`` and ``generate_stream``
sample the same tokens for one utterance seed -- the counterpart of the
JAX package's fold_in(key, t) -- and so do ``generate_dialogue`` and
``generate_dialogue_stream`` turn by turn (turn i's seed: utt_seed + i).

Serving on a (dp, tp) mesh (``mesh=``, ``parallel.mesh``): every rank of
the process group builds the engine from the same whole trees and keeps its
shard (``lm_param_pspecs``, ``codec_param_pspecs``); every rank then calls
the same methods in the same order (SPMD), and each returns the whole
result. A batch's rows split over dp (replicated over every rank when dp
does not divide them, as ``sanitize_pspecs`` leaves them); each dp row
draws its rows of the whole batch's noise, so tokens equal one rank's.
Each device call makes the engine's own mesh current for the model code
(``_on_mesh``), so engines on different meshes, or none, live side by side
in one process. While a tp > 1 engine serves through its lockstep pool, a
device call from any other thread raises NotImplementedError: the other
ranks step only the pool.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import inspect
import itertools
import logging
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional

import numpy as np
import torch

from fireredtts2_tpu_torch.config import (
    EngineConfig, codec_config_from_json, llm_config_from_json,
)
from fireredtts2_tpu_torch.models.codec.model import (
    assemble_chunks, codec_decode_chunks, codec_encode, stream_decode_init,
)
from fireredtts2_tpu_torch.models.codec.whisper_nn import (
    quantize_whisper_layers_int8,
)
from fireredtts2_tpu_torch.models.lm.model import (
    LMState, clone_lm_state, init_lm_state, kv_capacity, lm_generate_frame,
    lm_generate_loop, rewind_lm_state,
)
from fireredtts2_tpu_torch.models.lm.transformer import (
    quantize_transformer_int4, quantize_transformer_int8,
)
from fireredtts2_tpu_torch.models.pipeline import stream_block
from fireredtts2_tpu_torch.ops.depth_chain import enable_fused_depth
from fireredtts2_tpu_torch.ops.flash_decode import (
    flash_lm_tp_ok, flash_voc_tp_ok,
)
from fireredtts2_tpu_torch.ops.int4 import prepare_int4_layout
from fireredtts2_tpu_torch.parallel import mesh as pmesh
from fireredtts2_tpu_torch.utils.audio_io import load_prompt_audio_16k, resample
from fireredtts2_tpu_torch.utils.text import (
    SPEAKER_TAGS, clean_text, process_text_list, split_text,
)
from fireredtts2_tpu_torch.utils.tokenizer import load_tokenizer
from fireredtts2_tpu_torch.runtime import checkpoint as ckpt
from fireredtts2_tpu_torch.weights import (
    dtype_of, init_random, resolve_device, tree_shapes,
)

AUDIO_TOKEN_CACHE = 64          # prompt-audio token entries (LRU)


def _frame_seed(utt_seed: int, t: int) -> int:
    return (utt_seed * 1_000_003 + t) & ((1 << 63) - 1)


@dataclass
class Segment:
    """One conversational segment: a speaker tag, its text and its audio
    (float32 at 16 kHz). audio_tokens / audio_tokens_mask: optional
    pre-encoded (T, ncols) frames of `audio` (``encode_prompt_tokens``);
    when set the engine skips the encode."""
    speaker: str
    text: str
    audio: np.ndarray
    audio_tokens: Optional[np.ndarray] = None
    audio_tokens_mask: Optional[np.ndarray] = None


def _on_mesh(fn):
    """An engine method run with the engine's mesh current
    (``parallel.mesh.use_mesh``: its model code reads that mesh and no
    other engine's), a generator's body one step at a time. While a
    tensor-parallel engine serves through its lockstep pool, a call from
    any thread but the pool's worker raises NotImplementedError (see
    :meth:`FireRedTTS2Engine._check_lockstep`)."""
    name = fn.__name__
    if inspect.isgeneratorfunction(fn):
        @functools.wraps(fn)
        def steps(self, *args, **kwargs):
            it = fn(self, *args, **kwargs)
            try:
                while True:
                    self._check_lockstep(name)
                    with pmesh.use_mesh(self.mesh):
                        try:
                            item = next(it)
                        except StopIteration as stop:
                            return stop.value
                    yield item
            finally:
                with pmesh.use_mesh(self.mesh):
                    it.close()
        return steps

    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        self._check_lockstep(name)
        with pmesh.use_mesh(self.mesh):
            return fn(self, *args, **kwargs)
    return call


class FireRedTTS2Engine:
    """Synthesis, voice cloning and dialogue."""

    def __init__(self, config: Optional[EngineConfig] = None, seed: int = 0,
                 device=None, lm_params: Optional[dict] = None,
                 codec_params: Optional[dict] = None,
                 pretrained_dir: Optional[str] = None,
                 gen_type: str = "dialogue",
                 llm_overrides: Optional[dict] = None,
                 codec_overrides: Optional[dict] = None,
                 mesh: Optional[pmesh.Mesh] = None):
        """config: the model and engine configuration (default: the
        flagship EngineConfig()). device: where weights, state and kernels
        live: "cuda" by default; "cpu" runs the plain versions and must be
        asked for (without a CUDA device anything else raises).
        lm_params / codec_params: unquantised parameter trees in the JAX
        layout (e.g. ``weights.from_jax`` of the JAX package's
        initialisers); when absent the engine draws random weights from
        `seed`. The config's serving transforms are applied to them.

        pretrained_dir: a serving dir instead: the config from its
        ``config_llm.json`` / ``config_codec.json`` (max_seq_len from the
        LM's, prefill buckets trimmed to leave 28 decode slots), the
        weights from ``DIR/torch/`` converted trees when both are there,
        else from the reference pickles (``llm_posttrain.pt`` or, for
        gen_type "monologue", ``llm_pretrain.pt``, and ``codec.pt``); the
        Qwen2.5-1.5B tokenizer from ``DIR/Qwen2.5-1.5B`` (a byte fallback,
        with a warning, when that dir is absent). llm_overrides /
        codec_overrides: config fields set on top of the JSONs or of
        `config`, e.g. the serving preset's {"quantize_backbone": True,
        "fused_depth_plan": "gate=r8,up=s8,down=s8"}.

        mesh: a (dp, tp) mesh of this process group (``parallel.mesh.
        make_mesh``, made on every rank): every rank passes the same whole
        trees (or seed, or dir) and keeps its shard; the engine's device
        calls make the mesh current for the model code (``_on_mesh``). On
        the card a mesh whose tp the kernels' shard routes cannot split
        raises here."""
        if gen_type not in ("monologue", "dialogue"):
            raise ValueError(f"gen_type {gen_type!r}: 'monologue' or 'dialogue'")
        self.gen_type = gen_type
        tok_dir = None
        if pretrained_dir is not None:
            config = _config_from_dir(pretrained_dir, gen_type, llm_overrides,
                                      codec_overrides)
            tok_dir = os.path.join(pretrained_dir, "Qwen2.5-1.5B")
            if not os.path.isdir(tok_dir):
                logging.getLogger(__name__).warning(
                    "no Qwen2.5-1.5B tokenizer dir under %s; using the byte "
                    "fallback tokenizer", pretrained_dir)
                tok_dir = None
        else:
            config = config or EngineConfig()
            if llm_overrides or codec_overrides:
                config = dataclasses.replace(
                    config,
                    llm=dataclasses.replace(config.llm, **(llm_overrides or {})),
                    codec=dataclasses.replace(config.codec,
                                              **(codec_overrides or {})))
        llm = config.llm
        if not config.codec.acoustic_decoder.causal:
            raise NotImplementedError(
                "this configuration needs a path that is not ported yet "
                "(the non-causal vocoder's streaming decode)")
        self.config = config
        self.device = resolve_device(device)
        if pretrained_dir is not None:
            lm_params, codec_params = self._load_checkpoint_trees(
                pretrained_dir, config.llm, config.codec)
        elif lm_params is None or codec_params is None:
            rand_lm, rand_codec = init_random(config, seed, self.device)
            lm_params = lm_params or rand_lm
            codec_params = codec_params or rand_codec
        # the raw trees' leaf shapes: what a reloaded checkpoint must match
        self._ref_shapes = (tree_shapes(lm_params), tree_shapes(codec_params))
        self.mesh = mesh
        # the worker thread of the lockstep pool a tp > 1 engine serves
        # through (ContinuousBatcher sets it), else None
        self._lockstep: Optional[threading.Thread] = None
        self._check_mesh()
        self.lm_params, self.codec_params = self._place(
            *self._apply_serving_transforms(lm_params, codec_params))
        self.tokenizer = load_tokenizer(tok_dir)

        acfg = config.codec.acoustic_decoder
        self.max_seq_len = config.max_seq_len
        self.sample_rate = config.codec.input_sample_rate
        self.output_sample_rate = config.codec.output_sample_rate
        self._ncb = llm.audio_num_codebooks
        self._ncols = llm.num_columns
        self._chunk_samples = 8 * acfg.hop_length
        self._tail_samples = (acfg.n_fft - acfg.hop_length) \
            - (acfg.n_fft - acfg.hop_length) // 2
        self._lead_samples = self._tail_samples
        # One re-entrant lock guards the mutable shared state: the seed
        # chain and the two caches (lookup, encode or build, insert).
        self._lock = threading.RLock()
        self._seeds = np.random.default_rng(seed + 17)
        self._audio_token_cache: "OrderedDict[str, tuple]" = OrderedDict()
        self.encode_calls = 0          # prompt-audio encodes (cache misses)
        self._voice_state_cache: "OrderedDict[str, tuple]" = OrderedDict()
        self._voice_ctx_seen: "OrderedDict[str, bool]" = OrderedDict()
        self.voice_state_builds = 0
        self._first_packet_s: Optional[float] = None
        # The frames (T, ncb) of the last generate / generate_stream call,
        # and the host-clock split of the last generate call.
        self.last_tokens: Optional[np.ndarray] = None
        self.last_stats: dict = {}
        # The last dialogue's frames and stats per turn, and its LM state
        # after the last turn (kept for inspection; its KV slab holds the
        # whole conversation).
        self.last_turn_tokens: list[np.ndarray] = []
        self.last_turn_stats: list[dict] = []
        self.last_lm_state: Optional[LMState] = None

    # ------------------------------------------------------------------
    # Checkpoints and hot reload
    # ------------------------------------------------------------------

    def _lm_name(self) -> str:
        return ("llm_pretrain" if self.gen_type == "monologue"
                else "llm_posttrain")

    def _load_converted_trees(self, pretrained_dir: str, llm_cfg, codec_cfg
                              ) -> Optional[tuple[dict, dict]]:
        """Raw (lm_params, codec_params) from the ``DIR/torch/`` converted
        trees (tensors only, ``weights_only`` loads) on the engine's
        device; None when either is absent."""
        lm_path = ckpt.converted_path(pretrained_dir, self._lm_name())
        codec_path = ckpt.converted_path(pretrained_dir, "codec")
        if not (os.path.exists(lm_path) and os.path.exists(codec_path)):
            return None
        return (ckpt.load_converted_lm(lm_path, dtype_of(llm_cfg.dtype),
                                       self.device),
                ckpt.load_converted_codec(codec_path, dtype_of(codec_cfg.dtype),
                                          self.device))

    def _load_checkpoint_trees(self, pretrained_dir: str, llm_cfg, codec_cfg
                               ) -> tuple[dict, dict]:
        """Raw (lm_params, codec_params) of a serving dir on the engine's
        device: the ``DIR/torch/`` converted trees when both are there,
        else the reference pickles (the SSL encoder from a local HF whisper
        checkout when ``codec.pt`` has none)."""
        trees = self._load_converted_trees(pretrained_dir, llm_cfg, codec_cfg)
        if trees is not None:
            return trees
        lm_name = self._lm_name()
        lm_dtype, codec_dtype = dtype_of(llm_cfg.dtype), dtype_of(codec_cfg.dtype)
        lm = ckpt.load_lm_checkpoint(
            os.path.join(pretrained_dir, lm_name + ".pt"), llm_cfg, lm_dtype,
            device=self.device)
        codec = ckpt.load_codec_checkpoint(
            os.path.join(pretrained_dir, "codec.pt"), codec_cfg, codec_dtype,
            hf_whisper_dir=ckpt.find_hf_whisper_dir(pretrained_dir),
            device=self.device)
        return lm, codec

    @staticmethod
    def _shape_guard(name: str, loaded: dict, reference: dict,
                     path: str = "") -> dict:
        """The loaded tree restricted to the reference's structure (the
        shapes recorded when the engine built its trees). A leaf that is
        missing or of another shape raises ValueError naming it; subtrees
        the running model does not have (a checkpoint's semantic decoder,
        which no serving path runs) are left out."""
        out = {}
        for k, ref in reference.items():
            where = f"{path}/{k}" if path else k
            if k not in loaded:
                raise ValueError(f"reload {name}: leaf {where} is missing")
            got = loaded[k]
            if isinstance(ref, dict):
                if not isinstance(got, dict):
                    raise ValueError(f"reload {name}: {where} is a leaf, the "
                                     f"running model has a subtree there")
                out[k] = FireRedTTS2Engine._shape_guard(name, got, ref, where)
            elif not torch.is_tensor(got) or tuple(got.shape) != ref:
                raise ValueError(
                    f"reload {name} leaf {where} has shape "
                    f"{tuple(getattr(got, 'shape', ()))}, running model "
                    f"expects {ref}")
            else:
                out[k] = got
        return out

    def prepare_checkpoint(self, pretrained_dir: str) -> tuple[dict, dict]:
        """Load and transform new weights without touching what serves (the
        slow half of a hot reload; it runs while generation goes on). The
        dir must hold the converted ``DIR/torch/`` trees (a hot reload
        unpickles nothing: the reference pickles load only at start-up) of
        the running model's shapes, leaf by leaf; FileNotFoundError
        otherwise. Returns the handle for :meth:`apply_checkpoint`."""
        trees = self._load_converted_trees(
            pretrained_dir, self.config.llm, self.config.codec)
        if trees is None:
            raise FileNotFoundError(
                f"{pretrained_dir!r} has no converted DIR/torch/ trees "
                "(runtime/checkpoint.py: save_params); a hot reload reads "
                "only those")
        lm, codec = trees
        lm = self._shape_guard("LM", lm, self._ref_shapes[0])
        codec = self._shape_guard("codec", codec, self._ref_shapes[1])
        with torch.inference_mode():
            return self._apply_serving_transforms(lm, codec)

    def apply_checkpoint(self, prepared: tuple[dict, dict]) -> None:
        """Swap in weights from :meth:`prepare_checkpoint`. Callers drain
        in-flight generation first (``ContinuousBatcher.reload`` does): KV
        caches hold activations of the weights that made them. The
        prompt-token and voice-state caches are cleared under the lock."""
        lm_params, codec_params = prepared
        if self.mesh is not None:
            raise NotImplementedError("hot reload on a mesh is not ported")
        with self._lock:
            self.lm_params = lm_params
            self.codec_params = codec_params
            self._audio_token_cache.clear()
            self._voice_state_cache.clear()
            self._voice_ctx_seen.clear()

    def reload_checkpoint(self, pretrained_dir: str) -> None:
        """prepare + apply in one call, for an idle engine (serving reloads
        through ``ContinuousBatcher.reload``, which drains in between)."""
        self.apply_checkpoint(self.prepare_checkpoint(pretrained_dir))

    @_on_mesh
    def warmup(self) -> float:
        """One prefill per bucket and one short stream, so every kernel
        library is built and loaded and kernel C's merge counts are sized
        before the first request (nothing is compiled per shape here, as
        in the JAX package). A batcher pool warms its own shapes
        (``ContinuousBatcher.wait_ready``). Returns the seconds it took."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            for bucket in self.config.prefill_buckets:
                tokens = np.zeros((1, bucket, self._ncols), np.int32)
                mask = np.zeros((1, bucket, self._ncols), bool)
                mask[:, :, -1] = True
                lm_generate_frame(
                    self.lm_params, self.config.llm, self._new_lm_state(1),
                    self._dev(tokens), self._dev(mask),
                    self._dev(np.ones((1, bucket), bool)),
                    self.noise_fn(0, 1)(0), **self._sampling(0.9, 20))
        list(self.generate_stream("warm up", "[S1]", None,
                                  max_audio_length_ms=30 * 80, utt_seed=0))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    # ------------------------------------------------------------------
    # The mesh
    # ------------------------------------------------------------------

    def _check_lockstep(self, what: str) -> None:
        """Refuse a device call that would run tp collectives on this rank
        alone: while the engine serves through a lockstep pool, the other
        ranks step only that pool, so a call from another thread (rank 0's
        server building a voice, a prompt-less clone) would wait forever
        in its first collective."""
        t = self._lockstep
        if t is not None and threading.current_thread() is not t:
            raise NotImplementedError(
                f"{what} on a tensor-parallel engine outside its serving "
                f"pool: the other ranks follow only the pool's lockstep "
                f"(voice prompts, clones and dialogue at tp > 1 are not "
                f"ported yet: ROADMAP.md queue 1, item 13)")

    def _check_mesh(self) -> None:
        """On the card, refuse a mesh the kernels' shard routes cannot
        split (no silent plain route); on the CPU the plain versions take
        any mesh whose tp divides the split dimensions."""
        m = self.mesh
        if m is None or m.tp == 1:
            return
        llm, ac = self.config.llm, self.config.codec.acoustic_decoder
        if llm.quantize_depth and llm.quantize_depth_bits == 4 \
                and not llm.fused_depth_plan:
            raise NotImplementedError(
                "int4 depth weights (kernel E) under tp > 1 are not ported")
        if self.device.type != "cuda":
            return
        bb = llm.backbone
        T = kv_capacity(llm.max_seq_len)
        if not flash_lm_tp_ok(m, bb.num_heads, bb.num_kv_heads, bb.head_dim, T):
            raise ValueError(
                f"flash_lm_tp_ok: kernel A's tp route cannot split the "
                f"backbone (Hq={bb.num_heads}, Hkv={bb.num_kv_heads}, "
                f"Dh={bb.head_dim}, T={T}) over tp={m.tp}")
        Dh = ac.embed_dim // ac.num_heads
        if not flash_voc_tp_ok(m, ac.num_heads, Dh, 8, ac.max_stream_latents):
            raise ValueError(
                f"flash_voc_tp_ok: kernel C's tp route cannot split the "
                f"vocoder (H={ac.num_heads}, Dh={Dh}, "
                f"T={ac.max_stream_latents}) over tp={m.tp}")

    def _place(self, lm_params: dict, codec_params: dict
               ) -> tuple[dict, dict]:
        """This rank's shards of the transformed trees (whole trees without
        a mesh)."""
        m = self.mesh
        if m is None or m.tp == 1:
            return lm_params, codec_params
        return (pmesh.shard_params(m, lm_params,
                                   pmesh.lm_param_pspecs(lm_params)),
                pmesh.shard_params(m, codec_params,
                                   pmesh.codec_param_pspecs(codec_params)))

    def _rows(self, B: int) -> tuple[int, int]:
        """[start, stop) of this rank's rows of a B-stream batch: its dp
        share, or all B when dp does not divide them."""
        if self.mesh is None:
            return 0, B
        return pmesh.shard_spec_rows(B, self.mesh, "dp")

    def _gather_rows(self, x: torch.Tensor, B: int) -> torch.Tensor:
        """The whole B rows (dim 0) of a tensor whose rows split over dp."""
        m = self.mesh
        if m is None or x.shape[0] == B:
            return x
        return pmesh.gather_dim(x, B, 0, m.dp_group, m.dp_rank)

    def _apply_serving_transforms(self, lm_params: dict, codec_params: dict
                                  ) -> tuple[dict, dict]:
        """Quantisation and the fused depth chain per the config, on copies
        of the trees (engine.py:_apply_serving_transforms of the JAX
        package). The fused plan takes precedence over quantize_depth, and
        speculative depth is then ignored, as there; without a plan,
        speculative depth runs on whatever depth decoder this leaves (bf16,
        int8, or int4 through kernel E at 16 rows a stream)."""
        llm = self.config.llm
        if llm.fused_depth_plan or llm.quantize_depth or llm.quantize_backbone:
            lm_params = dict(lm_params)
            if llm.fused_depth_plan:
                lm_params = enable_fused_depth(lm_params, llm)
            elif llm.quantize_depth:
                if llm.quantize_depth_bits == 4:
                    lm_params["decoder"] = prepare_int4_layout(
                        quantize_transformer_int4(lm_params["decoder"]))
                else:
                    lm_params["decoder"] = quantize_transformer_int8(
                        lm_params["decoder"])
            if llm.quantize_backbone:
                lm_params["backbone"] = quantize_transformer_int8(
                    lm_params["backbone"])
        if self.config.codec.quantize_vocoder:
            codec_params = dict(codec_params)
            ad = dict(codec_params["acoustic_decoder"])
            ad["layers"] = quantize_whisper_layers_int8(ad["layers"])
            codec_params["acoustic_decoder"] = ad
        return lm_params, codec_params

    # ------------------------------------------------------------------
    # Prompt building
    # ------------------------------------------------------------------

    def _next_seed(self) -> int:
        with self._lock:
            return int(self._seeds.integers(0, 1 << 31))

    def _turn_seeds(self, n: int, utt_seed: Optional[int]) -> list[int]:
        if utt_seed is None:
            return [self._next_seed() for _ in range(n)]
        return [utt_seed + i for i in range(n)]

    def noise_fn(self, utt_seed: int, B: int,
                 rows: Optional[tuple[int, int]] = None
                 ) -> Callable[[int], torch.Tensor]:
        """Frame t's sampling noise (B, ncb, V_audio), Exp(1) draws from a
        generator seeded by (utt_seed, t); rows: only rows [start, stop) of
        those draws (a dp rank's share of a batch)."""
        shape = (B, self._ncb, self.config.llm.audio_vocab_size)

        def fn(t: int) -> torch.Tensor:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(_frame_seed(utt_seed, t))
            x = torch.empty(shape, dtype=torch.float32,
                            device=self.device).exponential_(generator=gen)
            return x if rows is None or rows == (0, B) else x[rows[0]:rows[1]]
        return fn

    def _tokenize_text_segment(self, text: str, speaker: str):
        """-> ((T, ncols) tokens, mask), text ids in the last column."""
        ids = self.tokenizer.encode(f"{speaker}<|text_start|>{text}<|text_end|>")
        frame = np.zeros((len(ids), self._ncols), np.int32)
        mask = np.zeros((len(ids), self._ncols), bool)
        frame[:, -1] = ids
        mask[:, -1] = True
        return frame, mask

    @_on_mesh
    def _tokenize_audio(self, audio16k: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Prompt audio (16 kHz) -> its codec frames plus an all-zero EOS
        frame, audio columns masked in (the EOS frame's too).

        A content-hash LRU of AUDIO_TOKEN_CACHE entries: a dialogue
        re-tokenizes its prompts every turn and clone requests reuse one
        voice, and the 32-layer SSL encode is the dominant cost of a
        prompt. The lookup, encode and insert run under the engine lock,
        so concurrent encodes of the same audio coalesce. `encode_calls`
        counts the encodes (misses)."""
        audio16k = np.ascontiguousarray(audio16k, np.float32)
        key = hashlib.sha1(audio16k.tobytes()).hexdigest()
        with self._lock:
            hit = self._audio_token_cache.get(key)
            if hit is not None:
                self._audio_token_cache.move_to_end(key)
                return hit
            self.encode_calls += 1
            with torch.inference_mode():
                codes, tlen = codec_encode(self.codec_params, self.config.codec,
                                           audio16k[None, :])
            tokens = codes[0, :, :tlen[0]]                   # (nq, T)
            T = tokens.shape[1] + 1                          # + EOS frame
            frame = np.zeros((T, self._ncols), np.int32)
            mask = np.zeros((T, self._ncols), bool)
            frame[:T - 1, :-1] = tokens.T
            mask[:, :-1] = True
            self._audio_token_cache[key] = (frame, mask)
            while len(self._audio_token_cache) > AUDIO_TOKEN_CACHE:
                self._audio_token_cache.popitem(last=False)
            return frame, mask

    @_on_mesh
    def encode_prompt_tokens(self, audio16k: np.ndarray
                             ) -> tuple[np.ndarray, np.ndarray]:
        """Pre-encode prompt audio: (T, ncols) frames + mask for
        ``Segment.audio_tokens`` / ``generate_monologue(prompt_tokens=)``."""
        return self._tokenize_audio(audio16k)

    def _tokenize_segment(self, seg: Segment) -> tuple[np.ndarray, np.ndarray]:
        tf, tm = self._tokenize_text_segment(seg.text, seg.speaker)
        if seg.audio_tokens is not None:
            af, am = seg.audio_tokens, seg.audio_tokens_mask
        else:
            af, am = self._tokenize_audio(seg.audio)
        return np.concatenate([tf, af]), np.concatenate([tm, am])

    def _build_prompt(self, context: Optional[List[Segment]],
                      text: Optional[str], speaker: Optional[str]):
        """Context segments (text, then audio frames) and the new text ->
        ((T, ncols) tokens, mask)."""
        pieces = [self._tokenize_segment(s) for s in context or []]
        if text is not None:
            pieces.append(self._tokenize_text_segment(text, speaker))
        return (np.concatenate([p[0] for p in pieces]),
                np.concatenate([p[1] for p in pieces]))

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

    def _right_pad(self, win: np.ndarray, wmask: np.ndarray):
        """Right-pad an append window into its static bucket (content
        left-aligned; run with real_len) -> (bucket, tokens, mask, valid),
        each with a leading 1."""
        L = win.shape[0]
        bucket = self._bucket(L)
        tokens = np.zeros((1, bucket, self._ncols), np.int32)
        mask = np.zeros((1, bucket, self._ncols), bool)
        valid = np.zeros((1, bucket), bool)
        tokens[0, :L] = win
        mask[0, :L] = wmask
        valid[0, :L] = True
        return bucket, tokens, mask, valid

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    @_on_mesh
    def _new_lm_state(self, B: int, capacity: Optional[int] = None):
        """A fresh B-stream LM state; capacity: a smaller position cap (a
        batcher pool's capacity class)."""
        return init_lm_state(self.config.llm, B, dtype_of(self.config.llm.dtype),
                             device=self.device, capacity=capacity)

    @_on_mesh
    def _new_vstate(self, B: int, latents: Optional[int] = None):
        """A fresh B-stream vocoder state; latents: a smaller KV capacity
        (8 per frame, 16-aligned)."""
        return stream_decode_init(self.config.codec, B,
                                  dtype_of(self.config.codec.dtype),
                                  device=self.device, latents=latents)

    @_on_mesh
    @torch.inference_mode()
    def _context_state(self, context: Optional[List[Segment]]):
        """(a copy of the cached LM state after this context's prefill,
        its length), or None: no context, the cache is off, or the
        context's first use.

        A context is cached on its second use (a one-shot prompt keeps the
        plain left-padded path): its segments are prefilled once into a
        fresh state at positions 0..L-1 (a right-padded window, then a
        rewind over the pad), keyed by the context's token content. Every
        hit hands out a clone, since generation writes the state in place.
        RoPE shift invariance makes greedy decode equal to the uncached
        layout's; sampled decode draws from the same distribution."""
        if self.config.voice_state_cache <= 0 or not context:
            return None
        with self._lock:
            win, wmask = self._build_prompt(context, None, None)
            L = int(win.shape[0])
            key = hashlib.sha256(win.tobytes() + wmask.tobytes()).hexdigest()
            hit = self._voice_state_cache.get(key)
            if hit is None:
                if key not in self._voice_ctx_seen:
                    self._voice_ctx_seen[key] = True
                    while len(self._voice_ctx_seen) > \
                            8 * self.config.voice_state_cache:
                        self._voice_ctx_seen.popitem(last=False)
                    return None
                self.voice_state_builds += 1
                _, tokens, mask, valid = self._right_pad(win, wmask)
                real_len = self._dev(np.array([L], np.int32))
                state, _ = lm_generate_frame(
                    self.lm_params, self.config.llm, self._new_lm_state(1),
                    self._dev(tokens), self._dev(mask), self._dev(valid),
                    self.noise_fn(0, 1)(0), temperature=1.0, topk=1,
                    real_len=real_len)          # the sampled frame is unused
                hit = (rewind_lm_state(state, real_len), L)
                self._voice_state_cache[key] = hit
                while len(self._voice_state_cache) > \
                        self.config.voice_state_cache:
                    self._voice_state_cache.popitem(last=False)
            else:
                self._voice_state_cache.move_to_end(key)
            return clone_lm_state(hit[0]), hit[1]

    # ------------------------------------------------------------------
    # Core generation
    # ------------------------------------------------------------------

    def _sampling(self, temperature: float, topk: int) -> dict:
        return dict(temperature=temperature, topk=topk,
                    depth_topk=self.config.depth_topk,
                    depth_temperature=self.config.depth_temperature)

    @torch.inference_mode()
    def _loop(self, state: LMState, tokens, mask, valid, max_frames: int,
              cap: int, temperature: float, topk: int, seed: int,
              real_len: Optional[int] = None
              ) -> tuple[LMState, list[np.ndarray]]:
        """lm_generate_loop on host arrays -> (state, B arrays of (T_i, ncb)
        int32 frames). Sets last_stats' "frames", "lm_s", "prefill_s". On a
        mesh `state` holds this rank's rows (:meth:`_rows`) and the frames
        are gathered whole."""
        B = tokens.shape[0]
        r0, r1 = self._rows(B)
        stats: dict = {}
        t0 = time.perf_counter()
        state, buf, n_frames = lm_generate_loop(
            self.lm_params, self.config.llm, state, self._dev(tokens[r0:r1]),
            self._dev(mask[r0:r1]), self._dev(valid[r0:r1]),
            self.noise_fn(seed, B, (r0, r1)),
            max_frames=max_frames, frame_cap=cap,
            real_len=(None if real_len is None
                      else self._dev(np.array([real_len], np.int32))),
            stats=stats, **self._sampling(temperature, topk))
        buf = self._gather_rows(buf, B).cpu().numpy()
        n_frames = self._gather_rows(n_frames, B).cpu().numpy()
        self.last_stats = {"frames": int(n_frames.max()),
                           "lm_s": time.perf_counter() - t0, **stats}
        return state, [buf[i, :n_frames[i]] for i in range(B)]

    def _run_ar(self, prompts: list, max_generation_len: int,
                temperature: float, topk: int,
                utt_seed: Optional[int] = None) -> list[np.ndarray]:
        """AR generation of B utterances together (shared bucket,
        per-stream EOS) -> B arrays of (T_i, ncb) int32 frames."""
        bucket, tokens, mask, valid = self._bucketize(prompts)
        max_frames = self.max_seq_len - bucket
        seed = self._next_seed() if utt_seed is None else utt_seed
        r0, r1 = self._rows(len(prompts))
        _, frames = self._loop(self._new_lm_state(r1 - r0), tokens, mask,
                               valid, max_frames,
                               min(max_generation_len, max_frames),
                               temperature, topk, seed)
        return frames

    def _run_ar_from(self, state: LMState, pos: int, win: np.ndarray,
                     wmask: np.ndarray, max_generation_len: int,
                     temperature: float, topk: int,
                     utt_seed: Optional[int] = None) -> np.ndarray:
        """Whole-utterance generation appended onto a live state at
        absolute position pos (the voice-state cache path): the window
        holds only the new tokens, right-padded (real_len)."""
        L = win.shape[0]
        bucket, tokens, mask, valid = self._right_pad(win, wmask)
        if pos + bucket > self.max_seq_len:
            raise ValueError(
                f"prompt too long: {pos} + {bucket} > {self.max_seq_len}")
        seed = self._next_seed() if utt_seed is None else utt_seed
        _, [gen] = self._loop(state, tokens, mask, valid,
                              self.max_seq_len - bucket,
                              min(max_generation_len,
                                  self.max_seq_len - pos - L - 1),
                              temperature, topk, seed, real_len=L)
        return gen

    @torch.inference_mode()
    @_on_mesh
    def _decode_tokens(self, frames: list[np.ndarray]) -> list[np.ndarray]:
        """B arrays of (T_i, ncb) frames -> B (T_i * 1920,) float32
        waveforms at 24 kHz: one bucket-padded streaming-exact vocoder pass
        (padding cannot leak into the audio)."""
        T_max = max(f.shape[0] for f in frames)
        if T_max == 0:
            return [np.zeros((0,), np.float32) for _ in frames]
        Lpad = ((T_max + 31) // 32) * 32
        B = len(frames)
        toks = np.zeros((B, self._ncb, Lpad), np.int32)
        for i, f in enumerate(frames):
            toks[i, :, :f.shape[0]] = f.T
        r0, r1 = self._rows(B)
        middles, tails = codec_decode_chunks(self.codec_params,
                                             self.config.codec,
                                             self._dev(toks[r0:r1]))
        # (L, B, n): rows on dim 1
        middles = self._gather_rows(middles.float().transpose(0, 1), B)
        tails = self._gather_rows(tails.float().transpose(0, 1), B)
        middles = middles.transpose(0, 1).cpu().numpy()
        tails = tails.transpose(0, 1).cpu().numpy()
        acfg = self.config.codec.acoustic_decoder
        return [assemble_chunks(middles[:, i:i + 1], tails[:, i:i + 1],
                                f.shape[0], acfg.hop_length, acfg.n_fft)[0]
                .astype(np.float32) if f.shape[0] else np.zeros(0, np.float32)
                for i, f in enumerate(frames)]

    def _stream_utterance(self, state: LMState, tokens, tmask, valid,
                          real_len: Optional[int], max_len: int, seed: int,
                          temperature: float, topk: int, t_start: float):
        """Stream one utterance from a prompt window: yields float32 chunks
        at 24 kHz and returns the LM state after it.

        The first call prefills the window (real_len: appended onto
        `state`) and runs a 1-frame block; blocks then grow 1 -> 4 -> 16
        (stream_block_cap) frames. Each block is one LM + vocoder pass with
        one packed host copy; the host emits middles for live frames and
        closes with the tail of the last live frame. Sets last_tokens, and
        the first-packet latency from t_start if none is set yet."""
        noise_fn = self.noise_fn(seed, 1)
        kw = self._sampling(temperature, topk)
        cs, ts = self._chunk_samples, self._tail_samples
        llm_cfg, codec_cfg = self.config.llm, self.config.codec
        self.last_tokens = np.zeros((0, self._ncb), np.int32)

        def block_noise(t_base: int, block: int) -> torch.Tensor:
            return torch.stack([noise_fn(t_base + t) for t in range(block)])

        with torch.inference_mode():
            vstate = self._new_vstate(1)
            state, frame = lm_generate_frame(
                self.lm_params, llm_cfg, state, self._dev(tokens),
                self._dev(tmask), self._dev(valid), noise_fn(0),
                real_len=(None if real_len is None
                          else self._dev(np.array([real_len], np.int32))),
                **kw)
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
        return state

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    @_on_mesh
    def prepare_prompt(self, text: str, speaker: str, audio_path: str
                       ) -> Segment:
        """A context segment from a wav file (any rate, read at 16 kHz)."""
        return Segment(speaker=speaker, text=text,
                       audio=load_prompt_audio_16k(audio_path))

    @_on_mesh
    def generate(self, text: str, speaker: str,
                 context: Optional[List[Segment]] = None,
                 max_audio_length_ms: float = 90_000, temperature: float = 0.9,
                 topk: int = 20, utt_seed: Optional[int] = None) -> np.ndarray:
        """One utterance conditioned on context -> (n,) float32 at 24 kHz.
        utt_seed fixes the sampling noise (default: the engine's seed
        chain). With a cached voice state for the context only the new
        text is prefilled, onto a copy of the context's KV."""
        max_len = int(max_audio_length_ms / 80)
        ctx = self._context_state(context)
        if ctx is not None:
            state, pos = ctx
            win, wmask = self._tokenize_text_segment(text, speaker)
            gen = self._run_ar_from(state, pos, win, wmask, max_len,
                                    temperature, topk, utt_seed)
        else:
            [gen] = self._run_ar([self._build_prompt(context, text, speaker)],
                                 max_len, temperature, topk, utt_seed)
        t1 = time.perf_counter()
        [audio] = self._decode_tokens([gen])
        self.last_tokens = gen
        self.last_stats["vocode_s"] = time.perf_counter() - t1
        return audio

    @_on_mesh
    def generate_single(self, context: List[Segment], temperature: float = 0.9,
                        topk: int = 20, utt_seed: Optional[int] = None,
                        max_frames: int = 400) -> np.ndarray:
        """The monologue clone's inner call: the context alone, its last 3
        frames dropped, at most max_frames (400) frames -> raw (T, ncb)
        frames."""
        prompt, mask = self._build_prompt(context, None, None)
        [gen] = self._run_ar([(prompt[:-3], mask[:-3])], max_frames,
                             temperature, topk, utt_seed)
        return gen

    @_on_mesh
    def generate_batch(self, texts: List[str], speakers: List[str],
                       contexts: Optional[List[List[Segment]]] = None,
                       max_audio_length_ms: float = 30_000,
                       temperature: float = 0.9, topk: int = 20,
                       utt_seed: Optional[int] = None) -> list[np.ndarray]:
        """Several utterances decoded together (shared bucket, per-stream
        EOS) -> list of (n_i,) float32 waveforms at 24 kHz."""
        if len(texts) != len(speakers):
            raise ValueError(f"{len(texts)} texts but {len(speakers)} speakers")
        contexts = contexts or [None] * len(texts)
        prompts = [self._build_prompt(c, t, s)
                   for c, t, s in zip(contexts, texts, speakers)]
        frames = self._run_ar(prompts, int(max_audio_length_ms / 80),
                              temperature, topk, utt_seed)
        return self._decode_tokens(frames)

    @_on_mesh
    def generate_stream(self, text: str, speaker: str,
                        context: Optional[List[Segment]] = None,
                        max_audio_length_ms: float = 90_000,
                        temperature: float = 0.9, topk: int = 20,
                        utt_seed: Optional[int] = None) -> Iterator[np.ndarray]:
        """Streaming synthesis: yields float32 chunks at 24 kHz (see
        _stream_utterance). The utterance is capped by the vocoder's KV
        slab (8 latents per frame). With a cached voice state for the
        context, the first call appends only the new text onto a copy of
        the context's KV."""
        max_len = min(int(max_audio_length_ms / 80),
                      self.config.codec.acoustic_decoder.max_stream_latents // 8)
        t_start = time.perf_counter()
        self._first_packet_s = None
        ctx = self._context_state(context)
        if ctx is not None:
            state, pos = ctx
            win, wmask = self._tokenize_text_segment(text, speaker)
            L = win.shape[0]
            _, tokens, tmask, valid = self._right_pad(win, wmask)
            real_len = L
            max_len = min(max_len, self.max_seq_len - pos - L - 1)
        else:
            bucket, tokens, tmask, valid = self._bucketize(
                [self._build_prompt(context, text, speaker)])
            real_len = None
            max_len = min(max_len, self.max_seq_len - bucket)
            state = self._new_lm_state(1)
        seed = self._next_seed() if utt_seed is None else utt_seed
        yield from self._stream_utterance(state, tokens, tmask, valid,
                                          real_len, max_len, seed,
                                          temperature, topk, t_start)

    def _prompt_segments(self, prompt_wav_list: Optional[List[str]],
                         prompt_text_list: Optional[List[str]]
                         ) -> list[Segment]:
        if prompt_wav_list is None:
            return []
        if prompt_text_list is None or \
                len(prompt_wav_list) != len(prompt_text_list):
            raise ValueError("each prompt wav needs its prompt text")
        segs = []
        for wav, ptext in zip(prompt_wav_list, prompt_text_list):
            speaker = _speaker_of(ptext)
            segs.append(self.prepare_prompt(ptext, speaker, wav))
        return segs

    def _dialogue_window(self, i: int, utterance: str, speaker: str,
                         prompt_segments: list[Segment], audio_piece,
                         pos: int):
        """Turn i's append window: the prompts (turn 0) or the previous
        turn's re-encoded audio, then this turn's text; right-padded.
        Raises when the conversation outgrows the LM's context."""
        pieces = ([self._tokenize_segment(s) for s in prompt_segments]
                  if i == 0 else [audio_piece])
        pieces.append(self._tokenize_text_segment(utterance, speaker))
        win = np.concatenate([p[0] for p in pieces])
        wmask = np.concatenate([p[1] for p in pieces])
        L = win.shape[0]
        bucket, tokens, mask, valid = self._right_pad(win, wmask)
        if pos + bucket > self.max_seq_len:
            raise ValueError(f"dialogue context overflow at utterance {i}: "
                             f"{pos} + {bucket} > {self.max_seq_len}")
        return L, tokens, mask, valid

    def _close_turn(self, state: LMState, pos: int, frames: np.ndarray,
                    stats: dict) -> LMState:
        """Record a finished turn (its frames, its stats and the live
        window its last decode step read) and rewind the state to pos."""
        live_end = int(state.pos[0])
        live_start = int(torch.argmax(state.slot_valid[0].to(torch.int8)))
        self.last_turn_tokens.append(frames)
        self.last_turn_stats.append(dict(stats, live_start=live_start,
                                         live_end=live_end))
        with torch.inference_mode():
            state = rewind_lm_state(state, self._dev(np.array([pos], np.int32)))
        self.last_lm_state = state
        return state

    @_on_mesh
    def generate_dialogue(self, text_list: List[str],
                          prompt_wav_list: Optional[List[str]] = None,
                          prompt_text_list: Optional[List[str]] = None,
                          temperature: float = 0.9, topk: int = 20,
                          max_utterance_ms: float = 30_000,
                          incremental: bool = True,
                          utt_seed: Optional[int] = None) -> np.ndarray:
        """Multi-speaker dialogue -> (n,) float32 at 24 kHz. Each text
        starts with its speaker tag; optional prompt wavs (with their
        texts, tag first) clone the voices.

        incremental=True keeps the LM state across turns and appends only
        each turn's new tokens (the previous turn's audio re-encoded at 16
        kHz, then the text); the decode-era KV is rewound, so the slab's
        content and positions match the re-prefill path's token for token
        (greedy decode is equal; sampled decode draws from the same
        distribution). incremental=False re-prefills the growing
        conversation every turn, as the reference does."""
        prompt_segments = self._prompt_segments(prompt_wav_list,
                                                prompt_text_list)
        text_list = process_text_list(text_list)
        seeds = self._turn_seeds(len(text_list), utt_seed)
        self.last_turn_tokens, self.last_turn_stats = [], []
        if incremental:
            return self._generate_dialogue_incremental(
                text_list, prompt_segments, temperature, topk,
                max_utterance_ms, seeds)
        generated: list[Segment] = []
        storage: list[np.ndarray] = []
        for text, seed in zip(text_list, seeds):
            speaker, utterance = _split_tag(text)
            audio24 = self.generate(utterance, speaker,
                                    prompt_segments + generated,
                                    max_utterance_ms, temperature, topk, seed)
            self.last_turn_tokens.append(self.last_tokens)
            self.last_turn_stats.append(dict(self.last_stats))
            generated.append(Segment(speaker=speaker, text=utterance,
                                     audio=resample(audio24,
                                                    self.output_sample_rate,
                                                    self.sample_rate)))
            storage.append(audio24)
        return np.concatenate(storage) if storage else np.zeros(0, np.float32)

    def _generate_dialogue_incremental(self, text_list: list[str],
                                       prompt_segments: list[Segment],
                                       temperature: float, topk: int,
                                       max_utterance_ms: float,
                                       seeds: list[int]) -> np.ndarray:
        """KV-persistent dialogue: per turn one append window (right-padded,
        real_len) and a decode loop, then a rewind over the decode-era KV;
        the turn's audio comes back as codec tokens in the next window
        (the reference's own feedback loop)."""
        state = self._new_lm_state(1)
        utt_cap = int(max_utterance_ms / 80)
        pos = 0
        storage: list[np.ndarray] = []
        audio_piece = None
        for i, (text, seed) in enumerate(zip(text_list, seeds)):
            speaker, utterance = _split_tag(text)
            L, tokens, mask, valid = self._dialogue_window(
                i, utterance, speaker, prompt_segments, audio_piece, pos)
            state, [gen] = self._loop(
                state, tokens, mask, valid, utt_cap,
                min(utt_cap, self.max_seq_len - (pos + L) - 1),
                temperature, topk, seed, real_len=L)
            pos += L
            state = self._close_turn(state, pos, gen, self.last_stats)
            [audio24] = self._decode_tokens([gen])
            storage.append(audio24)
            audio_piece = self._tokenize_audio(
                resample(audio24, self.output_sample_rate, self.sample_rate))
        return np.concatenate(storage) if storage else np.zeros(0, np.float32)

    @_on_mesh
    def generate_dialogue_stream(self, text_list: List[str],
                                 prompt_wav_list: Optional[List[str]] = None,
                                 prompt_text_list: Optional[List[str]] = None,
                                 temperature: float = 0.9, topk: int = 20,
                                 max_utterance_ms: float = 30_000,
                                 utt_seed: Optional[int] = None,
                                 ) -> Iterator[tuple[int, np.ndarray]]:
        """Streaming incremental dialogue: yields (turn index, float32
        chunk at 24 kHz) as each turn decodes, the LM state persisting
        across turns. Per turn: one fused append-prefill + first block,
        then the block ladder; at the turn's end the state rewinds over
        the decode-era KV and the turn's audio re-enters as codec tokens.

        The audio that re-enters is what the listener heard, the streamed
        chunks, as in the JAX engine. On the same seeds turn 0 equals
        generate_dialogue's; later turns equal it where the streamed audio
        encodes as the offline decode does (at f32; in bf16 the vocoder's
        passes of other shapes round differently, and their tokens may
        differ). Feeding back the offline decode instead would add a vocoder
        pass to the wait between turns (``chip_smoke.py`` phase 10 times
        both)."""
        prompt_segments = self._prompt_segments(prompt_wav_list,
                                                prompt_text_list)
        text_list = process_text_list(text_list)
        seeds = self._turn_seeds(len(text_list), utt_seed)
        self.last_turn_tokens, self.last_turn_stats = [], []
        state = self._new_lm_state(1)
        # every turn streams through a fresh vocoder state, whose KV slab
        # holds max_stream_latents / 8 frames
        utt_cap = min(int(max_utterance_ms / 80),
                      self.config.codec.acoustic_decoder.max_stream_latents
                      // 8)
        pos = 0
        self._first_packet_s = None
        t_start = time.perf_counter()
        audio_piece = None
        for i, (text, seed) in enumerate(zip(text_list, seeds)):
            speaker, utterance = _split_tag(text)
            L, tokens, mask, valid = self._dialogue_window(
                i, utterance, speaker, prompt_segments, audio_piece, pos)
            stream = self._stream_utterance(
                state, tokens, mask, valid, L,
                min(utt_cap, self.max_seq_len - (pos + L) - 1), seed,
                temperature, topk, t_start)
            chunks = []
            while True:
                try:
                    chunk = next(stream)
                except StopIteration as stop:     # the state after the turn
                    state = stop.value
                    break
                chunks.append(chunk)
                yield i, chunk
            pos += L
            frames = self.last_tokens
            state = self._close_turn(state, pos, frames,
                                     {"frames": len(frames)})
            if i + 1 < len(text_list):
                audio24 = (np.concatenate(chunks) if chunks
                           else np.zeros(0, np.float32))
                audio_piece = self._tokenize_audio(
                    resample(audio24, self.output_sample_rate,
                             self.sample_rate))

    @_on_mesh
    def generate_monologue(self, text: str, prompt_wav: Optional[str] = None,
                           prompt_text: Optional[str] = None,
                           temperature: float = 0.75, topk: int = 20,
                           prompt_tokens: Optional[tuple] = None,
                           utt_seed: Optional[int] = None,
                           max_frames: int = 400) -> np.ndarray:
        """Long-form monologue, optionally voice-cloned -> (n,) float32 at
        24 kHz. With a prompt, the text is split into chunks of at most
        400 bytes; each chunk runs as the prompt text merged with it over
        the prompt audio (generate_single, at most max_frames frames),
        retried until it gives more than 18 frames, its first 2 frames
        trimmed. prompt_tokens:
        pre-encoded (frames, mask) of the prompt (encode_prompt_tokens),
        which skips the wav load and the encode; prompt_wav may then be
        None. utt_seed: the first call's seed, each later call the next."""
        seeds = None if utt_seed is None else itertools.count(utt_seed)
        if prompt_wav is None and prompt_tokens is None:
            return self.generate(clean_text(text.strip()), "[S1]", None,
                                 30_000, temperature, topk,
                                 None if seeds is None else next(seeds))
        if prompt_text is None:
            raise ValueError("a voice prompt needs its prompt_text")
        prompt_text = clean_text(prompt_text)
        prompt_audio = (np.zeros(0, np.float32) if prompt_wav is None
                        else load_prompt_audio_16k(prompt_wav))
        frames, fmask = prompt_tokens if prompt_tokens is not None \
            else (None, None)
        pieces: list[np.ndarray] = []
        for chunk in split_text(clean_text(text), 400):
            seg = Segment(speaker="[S1]",
                          text=prompt_text[:-1] + "," + clean_text(chunk),
                          audio=prompt_audio, audio_tokens=frames,
                          audio_tokens_mask=fmask)
            for _ in range(8):
                gen = self.generate_single([seg], temperature, topk,
                                           None if seeds is None else next(seeds),
                                           max_frames)
                if gen.shape[0] > 18:
                    break
            pieces.append(self._decode_tokens([gen[2:]])[0])
        return np.concatenate(pieces) if pieces else np.zeros(0, np.float32)


def _config_from_dir(pretrained_dir: str, gen_type: str,
                     llm_overrides: Optional[dict],
                     codec_overrides: Optional[dict]) -> EngineConfig:
    """A serving dir's EngineConfig: its JSONs plus the overrides,
    max_seq_len from the LM's, prefill buckets that leave at least 28
    decode slots (3100 - 3072, the reference's own headroom)."""
    llm_cfg = llm_config_from_json(
        os.path.join(pretrained_dir, "config_llm.json"), **(llm_overrides or {}))
    codec_cfg = codec_config_from_json(
        os.path.join(pretrained_dir, "config_codec.json"),
        **(codec_overrides or {}))
    buckets = tuple(b for b in EngineConfig.prefill_buckets
                    if b <= llm_cfg.max_seq_len - 28) \
        or (max(32, llm_cfg.max_seq_len // 2),)
    return EngineConfig(llm=llm_cfg, codec=codec_cfg, gen_type=gen_type,
                        max_seq_len=llm_cfg.max_seq_len, prefill_buckets=buckets)


def _speaker_of(text: str) -> str:
    speaker = text[:4]
    if speaker not in SPEAKER_TAGS:
        raise ValueError(f"text must start with a speaker tag "
                         f"{SPEAKER_TAGS}: {text[:12]!r}")
    return speaker


def _split_tag(text: str) -> tuple[str, str]:
    return _speaker_of(text), text[4:]
