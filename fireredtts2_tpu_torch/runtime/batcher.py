"""Continuous batching: many concurrent TTS streams on one card.

Counterpart of ``fireredtts2_tpu/runtime/batcher.py``:
- a fixed pool of B stream slots shares one batched LM step and one
  batched vocoder pass per frame (``models/pipeline.py: stream_block``,
  K frames a block), through kernels A, B and C at B = the pool's size;
- new requests are admitted into free slots at block boundaries, a whole
  burst in one prefill padded to 1 or B rows
  (``models/lm/model.py: prefill_into_slots``), while the other slots
  keep decoding; a repeat context is admitted from its cached KV prefix
  (``prefill_into_slot_prefix``);
- a slot's EOS (the all-zero frame) or frame cap frees it; per-slot
  ``is_first`` runs each stream's vocoder warm-up inside the shared pass;
- every request keeps its own temperature and top-k as per-row tensors.

The port's own points:
- Sampling noise per slot, by the engine's rule: slot b's frame t is drawn
  from its request's seed (``engine._next_seed()``, kept on the handle as
  ``seed``) at that stream's own frame index t (0 is the prefill's frame),
  exactly as ``engine.generate_stream`` draws it; so a sampled stream
  replays through ``generate_stream(..., utt_seed=handle.seed)``. Idle
  slots get noise of ones.
- Double buffering: block k+1 is queued on the card before block k's
  packed output is read; that output goes to pinned host memory with a
  non-blocking copy behind a CUDA event and is fanned out after the next
  block is queued.
- One worker thread runs the loop. It enters ``torch.inference_mode()``
  itself (the mode is thread-local), uses the engine's device, and
  launches every kernel on its current stream. A failure there reaches
  every live and pending handle as its ``error``; nothing falls back.

Clients consume per-stream chunk queues (float32 at 24 kHz).

On a meshed engine (``engine.mesh``, ``parallel.mesh``) every rank builds
the pool and runs its worker loop in lockstep, as JAX's one program steps
every slot: the B slots' host bookkeeping lives on every rank, the device
state holds the rank's dp share of the slots (all of them when dp does not
divide B). Rank 0 alone takes requests: at the top of each iteration it
broadcasts the iteration's control (stop, the admissions with their slot
ids, tokens, seeds and sampling, and the block length K its policy chose)
to the other ranks, which run the same admission and block on their rows.
Each block's packed output is gathered whole over dp, so every rank fans
it out alike; rank 0's handles hold the audio (the others' are sinks).
On a mesh a pool admits plain requests only: no cached KV prefix, no
dialogue, and with tp > 1 no voice prompt or clone (encoding and vocoding
would need the other ranks outside the lockstep), and it does not
hot-reload. The worker loop runs with the engine's mesh current; while a
tp > 1 pool runs, the engine refuses device calls from other threads.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import queue
import threading
import time
import traceback
import uuid
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from fireredtts2_tpu_torch.models.codec.decoder import reset_vocoder_slots
from fireredtts2_tpu_torch.models.lm.model import (
    prefill_into_slot_prefix, prefill_into_slots, reset_lm_slots,
    slot_kv_prefix,
)
from fireredtts2_tpu_torch.models.pipeline import stream_block
from fireredtts2_tpu_torch.parallel.mesh import broadcast_object, use_mesh
from fireredtts2_tpu_torch.runtime.policy import (
    AdaptiveBlockPolicy, BlockPolicyConfig,
)
from fireredtts2_tpu_torch.weights import host_to_device


@dataclass
class StreamHandle:
    """Client-side view of one stream: a queue of float32 audio chunks at
    24 kHz; None ends the stream (iteration raises `error` if one is set).

    tokens: the stream's frames (T, ncb) int32, set at its end. In token
    mode (``collect_tokens``) no audio is emitted at all: the batched clone
    trims tokens before it vocodes them.
    kv_prefix: dialogue mode: the slot's context + window K/V rows (pk, pv,
    plen, P) at its end, the next turn's prefix; set before the final None.
    finished_s / samples: seconds from submit to the last chunk produced,
    and the samples produced (independent of how fast the client reads).
    seed: the request's noise seed.
    weights_gen: the weights generation (one more after each
    ``ContinuousBatcher.reload``) that served the stream and made its
    kv_prefix."""
    request_id: str
    chunks: "queue.Queue[Optional[np.ndarray]]" = field(
        default_factory=lambda: queue.Queue(maxsize=256))
    tokens: Optional[np.ndarray] = None
    first_packet_s: Optional[float] = None
    kv_prefix: Optional[tuple] = None
    finished_s: Optional[float] = None
    samples: int = 0
    error: Optional[Exception] = None
    seed: int = 0
    weights_gen: int = 0
    t0: float = field(default_factory=time.perf_counter)

    def __iter__(self):
        while True:
            c = self.chunks.get()
            if c is None:
                if self.error is not None:
                    raise self.error
                return
            yield c


@dataclass
class _Slot:
    active: bool = False
    handle: Optional[StreamHandle] = None
    frames_done: int = 0
    max_frames: int = 0
    last_tail: Optional[np.ndarray] = None
    collect_tokens: bool = False
    token_rows: list = field(default_factory=list)
    keep_kv: bool = False
    base_len: int = 0        # plen + window real_len (prefix rows to keep)
    noise_t: int = 0         # the stream's frame index of its next sample


@dataclass
class _Pending:
    handle: StreamHandle
    tokens: np.ndarray       # (1, S, C+1), left-padded (right-padded with prefix)
    mask: np.ndarray
    valid: np.ndarray
    temperature: float
    topk: int
    max_frames: int
    collect_tokens: bool = False
    prefix: Optional[tuple] = None   # (pk, pv, plen, P): admit from a prefix
    real_len: int = 0
    keep_kv: bool = False
    # the weights generation the request's tokens and prefix were made
    # under, and how to make it anew under the current weights (None: it
    # does not depend on them); admission rebuilds a request of an older
    # generation
    gen: int = 0
    rebuild: Optional[Callable[[], "_Pending"]] = None


class _Sink:
    """A follower rank's chunk queue: it keeps nothing."""

    def put(self, item, *a, **k) -> None:
        pass

    put_nowait = put


# the fields of a _Pending that a follower rank needs to admit it
_WIRE = ("tokens", "mask", "valid", "temperature", "topk", "max_frames",
         "collect_tokens", "real_len")


def voc_latent_capacity(ac_cfg, max_frames_cap: int) -> int:
    """Latent rows a pool's vocoder slab holds for a frame cap: 8 latents a
    frame, rounded up to 16, at most the stock slab."""
    return min(-(-8 * max_frames_cap // 16) * 16, ac_cfg.max_stream_latents)


class ContinuousBatcher:
    """Batched multi-stream decoding over an engine's weights."""

    def __init__(self, engine, max_streams: int = 16, topk: int = 20,
                 policy=None, warmup_blocks: Optional[bool] = None,
                 seq_capacity: Optional[int] = None,
                 max_frames_cap: Optional[int] = None):
        """seq_capacity / max_frames_cap define the pool's capacity class:
        LM positions per slot (prompt bucket + frames; default the
        engine's max_seq_len) and frames per utterance (default the stock
        vocoder slab's, 8 latents a frame). Slab memory scales with both;
        submit() rejects requests that do not fit the class.

        warmup_blocks: run the warm-up ladder (one block per ladder K, both
        burst shapes, the prefix admission) before admitting anything;
        default on for a CUDA engine."""
        self.engine = engine
        self.B = max_streams
        self.default_topk = topk
        self.cfg = cfg = engine.config
        self.device = engine.device
        # the worker thread's CUDA device ("cuda" names the current one)
        self._device_index = (None if self.device.type != "cuda"
                              else self.device.index if self.device.index
                              is not None else torch.cuda.current_device())
        llm_cfg, codec_cfg = cfg.llm, cfg.codec
        acfg = codec_cfg.acoustic_decoder
        self.seq_capacity = min(seq_capacity or llm_cfg.max_seq_len,
                                llm_cfg.max_seq_len)
        stock_frames = acfg.max_stream_latents // 8
        self.max_frames_cap = min(max_frames_cap or stock_frames,
                                  stock_frames, self.seq_capacity - 1)
        self._ncb = llm_cfg.audio_num_codebooks
        self._V = llm_cfg.audio_vocab_size
        # a meshed engine: this rank's device rows [r0, r1) of the B slots
        self.mesh = getattr(engine, "mesh", None)
        self._tp_split = self.mesh is not None and self.mesh.tp > 1
        self._r0, self._r1 = (engine._rows(self.B) if self.mesh is not None
                              else (0, self.B))
        self._Bl = self._r1 - self._r0
        with torch.inference_mode():
            self.lm_state = engine._new_lm_state(self._Bl,
                                                 capacity=self.seq_capacity)
            self.vo_state = engine._new_vstate(
                self._Bl, latents=voc_latent_capacity(acfg, self.max_frames_cap))
            self.frames = torch.zeros((self._Bl, self._ncb), dtype=torch.int32,
                                      device=self.device)
            self.emitted = torch.zeros((self._Bl,), dtype=torch.int32,
                                       device=self.device)
            self._ones = torch.ones((self._ncb, self._V), dtype=torch.float32,
                                    device=self.device)
        self.temps = np.full((self.B,), cfg.default_temperature, np.float32)
        self.topks = np.full((self.B,), topk, np.int32)
        self._upload_sampling()

        self.slots = [_Slot() for _ in range(self.B)]
        self.pending: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._wake = threading.Event()   # set by submits, stop and reload
        self._held = 0                   # open burst() blocks
        self._dead: Optional[Exception] = None
        self._lock = threading.Lock()
        # reload(): while set, pending requests stay queued and live
        # slots drain; an admission runs whole under _admit_lock, so once
        # reload has taken it after pausing, no slot turns active
        self._admit_paused = threading.Event()
        self._admit_lock = threading.Lock()
        self._reload_lock = threading.Lock()
        self._gen = 0           # weights generation, bumped by each reload
        self._prefix_cache: "OrderedDict[str, tuple]" = OrderedDict()
        self._prefix_lock = threading.Lock()
        self._cs = 8 * acfg.hop_length
        self._ts = (acfg.n_fft - acfg.hop_length) // 2
        self._lead = (acfg.n_fft - acfg.hop_length) - self._ts
        self.block_frames = 4
        self.policy = policy or AdaptiveBlockPolicy(BlockPolicyConfig(
            ladder=(1, 4, 16), start_block=self.block_frames))
        self.chunk_drops = 0
        # host seconds by phase: dispatch (queueing a block's launches),
        # fetch (waiting for its packed output), fanout (slicing + puts)
        self._host = {"blocks": 0, "frames": 0, "dispatch_s": 0.0,
                      "fetch_s": 0.0, "fanout_s": 0.0}
        self._tl_t0 = time.perf_counter()
        self.timeline: "deque[dict]" = deque(maxlen=256)
        self._warmup_blocks_on = (self.device.type == "cuda"
                                  if warmup_blocks is None else warmup_blocks)
        self.warmup_s: Optional[float] = None
        self.last_reload: Optional[dict] = None
        self.cuda_stream: Optional[torch.cuda.Stream] = None
        self._ready = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)

    # ------------------------------------------------------------- API

    def start(self) -> None:
        if self._tp_split:
            # the engine's device calls from any other thread would run
            # collectives the other ranks never join: it refuses them
            self.engine._lockstep = self._worker
        self._worker.start()

    def follow(self) -> None:
        """A follower rank of a meshed pool: run the worker loop until rank
        0's pool stops."""
        self.start()
        self._worker.join()
        if self._dead is not None:
            raise self._dead

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the worker's warm-up is done (True) or timeout
        (False). Requests submitted before then queue."""
        return self._ready.wait(timeout)

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        self._worker.join(timeout=30)

    @contextlib.contextmanager
    def burst(self):
        """Requests submitted inside this block are admitted together when
        it ends: one burst prefill, one first block (a batch that arrives
        at once; otherwise the worker may admit the first submits before
        the last ones are queued)."""
        with self._lock:
            self._held += 1
        try:
            yield self
        finally:
            with self._lock:
                self._held -= 1
            self._wake.set()

    def _enqueue(self, req: "_Pending") -> StreamHandle:
        self.pending.put(req)
        self._wake.set()
        return req.handle

    def _upload_sampling(self) -> None:
        r0, r1 = self._r0, self._r1
        self._temps_dev = host_to_device(self.temps[r0:r1, None].copy(),
                                         self.device)
        self._topks_dev = host_to_device(self.topks[r0:r1].copy(), self.device)

    def _local(self, ids) -> np.ndarray:
        """Global slot ids -> this rank's device rows; ids outside its rows
        (and the padding id B) -> its padding row Bl, which resets and
        prefills drop."""
        ids = np.asarray(ids, np.int64)
        inside = (ids >= self._r0) & (ids < self._r1)
        return np.where(inside, ids - self._r0, self._Bl)

    def _block(self, K: int, noise: torch.Tensor):
        e = self.engine
        return stream_block(
            e.lm_params, e.codec_params, self.cfg.llm, self.cfg.codec,
            self.lm_state, self.vo_state, self.frames, self.emitted, noise, K,
            temperature=self._temps_dev, topk=self._topks_dev,
            depth_topk=self.cfg.depth_topk,
            depth_temperature=self.cfg.depth_temperature)

    def _warmup_ladder(self) -> None:
        """One block per ladder K the policy can choose, both burst shapes
        of the smallest bucket, a prefix admission and its extraction, and
        the resets: every kernel library is built and loaded and every
        launch plan made before the first admission. All slots are idle,
        so what this writes is reset when a slot is admitted."""
        t0 = time.perf_counter()
        pcfg = getattr(self.policy, "cfg", None)
        cadence = getattr(pcfg, "max_cadence_ms", float("inf"))
        for k in getattr(pcfg, "ladder", (self.block_frames,)):
            if k * 80.0 > cadence:
                continue
            noise = self._ones.expand(k, self._Bl, self._ncb, self._V)
            (self.lm_state, self.vo_state, self.frames, self.emitted,
             packed) = self._block(k, noise)
            packed.cpu()
        S0 = min(self.cfg.prefill_buckets)
        C = self.cfg.llm.num_columns
        e = self.engine
        for Np in (1, self._Bl):
            self.lm_state, _ = prefill_into_slots(
                e.lm_params, self.cfg.llm, self.lm_state, [self._Bl] * Np,
                *self._dev(np.zeros((Np, S0, C), np.int32),
                           np.zeros((Np, S0, C), bool),
                           np.zeros((Np, S0), bool)),
                self._ones.expand(Np, self._ncb, self._V),
                *self._sampling_rows([self.cfg.default_temperature] * Np,
                                     [self.default_topk] * Np),
                self.cfg.depth_topk, self.cfg.depth_temperature)
        shp = self.lm_state.cache_k.shape
        z = torch.zeros((shp[0], 1, 128, shp[3]), dtype=self.lm_state.cache_k.dtype,
                        device=self.device)
        wtok = np.zeros((1, S0, C), np.int32)
        wmask = np.zeros((1, S0, C), bool)
        wval = np.zeros((1, S0), bool)
        wmask[0, 0, -1] = wval[0, 0] = True
        self.lm_state, _ = prefill_into_slot_prefix(
            e.lm_params, self.cfg.llm, self.lm_state, 0, z, z,
            *self._dev(np.array([0], np.int32), wtok, wmask, wval,
                       np.array([1], np.int32)),
            self._ones[None],
            *self._sampling_rows([self.cfg.default_temperature],
                                 [self.default_topk]),
            self.cfg.depth_topk, self.cfg.depth_temperature)
        slot_kv_prefix(self.lm_state, 0, 128)
        rs = np.full((self._Bl,), self._Bl, np.int64)
        self.lm_state = reset_lm_slots(self.lm_state, rs)
        self.vo_state = reset_vocoder_slots(self.vo_state, rs)
        self.frames.cpu()
        self.warmup_s = time.perf_counter() - t0

    def reload(self, pretrained_dir: str, timeout_s: float = 300.0) -> None:
        """Hot-swap checkpoint weights with no dropped request: (1) load and
        transform the new trees while serving goes on; (2) pause
        admissions so live slots drain (pending requests stay queued; a
        live stream keeps the weights that made its KV); (3) swap the
        engine's trees, clear the prefix cache (its slabs hold the old
        weights' K/V) and bump the weights generation; (4) resume
        admissions. A request made under the old weights (a cached
        context's KV prefix, prompt audio tokenized by the old codec, a
        dialogue's carried prefix) is made anew when it is admitted: plain
        from its context, or from the dialogue's whole history.

        Raises TimeoutError, and goes on serving the old weights, when the
        live streams do not finish within timeout_s. ``last_reload`` holds
        the seconds of the last swap's prepare, drain and apply. Not on a
        meshed engine."""
        if self.mesh is not None:
            raise NotImplementedError("hot reload on a mesh is not ported")
        with self._reload_lock:
            t0 = time.perf_counter()
            prepared = self.engine.prepare_checkpoint(pretrained_dir)
            t1 = time.perf_counter()
            self._admit_paused.set()
            try:
                with self._admit_lock:   # an admission under way ends first
                    pass
                deadline = time.monotonic() + timeout_s
                while self.active_streams:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{self.active_streams} live stream(s) did not "
                            f"finish within {timeout_s}s; still serving the "
                            f"old weights")
                    time.sleep(0.05)
                # no slot is live and none can be admitted: the worker
                # queues no block until admissions resume (a block still in
                # flight holds only finished slots' lanes, which it drops)
                t2 = time.perf_counter()
                self.engine.apply_checkpoint(prepared)
                with self._prefix_lock:
                    self._prefix_cache.clear()
                    self._gen += 1
                self.last_reload = dict(prepare_s=t1 - t0, drain_s=t2 - t1,
                                        apply_s=time.perf_counter() - t2)
            finally:
                self._admit_paused.clear()
                self._wake.set()

    def _check_alive(self) -> None:
        """Fail fast on every submit path when the worker can no longer
        drain the pending queue (a consumer would otherwise wait forever)."""
        if self._dead is not None:
            raise RuntimeError("batcher worker died") from self._dead
        if self._stop.is_set():
            raise RuntimeError("batcher stopped")

    def _new_handle(self, utt_seed: Optional[int] = None) -> StreamHandle:
        if self.mesh is not None and not self.mesh.is_leader:
            raise RuntimeError("a follower rank of a meshed pool takes no "
                               "requests; submit to rank 0")
        return StreamHandle(request_id=uuid.uuid4().hex,
                            seed=(self.engine._next_seed() if utt_seed is None
                                  else utt_seed))

    def _sampling_of(self, temperature, topk) -> tuple[float, int]:
        return (temperature if temperature is not None
                else self.cfg.default_temperature,
                topk if topk is not None else self.default_topk)

    def submit(self, text: str, speaker: str = "[S1]", context=(),
               temperature: Optional[float] = None,
               topk: Optional[int] = None,
               max_audio_length_ms: float = 30_000,
               utt_seed: Optional[int] = None) -> StreamHandle:
        """Queue a stream; returns a handle that yields audio chunks.
        temperature, topk and max_audio_length_ms hold per request inside
        the shared batched step; utt_seed fixes the request's noise seed
        (default: the engine's seed chain), as in ``engine.generate_stream``.

        A repeat context is admitted from its cached KV prefix (the
        engine's voice-state cache, batched): the slot starts with the
        context rows in place and only the text window prefills. Greedy
        decode equals the plain layout's (RoPE shift invariance)."""
        self._check_alive()
        temp, k = self._sampling_of(temperature, topk)
        return self._enqueue(self._text_request(
            list(context), text, speaker, temp, k, max_audio_length_ms,
            utt_seed=utt_seed))

    def _refuse_on_tp(self, what: str) -> None:
        """On a tp > 1 pool: encoding prompt audio and vocoding a clone run
        the engine outside the lockstep, which the other ranks never
        join."""
        if self._tp_split:
            raise NotImplementedError(
                f"{what} on a tensor-parallel pool are not ported yet "
                f"(ROADMAP.md queue 1, item 13)")

    def _text_request(self, context: list, text: str, speaker: str,
                      temp: float, k: int, max_audio_length_ms: float,
                      utt_seed: Optional[int] = None,
                      handle: Optional[StreamHandle] = None,
                      use_prefix: bool = True) -> "_Pending":
        """submit()'s request under the current weights. With a context its
        rebuild makes it anew, plain (no cached prefix), for the same
        handle."""
        gen = self._gen          # read first: what follows is this or newer
        req = None
        if context:
            self._refuse_on_tp("voice prompts")
        pre = (self._context_prefix(context)
               if context and use_prefix and self.mesh is None else None)
        if pre is not None:
            pk, pv, plen, P = pre
            win, wmask = self.engine._tokenize_text_segment(text, speaker)
            bucket, tokens, tmask, valid = self.engine._right_pad(win, wmask)
            if plen + bucket < min(self.lm_state.cache_k.shape[2],
                                   self.seq_capacity):
                req = _Pending(
                    handle=handle or self._new_handle(utt_seed),
                    tokens=tokens, mask=tmask, valid=valid, temperature=temp,
                    topk=k, max_frames=min(int(max_audio_length_ms / 80),
                                           self.seq_capacity - plen - bucket,
                                           self.max_frames_cap),
                    prefix=(pk, pv, plen, P), real_len=int(win.shape[0]))
        if req is None:
            prompt, mask = self.engine._build_prompt(context, text, speaker)
            req = self._prompt_request(prompt, mask, temp, k,
                                       max_audio_length_ms,
                                       utt_seed=utt_seed, handle=handle)
        req.gen = gen
        if context:
            req.rebuild = lambda: self._text_request(
                context, text, speaker, temp, k, max_audio_length_ms,
                handle=req.handle, use_prefix=False)
        return req

    def _context_prefix(self, context) -> Optional[tuple]:
        """The cached (pk, pv, plen, P) of this context, or None (its first
        sighting, the cache off, or too long for the pool). The engine's
        voice-state cache keys the content, caches on second use and
        builds the prefix; the batcher keeps a crop of it to the smallest
        128-aligned P >= plen, so a slot copies only live rows. The
        lookup, build and insert run under the prefix cache's lock."""
        e = self.engine
        if getattr(e.config, "voice_state_cache", 0) <= 0:
            return None
        try:
            pieces = [e._tokenize_segment(s) for s in context]
        except Exception:  # noqa: BLE001 -- the plain path takes it
            return None
        win = np.concatenate([p[0] for p in pieces])
        wmask = np.concatenate([p[1] for p in pieces])
        key = hashlib.sha256(win.tobytes() + wmask.tobytes()).hexdigest()
        with self._prefix_lock:
            hit = self._prefix_cache.get(key)
            if hit is not None:
                self._prefix_cache.move_to_end(key)
                return hit
            ctx = e._context_state(context)
            if ctx is None:
                return None
            state, plen = ctx
            P = -(-plen // 128) * 128
            if P >= min(self.lm_state.cache_k.shape[2], self.seq_capacity):
                return None          # the context alone fills the class
            hit = (state.cache_k[:, :, :P].clone(),
                   state.cache_v[:, :, :P].clone(), plen, P)
            self._prefix_cache[key] = hit
            while len(self._prefix_cache) > max(4, e.config.voice_state_cache):
                self._prefix_cache.popitem(last=False)
            return hit

    def submit_prompt(self, prompt: np.ndarray, mask: np.ndarray,
                      temperature: Optional[float] = None,
                      topk: Optional[int] = None,
                      max_audio_length_ms: float = 30_000,
                      collect_tokens: bool = False,
                      utt_seed: Optional[int] = None) -> StreamHandle:
        """Queue pre-built (S, C+1) prompt frames. collect_tokens: token
        mode, no audio; the frames land in handle.tokens at the end."""
        self._check_alive()
        temp, k = self._sampling_of(temperature, topk)
        return self._enqueue(self._prompt_request(
            prompt, mask, temp, k, max_audio_length_ms,
            collect_tokens=collect_tokens, utt_seed=utt_seed))

    def _prompt_request(self, prompt: np.ndarray, mask: np.ndarray,
                        temp: float, k: int, max_audio_length_ms: float,
                        collect_tokens: bool = False,
                        utt_seed: Optional[int] = None,
                        handle: Optional[StreamHandle] = None) -> "_Pending":
        bucket, tokens, tmask, valid = self.engine._bucketize([(prompt, mask)])
        if bucket >= self.seq_capacity:
            raise ValueError(
                f"prompt bucket {bucket} does not fit this pool's capacity "
                f"class (seq_capacity={self.seq_capacity}); use a "
                f"full-capacity batcher or shorten the context")
        return _Pending(
            handle=handle or self._new_handle(utt_seed), tokens=tokens,
            mask=tmask, valid=valid, temperature=temp, topk=k,
            max_frames=min(int(max_audio_length_ms / 80),
                           self.seq_capacity - bucket, self.max_frames_cap),
            collect_tokens=collect_tokens, gen=self._gen)

    def generate_monologue_clone(self, text: str, prompt_text: str,
                                 prompt_audio: Optional[np.ndarray] = None,
                                 prompt_tokens: Optional[tuple] = None,
                                 temperature: float = 0.75, topk: int = 20,
                                 max_frames: int = 400) -> np.ndarray:
        """Voice-clone monologue through the shared batched decoder, with
        the engine's glue (``engine.generate_monologue``): per text chunk
        of at most 400 bytes the prompt is the prompt text merged with the
        chunk over the prompt audio, its last 3 frames dropped; a chunk is
        retried (8 tries in all) while it ends within 18 frames; its first
        2 frames are trimmed, then it is vocoded by the engine's offline
        decode (token mode: no audio before the trim is emitted). All
        chunks are submitted at once and decode together. Blocking;
        returns (n,) float32 at 24 kHz."""
        from fireredtts2_tpu_torch.engine.engine import Segment
        from fireredtts2_tpu_torch.utils.text import clean_text, split_text

        self._refuse_on_tp("voice clones")
        e = self.engine
        prompt_text = clean_text(prompt_text)
        text = clean_text(text)
        if prompt_audio is None and prompt_tokens is None:
            raise ValueError("clone needs prompt_audio or prompt_tokens")
        audio = (np.zeros(0, np.float32) if prompt_audio is None
                 else prompt_audio)
        pt_frames, pt_mask = (prompt_tokens if prompt_tokens is not None
                              else (None, None))

        def build(chunk: str):
            seg = Segment(speaker="[S1]",
                          text=prompt_text[:-1] + "," + clean_text(chunk),
                          audio=audio, audio_tokens=pt_frames,
                          audio_tokens_mask=pt_mask)
            prompt, mask = e._build_prompt([seg], None, None)
            return prompt[:-3], mask[:-3]

        def submit(chunk: str) -> StreamHandle:
            # the prompt's audio tokens depend on the codec's weights: made
            # anew if a reload lands before its admission
            self._check_alive()
            gen = self._gen
            req = self._prompt_request(*build(chunk), temperature, topk,
                                       max_frames * 80, collect_tokens=True)
            req.gen = gen
            req.rebuild = lambda: self._prompt_request(
                *build(chunk), temperature, topk, max_frames * 80,
                collect_tokens=True, handle=req.handle)
            return self._enqueue(req)

        chunks = split_text(text, 400) or [text]
        handles = [submit(c) for c in chunks]
        pieces: list[np.ndarray] = []
        for c, h in zip(chunks, handles):
            for attempt in range(8):
                for _ in h:          # token mode emits no audio
                    pass
                if h.tokens.shape[0] > 18 or attempt == 7:
                    break
                h = submit(c)
            pieces.append(e._decode_tokens([h.tokens[2:]])[0])
        return np.concatenate(pieces) if pieces else np.zeros(0, np.float32)

    def _dialogue_request(self, win: np.ndarray, wmask: np.ndarray,
                          prefix: Optional[tuple], temp: float, k: int,
                          max_utterance_ms: float,
                          handle: Optional[StreamHandle] = None
                          ) -> "_Pending":
        """One utterance's window (its new tokens only) onto the
        dialogue's carried KV prefix; at its end the slot hands out the
        grown prefix (keep_kv). Utterance 0 rides a zero prefix (plen 0),
        so every turn has the same contiguous-position layout."""
        if self.mesh is not None:
            raise NotImplementedError("dialogue on a meshed pool is not ported")
        bucket, tokens, tmask, valid = self.engine._right_pad(win, wmask)
        if prefix is None:
            L, _, _, W = self.lm_state.cache_k.shape
            z = torch.zeros((L, 1, 128, W), dtype=self.lm_state.cache_k.dtype,
                            device=self.device)
            prefix = (z, z, 0, 128)
        pk, pv, plen, P = prefix
        cap = min(self.lm_state.cache_k.shape[2], self.seq_capacity)
        if plen + bucket >= cap:
            raise ValueError(
                f"dialogue context overflow: {plen} + {bucket} >= {cap} "
                f"(the pool's capacity class)")
        return _Pending(
            handle=handle or self._new_handle(), tokens=tokens, mask=tmask,
            valid=valid, temperature=temp, topk=k,
            max_frames=min(int(max_utterance_ms / 80),
                           self.seq_capacity - plen - bucket,
                           self.max_frames_cap),
            prefix=(pk, pv, plen, P), real_len=int(win.shape[0]),
            keep_kv=True, gen=self._gen)

    def _submit_dialogue_window(self, win: np.ndarray, wmask: np.ndarray,
                                prefix: Optional[tuple], temp: float, k: int,
                                max_utterance_ms: float, gen: int,
                                history: Callable[[], tuple]) -> StreamHandle:
        """Queue one utterance's window (_dialogue_request). gen: the
        oldest weights generation its tokens and prefix came from; if that
        is older than the weights at admission, the turn is admitted from
        `history()`, the dialogue's whole window so far, on a zero
        prefix."""
        self._check_alive()
        req = self._dialogue_request(win, wmask, prefix, temp, k,
                                     max_utterance_ms)
        req.gen = gen
        req.rebuild = lambda: self._dialogue_request(
            *history(), None, temp, k, max_utterance_ms, handle=req.handle)
        return self._enqueue(req)

    def run_dialogue(self, text_list: list, prompt_wav_list=None,
                     prompt_text_list=None, prompt_segments=None,
                     temperature: float = 0.9, topk: Optional[int] = None,
                     max_utterance_ms: float = 30_000):
        """Multi-speaker incremental dialogue through the shared batched
        decoder: yields (utterance index, audio chunk) while each turn
        decodes in the pool's batched block with every other stream.

        Utterance i admits a window of only its new tokens (turn 0: the
        prompt segments; later turns: turn i-1's streamed audio re-encoded,
        then the text) onto the dialogue's carried KV prefix, and at its
        end the slot hands out the grown prefix for the next turn: the
        engine's incremental layout (contiguous absolute positions, audio
        fed back as codec tokens). Between turns the slot is free for other
        requests. A turn admitted after a reload whose carried prefix the
        old weights made prefills the dialogue's whole history (prompts,
        every turn's text and streamed audio) on the new weights instead.

        Turn 0's layout depends on whether the engine's voice-state cache
        is warm for the prompt set: on a context's first sighting the
        prompts prefill inside turn 0's window; once the cache holds it,
        turn 0 is admitted from its cached prefix (``_context_prefix``).
        Greedy decode gives the same tokens either way; sampled decode
        draws from the same distribution, but a repeat of the same
        dialogue with the same seeds need not give the same samples across
        the two layouts. Blocking generator."""
        from fireredtts2_tpu_torch.utils.audio_io import resample
        from fireredtts2_tpu_torch.utils.text import (
            SPEAKER_TAGS, process_text_list,
        )

        self._refuse_on_tp("dialogue")
        e = self.engine
        text_list = process_text_list(list(text_list))
        segs = list(prompt_segments) if prompt_segments else []
        if prompt_wav_list is not None:
            if prompt_text_list is None or \
                    len(prompt_wav_list) != len(prompt_text_list):
                raise ValueError("each prompt wav needs its prompt text")
            for wav, ptext in zip(prompt_wav_list, prompt_text_list):
                if ptext[:4] not in SPEAKER_TAGS:
                    raise ValueError(f"prompt text needs a speaker tag: "
                                     f"{ptext[:12]!r}")
                segs.append(e.prepare_prompt(ptext, ptext[:4], wav))
        temp, k = self._sampling_of(temperature, topk)

        def history(turns: list, audios: list) -> tuple:
            """The whole dialogue so far as one window, made under the
            current weights: prompts, then each turn's text after the
            previous turn's audio."""
            pieces = [e._tokenize_segment(s) for s in segs]
            for j, (utterance, speaker) in enumerate(turns):
                if j > 0:
                    pieces.append(e._tokenize_audio(audios[j - 1]))
                pieces.append(e._tokenize_text_segment(utterance, speaker))
            return (np.concatenate([p[0] for p in pieces]),
                    np.concatenate([p[1] for p in pieces]))

        prefix: Optional[tuple] = None
        prefix_gen = 0
        turns: list[tuple[str, str]] = []
        audios16: list[np.ndarray] = []     # each turn's audio at 16 kHz
        for i, text in enumerate(text_list):
            speaker, utterance = text[:4], text[4:]
            if speaker not in SPEAKER_TAGS:
                raise ValueError(f"text must start with a speaker tag "
                                 f"{SPEAKER_TAGS}: {text[:12]!r}")
            gen = self._gen      # read first: what follows is this or newer
            turns.append((utterance, speaker))
            pieces: list[tuple[np.ndarray, np.ndarray]] = []
            if i == 0:
                prefix_gen = gen
                if segs:
                    prefix = self._context_prefix(segs)
                    if prefix is None:
                        pieces += [e._tokenize_segment(s) for s in segs]
            else:
                pieces.append(e._tokenize_audio(audios16[-1]))
            pieces.append(e._tokenize_text_segment(utterance, speaker))
            handle = self._submit_dialogue_window(
                np.concatenate([p[0] for p in pieces]),
                np.concatenate([p[1] for p in pieces]), prefix, temp, k,
                max_utterance_ms, min(gen, prefix_gen),
                functools.partial(history, list(turns), list(audios16)))
            chunks: list[np.ndarray] = []
            for c in handle:         # raises if the worker failed
                chunks.append(c)
                yield i, c
            prefix, prefix_gen = handle.kv_prefix, handle.weights_gen
            if prefix is None:       # the worker stopped before the end
                return
            if i + 1 < len(text_list):
                audio24 = (np.concatenate(chunks) if chunks
                           else np.zeros(0, np.float32))
                audios16.append(resample(audio24, e.output_sample_rate,
                                         e.sample_rate))

    @property
    def active_streams(self) -> int:
        with self._lock:
            return sum(s.active for s in self.slots)

    # ------------------------------------------------------------- loop

    def _dev(self, *arrays) -> list[torch.Tensor]:
        return [host_to_device(a, self.device) for a in arrays]

    def _sampling_rows(self, temps, topks) -> list[torch.Tensor]:
        """Per-row temperature (N, 1) and top-k (N,) on the device."""
        return self._dev(np.asarray(temps, np.float32)[:, None],
                         np.asarray(topks, np.int32))

    def _noise(self, seed: int, t: int) -> torch.Tensor:
        """Frame t of a stream seeded `seed`: (ncb, V) Exp(1) draws, the
        engine's noise for that stream and frame."""
        return self.engine.noise_fn(seed, 1)(t)[0]

    def _admit(self) -> None:
        with self._admit_lock:
            if not (self._admit_paused.is_set() or self._held):
                self._admit_locked()

    def _take_pending(self, n: int) -> list["_Pending"]:
        """Up to n pending requests, each made under the current weights: a
        request of an older generation is rebuilt; one that no longer fits
        (ValueError) ends its handle with that error."""
        reqs: list[_Pending] = []
        while len(reqs) < n and not self.pending.empty():
            try:
                req = self.pending.get_nowait()
            except queue.Empty:
                break
            if req.rebuild is not None and req.gen != self._gen:
                try:
                    req = req.rebuild()
                except ValueError as e:
                    req.handle.error = e
                    req.handle.chunks.put(None)
                    continue
            req.handle.weights_gen = self._gen
            reqs.append(req)
        return reqs

    def _choose(self) -> list[tuple["_Pending", int]]:
        """The pending requests that fit in free slots, each with its slot."""
        free = [i for i, s in enumerate(self.slots) if not s.active]
        reqs = self._take_pending(len(free))
        return [(r, free.pop()) for r in reqs]

    def _admit_locked(self) -> None:
        self._admit_pairs(self._choose())

    def _admit_pairs(self, pairs: list[tuple["_Pending", int]]) -> None:
        """Admit requests into their slots: one reset per state, one burst
        prefill (padded to 1 or Bl rows; dummy rows go to row Bl and are
        dropped) and one prefill per prefix admission. The device work
        covers this rank's rows; the slots' bookkeeping all of them."""
        if not pairs:
            return
        reqs = [r for r, _ in pairs]
        slot_ids = [b for _, b in pairs]
        t_admit = time.perf_counter()
        e, llm_cfg = self.engine, self.cfg.llm
        depth = (self.cfg.depth_topk, self.cfg.depth_temperature)

        rows = self._local(slot_ids)
        rs = np.full((max(self._Bl, len(rows)),), self._Bl, np.int64)
        rs[:len(rows)] = rows
        self.lm_state = reset_lm_slots(self.lm_state, rs)
        self.vo_state = reset_vocoder_slots(self.vo_state, rs)
        t_reset = time.perf_counter()

        plain = [(r, int(b)) for (r, _), b in zip(pairs, rows)
                 if r.prefix is None and b < self._Bl]
        prefixed = [(r, b) for r, b in zip(reqs, slot_ids)
                    if r.prefix is not None]
        t_pack = t_disp = t_reset
        if plain:
            N = len(plain)
            Np = 1 if N == 1 else self._Bl
            S = max(r.tokens.shape[1] for r, _ in plain)
            C = llm_cfg.num_columns
            tokens = np.zeros((Np, S, C), np.int32)
            mask = np.zeros((Np, S, C), bool)
            valid = np.zeros((Np, S), bool)
            temps = np.full((Np,), self.cfg.default_temperature, np.float32)
            topks = np.full((Np,), self.default_topk, np.int32)
            bs = np.full((Np,), self._Bl, np.int64)
            noise = [self._ones] * Np
            for i, (req, slot_id) in enumerate(plain):
                s = req.tokens.shape[1]
                tokens[i, S - s:] = req.tokens[0]
                mask[i, S - s:] = req.mask[0]
                valid[i, S - s:] = req.valid[0]
                temps[i], topks[i], bs[i] = req.temperature, req.topk, slot_id
                noise[i] = self._noise(req.handle.seed, 0)
            t_pack = time.perf_counter()
            self.lm_state, frames = prefill_into_slots(
                e.lm_params, llm_cfg, self.lm_state, bs,
                *self._dev(tokens, mask, valid), torch.stack(noise),
                *self._sampling_rows(temps, topks), *depth)
            t_disp = time.perf_counter()
            ids = host_to_device(bs[:N], self.device)
            self.frames[ids] = frames[:N]
        for req, slot_id in prefixed:
            pk, pv, plen, _P = req.prefix
            self.lm_state, frame = prefill_into_slot_prefix(
                e.lm_params, llm_cfg, self.lm_state, slot_id, pk, pv,
                *self._dev(np.array([plen], np.int32), req.tokens, req.mask,
                           req.valid, np.array([req.real_len], np.int32)),
                self._noise(req.handle.seed, 0)[None],
                *self._sampling_rows([req.temperature], [req.topk]), *depth)
            self.frames[slot_id] = frame[0]
        self.emitted = self.emitted.index_fill(
            0, host_to_device(rows[rows < self._Bl], self.device), 0)
        now = time.perf_counter()
        self.timeline.append({
            "t": round(now - self._tl_t0, 4), "ev": "admit", "n": len(reqs),
            "S": max(r.tokens.shape[1] for r in reqs),
            "n_prefix": len(prefixed),
            "host_ms": round((now - t_admit) * 1e3, 2),
            "reset_ms": round((t_reset - t_admit) * 1e3, 1),
            "prefill_ms": round((t_disp - t_pack) * 1e3, 1),
            "update_ms": round((now - t_disp) * 1e3, 1)})
        for req, b in zip(reqs, slot_ids):
            self.temps[b] = req.temperature
            self.topks[b] = req.topk
            slot = self.slots[b]
            with self._lock:
                slot.active = True
            slot.handle = req.handle
            slot.frames_done = 0
            slot.max_frames = req.max_frames
            slot.last_tail = None
            slot.collect_tokens = req.collect_tokens
            slot.token_rows = []
            slot.keep_kv = req.keep_kv
            slot.base_len = ((req.prefix[2] if req.prefix is not None else 0)
                             + req.real_len)
            slot.noise_t = 1
        self._upload_sampling()

    def _vocoder_room(self, active: list) -> int:
        """The longest block every live slot's vocoder slab still holds for
        the frames the slot keeps. A block running past a slab's end would
        have kernel C write its rows at T - S, over live rows of kept
        frames (a pool whose frame cap fills its slab, or a stream at the
        stock 30 s cap). Slots whose kept frames are all dispatched do not
        count; their extra frames are discarded."""
        slab = self.vo_state.kv_k.shape[2] // 8
        room = slab
        for i, _ in active:
            s = self.slots[i]
            sent = s.noise_t - 1          # frames through the vocoder
            if s.max_frames > sent:
                room = min(room, slab - sent)
        return max(room, 1)

    def _block_noise(self, K: int) -> torch.Tensor:
        """(K, Bl, ncb, V): each live slot's next K frames' noise, ones for
        idle slots, over this rank's rows."""
        rows = []
        for t in range(K):
            for s in self.slots[self._r0:self._r1]:
                rows.append(self._noise(s.handle.seed, s.noise_t + t)
                            if s.active else self._ones)
        return torch.stack(rows).reshape(K, self._Bl, self._ncb, self._V)

    def _finish(self, b: int) -> None:
        slot = self.slots[b]
        h = slot.handle
        if h is not None:
            ncb = self._ncb
            if slot.keep_kv and slot.base_len > 0:
                # set before the final None, which publishes it; the block
                # in flight writes this slot only at rows >= base_len
                P = min(-(-slot.base_len // 128) * 128,
                        self.lm_state.cache_k.shape[2])
                pk, pv = slot_kv_prefix(self.lm_state, b, P)
                h.kv_prefix = (pk, pv, slot.base_len, P)
            h.tokens = (np.concatenate(slot.token_rows).astype(np.int32)
                        if slot.token_rows else np.zeros((0, ncb), np.int32))
            if (not slot.collect_tokens and slot.frames_done > 0
                    and slot.last_tail is not None):
                h.chunks.put(slot.last_tail)
                h.samples += len(slot.last_tail)
            h.finished_s = time.perf_counter() - h.t0
            h.chunks.put(None)
        with self._lock:
            slot.active = False
        slot.handle = None
        slot.collect_tokens = False
        slot.token_rows = []
        slot.keep_kv = False
        slot.base_len = 0

    def _loop(self) -> None:
        try:
            if self._device_index is not None:
                torch.cuda.set_device(self._device_index)
                # the stream every kernel of the loop launches on
                self.cuda_stream = torch.cuda.current_stream()
            with torch.inference_mode(), use_mesh(self.mesh):
                if self.mesh is None:
                    self._loop_inner()
                else:
                    self._loop_mesh()
        except Exception as e:  # fail every live and pending stream loudly
            traceback.print_exc()
            self._dead = e
            self._ready.set()
            for s in self.slots:
                if s.active and s.handle is not None:
                    s.handle.error = e
                    s.handle.chunks.put(None)
                    with self._lock:
                        s.active = False
            self._end_pending(e)
        else:
            # requests queued as the pool stopped: their consumers must
            # not wait forever (a consumer thread blocked in a handle
            # would also hold up the interpreter's exit)
            self._end_pending(RuntimeError("batcher stopped"))
        finally:
            if getattr(self.engine, "_lockstep", None) \
                    is threading.current_thread():
                self.engine._lockstep = None

    def _end_pending(self, e: Exception) -> None:
        """End every queued request's handle with error e."""
        while not self.pending.empty():
            try:
                req = self.pending.get_nowait()
            except queue.Empty:
                break
            req.handle.error = e
            req.handle.chunks.put(None)

    def _to_host(self, packed: torch.Tensor):
        """Start the packed block's copy to the host: pinned memory and a
        non-blocking copy behind an event on the card; the tensor itself on
        the CPU."""
        if not packed.is_cuda:
            return packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def _loop_inner(self) -> None:
        """Double-buffered block loop: block k+1 is queued before block k's
        output is read, so its copy and fan-out overlap the card's work on
        k+1. A slot that ends in block k wastes its lanes in k+1 (the
        fan-out discards them by handle identity)."""
        try:
            if self._warmup_blocks_on:
                self._warmup_ladder()
        finally:
            self._ready.set()
        in_flight = None   # (host packed, event, K, active, t_dispatch)
        while not self._stop.is_set():
            self._admit()
            # (slot, handle) pairs at dispatch: a slot freed by the previous
            # fan-out may be admitted again before this block's fan-out
            active = [(i, s.handle) for i, s in enumerate(self.slots)
                      if s.active]
            nxt = None
            if active:
                # short blocks while requests wait for a slot or a stream
                # waits for its first packet: this block's dispatch is what
                # stands between the previous block and its fan-out
                fresh = any(h.first_packet_s is None for _, h in active)
                K = min(self.policy.choose(
                    pending=fresh or not self.pending.empty(),
                    active=len(active)), self._vocoder_room(active))
                t_block = time.perf_counter()
                noise = self._block_noise(K)
                (self.lm_state, self.vo_state, self.frames, self.emitted,
                 packed) = self._block(K, noise)
                for i, _ in active:
                    self.slots[i].noise_t += K
                host, ev = self._to_host(packed)
                self._host["dispatch_s"] += time.perf_counter() - t_block
                nxt = (host, ev, K, active, t_block)
            if in_flight is not None:
                self._fan_out(*in_flight)
            in_flight = nxt
            if in_flight is None:
                # idle: sleep until a submit, reload or stop (no polling,
                # which would take the GIL from threads launching work)
                self._wake.wait(timeout=0.5)
                self._wake.clear()
        if in_flight is not None:
            self._fan_out(*in_flight)
        for b, s in enumerate(self.slots):
            if s.active:
                self._finish(b)

    def _control(self) -> dict:
        """Rank 0: this iteration's control, broadcast to every rank: stop;
        the slots its fan-out dropped; the admissions (slot, seed and the
        request's _WIRE fields); the block length K (0: no block). The other
        ranks receive it and make follower requests of the admissions."""
        if self.mesh.is_leader:
            ctl = {"stop": self._stop.is_set(), "drop": self._dropped,
                   "admit": [], "K": 0}
            self._dropped = []
            pairs = []
            if not ctl["stop"]:
                with self._admit_lock:
                    if not (self._admit_paused.is_set() or self._held):
                        pairs = self._choose()
                ctl["admit"] = [(b, r.handle.seed,
                                 {f: getattr(r, f) for f in _WIRE})
                                for r, b in pairs]
            broadcast_object(ctl, self.mesh)
            ctl["pairs"] = pairs
            return ctl
        ctl = broadcast_object(None, self.mesh)
        ctl["pairs"] = [
            (_Pending(handle=StreamHandle(request_id=f"follower-{b}",
                                          chunks=_Sink(), seed=seed), **f), b)
            for b, seed, f in ctl["admit"]]
        return ctl

    def _choose_block(self) -> int:
        """Rank 0: K for the next block over the active slots (0: none)."""
        active = [(i, s.handle) for i, s in enumerate(self.slots) if s.active]
        if not active:
            return 0
        fresh = any(h.first_packet_s is None for _, h in active)
        return min(self.policy.choose(
            pending=fresh or not self.pending.empty(), active=len(active)),
            self._vocoder_room(active))

    def _loop_mesh(self) -> None:
        """The lockstep loop of a meshed pool (every rank): each iteration
        takes rank 0's control, admits, runs one block on this rank's rows,
        gathers its packed output whole over dp and fans it out. No double
        buffering: the gather is a collective, in step on every rank."""
        try:
            if self._warmup_blocks_on:
                self._warmup_ladder()
        finally:
            self._ready.set()
        self._dropped: list = []
        while True:
            ctl = self._control()
            if ctl["stop"]:
                break
            for b in ctl["drop"]:
                if self.slots[b].active:
                    self._finish(b)
            self._admit_pairs(ctl["pairs"])
            if self.mesh.is_leader:
                ctl["K"] = self._choose_block()
            K = broadcast_object(ctl["K"], self.mesh)
            if K:
                active = [(i, s.handle) for i, s in enumerate(self.slots)
                          if s.active]
                t_block = time.perf_counter()
                noise = self._block_noise(K)
                (self.lm_state, self.vo_state, self.frames, self.emitted,
                 packed) = self._block(K, noise)
                for i, _ in active:
                    self.slots[i].noise_t += K
                packed = self.engine._gather_rows(packed, self.B)
                host, ev = self._to_host(packed)
                self._host["dispatch_s"] += time.perf_counter() - t_block
                self._fan_out(host, ev, K, active, t_block)
            elif self.mesh.is_leader:
                self._wake.wait(timeout=0.5)
                self._wake.clear()
        for b, s in enumerate(self.slots):
            if s.active:
                self._finish(b)

    def _fan_out(self, host: torch.Tensor, ev, K: int, active: list,
                 t_block: float) -> None:
        """Read one packed block, (B, K*cs + K*ts + K + K*ncb) = [middles |
        cut tails | EOS flags | frames] per stream, and hand each stream
        one contiguous chunk: its frames up to its first EOS flag or its
        frame cap."""
        cs, ts, ncb = self._cs, self._ts, self._ncb
        t_fetch0 = time.perf_counter()
        if ev is not None:
            ev.synchronize()
        pk = host.numpy()
        now = time.perf_counter()
        self.policy.record(K, now - t_block)
        self._host["fetch_s"] += now - t_fetch0
        self.timeline.append({
            "t": round(t_block - self._tl_t0, 4), "ev": "block", "K": K,
            "n": len(active), "wall_ms": round((now - t_block) * 1e3, 1)})
        base = K * (cs + ts)
        eos = pk[:, base:base + K] > 0.5                  # (B, K)
        toks = pk[:, base + K:].reshape(-1, K, ncb)
        for b, handle in active:
            slot = self.slots[b]
            if not slot.active or slot.handle is not handle:
                continue
            hit_eos = bool(eos[b].any())
            n_eos = int(np.argmax(eos[b])) if hit_eos else K
            n = min(n_eos, slot.max_frames - slot.frames_done)
            capped = n < n_eos or slot.frames_done + n >= slot.max_frames
            if n > 0:
                slot.token_rows.append(toks[b, :n].astype(np.int32))
                if slot.handle.first_packet_s is None:
                    slot.handle.first_packet_s = now - slot.handle.t0
                if not slot.collect_tokens:
                    audio = pk[b, :n * cs]
                    if slot.frames_done == 0:
                        audio = audio[self._lead:]
                    slot.last_tail = pk[b, K * cs + (n - 1) * ts:
                                        K * cs + n * ts].copy()
                    try:
                        slot.handle.chunks.put_nowait(audio.copy())
                        slot.handle.samples += len(audio)
                    except queue.Full:
                        slot.handle.error = RuntimeError(
                            "client too slow; dropped")
                        self.chunk_drops += 1
                        slot.frames_done += n
                        self._finish(b)
                        if self.mesh is not None:   # the others follow
                            self._dropped.append(b)
                        continue
                slot.frames_done += n
            if hit_eos or capped:
                self._finish(b)
        self._host["fanout_s"] += time.perf_counter() - now
        self._host["blocks"] += 1
        self._host["frames"] += K * len(active)

    def reset_host_stats(self) -> None:
        """Zero the host-cost counters (after a warm-up wave)."""
        for k in self._host:
            self._host[k] = type(self._host[k])(0)

    def host_stats(self) -> dict:
        """Host cost per frame in ms by phase (dispatch, fetch, fanout;
        frames count every live slot's frames). fetch includes waiting for
        the card when the host is ahead, so dispatch + fanout is the host's
        own overhead (``host_ms_per_frame``)."""
        h = dict(self._host)
        f = max(h.pop("frames"), 1)
        out = {"blocks": h.pop("blocks"), "frames": f}
        out.update({k[:-2] + "_ms_per_frame": 1e3 * v / f
                    for k, v in h.items()})
        out["host_ms_per_frame"] = (out["dispatch_ms_per_frame"]
                                    + out["fanout_ms_per_frame"])
        return out
