"""The (dp, tp) serving mesh over torch.distributed, its placement rules
and collectives.

Counterpart of ``fireredtts2_tpu/parallel/mesh.py``. There, one program
spans the devices of a ``jax.sharding.Mesh`` and XLA inserts the
collectives. Here each rank is one process (``torchrun``, or :class:`Ranks`
in tests and on one card), holds only its shard of every weight and its
share of the streams, and calls the collectives itself, on plain local
tensors:

- axis "dp": streams. A batch's rows split over the dp ranks; no weight
  moves between them.
- axis "tp": Megatron tensor parallelism. Column-parallel projections keep
  their rank's output features, row-parallel ones their input features and
  end in a sum over the tp group (:func:`all_reduce`); embeddings and heads
  keep a vocabulary slice.

Ranks are laid out row-major, as JAX reshapes its devices: rank =
dp_rank * tp + tp_rank. The placement rules are JAX's PartitionSpecs,
written as tuples of axis names (``None`` = that dimension is whole on
every rank; ``()`` = replicated), so the two packages' trees compare leaf
for leaf.

On device tensors only ``all_reduce`` and ``broadcast`` are used: gloo
takes CUDA tensors for those two only, and NCCL refuses two ranks on one
card, so one code path serves both backends. A gather is an all-reduce of
a zeroed buffer in which each rank fills its own part. Every collective is
counted (:func:`collective_stats`): how many, and the largest tensor moved.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import multiprocessing as mp
import os
import pickle
import socket
import threading
import time
import traceback
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

Spec = tuple


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Mesh:
    """This rank's view of a (dp, tp) mesh: its coordinates and the process
    groups of its row (tp) and column (dp). Groups are None on a one-rank
    axis (and everywhere without torch.distributed)."""

    dp: int
    tp: int
    rank: int = 0
    tp_group: Any = None
    dp_group: Any = None
    host_group: Any = None      # gloo over every rank: host-side objects

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    def axis_rank(self, axis: str) -> int:
        return self.tp_rank if axis == "tp" else self.dp_rank

    @property
    def is_leader(self) -> bool:
        return self.rank == 0


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              world: Optional[int] = None) -> Mesh:
    """Build a (dp, tp) mesh over the process world; dp defaults to
    world // tp (parallel/mesh.py:make_mesh's defaults and errors, with
    ranks for devices). `world` gives the size without torch.distributed
    (shapes only: the mesh then has no groups). Under torch.distributed
    every rank must call this, in the same order, since it makes the
    groups."""
    n, rank = _world()
    if world is not None:
        n, rank = world, 0
    if dp is None:
        if n % tp:
            raise ValueError(
                f"tp={tp} does not divide the {n} visible rank(s); "
                f"pass --tp that divides the rank count (launch one rank "
                f"per GPU with torchrun --nproc-per-node N)")
        dp = n // tp
    if dp * tp > n:
        raise ValueError(f"dp={dp} x tp={tp} exceeds the {n} visible "
                         f"rank(s)")
    mesh = Mesh(dp=dp, tp=tp, rank=rank)
    if world is None and n > 1:
        _make_groups(mesh, n)
    return mesh


def _make_groups(mesh: Mesh, n: int) -> None:
    """The tp rows, dp columns and a gloo world group; new_group is
    collective, so every rank makes every group in the same order. Ranks
    past dp * tp belong to no row or column."""
    dp, tp = mesh.dp, mesh.tp
    backend = dist.get_backend()
    for d in range(dp):
        ranks = [d * tp + t for t in range(tp)]
        g = dist.new_group(ranks, backend=backend) if tp > 1 else None
        if mesh.rank in ranks:
            mesh.tp_group = g
    for t in range(tp):
        ranks = [d * tp + t for d in range(dp)]
        g = dist.new_group(ranks, backend=backend) if dp > 1 else None
        if mesh.rank in ranks:
            mesh.dp_group = g
    mesh.host_group = (dist.new_group(list(range(n)), backend="gloo")
                       if backend != "gloo" else dist.group.WORLD)


# ---------------------------------------------------------------------------
# Placement rules (PartitionSpecs as tuples)
# ---------------------------------------------------------------------------


def _transformer_pspecs() -> dict[str, Spec]:
    """Specs of a stacked transformer tree (leading L axis): column-parallel
    wq/wk/wv, w_gate, w_up (output features on tp), row-parallel wo,
    w_down (input features on tp), norms replicated."""
    return {
        "wq": (None, None, "tp"), "bq": (None, "tp"),
        "wk": (None, None, "tp"), "bk": (None, "tp"),
        "wv": (None, None, "tp"), "bv": (None, "tp"),
        "wo": (None, "tp", None),
        "w_gate": (None, None, "tp"),
        "w_up": (None, None, "tp"),
        "w_down": (None, "tp", None),
        "attn_norm": (), "mlp_norm": (), "final_norm": (),
    }


# Column-parallel matmuls; their per-output-channel int8 scales (L, 1, O)
# shard on the same last axis. Row-parallel scales stay replicated: the
# scale multiplies AFTER the partial-sum all-reduce (ops/quant.py).
_COL_KEYS = ("wq", "wk", "wv", "w_gate", "w_up")


def _map_paths(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """fn(path, leaf) over a nested dict tree (other leaves as they are)."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def lm_param_pspecs(params: Any) -> Any:
    """Spec tree of an LM param tree: the stacks Megatron-split, embeddings
    and heads on the vocabulary, int8 scales with their weights, the fused
    depth-chain bundle (kernel B) and anything else replicated."""
    t = _transformer_pspecs()

    def spec_for(path: tuple, leaf) -> Spec:
        top = path[0]
        if top in ("backbone", "decoder"):
            key = path[1]
            if key in t:
                return t[key]
            if key.endswith("_scale"):
                base = key[: -len("_scale")]
                if base in _COL_KEYS and hasattr(leaf, "ndim"):
                    return (None,) * (leaf.ndim - 1) + ("tp",)
                return ()
            return ()       # packed int4 / other serving leaves: replicate
        if top in ("text_embeddings", "audio_embeddings"):
            return ("tp", None)
        if top in ("codebook0_head", "text_head"):
            return (None, "tp")
        if top == "audio_head":
            return (None, None, "tp")
        return ()

    return _map_paths(spec_for, params)


_WHISPER_COL = ("wq", "wk", "wv", "fc1_w", "cross_wq", "cross_wk",
                "cross_wv", "self_wq", "self_wk", "self_wv")
_WHISPER_ROW = ("wo", "fc2_w", "cross_wo", "self_wo")
_WHISPER_COL_BIAS = ("bq", "bv", "fc1_b", "cross_bq", "cross_bv",
                     "self_bq", "self_bv")


def _whisper_layer_spec(key: str, leaf) -> Spec:
    """Column-parallel q/k/v and MLP-in (biases too), row-parallel out-proj
    and MLP-out (their biases added after the all-reduce, replicated);
    int8 scales follow their column-parallel weights."""
    if key in _WHISPER_COL:
        return (None, None, "tp")
    if key in _WHISPER_ROW:
        return (None, "tp", None)
    if key in _WHISPER_COL_BIAS:
        return (None, "tp")
    if key.endswith("_scale"):
        base = key[: -len("_scale")]
        if base in _WHISPER_COL and hasattr(leaf, "ndim"):
            return (None,) * (leaf.ndim - 1) + ("tp",)
    return ()


def codec_param_pspecs(params: Any) -> Any:
    """Spec tree of a codec param tree: every whisper-style layer stack
    (encoders, adaptors, the acoustic decoder) Megatron-split; convs, RVQ,
    norms and heads replicated."""
    def spec_for(path: tuple, leaf) -> Spec:
        if len(path) >= 2 and path[-2] == "layers":
            return _whisper_layer_spec(path[-1], leaf)
        return ()

    return _map_paths(spec_for, params)


def sanitize_pspecs(mesh: Mesh, tree: Any, pspecs: Any) -> Any:
    """Replicate any sharded dimension the mesh does not divide evenly
    (quantised scales of size-1 dims, tiny test configs, B=1 states on a
    dp > 1 mesh). Trailing dimensions are named None."""
    def fix(leaf, spec):
        if not hasattr(leaf, "shape") or not isinstance(spec, tuple):
            return spec
        names = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        return tuple(name if name is None or dim % mesh.shape[name] == 0
                     else None for dim, name in zip(leaf.shape, names))

    return _zip_map(fix, tree, pspecs)


def _zip_map(fn: Callable, tree: Any, specs: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if _is_record(tree):
        return type(tree)(**{f: _zip_map(fn, getattr(tree, f),
                                         getattr(specs, f))
                             for f in _fields(tree)})
    return fn(tree, specs)


def _is_record(x) -> bool:
    return dataclasses.is_dataclass(x) or hasattr(x, "_fields")


def _fields(x) -> tuple:
    if dataclasses.is_dataclass(x):
        return tuple(f.name for f in dataclasses.fields(x))
    return tuple(x._fields)


def lm_state_pspecs(state) -> Any:
    """LMState: stream rows on dp; the (L, B, T, Hkv*Dh) slabs are
    tp-replicated (two kv heads are too few to shard; the projections
    are)."""
    return type(state)(cache_k=(None, "dp", None, None),
                       cache_v=(None, "dp", None, None),
                       slot_valid=("dp", None), pos=("dp",))


def vocoder_state_pspecs(state) -> Any:
    """VocoderStreamState: stream rows on dp; the KV slabs ALSO shard their
    merged head columns over tp (MHA: each tp rank owns whole heads, so
    kernel C writes and reads only its own columns); conv and iSTFT caches
    tp-replicated."""
    return type(state)(
        up1_cache=("dp", None, None), up2_cache=("dp", None, None),
        in_proj_cache=("dp", None, None),
        rb_caches=(None, None, "dp", None, None),
        kv_k=(None, "dp", None, "tp"), kv_v=(None, "dp", None, "tp"),
        istft_cache=("dp", None, None), pos=("dp",))


def local_slice(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of a whole leaf under a (sanitized) spec: for each
    dimension named by an axis, the axis rank's even part."""
    for d, name in enumerate(spec):
        if name is None:
            continue
        n = mesh.shape[name]
        if n == 1:
            continue
        w = x.shape[d] // n
        x = x.narrow(d, mesh.axis_rank(name) * w, w)
    return x.contiguous()


def shard_params(mesh: Mesh, params: Any, pspecs: Any) -> Any:
    """Keep this rank's shard of every leaf of a whole tree (from
    ``weights.from_jax``, a checkpoint or the initialisers), under the
    sanitized specs: a dimension the mesh does not divide stays whole, as
    JAX places it (the flagship's 2051-token audio heads at tp=2).

    The model code (``parallel.layers``) reads a leaf's split from its
    shape: an LM stack's widths and a table's vocabulary from the config.
    A whisper layer stack is split whole or not at all: a tp dimension of
    one that the mesh does not divide raises a ValueError naming the leaf,
    so the stack's out-projection rows (D/tp or D) say which it is
    (``whisper_nn``)."""
    def check(path: tuple, leaf, spec) -> None:
        if "layers" not in path:
            return
        for dim, name in zip(getattr(leaf, "shape", ()), spec):
            if name == "tp" and dim % mesh.tp:
                raise ValueError(
                    f"tp={mesh.tp} does not divide dimension {dim} of "
                    f"{'/'.join(path)} {tuple(leaf.shape)}")

    _walk(check, params, pspecs)
    specs = sanitize_pspecs(mesh, params, pspecs)
    return _zip_map(lambda leaf, spec: local_slice(leaf, spec, mesh)
                    if torch.is_tensor(leaf) else leaf, params, specs)


def _walk(fn: Callable, tree: Any, specs: Any, path: tuple = ()) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _walk(fn, v, specs[k], path + (k,))
    else:
        fn(path, tree, specs)


def shard_spec_rows(n: int, mesh: Mesh, axis: str = "dp") -> tuple[int, int]:
    """[start, stop) of this rank's rows of an n-row dimension on `axis`,
    or (0, n) when the axis does not divide n (replicated, as
    sanitize_pspecs leaves it)."""
    k = mesh.shape[axis]
    if k == 1 or n % k:
        return 0, n
    w = n // k
    r = mesh.axis_rank(axis)
    return r * w, (r + 1) * w


# ---------------------------------------------------------------------------
# The current mesh: model code reaches its engine's mesh through it
# ---------------------------------------------------------------------------

_CURRENT = threading.local()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make `mesh` this thread's current mesh for the block (None: none).
    An engine enters its own around each of its device calls and its pool
    around its worker loop, so model code on that engine's shards reads
    that engine's mesh, and code run outside them (a whole tree, another
    engine's) reads its own or none."""
    prev = getattr(_CURRENT, "mesh", None)
    _CURRENT.mesh = mesh
    try:
        yield mesh
    finally:
        _CURRENT.mesh = prev


def serving_mesh() -> Optional[Mesh]:
    """This thread's current mesh (:func:`use_mesh`), or None."""
    return getattr(_CURRENT, "mesh", None)


def tp_mesh() -> Optional[Mesh]:
    """The current mesh when it splits tensors (tp > 1), else None."""
    m = serving_mesh()
    return m if m is not None and m.tp > 1 else None


# ---------------------------------------------------------------------------
# Collectives (all_reduce and broadcast only), counted
# ---------------------------------------------------------------------------

_STATS = {"calls": 0, "bytes": 0, "max_bytes": 0, "max_shape": ()}


def reset_collective_stats() -> None:
    _STATS.update(calls=0, bytes=0, max_bytes=0, max_shape=())


def collective_stats() -> dict:
    """Collectives since the last reset: count, total bytes, and the
    largest tensor's bytes and shape."""
    return dict(_STATS)


def _count(x: torch.Tensor) -> None:
    nb = x.numel() * x.element_size()
    _STATS["calls"] += 1
    _STATS["bytes"] += nb
    if nb > _STATS["max_bytes"]:
        _STATS["max_bytes"], _STATS["max_shape"] = nb, tuple(x.shape)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over `group` (a new tensor; x itself when the group is None).
    bfloat16 and float16 are summed in fp32 and rounded once."""
    if group is None:
        return x
    y = x.to(torch.float32) if x.dtype in (torch.bfloat16, torch.float16) \
        else x.clone()
    _count(y)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def gather_dim(x: torch.Tensor, full: int, dim: int, group, rank: int
               ) -> torch.Tensor:
    """The whole of a dimension split evenly over `group` (x holds part
    `rank` of `full`): an all-reduce of a zeroed buffer in which each rank
    fills its own part. Exact, since every other part adds zeros."""
    if group is None or x.shape[dim] == full:
        return x
    w = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = full
    # 16-bit floats ride in fp32 (gloo's sums take them on the host only);
    # adding zeros keeps every value exact
    wide = x.dtype in (torch.bfloat16, torch.float16)
    buf = torch.zeros(shape, dtype=torch.float32 if wide else x.dtype,
                      device=x.device)
    buf.narrow(dim, rank * w, w).copy_(x)
    _count(buf)
    dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


def broadcast_object(obj: Any, mesh: Mesh, src: int = 0) -> Any:
    """A picklable host object from rank `src` to every rank, over the
    mesh's gloo world group."""
    if mesh.host_group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=mesh.host_group)
    return box[0]


# ---------------------------------------------------------------------------
# Launching ranks: tests and single-card runs (the CLI uses torchrun)
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_ranks(world: int, rank: int, port: int, backend: str = "gloo",
               timeout_s: float = 300.0) -> None:
    """init_process_group on localhost with an explicit timeout."""
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def _rank_main(fn, rank: int, world: int, port: int, args: tuple,
               threads: int, timeout_s: float, conn) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        init_ranks(world, rank, port, timeout_s=timeout_s)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        # plain pickle: tensors travel by value (multiprocessing's pickler
        # would pass CPU tensors as shared-memory handles, which die with
        # this process)
        conn.send_bytes(pickle.dumps(("ok", out)))
    except BaseException:          # report, then exit non-zero
        conn.send_bytes(pickle.dumps(("error", traceback.format_exc())))
        raise
    finally:
        conn.close()


class Ranks:
    """fn(rank, world, *args) running in `world` fresh processes joined by
    a gloo process group on localhost: the tests' and a single card's ranks
    (the CLI's come from torchrun). They start on construction, so the
    caller may work meanwhile; :meth:`join` returns their results by rank.
    fn must be importable: a module-level function of a module the
    children can import."""

    def __init__(self, fn: Callable, world: int, args: tuple = (),
                 timeout_s: float = 300.0, threads: int = 1):
        ctx = mp.get_context("spawn")
        port = free_port()
        self.world, self.timeout_s = world, timeout_s
        self.t0 = time.monotonic()
        self.procs, self.conns = [], []
        try:
            for r in range(world):
                parent, child = ctx.Pipe(duplex=False)
                p = ctx.Process(target=_rank_main,
                                args=(fn, r, world, port, args, threads,
                                      timeout_s, child), daemon=True)
                p.start()
                child.close()
                self.procs.append(p)
                self.conns.append(parent)
        except BaseException:
            self._reap()
            raise

    def join(self) -> list:
        """The ranks' results. Raises if a rank fails or the deadline
        (timeout_s from the start) passes; every child is joined, or
        killed, before this returns."""
        try:
            results: list = [None] * self.world
            done = [False] * self.world
            while not all(done):
                if time.monotonic() - self.t0 > self.timeout_s:
                    raise TimeoutError(
                        f"ranks {[r for r in range(self.world) if not done[r]]}"
                        f" did not finish in {self.timeout_s} s")
                for r, c in enumerate(self.conns):
                    if done[r] or not c.poll(0.05):
                        continue
                    try:
                        status, out = pickle.loads(c.recv_bytes())
                    except EOFError:
                        raise RuntimeError(
                            f"rank {r} exited without a result (exit code "
                            f"{self.procs[r].exitcode})")
                    if status != "ok":
                        raise RuntimeError(f"rank {r} failed:\n{out}")
                    results[r], done[r] = out, True
            return results
        finally:
            self._reap()

    def _reap(self) -> None:
        for c in self.conns:
            c.close()
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


def env_world() -> Optional[tuple[int, int, int]]:
    """(world, rank, local_rank) when launched by torchrun, else None."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return None
    return (int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
            int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
