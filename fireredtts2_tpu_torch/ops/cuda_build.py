"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), and loaded with ``ctypes``. All sources build in parallel.
Libraries are named by a hash of their source and flags, so a changed
source rebuilds and an unchanged one is reused. The build directory is
``fireredtts2_tpu_torch/_build/`` (git-ignored).

A source may also be built as a variant with preprocessor defines (``-D``
flags, part of the hash and of the library's name): kernel B's ablation
builds (``FRT_ABL=<bits>``) exist only for the probe tools. The engine
loads every library without defines.

Nothing here runs at import: the first CUDA launch of a kernel wrapper
builds its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}   # build label -> nvcc output of its build


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def label(name: str, defines: tuple[str, ...] = ()) -> str:
    """A build's key: the source's name, with its defines if any."""
    return name if not defines else f"{name}[{','.join(defines)}]"


def _lib_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    """The library's path, named by a hash of its source, the shared
    headers (``csrc/*.cuh``), the flags and the defines."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS + tuple(f"-D{d}" for d in defines))
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    tag = "".join(f"_{d.replace('=', '')}" for d in defines)
    return BUILD_DIR / f"lib{name}{tag}_{digest[:16]}.so"


def build(jobs: list | None = None) -> dict[str, Path]:
    """Compile the named sources (default: every ``csrc/*.cu`` without
    defines), one nvcc process each, all started together. A job is a
    source's name or (name, defines). Returns {label: library path}."""
    if jobs is None:
        jobs = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    jobs = [(j, ()) if isinstance(j, str) else (j[0], tuple(j[1])) for j in jobs]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {label(n, d): (n, d, _lib_path(n, d)) for n, d in jobs}
    nvcc = None
    procs = {}
    for key, (n, d, p) in out.items():
        if p.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(f"-D{x}" for x in d), "-o", str(tmp),
               str(CSRC_DIR / f"{n}.cu")]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, p)
    failed = []
    for key, (proc, tmp, p) in procs.items():
        log, _ = proc.communicate()
        build_logs[key] = log
        if proc.returncode != 0:
            failed.append(f"{key} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, p)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {key: p for key, (_, _, p) in out.items()}


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (with ``defines``, a
    variant), built on first use."""
    key = label(name, tuple(defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build([(name, tuple(defines))])[key]))
            _libs[key] = lib
        return lib
