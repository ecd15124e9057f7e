"""Build the CUDA sources under ``icl_torch/csrc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` holds kernels plus plain C entry points.  At first
use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``icl_torch/_build/`` (git-ignored), named by a hash of the source,
of every header ``csrc/*.cuh`` and of the flags, so an edited source or
header rebuilds and an unchanged one loads at once.
The library is loaded with :mod:`ctypes` and each entry point given explicit
``argtypes``.  A failed build raises with the compiler's output; nothing
falls back to another implementation.

nvcc is looked up as ``$CUDA_HOME/bin/nvcc``, then on ``PATH``, then under
``/usr/local/cuda``.  The compiler's report (``-Xptxas -v``: registers,
shared memory, spills per kernel) is kept beside the library as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_bound: set[tuple[str, str]] = set()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str, extra: tuple[str, ...] = ()) -> Path:
    """Where ``csrc/<name>.cu`` builds to: a hash of the source, of the
    headers ``csrc/*.cuh`` (any source may include any of them) and of the
    flags."""
    digest = hashlib.sha256()
    for src in (SRC_DIR / f"{name}.cu", *sorted(SRC_DIR.glob("*.cuh"))):
        digest.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    digest.update("\0".join(NVCC_FLAGS + tuple(extra)).encode())
    digest = digest.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str, extra: tuple[str, ...] = ()) -> tuple[Path, float]:
    """Compile ``csrc/<name>.cu`` unless already built; returns (path, s).

    ``extra``: more nvcc flags (``-D...`` of a measuring build); they enter
    the library's name, so such a build never replaces the plain one.

    The seconds are 0.0 when the library was already there.  The output is
    written under a temporary name and renamed, so a concurrent or
    interrupted build never leaves a half-written library behind.
    """
    out = library_path(name, extra)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp),
           str(SRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {name}.cu:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out, seconds


def load(name: str, symbol: str, argtypes: list) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; bind ``symbol``.

    A source may hold several entry points; each is bound at its first
    load.  An entry point returns a ``cudaError_t`` as ``int``.
    """
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _ = build(name)
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        if (name, symbol) not in _bound:
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _bound.add((name, symbol))
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
