"""ctypes bindings to the port's C++ I/O library (``icl_native.cpp`` here).

The port's own copy of ``icl/native``: the source beside this file is
compiled at first use by the host's C++ compiler (``$CXX``, else ``g++``)
into ``icl_torch/_build/`` (git-ignored), under a name that hashes the
source, the flags, the compiler's ``--version`` and the host CPU's
instruction-set flags (``-march=native`` code must not load on another
CPU), so an unchanged source loads at once and an edited one rebuilds.
The library is written under a temporary name and renamed into place, so
concurrent builds (test workers, data-parallel ranks) never expose a
half-written file.

All callers fall back to the pure-Python implementations when the library
is unavailable; results are identical either way (tests/test_torch_native.py).
A failed build or ``dlopen`` logs one WARNING with the compiler's last
lines and is remembered, so it is not retried on every call.
``ICL_TORCH_NO_NATIVE_BUILD=1`` turns the library off: nothing is built
or loaded and the Python paths run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().with_name("icl_native.cpp")
BUILD_DIR = SOURCE.parent.parent / "_build"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")
OFF_SWITCH = "ICL_TORCH_NO_NATIVE_BUILD"

_lib = None
_load_failed = False
_lock = threading.Lock()


def compiler() -> tuple[str, str]:
    """The host C++ compiler and the first line of its ``--version``
    ("" when it cannot be run)."""
    cxx = os.environ.get("CXX") or "g++"
    try:
        out = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        out = ""
    return cxx, out.strip().splitlines()[0] if out.strip() else ""


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line
    except OSError:
        pass
    return platform.processor()


def library_path(cxx: str, version: str) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    for part in (*CXXFLAGS, cxx, version, platform.machine(), _cpu_flags()):
        digest.update(b"\0" + part.encode())
    return BUILD_DIR / f"libicl_native-{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library unless already built; returns (path, seconds),
    0.0 seconds when it was taken from the cache.  Raises RuntimeError with
    the compiler's last lines when the build fails."""
    cxx, version = compiler()
    out = library_path(cxx, version)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        tail = "\n".join((proc.stdout + proc.stderr).splitlines()[-20:])
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                           f"{tail}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0


def _load() -> ctypes.CDLL | None:
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed or os.environ.get(OFF_SWITCH) == "1":
        return None
    with _lock:
        if _lib is None and not _load_failed:
            try:
                path, _ = build()
                _lib = _bind(ctypes.CDLL(str(path)))
            except (RuntimeError, OSError, AttributeError) as e:
                # a failed build, a failed dlopen or a library without the
                # symbols bound below: degrade to the Python paths, say so
                # once, and do not try again on every call
                from icl_torch.util.log import LOG

                LOG.warning("native I/O library unusable (%s: %s) — using "
                            "the pure-Python I/O", type(e).__name__, e)
                _load_failed = True
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.feats_parse.restype = ctypes.c_void_p
    lib.feats_parse.argtypes = [ctypes.c_char_p]
    for fn in ("feats_num_examples", "feats_num_entries",
               "feats_id_buffer_size", "feats_num_skipped"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ("feats_needs_python", "featsl_needs_python"):
        getattr(lib, fn).restype = ctypes.c_int32
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ("feats_fallback_line", "featsl_fallback_line",
               "men_fallback_line", "cap_fallback_line"):
        # 1-based line of the first byte the fast path couldn't prove
        # equivalent to Python (-1: none) — demotion diagnostics
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.feats_fill.restype = None
    lib.feats_free.restype = None
    lib.feats_free.argtypes = [ctypes.c_void_p]
    lib.feats_parse_labels.restype = ctypes.c_void_p
    lib.feats_parse_labels.argtypes = [ctypes.c_char_p]
    for fn in ("featsl_num", "featsl_id_buffer_size", "featsl_num_skipped"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.featsl_fill.restype = None
    lib.featsl_fill_labels.restype = None
    lib.featsl_free.restype = None
    lib.featsl_free.argtypes = [ctypes.c_void_p]
    lib.featsl_parse_ids.restype = ctypes.c_void_p
    lib.featsl_parse_ids.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    for fn in ("idt_bad_row", "idt_num_docs", "idt_docs_size",
               "idt_num_padded", "idt_padded_ids_size"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.idt_fill.restype = None
    lib.idt_free.restype = None
    lib.idt_free.argtypes = [ctypes.c_void_p]
    lib.mentions_parse.restype = ctypes.c_void_p
    lib.mentions_parse.argtypes = [ctypes.c_char_p]
    for fn in ("men_num", "men_num_docs", "men_docs_size"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.men_fallback.restype = ctypes.c_int32
    lib.men_fallback.argtypes = [ctypes.c_void_p]
    lib.men_fill.restype = None
    lib.men_free.restype = None
    lib.men_free.argtypes = [ctypes.c_void_p]
    lib.captions_parse.restype = ctypes.c_void_p
    lib.captions_parse.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.captions_words.restype = ctypes.c_void_p
    lib.captions_words.argtypes = [ctypes.c_char_p]
    for fn in ("cap_num", "cap_num_docs", "cap_docs_size", "cap_ids_total",
               "cap_num_flagged", "cap_flagged_bytes"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.cap_fallback.restype = ctypes.c_int32
    lib.cap_fallback.argtypes = [ctypes.c_void_p]
    lib.cap_fill.restype = None
    lib.cap_free.restype = None
    lib.cap_free.argtypes = [ctypes.c_void_p]
    lib.scores_write.restype = ctypes.c_int
    lib.scores_write_chunk.restype = ctypes.c_int
    lib.w2v_load.restype = ctypes.c_void_p
    lib.w2v_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.w2v_vocab.restype = ctypes.c_int64
    lib.w2v_vocab.argtypes = [ctypes.c_void_p]
    lib.w2v_dim.restype = ctypes.c_int32
    lib.w2v_dim.argtypes = [ctypes.c_void_p]
    lib.w2v_words_size.restype = ctypes.c_int64
    lib.w2v_words_size.argtypes = [ctypes.c_void_p]
    lib.w2v_fill.restype = None
    lib.w2v_free.restype = None
    lib.w2v_free.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    return _load() is not None


def warn_demoted(path: str, line: int, what: str = "file") -> None:
    """Tell the user WHY a whole-load fell back to the Python parsers.

    A single unprovable byte (stray non-ASCII, malformed id grammar) in
    millions of rows demotes the load from the C++ fast path to the
    ~4x-slower Python one (correct by design — parity first).  Without
    the first offending line the user has no route back to the fast path."""
    from icl_torch.util.log import LOG

    LOG.warning(
        "%s: native fast-path load demoted to the pure-Python %s parser "
        "(first unprovable byte at line %s) — results are identical but "
        "the load is ~4x slower; run `icl-torch-check` on the data dir to "
        "locate and clean such lines", path, what,
        line if line and line > 0 else "?")
