"""Native C++ host IO: mmap'd vector files, batched row gather, LRU row cache
(port of `diskann_tpu/native/__init__.py`).

`hostio.cpp` is a byte-for-byte copy of the JAX package's source: a plain C
ABI bound here with ctypes.  It serves the tiered index's host tier: the
full-precision rows of a `.fbin` file, gathered by a thread pool (at once,
or submitted and waited for), optionally through an LRU cache of hot rows
or io_uring batched reads.

The library is compiled with ``g++`` at first use into
``diskann_tpu_torch/_build/<hash>/libhostio.so``, keyed by a hash of the
source and the flags, so a fresh checkout builds itself and a changed
source never loads a stale library.  `get_lib` returns None where no
compiler is found; `HostVectorStore.from_fbin` then reads the file with
numpy instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "hostio.cpp"
_BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_P, _L = ctypes.c_void_p, ctypes.c_int64
# C entry points: name -> (restype, argtypes)
_SIGNATURES = {
    "hio_open": (_P, [ctypes.c_char_p, _L]),
    "hio_rows": (_L, [_P]),
    "hio_dim": (_L, [_P]),
    "hio_gather": (None, [_P, _P, _L, _P, _L]),
    "hio_close": (None, [_P]),
    "hio_cache_create": (_P, [_P, _L]),
    "hio_gather_cached": (None, [_P, _P, _P, _L, _P]),
    "hio_cache_hits": (_L, [_P]),
    "hio_cache_misses": (_L, [_P]),
    "hio_cache_destroy": (None, [_P]),
    "hio_pipe_create": (_P, [_L]),
    "hio_pipe_submit": (_L, [_P, _P, _P, _L, _P]),
    "hio_pipe_wait": (None, [_P, _L]),
    "hio_pipe_destroy": (None, [_P]),
    "hio_uring_create": (_P, [_L]),
    "hio_uring_gather": (_L, [_P, _P, _P, _L, _P]),
    "hio_uring_destroy": (None, [_P]),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def library_path() -> Path:
    """Where the library for the current source lives (built or not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_ROOT / f"hostio-{h.hexdigest()[:16]}" / "libhostio.so"


def build() -> Path:
    """Compile the library if the one for this source is missing; raises
    with the compiler's stderr on failure."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    with tempfile.TemporaryDirectory(dir=out.parent) as work:
        tmp = os.path.join(work, "libhostio.so")
        cmd = ["g++", *CXX_FLAGS, "-o", tmp, str(_SRC), "-lpthread"]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL | None:
    """The loaded library (built on first use), or None where it cannot be
    built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            try:
                lib = ctypes.CDLL(str(build()))
            except (OSError, RuntimeError, subprocess.SubprocessError):
                return None
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _lib = lib
        return _lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeVectorFile:
    """mmap'd [n][dim] binary file (8-byte header) with a threaded batched
    row gather, an optional LRU cache of ``cache_rows`` rows, an async
    submit/wait pipe, and io_uring reads on request (``uring=True``; where
    the kernel refuses the ring, gathers use the mmap path).  Ids outside
    [0, n) are clamped to the nearest row."""

    def __init__(self, path: str, elem_size: int = 4, *, cache_rows: int = 0,
                 threads: int | None = None, uring: bool = False,
                 uring_depth: int = 256):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native hostio unavailable (no g++?)")
        self._lib = lib
        self.path = path
        self._h = lib.hio_open(path.encode(), elem_size)
        if not self._h:
            raise OSError(f"hio_open failed for {path}")
        self.n = lib.hio_rows(self._h)
        self.dim = lib.hio_dim(self._h)
        self.elem_size = elem_size
        self.threads = threads or min(8, os.cpu_count() or 1)
        self._cache = lib.hio_cache_create(self._h, cache_rows) if cache_rows else None
        self._uring = (lib.hio_uring_create(uring_depth) if uring else None) or None
        self._pipe = None

    @property
    def uring_active(self) -> bool:
        return self._uring is not None

    def _out(self, count: int) -> np.ndarray:
        dt = np.float32 if self.elem_size == 4 else np.uint8
        return np.empty((count, self.dim), dt)

    def gather(self, ids) -> np.ndarray:
        """Rows ``ids`` as a [len(ids), dim] array: through the cache when
        there is one, else io_uring when active, else the thread pool."""
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        out = self._out(ids.size)
        lib = self._lib
        if self._cache:
            lib.hio_gather_cached(self._h, self._cache, _ptr(ids), ids.size, _ptr(out))
        elif self._uring is not None:
            if lib.hio_uring_gather(self._uring, self._h, _ptr(ids), ids.size, _ptr(out)):
                # a ring that failed mid-flight holds stale completions: drop
                # it and read through the mmap from now on
                lib.hio_uring_destroy(self._uring)
                self._uring = None
                lib.hio_gather(self._h, _ptr(ids), ids.size, _ptr(out), self.threads)
        else:
            lib.hio_gather(self._h, _ptr(ids), ids.size, _ptr(out), self.threads)
        return out

    @property
    def cache_stats(self) -> dict | None:
        if not self._cache:
            return None
        return {"hits": self._lib.hio_cache_hits(self._cache),
                "misses": self._lib.hio_cache_misses(self._cache)}

    def gather_async(self, ids):
        """Submit a row gather to the worker pipe; returns the handle for
        `wait`.  Submit batch i+1's gather, work on batch i, then wait."""
        if self._pipe is None:
            self._pipe = self._lib.hio_pipe_create(self.threads)
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        out = self._out(ids.size)
        ticket = self._lib.hio_pipe_submit(self._pipe, self._h, _ptr(ids), ids.size,
                                           _ptr(out))
        return (ticket, ids, out)   # ids and out stay alive until the wait

    def wait(self, handle) -> np.ndarray:
        ticket, _ids, out = handle
        self._lib.hio_pipe_wait(self._pipe, ticket)
        return out

    def close(self) -> None:
        lib = self._lib
        if self._uring:
            lib.hio_uring_destroy(self._uring)
            self._uring = None
        if self._pipe:
            lib.hio_pipe_destroy(self._pipe)
            self._pipe = None
        if self._cache:
            lib.hio_cache_destroy(self._cache)
            self._cache = None
        if self._h:
            lib.hio_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
