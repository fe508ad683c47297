"""Build and load the hand-written CUDA kernels of `csrc/`.

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, into ``diskann_tpu_torch/_build/<hash>/``, keyed by a hash
of the sources and the compiler flags, so a fresh checkout builds itself and
a rebuilt source never loads a stale library.  A failed compile raises with
the compiler's stderr; a good one leaves ptxas's report (registers, shared
memory and spills of every kernel) beside the library, read by
`ptxas_report`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
# compile-only: ptxas prints each kernel's registers, shared memory and spills
REPORT_FLAGS = ("-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argument types.  Every entry point returns the
# launch's cudaError_t (0 = success) as an int.
_SIGNATURES = {
    # rows, n_rows, beam, qiw, bw, rp, dp, the plan (slots a stage, stages,
    # warps, blocks, stage stride, shared bytes), ids_out, aux_out,
    # dots_out, stream
    "fatrow_expand_launch": (_P, _L, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P, _P, _P, _P),
    # table, n_blocks, block_idx, vals, g, block_bytes, stream
    "block_patch_launch": (_P, _L, _P, _P, _L, _L, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / "libdiskann_kernels.so"


def build() -> Path:
    """Compile the kernels if the library for these sources is missing."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as work:
        jobs = []
        for src in _sources():
            cmd = [_nvcc(), *NVCC_FLAGS, *REPORT_FLAGS, "-c", "-o",
                   os.path.join(work, src.stem + ".o"), str(src)]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.PIPE, text=True)))
        report = []
        for cmd, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                for _, other in jobs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{err}")
            report.append(err)
        (out.parent / "ptxas.txt").write_text("".join(report))
        # link to a private name, then rename: a concurrent build never
        # loads a half-written library
        tmp = os.path.join(work, "lib.so")
        cmd = [_nvcc(), *LINK_FLAGS, "-o", tmp,
               *(os.path.join(work, p.stem + ".o") for p in _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def ptxas_report() -> str:
    """ptxas's report of the last build of these sources ("" if none)."""
    path = library_path().parent / "ptxas.txt"
    return path.read_text() if path.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            lib.diskann_cuda_error_string.argtypes = [ctypes.c_int]
            lib.diskann_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = library().diskann_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: error {err} ({msg})")
