"""Readers/writers for the standard ANN dataset binary formats.

- ``.fbin`` / ``.u8bin`` / ``.i8bin``: ``[npts:i32][dim:i32]`` header followed
  by row-major data (the BigANN / DiskANN dataset format; the reference reads
  these via `diskann-utils/src/io.rs`).
- ``.fvecs`` / ``.ivecs``: per-row ``[dim:i32][row data]`` (TexMex SIFT format).

All readers return numpy arrays (host side); moving to device is the caller's
choice so large datasets can stay in host RAM for the tiered store.
"""

from __future__ import annotations

import os

import numpy as np

_BIN_DTYPES = {
    ".fbin": np.float32,
    ".u8bin": np.uint8,
    ".i8bin": np.int8,
    ".ibin": np.int32,
}


def read_fbin(path: str, dtype=None, *, mmap: bool = False) -> np.ndarray:
    """Read a [npts][dim] header binary file. dtype inferred from extension
    unless given explicitly."""
    if dtype is None:
        ext = os.path.splitext(path)[1]
        dtype = _BIN_DTYPES.get(ext, np.float32)
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=np.int32, count=2)
        npts, dim = int(header[0]), int(header[1])
    itemsize = np.dtype(dtype).itemsize
    expected = 8 + npts * dim * itemsize
    actual = os.path.getsize(path)
    if actual < expected:
        raise ValueError(
            f"{path}: header says {npts}x{dim} ({expected} bytes) but file has {actual}"
        )
    if mmap:
        data = np.memmap(path, dtype=dtype, mode="r", offset=8, shape=(npts, dim))
    else:
        with open(path, "rb") as f:
            f.seek(8)
            data = np.fromfile(f, dtype=dtype, count=npts * dim).reshape(npts, dim)
    return data


def write_fbin(path: str, data: np.ndarray) -> None:
    data = np.ascontiguousarray(data)
    with open(path, "wb") as f:
        np.array([data.shape[0], data.shape[1]], dtype=np.int32).tofile(f)
        data.tofile(f)


def read_knn_groundtruth(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a DiskANN knn groundtruth .bin: ``[n:u32][k:u32]`` then ``n*k``
    u32 ids then ``n*k`` f32 distances (reference loader:
    `diskann-benchmark/src/utils/datafiles.rs:96-128`).
    Returns (ids [n, k] int32, dists [n, k] float32)."""
    with open(path, "rb") as f:
        n, k = (int(v) for v in np.fromfile(f, dtype=np.uint32, count=2))
        ids = np.fromfile(f, dtype=np.uint32, count=n * k).reshape(n, k)
        dists = np.fromfile(f, dtype=np.float32, count=n * k)
    dists = (
        dists.reshape(n, k)
        if dists.size == n * k
        else np.zeros((n, k), np.float32)   # dists are optional in the wild
    )
    return ids.astype(np.int32), dists


def write_knn_groundtruth(path: str, ids: np.ndarray, dists=None) -> None:
    ids = np.ascontiguousarray(ids)
    n, k = ids.shape
    if dists is None:
        dists = np.zeros((n, k), np.float32)
    with open(path, "wb") as f:
        np.array([n, k], dtype=np.uint32).tofile(f)
        ids.astype(np.uint32).tofile(f)
        np.ascontiguousarray(dists, dtype=np.float32).tofile(f)


def read_range_groundtruth(path: str) -> list[np.ndarray]:
    """Read a DiskANN range groundtruth file (``.rangeres``):
    ``[n:u32][total:u32]`` then ``n`` u32 per-query result counts then
    ``total`` u32 ids (distances follow; unused — reference drops them too,
    `datafiles.rs:137-168`).  Returns a ragged list of id arrays."""
    with open(path, "rb") as f:
        n, total = (int(v) for v in np.fromfile(f, dtype=np.uint32, count=2))
        sizes = np.fromfile(f, dtype=np.uint32, count=n)
        ids = np.fromfile(f, dtype=np.uint32, count=total)
    out = []
    off = 0
    for s in sizes:
        out.append(ids[off : off + int(s)].astype(np.int32))
        off += int(s)
    return out


def write_range_groundtruth(path: str, per_query_ids: list[np.ndarray]) -> None:
    sizes = np.array([len(r) for r in per_query_ids], np.uint32)
    flat = (
        np.concatenate([np.asarray(r, np.uint32) for r in per_query_ids])
        if per_query_ids and sizes.sum()
        else np.empty((0,), np.uint32)
    )
    with open(path, "wb") as f:
        np.array([len(per_query_ids), int(sizes.sum())], np.uint32).tofile(f)
        sizes.tofile(f)
        flat.tofile(f)
        np.zeros((int(sizes.sum()),), np.float32).tofile(f)  # distances


def is_lfs_pointer(path: str) -> bool:
    """True if `path` is a git-lfs pointer stub rather than real data (the
    reference's test_data binaries ship as LFS pointers)."""
    try:
        with open(path, "rb") as f:
            return f.read(12).startswith(b"version http")
    except OSError:
        return True


def _read_vecs(path: str, dtype) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.int32)
    if raw.size == 0:
        return np.empty((0, 0), dtype=dtype)
    dim = int(raw[0])
    row_ints = dim * np.dtype(dtype).itemsize // 4 + 1
    if raw.size % row_ints != 0:
        raise ValueError(f"{path}: not a valid vecs file (dim={dim})")
    mat = raw.reshape(-1, row_ints)
    return mat[:, 1:].view(dtype)


def read_fvecs(path: str) -> np.ndarray:
    return _read_vecs(path, np.float32)


def read_ivecs(path: str) -> np.ndarray:
    return _read_vecs(path, np.int32)
