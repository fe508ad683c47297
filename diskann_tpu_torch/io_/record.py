"""Versioned save/load: JSON manifest + binary side-car artifacts.

Replaces `diskann-record` (`diskann-record/src/lib.rs:6-62`): a checkpoint is
a directory holding ``manifest.json`` (format version, type tag, metadata,
artifact table) plus one raw binary file per array.  Loaders dispatch on the
manifest version with an upgrade chain for legacy formats (`load_legacy`)."""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np

FORMAT_VERSION = 1


def save_record(path: str, kind: str, meta: dict, arrays: dict[str, np.ndarray],
                *, bfloat16=()):
    """``bfloat16``: names of arrays that hold bfloat16 values as their raw
    uint16 bits; the manifest names their dtype "bfloat16", as numpy with
    ml_dtypes does."""
    os.makedirs(path, exist_ok=True)
    artifacts = {}
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        fname = f"{name}.bin"
        arr.tofile(os.path.join(path, fname))
        artifacts[name] = {
            "file": fname,
            "dtype": "bfloat16" if name in bfloat16 else str(arr.dtype),
            "shape": list(arr.shape),
        }
    manifest = {
        "format_version": FORMAT_VERSION,
        "kind": kind,
        "meta": meta,
        "artifacts": artifacts,
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


# version -> upgrade fn(manifest) -> manifest at version+1
_UPGRADES: dict[int, Callable[[dict], dict]] = {}


def register_upgrade(from_version: int):
    def deco(fn):
        _UPGRADES[from_version] = fn
        return fn

    return deco


def load_record(path: str, *, mmap: bool = False):
    """Returns (manifest, arrays). Upgrades legacy manifests in memory."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    v = manifest.get("format_version", 0)
    while v < FORMAT_VERSION:
        if v not in _UPGRADES:
            raise ValueError(f"no upgrade path from record version {v}")
        manifest = _UPGRADES[v](manifest)
        v = manifest["format_version"]
    arrays = {}
    for name, info in manifest["artifacts"].items():
        fpath = os.path.join(path, info["file"])
        # bfloat16 comes back as its raw uint16 bits: numpy knows the type
        # only through ml_dtypes
        dtype = np.uint16 if info["dtype"] == "bfloat16" else np.dtype(info["dtype"])
        shape = tuple(info["shape"])
        if mmap:
            arrays[name] = np.memmap(fpath, dtype=dtype, mode="r", shape=shape)
        else:
            arrays[name] = np.fromfile(fpath, dtype=dtype).reshape(shape)
    return manifest, arrays
