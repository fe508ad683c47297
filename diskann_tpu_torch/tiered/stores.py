"""External vector stores pluggable under the tiered index.

The reference treats "connect DiskANN to your storage engine" as a
first-class extension point and ships `diskann-bftree` as the exemplar: a
DataProvider over a buffered B-tree research store (`diskann-bftree/src/
lib.rs:6-35`, provider `src/provider.rs`).  Here the equivalent boundary is
the `HostVectorStore` duck type consumed by `TieredIndex` — anything with
``n``, ``dim``, ``fetch``, ``fetch_async``, ``fetch_wait`` serves the
full-precision rerank tier.

`SqliteVectorStore` is the in-tree second exemplar: vectors live as BLOB
rows in a SQLite B-tree (stdlib `sqlite3`, no native deps), i.e. a real
database page cache under the index instead of a flat mmap'd file.  It
exists to PROVE the boundary (and to serve small/medium datasets from a
file a DBA can query); the mmap/io_uring `HostVectorStore` remains the
fast path.
"""

from __future__ import annotations

import sqlite3
import threading

import numpy as np


class SqliteVectorStore:
    """Full-precision vectors in a SQLite table (the bftree-exemplar
    analogue).  Schema: ``vectors(id INTEGER PRIMARY KEY, v BLOB)`` with
    one f32 row per point."""

    def __init__(self, path: str, *, dim: int | None = None):
        self._path = path
        self._local = threading.local()
        con = self._con()
        con.execute(
            "CREATE TABLE IF NOT EXISTS vectors ("
            "id INTEGER PRIMARY KEY, v BLOB NOT NULL)"
        )
        con.execute(
            "CREATE TABLE IF NOT EXISTS meta (k TEXT PRIMARY KEY, v TEXT)"
        )
        con.commit()
        row = con.execute("SELECT v FROM meta WHERE k='dim'").fetchone()
        if row is not None:
            self.dim = int(row[0])
            if dim is not None and dim != self.dim:
                raise ValueError(f"store dim {self.dim} != requested {dim}")
        else:
            if dim is None:
                raise ValueError("new store needs dim=")
            self.dim = dim
            con.execute(
                "INSERT INTO meta VALUES ('dim', ?)", (str(dim),)
            )
            con.commit()
        self.source_path = path

    def _con(self) -> sqlite3.Connection:
        # sqlite3 connections are not thread-safe; fetch_async runs on a
        # worker thread, so keep one connection per thread
        con = getattr(self._local, "con", None)
        if con is None:
            con = sqlite3.connect(self._path)
            self._local.con = con
        return con

    # ------------------------------------------------------------- writes
    @classmethod
    def from_array(cls, path: str, vectors: np.ndarray) -> "SqliteVectorStore":
        vectors = np.ascontiguousarray(vectors, np.float32)
        store = cls(path, dim=vectors.shape[1])
        store.put(np.arange(len(vectors)), vectors)
        return store

    def put(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        vectors = np.ascontiguousarray(vectors, np.float32)
        con = self._con()
        con.executemany(
            "INSERT OR REPLACE INTO vectors VALUES (?, ?)",
            ((int(i), v.tobytes()) for i, v in zip(ids, vectors)),
        )
        con.commit()

    # -------------------------------------------------------------- reads
    @property
    def n(self) -> int:
        return self._con().execute("SELECT COUNT(*) FROM vectors").fetchone()[0]

    def fetch(self, ids: np.ndarray) -> np.ndarray:
        """Batched row gather (the HostVectorStore contract): out-of-range
        or missing ids clamp to zero vectors, matching the tiered rerank's
        masking of invalid ids."""
        ids = np.asarray(ids)
        flat = ids.reshape(-1)
        out = np.zeros((len(flat), self.dim), np.float32)
        con = self._con()
        # chunked IN() queries (SQLite caps bound parameters)
        uniq, inv = np.unique(flat, return_inverse=True)
        rows: dict[int, bytes] = {}
        step = 512
        for off in range(0, len(uniq), step):
            seg = [int(i) for i in uniq[off : off + step] if i >= 0]
            if not seg:
                continue
            marks = ",".join("?" * len(seg))
            for rid, blob in con.execute(
                f"SELECT id, v FROM vectors WHERE id IN ({marks})", seg
            ):
                rows[rid] = blob
        for j, u in enumerate(uniq):
            blob = rows.get(int(u))
            if blob is not None:
                out[inv == j] = np.frombuffer(blob, np.float32)
        return out.reshape(ids.shape + (self.dim,))

    def fetch_async(self, ids: np.ndarray):
        """Async gather on a worker thread (pairs with fetch_wait) — the
        staging-pipeline contract `TieredIndex.search_batched` drives."""
        import concurrent.futures

        pool = getattr(self, "_pool", None)
        if pool is None:
            pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
            self._pool = pool
        ids = np.asarray(ids)
        return ("future", ids.shape, pool.submit(self.fetch, ids.reshape(-1)))

    def fetch_wait(self, handle) -> np.ndarray:
        kind, shape, fut = handle
        return fut.result().reshape(shape + (self.dim,))

    def close(self) -> None:
        con = getattr(self._local, "con", None)
        if con is not None:
            con.close()
            self._local.con = None
