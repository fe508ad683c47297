"""The control: the exact search put in the program's place, with the same
four calls as `annbench.system.Port`, computing its distances in a lower
precision than the configuration states.

Its slots behave as the port's do (deleted slots reused last freed,
first reused, then fresh ones), so the harness drives it unchanged.  In
float32 it is the reference itself; ``precision="tf32"`` rounds every
vector and query to TF32's 10 mantissa bits before the float32 product,
as a TF32 matrix unit does, and ``"bf16"`` computes in bfloat16, the
product's output too: the control of a configuration whose vectors lie on
the uint8 grid, which TF32 inputs and a float32 product hold exactly.

Given the base rows' tags (``labels``, CSR), it is the exact filtered
search: a search step takes each query's predicate, and only the rows that
match it (`annbench.reference.exact.matches`).
"""

from __future__ import annotations

import numpy as np
import torch

from annbench.manifest import serve_kw
from annbench.reference.exact import matches, no_tf32, wire

_CHUNK = 131072   # rows scored at once


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), as float32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class Exact:
    def __init__(self, cfg: dict, base: torch.Tensor, labels=None, *,
                 precision: str = "tf32"):
        if precision not in ("float32", "tf32", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        no_tf32()
        b = cfg["build"]
        cap = max(b.get("capacity") or 0, base.shape[0])
        self.x = torch.zeros((cap, base.shape[1]), device=base.device)
        self.x[: base.shape[0]] = base
        self.valid = torch.zeros(cap, dtype=torch.bool, device=base.device)
        self.valid[: base.shape[0]] = True
        self.n = base.shape[0]
        self.free: list[int] = []
        self.k = cfg["k"]
        self.query_dtype = serve_kw(cfg).get("query_dtype")
        self.precision = precision
        self.labels = labels

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        if self.precision == "tf32":
            return round_tf32(t)
        if self.precision == "bf16":
            return t.bfloat16()
        return t.float()

    def search(self, queries: np.ndarray, preds: np.ndarray | None = None):
        q = wire(torch.as_tensor(queries, device=self.x.device), self.query_dtype)
        qc = self._cast(q)
        p = None if preds is None else torch.as_tensor(preds, device=self.x.device)
        best_d, best_i = [], []
        for n0 in range(0, self.n, _CHUNK):
            x = self.x[n0:min(n0 + _CHUNK, self.n)]
            xc = self._cast(x)
            dots = (qc @ xc.T).float()
            d = (q * q).sum(-1, keepdim=True) + (x * x).sum(-1)[None, :] - 2.0 * dots
            d = torch.where(self.valid[n0:n0 + x.shape[0]][None, :], d, float("inf"))
            if p is not None:
                d.masked_fill_(~matches(self.labels, p, n0, n0 + x.shape[0]), float("inf"))
            v, i = torch.topk(d, min(self.k, x.shape[0]), dim=1, largest=False)
            best_d.append(v)
            best_i.append(i + n0)
        d, i = torch.cat(best_d, 1), torch.cat(best_i, 1)
        d, j = torch.topk(d, self.k, dim=1, largest=False)
        ids = torch.gather(i, 1, j)
        ids = torch.where(torch.isfinite(d), ids, -1)
        return (d.cpu().numpy(), ids.cpu().numpy(),
                np.zeros(q.shape[0], np.int64))

    def insert(self, vectors: torch.Tensor) -> np.ndarray:
        if self.labels is not None:
            raise NotImplementedError("inserted rows would come without tags")
        m = vectors.shape[0]
        reuse = min(len(self.free), m)
        slots = np.empty(m, np.int64)
        if reuse:
            slots[:reuse] = self.free[-reuse:][::-1]
            del self.free[-reuse:]
        slots[reuse:] = np.arange(self.n, self.n + m - reuse)
        self.n += m - reuse
        s = torch.as_tensor(slots, device=self.x.device)
        self.x[s] = vectors.float()
        self.valid[s] = True
        return slots

    def delete(self, slots: np.ndarray) -> None:
        s = torch.as_tensor(np.asarray(slots, np.int64), device=self.x.device)
        self.valid[s] = False
        self.free.extend(int(v) for v in np.asarray(slots))

    def close(self) -> None:
        self.x = self.valid = None
