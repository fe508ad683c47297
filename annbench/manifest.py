"""`BENCHMARK.json` and the files it names, found by name:

- a configuration ``<c>``: ``annbench/configs/<c>.json`` (the cell's
  ``config`` entry names the file too);
- a traffic mix ``<m>``: ``annbench/traffic/<m>.json``, read by
  `annbench.driver`;
- a metric ``<x>``, end-to-end or per-layer: ``annbench/metrics/<x>.py``, a
  reader with ``UNIT`` (and, per layer, ``LAYER`` and ``MOVES``) and
  ``read(run)``, which returns the number or None when it finds nothing
  to read.
"""

from __future__ import annotations

import copy
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over`` laid on it, nested dicts key by key."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Bench:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((HERE / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, kind: str) -> list[dict]:
        """The ``kind`` ("end_to_end" or "per_layer") metrics ``cell``
        reports: those that list it, and those that list no cells but move
        (per layer) an end-to-end metric the cell reports."""
        e2e = [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]
        if kind == "end_to_end":
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def serve_kw(cfg: dict) -> dict:
    """The keyword arguments of a configuration's search: ``serve.filtered``
    for a filtered configuration (one with a ``labels`` block), else
    ``serve.search``."""
    return cfg["serve"]["filtered" if "labels" in cfg else "search"]


def reader(name: str):
    """The reader module of metric ``name``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "annbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
