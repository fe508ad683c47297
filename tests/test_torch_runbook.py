"""The port's streaming runbook executor against the JAX package's.

- `parse_runbook` / `load_runbook` give the JAX package's outputs on a step
  list, a numbered mapping, YAML text and a dataset-nested YAML runbook.
- The churn workload of `tests/test_runbook.py` (insert, delete, insert,
  replace, consolidate, with four search checkpoints), from an empty index
  with the full-precision build: the tag maps and freelists are equal
  after every stage, and every checkpoint's recall is within 0.01 of the
  JAX package's.  The graphs are not bitwise equal here: at this data's
  norms two neighbours' float32 distances can lie ~1e-4 apart, the two
  frameworks sum them in different orders, and a near-tied pair swaps
  places in a row (first in the third insert batch); later batches build
  on that.  They still hold the same entry at >= 99% of adjacency cells.
- Importing the port's runbook module does not import PyYAML (the card's
  host may not have it).
"""

import subprocess
import sys

import numpy as np
import pytest

from diskann_tpu import GraphConfig as JConfig
from diskann_tpu import GraphIndex as JIndex
from diskann_tpu.bench.runbook import RunbookExecutor as JExecutor
from diskann_tpu.bench.runbook import load_runbook as j_load
from diskann_tpu_torch import GraphConfig, GraphIndex
from diskann_tpu_torch.bench.runbook import RunbookExecutor, load_runbook, parse_runbook
from torch_port_helpers import CPU, n

NESTED = """
sift-1M:
  max_pts: 500
  1: {operation: insert, start: 0, end: 100}
  2: {operation: search}
  gt_url: none
"""


@pytest.mark.parametrize("runbook", [
    [{"operation": "insert", "start": 0, "end": 10}],
    {"2": {"operation": "search"}, "1": {"operation": "insert", "start": 0, "end": 5}},
    "steps:\n  - {operation: insert, start: 0, end: 100}\n  - {operation: search}\n",
    NESTED,
])
def test_load_runbook_matches_jax(runbook):
    assert tuple(load_runbook(runbook)) == tuple(j_load(runbook))
    assert parse_runbook(runbook) == j_load(runbook).steps


def test_nested_runbook_needs_a_dataset_name():
    two = {"a": {"1": {"operation": "search"}}, "b": {"1": {"operation": "search"}}}
    with pytest.raises(ValueError):
        load_runbook(two)
    assert load_runbook(two, dataset="b").name == "b"


def test_churn_workload_matches_jax(rng):
    d = 16
    centers = rng.standard_normal((20, d)).astype(np.float32) * 2
    data = centers[rng.integers(0, 20, size=1600)] + 0.15 * rng.standard_normal(
        (1600, d)).astype(np.float32)
    queries = centers[rng.integers(0, 20, size=40)] + 0.15 * rng.standard_normal(
        (40, d)).astype(np.float32)
    cfg = dict(max_degree=16, l_build=32)
    steps = [
        {"operation": "insert", "start": 0, "end": 800},
        {"operation": "search"},
        {"operation": "delete", "start": 0, "end": 300},
        {"operation": "search"},
        {"operation": "insert", "start": 800, "end": 1300},
        {"operation": "search"},
        # tags 300..500 (live) re-point at dataset rows 1300..1500
        {"operation": "replace", "tags_start": 300, "tags_end": 500,
         "ids_start": 1300, "ids_end": 1500},
        {"operation": "consolidate"},
        {"operation": "search"},
    ]
    jidx = JIndex(d, JConfig(**cfg), capacity=1024, insert_batch_size=256)
    tidx = GraphIndex(d, GraphConfig(**cfg), capacity=1024, insert_batch_size=256,
                      device=CPU)
    jex = JExecutor(jidx, data, queries, k=10, l_search=48)
    tex = RunbookExecutor(tidx, data, queries, k=10, l_search=48)
    for step in steps:
        jlog, tlog = jex.run([step]), tex.run([step])
        assert tex.tag_to_id == jex.tag_to_id and tex.tag_to_row == jex.tag_to_row
        same = (n(tidx.state.adjacency) == np.asarray(jidx.state.adjacency)).mean()
        assert same >= 0.99, (step, same)
        assert tidx.free_slots == jidx.free_slots
    jr = [e["recall"] for e in jlog if e["operation"] == "search"]
    tr = [e["recall"] for e in tlog if e["operation"] == "search"]
    assert len(tr) == 4 and np.allclose(tr, jr, atol=0.01), (tr, jr)
    assert [e.get("count") for e in tlog] == [e.get("count") for e in jlog]
    assert min(tr) >= 0.85, tr
    assert tidx.n <= 1800 and tidx.n == jidx.n      # the replace recycled slots


def test_runbook_module_imports_without_yaml():
    code = ("import sys; import diskann_tpu_torch.bench.runbook; "
            "sys.exit(1 if 'yaml' in sys.modules else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
