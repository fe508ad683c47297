"""The port's vector dtypes other than float32 against the JAX package's.

- The four cases of `test_dtypes.py::test_dtype_build_search_recall`
  (float16, int8, uint8 and bfloat16 at n=900, d=16): one JAX index per
  dtype, carried across with its vectors in their own dtype, searches
  with bitwise-equal ids and distances within 1e-5 relative, plus an
  absolute 1e-6 of the largest |q|^2: the queries sit 0.01 from a row,
  where |q|^2 + |x|^2 - 2 q.x cancels to ~1e-3, below a few float32 ulps
  of the norms, and the two frameworks sum the products in different
  orders; the port's
  own build of the same data stores that dtype and reaches JAX's recall
  less 0.01.
- Integer dtypes saturate out-of-range values as JAX's cast does (a torch
  cast wraps around): the stored rows and norms are JAX's.
- The int8 delete and insert cycle, carried across: the same freelist
  slots, the stored dtype kept, equal ids and no deleted id returned.
- A float16 and a bfloat16 record saved by JAX load in the port (the
  bfloat16 vectors as raw uint16 bits: the card's host has no
  ml_dtypes), search like JAX's own load, the port's rewrite is JAX's
  record byte for byte, and JAX loads it.
- The uint8 fbin round trip.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diskann_tpu import FlatIndex as JFlat
from diskann_tpu import GraphConfig as JConfig
from diskann_tpu import GraphIndex as JIndex
from diskann_tpu import Metric as JMetric
from diskann_tpu.bench.recall import knn_recall
from diskann_tpu_torch import GraphConfig, GraphIndex
from diskann_tpu_torch.convert import graph_index_from_arrays
from diskann_tpu_torch.io_ import fbin
from torch_port_helpers import CPU, jax_index_arrays

CASES = {
    "f16": (jnp.float16, torch.float16,
            lambda rng, n, d: (rng.standard_normal((n, d)) * 2).astype(np.float16)),
    "i8": (jnp.int8, torch.int8,
           lambda rng, n, d: rng.integers(-100, 100, (n, d)).astype(np.int8)),
    "u8": (jnp.uint8, torch.uint8,
           lambda rng, n, d: rng.integers(0, 250, (n, d)).astype(np.uint8)),
    # bf16 has no numpy dtype without ml_dtypes: ingest float32
    "bf16": (jnp.bfloat16, torch.bfloat16,
             lambda rng, n, d: (rng.standard_normal((n, d)) * 2).astype(np.float32)),
}
CFG = dict(max_degree=12, l_build=24)


def _same(got, want, what, q):
    np.testing.assert_array_equal(got[1], want[1], err_msg=f"ids differ: {what}")
    atol = 1e-6 * float((q.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def built():
    """Per dtype: (data, queries, groundtruth, JAX index)."""
    out = {}
    for name, (jdt, _, gen) in CASES.items():
        rng = np.random.default_rng(0xD15CA)
        x = gen(rng, 900, 16)
        q = x[:40].astype(np.float32) + 0.01
        _, gt = JFlat(x.astype(np.float32), JMetric.L2).search(q, k=10)
        j = JIndex.build(x, JConfig(**CFG), insert_batch_size=256, dtype=jdt)
        out[name] = (x, q, gt, j)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_dtype_search_matches_jax(built, case):
    x, q, gt, j = built[case]
    p = graph_index_from_arrays(**jax_index_arrays(j))
    assert p.state.vectors.dtype == p.dtype == CASES[case][1]
    want = j.search(q, k=10, l_search=32)
    got = p.search(q, k=10, l_search=32)
    _same(got, want, case, q)
    assert knn_recall(got[1], gt, 10) >= 0.9


@pytest.mark.parametrize("case", list(CASES))
def test_dtype_port_build_recall(built, case):
    x, q, gt, j = built[case]
    p = GraphIndex.build(x, GraphConfig(**CFG), insert_batch_size=256,
                         dtype=CASES[case][1], device=CPU)
    assert p.state.vectors.dtype == CASES[case][1]
    want = knn_recall(j.search(q, k=10, l_search=32)[1], gt, 10)
    got = knn_recall(p.search(q, k=10, l_search=32)[1], gt, 10)
    assert got >= min(want - 0.01, 0.9), (got, want)


def test_dtype_names_are_accepted():
    for name in ("float16", np.float16, torch.float16):
        assert GraphIndex(8, GraphConfig(**CFG), dtype=name, device=CPU).dtype == torch.float16
    assert GraphIndex(8, dtype="bfloat16", device=CPU).state.vectors.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="vector dtype"):
        GraphIndex(8, dtype=np.float64, device=CPU)


@pytest.mark.parametrize("case", ["i8", "u8"])
def test_integer_vectors_saturate_like_jax(case):
    jdt, tdt, _ = CASES[case]
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((64, 8)) * 150).astype(np.float32)     # past the range
    x[:4, 0] = [2.7, -2.7, 127.9, -0.5]
    j = JIndex.build(x, JConfig(**CFG), insert_batch_size=64, dtype=jdt)
    p = GraphIndex.build(x, GraphConfig(**CFG), insert_batch_size=64, dtype=tdt, device=CPU)
    np.testing.assert_array_equal(p.state.vectors[:64].numpy(), np.asarray(j.state.vectors[:64]))
    np.testing.assert_array_equal(p.state.sq_norms[:64].numpy(), np.asarray(j.state.sq_norms[:64]))


def test_i8_delete_and_insert_cycle_matches_jax():
    rng = np.random.default_rng(0xD15CA)
    x = rng.integers(-100, 100, (700, 12)).astype(np.int8)
    j = JIndex.build(x, JConfig(**CFG), insert_batch_size=256, dtype=jnp.int8)
    p = graph_index_from_arrays(**jax_index_arrays(j))
    dead = rng.choice(700, size=100, replace=False)
    more = rng.integers(-100, 100, (50, 12)).astype(np.int8)
    j.delete(dead)
    p.delete(dead)
    slots = p.insert(more)          # the freelist recycles deleted slots
    np.testing.assert_array_equal(slots, j.insert(more))
    assert p.state.vectors.dtype == torch.int8
    np.testing.assert_array_equal(p.state.vectors[slots].numpy(), more)
    still_dead = np.setdiff1d(dead, slots)
    qx = x[:10].astype(np.float32)
    got = p.search(qx, k=5, l_search=24)
    _same(got, j.search(qx, k=5, l_search=24), "i8 after delete + insert", qx)
    assert not np.isin(got[1][got[1] >= 0], still_dead).any()


@pytest.mark.parametrize("case", ["f16", "bf16"])
def test_records_cross_both_ways(case, tmp_path):
    jdt, tdt, gen = CASES[case]
    rng = np.random.default_rng(0xD15CA)
    x = gen(rng, 600, 12)
    j = JIndex.build(x, JConfig(**CFG), insert_batch_size=256, dtype=jdt)
    q = x[:16].astype(np.float32)
    j.save(str(tmp_path / "j"))
    jl = JIndex.load(str(tmp_path / "j"))
    want = jl.search(q, k=5, l_search=24)

    p = GraphIndex.load(str(tmp_path / "j"), device=CPU)
    assert p.state.vectors.dtype == tdt
    _same(p.search(q, k=5, l_search=24), want, f"{case}: JAX record in the port", q)

    p.save(str(tmp_path / "p"))
    jm = json.loads((tmp_path / "j" / "manifest.json").read_text())
    pm = json.loads((tmp_path / "p" / "manifest.json").read_text())
    assert pm["meta"]["dtype"] == jm["meta"]["dtype"] == jnp.dtype(jdt).name
    for name, info in jm["artifacts"].items():
        assert pm["artifacts"][name] == info, name
        assert ((tmp_path / "p" / info["file"]).read_bytes()
                == (tmp_path / "j" / info["file"]).read_bytes()), name

    back = JIndex.load(str(tmp_path / "p"))
    assert back.state.vectors.dtype == jdt
    _same(back.search(q, k=5, l_search=24), want, f"{case}: port record in JAX", q)
    again = GraphIndex.load(str(tmp_path / "p"), device=CPU)
    _same(again.search(q, k=5, l_search=24), want, f"{case}: port round trip", q)


def test_u8_fbin_roundtrip(tmp_path):
    rng = np.random.default_rng(0xD15CA)
    x = rng.integers(0, 255, (64, 8)).astype(np.uint8)
    p = str(Path(tmp_path) / "u8.fbin")
    fbin.write_fbin(p, x)
    back = fbin.read_fbin(p, dtype=np.uint8)
    assert back.dtype == np.uint8
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(fbin.read_fbin(str(Path(tmp_path) / "u8.fbin"),
                                                 dtype=np.uint8, mmap=True), x)
