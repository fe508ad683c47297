"""The port's quantized search modes against the JAX package's.

One JAX index is built per module (n=2000 x 24 clustered, R=16, L=32,
W=4, router on) with every quantizer attached (SQ, MinMax, spherical
4-bit, PQ 8-bit, and 4-bit PQ swapped in per case), and carried across
by `convert.py` with its trained state.

- `convert.py` carries every attachment bitwise (code tables, ranges,
  pivots, rotation; spherical words as int32 with the same bits), and
  `index_arrays` takes them back out of the port unchanged.
- `search(mode=...)` for pq (k=256 and k=16), sq, minmax and spherical at
  W=4 (best-list dedup) and W=1 (ring dedup): ids, `cmps` and hops
  bitwise equal (every mode is, on this data; the looser bars of >= 99%
  identical (query, rank) ids and equal `cmps` for >= 99% of queries stay
  checked too), distances within 1e-5.
- The port's own `attach_sq` / `attach_minmax` / `attach_pq(pq=...)` on
  the same vectors: codes equal or off by one on <= 0.1% of entries.
- The same searches at W=4 with the queries through the int8 wire
  (``query_dtype="i8"``) and through bfloat16: ids, `cmps` and hops
  bitwise JAX's with the same ``query_dtype``.
- `search_filtered(mode="sq")` and the other quantized modes take the
  full-precision route, as in JAX: the same ids as JAX.
- An insert grows the code tables without encoding the new rows (the
  reference's behaviour).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diskann_tpu import GraphConfig as JConfig
from diskann_tpu import GraphIndex as JIndex
from diskann_tpu_torch import FlatIndex
from diskann_tpu_torch.bench.harness import make_clustered
from diskann_tpu_torch.bench.recall import knn_recall
from diskann_tpu_torch.convert import graph_index_from_arrays, index_arrays
from diskann_tpu_torch.quant.pq import PQ
from torch_port_helpers import CPU, jax_index_arrays, n, t

N, D, NQ = 2000, 24, 64
CFG = dict(max_degree=16, l_build=32, beam_width=4)
MODES = ("pq", "pq4", "sq", "minmax", "spherical")


@pytest.fixture(scope="module")
def setup():
    x, q = make_clustered(21, N, NQ, D, n_clusters=24, sigma=0.35)
    j = JIndex.build(x, JConfig(**CFG), insert_batch_size=512)
    j.attach_sq()
    j.attach_minmax()
    j.attach_spherical(n_bits=4, seed=1)
    j.attach_pq(n_chunks=12, n_centers=16, seed=2)
    pq4 = j.pq
    j.attach_pq(n_chunks=8, seed=3)
    return x, q, j, {"pq": j.pq, "pq4": pq4}


def _with_pq(j, pqs, mode):
    """The JAX index with the PQ of `mode` attached (no retraining)."""
    want = pqs["pq4" if mode == "pq4" else "pq"]
    if j.pq is not want:
        j.attach_pq(want)
    return "pq" if mode == "pq4" else mode


def _port(j, **kw):
    """The port's copy of JAX index j, with JAX's start point: JAX keeps
    the medoid it took while building (of the rows committed by then),
    where the copy derives it from all rows."""
    p = graph_index_from_arrays(**jax_index_arrays(j), insert_batch_size=512, **kw)
    p._auto_start = t(np.asarray(j._start()))
    return p


def test_convert_carries_every_attachment(setup):
    _, _, j, pqs = setup
    _with_pq(j, pqs, "pq")
    p = _port(j)
    pairs = {"pq_codes": j.pq_codes, "sq_codes": j.sq_codes, "sq_aux": j.sq_aux,
             "sq_bias2": j.sq_bias2, "mm_codes": j.mm_codes, "mm_lo": j.mm_lo,
             "mm_step": j.mm_step, "mm_aux": j.mm_aux, "sph_norms": j.sph_norms,
             "sph_cscale": j.sph_cscale}
    for name, want in pairs.items():
        got = n(getattr(p, name))
        assert got.dtype == np.asarray(want).dtype, name
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
    np.testing.assert_array_equal(n(p.sph_words), np.asarray(j.sph_words).view(np.int32))
    np.testing.assert_array_equal(n(p.pq.pivots), np.asarray(j.pq.pivots))
    np.testing.assert_array_equal(n(p.sq.scale), np.asarray(j.sq.scale))
    np.testing.assert_array_equal(n(p.sph.rotation), np.asarray(j.sph.rotation))
    assert (p.pq.dim, p.sq.n_bits, p.sph.n_bits) == (j.pq.dim, j.sq.n_bits, j.sph.n_bits)
    # and back out of the port (`index_arrays`, the card-to-CPU copy)
    back = graph_index_from_arrays(**index_arrays(p), device=CPU, insert_batch_size=512)
    for name in list(pairs) + ["sph_words"]:
        np.testing.assert_array_equal(n(getattr(back, name)), n(getattr(p, name)), err_msg=name)
    for a, b in ((back.pq.pivots, p.pq.pivots), (back.sq.bias, p.sq.bias),
                 (back.sph.rotation, p.sph.rotation), (back.packed.rows, p.packed.rows)
                 if p.packed is not None else (back.state.adjacency, p.state.adjacency)):
        np.testing.assert_array_equal(n(a), n(b))
    with pytest.raises(ValueError, match="rows"):
        kw = jax_index_arrays(j)
        kw["sq"] = dict(kw["sq"], codes=np.asarray(j.sq_codes)[:-1])
        graph_index_from_arrays(**kw)


@pytest.mark.parametrize("w", [4, 1])
@pytest.mark.parametrize("mode", MODES)
def test_quant_search_matches_jax(setup, mode, w):
    _, q, j, pqs = setup
    m = _with_pq(j, pqs, mode)
    p = _port(j)
    kw = dict(l_search=32, beam_width=w, mode=m)
    jd, ji, js = j.search(q, 10, **kw)
    td, ti, ts = p.search(q, 10, **kw)
    assert (ti == ji).mean() >= 0.99, (mode, (ti == ji).mean())
    assert (ts.cmps == js.cmps).mean() >= 0.99, mode
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts.cmps, js.cmps)
    np.testing.assert_array_equal(ts.hops, js.hops)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wire", ["i8", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_quant_search_query_wire_matches_jax(setup, mode, wire):
    _, q, j, pqs = setup
    m = _with_pq(j, pqs, mode)
    p = _port(j)
    kw = dict(l_search=32, beam_width=4, mode=m)
    jd, ji, js = j.search(q, 10, query_dtype=jnp.bfloat16 if wire == "bfloat16" else wire,
                          **kw)
    td, ti, ts = p.search(q, 10, query_dtype=wire, **kw)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts.cmps, js.cmps)
    np.testing.assert_array_equal(ts.hops, js.hops)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)


def test_port_attach_encodes_like_jax(setup):
    x, q, j, pqs = setup
    _with_pq(j, pqs, "pq")
    kw = jax_index_arrays(j)
    for name in ("pq", "sq", "minmax", "spherical"):
        kw.pop(name)
    p = graph_index_from_arrays(**kw)

    def close(got, want, what):
        diff = np.abs(n(got).astype(np.int64) - np.asarray(want).astype(np.int64))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, what

    p.attach_sq()
    close(p.sq_codes, j.sq_codes, "sq")
    np.testing.assert_allclose(n(p.sq_aux), np.asarray(j.sq_aux), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(n(p.sq_bias2), np.asarray(j.sq_bias2), rtol=1e-5, atol=1e-5)
    p.attach_minmax()
    close(p.mm_codes, j.mm_codes, "minmax")
    np.testing.assert_allclose(n(p.mm_step), np.asarray(j.mm_step), rtol=1e-6)
    p.attach_pq(PQ(pivots=t(j.pq.pivots), dim=j.pq.dim))
    assert (n(p.pq_codes) == np.asarray(j.pq_codes)).mean() >= 0.999
    p.attach_spherical(n_bits=4, seed=1)
    rot = n(p.sph.rotation)
    np.testing.assert_allclose(rot @ rot.T, np.eye(D), atol=1e-5)
    assert p.sph_words.shape == j.sph_words.shape and p.sph_words.dtype == torch.int32
    # the port's own attachments walk as well as JAX's (its rotation is
    # another draw, so spherical is held by recall, not by ids)
    _, gt = FlatIndex(x, device=CPU).search(q, 10)
    for mode in ("sq", "minmax", "pq", "spherical"):
        _, ti, _ = p.search(q, 10, l_search=32, mode=mode)
        _, ji, _ = j.search(q, 10, l_search=32, mode=mode)
        if mode != "spherical":
            assert (ti == ji).mean() >= 0.99, mode
        assert knn_recall(ti, gt, 10) >= knn_recall(ji, gt, 10) - 0.03, mode


@pytest.mark.parametrize("mode", ["sq", "pq", "minmax", "spherical"])
def test_filtered_quant_modes_take_the_full_route(setup, mode):
    _, q, j, pqs = setup
    _with_pq(j, pqs, "pq")
    labels = [[f"cat{i % 7}"] for i in range(N)]
    j.attach_labels(labels)
    p = _port(j)
    kw = dict(l_search=32, scan_threshold=0, mode=mode)
    jd, ji, _ = j.search_filtered(q, "cat3", 10, **kw)
    td, ti, _ = p.search_filtered(q, "cat3", 10, **kw)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
    _, fi, _ = p.search_filtered(q, "cat3", 10, l_search=32, scan_threshold=0, mode="full")
    np.testing.assert_array_equal(ti, fi)
    with pytest.raises(ValueError, match="unknown search mode"):
        p.search_filtered(q, "cat3", 10, mode="nope")


def test_insert_grows_the_code_tables_without_encoding(setup):
    x, q, j, pqs = setup
    _with_pq(j, pqs, "pq")
    p = _port(j)
    cap0 = p.state.capacity
    new, _ = make_clustered(22, cap0 - N + 100, 1, D, n_clusters=24, sigma=0.35)
    slots = p.insert(new)
    cap = p.state.capacity
    assert cap > cap0 and slots.max() >= cap0
    for name in ("pq_codes", "sq_codes", "sq_aux", "mm_codes", "mm_lo", "mm_step",
                 "mm_aux", "sph_words", "sph_norms", "sph_cscale"):
        table = n(getattr(p, name))
        assert table.shape[0] == cap, name
        fill = 1.0 if name == "mm_step" else 0
        assert (table[cap0:] == fill).all(), name
    # rows below the old capacity keep their codes; new rows encode nothing
    np.testing.assert_array_equal(n(p.sq_codes)[:N], np.asarray(j.sq_codes)[:N])
    np.testing.assert_array_equal(n(p.sq_codes)[slots[slots >= cap0]], 0)
    for mode in ("sq", "pq", "minmax", "spherical"):
        _, ids, _ = p.search(q, 10, l_search=32, mode=mode)
        assert ids.shape == (NQ, 10) and (ids >= 0).all()
