"""The port's search modes (`graph/modes.py`) and the search options they
ride on against the JAX package's.

One JAX index is built per module (n=1200 x 16 clustered, R=16, L=32,
W=2) with a packed layout (dp=16), and carried across by `convert.py`
with JAX's start point.

- `beam_search_scored` with ``reserve``, with the in-traversal diversity
  quota (ring, best-list and merge dedup; full-precision and packed
  scorers) and with ``merge_trunc``: ids, `cmps` and hops bitwise,
  distances within 1e-5.
- `diverse_topk_device` and `determinant_diversity_device` on tie-free
  random data: bitwise.
- `range_search` on the resume route and the restart route (full and
  packed): the same id sets and completeness flags as JAX.
- `PagedSearch` in full and packed mode: the same pages.
- `search_diverse` on both ``enforce`` routes and `determinant_rerank`:
  the same ids.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from diskann_tpu import GraphConfig as JConfig
from diskann_tpu import GraphIndex as JIndex
from diskann_tpu.graph import modes as jmodes
from diskann_tpu.graph import scorers as jsc
from diskann_tpu.graph.search import beam_search_scored as jbeam
from diskann_tpu_torch.bench.harness import make_clustered
from diskann_tpu_torch.convert import graph_index_from_arrays
from diskann_tpu_torch.graph import modes as tmodes
from diskann_tpu_torch.graph import scorers as tsc
from diskann_tpu_torch.graph.search import beam_search_scored as tbeam
from torch_port_helpers import jax_index_arrays, n, t

N, D, NQ = 1200, 16, 24


@pytest.fixture(scope="module")
def setup():
    x, q = make_clustered(31, N, NQ, D, n_clusters=16, sigma=0.35)
    j = JIndex.build(x, JConfig(max_degree=16, l_build=32, beam_width=2),
                     insert_batch_size=512)
    j.attach_packed(dp=16)
    p = graph_index_from_arrays(**jax_index_arrays(j), insert_batch_size=512)
    # JAX keeps the medoid it took while building; the copy would derive
    # it from all rows
    p._auto_start = t(np.asarray(j._start()))
    attrs = np.random.default_rng(4).integers(0, 6, size=p.state.capacity).astype(np.int32)
    return x, q, j, p, attrs


# --------------------------------------------------------- search options
CASES = {
    "reserve_ring": dict(scorer="full", l_search=16, reserve=24, dedup="ring"),
    "quota_ring": dict(scorer="full", l_search=24, diverse_l=3, dedup="ring"),
    "quota_packed_list": dict(scorer="packed", l_search=24, diverse_l=3, dedup="list"),
    "quota_packed_merge": dict(scorer="packed", l_search=24, diverse_l=3, dedup="merge"),
    "merge_trunc_full": dict(scorer="full", l_search=12, merge_trunc=True, dedup="list",
                             beam_width=4),
    "merge_trunc_packed": dict(scorer="packed", l_search=16, merge_trunc=True,
                               dedup="list", beam_width=4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_beam_search_options_match_jax(setup, case):
    _, q, j, p, attrs = setup
    kw = dict(CASES[case])
    scorer = kw.pop("scorer")
    kw.setdefault("beam_width", 2)
    if scorer == "full":
        jdef, jdata = jsc.full_precision_scorer(j.state.vectors, j.state.sq_norms, j.config.metric)
        tdef, tdata = tsc.full_precision_scorer(p.state.vectors, p.state.sq_norms, p.metric)
    else:
        jdef, jdata = jsc.packed_scorer(j.packed, j.config.metric)
        tdef, tdata = tsc.packed_scorer(p.packed, p.metric)
        kw["expand_r"] = p.packed.r_pack
    jkw, tkw = dict(kw), dict(kw)
    if "diverse_l" in kw:
        jkw["diverse_attrs"] = jnp.asarray(attrs)
        tkw["diverse_attrs"] = t(attrs)
    start = np.asarray(j._start())
    want = jbeam(jdef, jdata, j.state.adjacency, jnp.asarray(start), jnp.asarray(q), **jkw)
    got = tbeam(tdef, tdata, p.state.adjacency, t(start), t(q), **tkw)
    np.testing.assert_array_equal(n(got.ids), np.asarray(want.ids))
    np.testing.assert_array_equal(n(got.cmps), np.asarray(want.cmps))
    np.testing.assert_array_equal(n(got.hops), np.asarray(want.hops))
    np.testing.assert_allclose(n(got.dists), np.asarray(want.dists), rtol=1e-5, atol=1e-5)
    ids = n(got.ids)
    if "diverse_l" in kw:          # the quota holds in every returned list
        for row in ids:
            _, counts = np.unique(attrs[row[row >= 0]], return_counts=True)
            assert counts.max() <= kw["diverse_l"]
    if "reserve" in kw:            # the reserve slots hold scored candidates
        assert ids.shape[1] == kw["l_search"] + kw["reserve"]
        assert (ids[:, kw["l_search"]:] >= 0).any()


# ------------------------------------------------------- device selections
def test_diverse_topk_device_matches_jax():
    rng = np.random.default_rng(3)
    b, l, k, quota = 6, 40, 8, 2
    dists = np.sort(rng.random((b, l)).astype(np.float32), axis=1)
    ids = np.stack([rng.choice(500, size=l, replace=False) for _ in range(b)]).astype(np.int32)
    ids[:, -5:] = -1
    dists[:, -5:] = np.inf
    attrs = rng.integers(0, 7, size=512).astype(np.int32)
    wd, wi = jmodes.diverse_topk_device(jnp.asarray(dists), jnp.asarray(ids),
                                        jnp.asarray(attrs), k, quota)
    gd, gi = tmodes.diverse_topk_device(t(dists), t(ids), t(attrs), k, quota)
    np.testing.assert_array_equal(n(gi), np.asarray(wi))
    np.testing.assert_array_equal(n(gd), np.asarray(wd))
    hd, hi = tmodes.diverse_topk(dists, ids, attrs, k, quota)
    np.testing.assert_array_equal(hi, np.asarray(wi).astype(np.int64))


@pytest.mark.parametrize("power,eta", [(1.5, 0.0), (1.0, 0.5)])
def test_determinant_diversity_device_matches_jax(power, eta):
    rng = np.random.default_rng(11)
    b, c, d, k = 4, 24, 8, 6
    vecs = rng.standard_normal((b, c, d)).astype(np.float32)
    dists = np.sort(rng.random((b, c)).astype(np.float32), axis=1)
    valid = np.ones((b, c), bool)
    valid[:, -3:] = False
    want = jmodes.determinant_diversity_device(jnp.asarray(vecs), jnp.asarray(dists),
                                               jnp.asarray(valid), k, power=power, eta=eta)
    got = tmodes.determinant_diversity_device(t(vecs), t(dists), t(valid), k,
                                              power=power, eta=eta)
    np.testing.assert_array_equal(n(got), np.asarray(want))


# ---------------------------------------------------------------- modes
@pytest.mark.parametrize("route", ["full_resume", "full_restart", "packed_restart"])
def test_range_search_matches_jax(setup, route):
    x, q, j, p, _ = setup
    d2 = ((q[:8, None, :] - x[None]) ** 2).sum(-1)
    radius = float(np.median(np.sort(d2, 1)[:, 20]))
    kw = dict(l_init=16, mode="packed" if route.startswith("packed") else "full",
              resume=route == "full_resume", return_complete=True)
    want, wc = jmodes.range_search(j, q[:8], radius, **kw)
    got, gc = tmodes.range_search(p, q[:8], radius, **kw)
    np.testing.assert_array_equal(gc, wc)
    for a, b in zip(got, want):
        assert a.dtype == np.int64
        assert set(a.tolist()) == set(b.tolist())
    assert sum(len(a) for a in got) > 8 * 10


@pytest.mark.parametrize("mode", ["full", "packed"])
def test_paged_search_matches_jax(setup, mode):
    _, q, j, p, _ = setup
    for qi in (0, 5):
        jp = jmodes.PagedSearch(j, q[qi], l_search=16, mode=mode)
        tp = tmodes.PagedSearch(p, q[qi], l_search=16, mode=mode)
        seen = set()
        for _ in range(5):
            wd, wi = jp.next_page(6)
            gd, gi = tp.next_page(6)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5)
            assert not seen & set(gi.tolist())
            seen |= set(gi.tolist())
        assert len(seen) == 30
        np.testing.assert_array_equal(n(tp.state.cmps), np.asarray(jp.state.cmps))


@pytest.mark.parametrize("mode", ["full", "packed"])
@pytest.mark.parametrize("enforce", ["post", "traversal"])
def test_search_diverse_matches_jax(setup, enforce, mode):
    _, q, j, p, attrs = setup
    kw = dict(k=6, max_per_attribute=2, l_search=32, mode=mode, enforce=enforce)
    wd, wi, ws = jmodes.search_diverse(j, q, attrs, **kw)
    gd, gi, gs = tmodes.search_diverse(p, q, attrs, **kw)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(gs.cmps, np.asarray(ws.cmps))
    for row in gi:
        _, counts = np.unique(attrs[row[row >= 0]], return_counts=True)
        assert counts.max() <= 2


@pytest.mark.parametrize("mode", ["full", "packed"])
def test_determinant_rerank_matches_jax(setup, mode):
    _, q, j, p, _ = setup
    kw = dict(k=5, l_search=32, power=2.0, mode=mode)
    wd, wi, _ = jmodes.determinant_rerank(j, q, **kw)
    gd, gi, _ = tmodes.determinant_rerank(p, q, **kw)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5)
    assert all(len(set(row.tolist())) == 5 for row in gi)
