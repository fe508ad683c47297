"""Parity of the port's distance and top-k ops with the JAX package.

Same numpy inputs through `diskann_tpu.ops` and `diskann_tpu_torch.ops`.
Float distances agree within rtol 1e-5 / atol 1e-4 (the two frameworks sum
float32 products in different orders); ids, masks and ranks are equal.
"""

import numpy as np
import pytest

import diskann_tpu.ops.distance as jd
import diskann_tpu.ops.topk as jt
import diskann_tpu_torch.ops.distance as td
import diskann_tpu_torch.ops.topk as tt
from torch_port_helpers import n, t

RTOL, ATOL = 1e-5, 1e-4
METRICS = [m.value for m in td.Metric]


def test_metric_members_match():
    assert [(m.name, m.value) for m in td.Metric] == [
        (m.name, m.value) for m in jd.Metric
    ]
    for m in td.Metric:
        assert m.needs_norms == jd.Metric(m.value).needs_norms


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("shared_db", [True, False])
def test_distance_to_set_parity(metric, shared_db):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((6, 24)).astype(np.float32)
    x = rng.standard_normal((40, 24) if shared_db else (6, 9, 24)).astype(np.float32)
    want = jd.distance_to_set(q, x, jd.Metric(metric))
    got = td.distance_to_set(t(q), t(x), td.Metric(metric))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    # precomputed norms take the same path
    xsq, qsq = td.squared_norms(t(x)), td.squared_norms(t(q))
    got2 = td.distance_to_set(t(q), t(x), td.Metric(metric),
                              x_sq_norms=xsq, q_sq_norms=qsq)
    np.testing.assert_allclose(n(got2), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_distance_parity(metric):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, 7, 16)).astype(np.float32)
    b = rng.standard_normal((2, 11, 16)).astype(np.float32)
    m_j, m_t = jd.Metric(metric), td.Metric(metric)
    np.testing.assert_allclose(
        n(td.pairwise_distance(t(a[0]), t(b[0]), m_t)),
        np.asarray(jd.pairwise_distance(a[0], b[0], m_j)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        n(td.pairwise_distance(t(a), t(b), m_t)),
        np.asarray(jd.pairwise_distance(a, b, m_j)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ["l2", "cosine_normalized"])
def test_norms_and_preprocess_parity(metric):
    x = np.random.default_rng(5).standard_normal((9, 12)).astype(np.float32)
    np.testing.assert_allclose(n(td.squared_norms(t(x))),
                               np.asarray(jd.squared_norms(x)), rtol=RTOL)
    np.testing.assert_allclose(
        n(td.preprocess_for_metric(t(x), td.Metric(metric))),
        np.asarray(jd.preprocess_for_metric(x, jd.Metric(metric))), rtol=RTOL)


def _lists(rng, b=5, l=12, c=17):
    best_d = np.sort(rng.random((b, l)).astype(np.float32), axis=1)
    best_d[:, -3:] = np.inf
    best_i = rng.permutation(b * l).reshape(b, l).astype(np.int32)
    cd = rng.random((b, c)).astype(np.float32)
    cd[:, ::5] = np.inf
    ci = rng.integers(0, 1000, size=(b, c)).astype(np.int32)
    return best_d, best_i, cd, ci


def test_topk_smallest_parity():
    d, i, cd, ci = _lists(np.random.default_rng(6))
    for want, got in zip(jt.topk_smallest(cd, ci, 7), tt.topk_smallest(t(cd), t(ci), 7)):
        np.testing.assert_array_equal(n(got), np.asarray(want))


def test_merge_sorted_parity():
    best_d, best_i, cd, ci = _lists(np.random.default_rng(7))
    pe = np.arange(best_d.size, dtype=np.int32).reshape(best_d.shape)
    ce = -np.arange(cd.size, dtype=np.int32).reshape(cd.shape)
    want = jt.merge_sorted(best_d, best_i, cd, ci, 12, pe, ce)
    got = tt.merge_sorted(t(best_d), t(best_i), t(cd), t(ci), 12, t(pe), t(ce))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(n(g), np.asarray(w))


def test_merge_into_sorted_parity():
    best_d, best_i, cd, ci = _lists(np.random.default_rng(8))
    be = np.zeros(best_d.shape, np.int32)
    ce = np.ones(cd.shape, np.int32)
    want = jt.merge_into_sorted(best_d, best_i, be, cd, ci, ce)
    got = tt.merge_into_sorted(t(best_d), t(best_i), t(be), t(cd), t(ci), t(ce))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(n(g), np.asarray(w))


def test_duplicate_masks_and_grouped_ranks_parity():
    rng = np.random.default_rng(9)
    ids = rng.integers(-1, 6, size=(4, 20)).astype(np.int32)
    np.testing.assert_array_equal(
        n(tt.mask_duplicates_any_order(t(ids))),
        np.asarray(jt.mask_duplicates_any_order(ids)))
    s = np.sort(ids, axis=1)
    np.testing.assert_array_equal(
        n(tt.mask_duplicates_sorted(t(s))), np.asarray(jt.mask_duplicates_sorted(s)))
    np.testing.assert_array_equal(
        n(tt.grouped_ranks(t(ids))), np.asarray(jt.grouped_ranks(ids)))


def test_sort_lex_matches_two_key_sort():
    import jax

    rng = np.random.default_rng(10)
    k1 = rng.integers(0, 4, size=(3, 30)).astype(np.float32)
    k2 = rng.integers(-5, 5, size=(3, 30)).astype(np.int32)
    want = jax.lax.sort((k1, k2), dimension=-1, num_keys=2)
    got = tt.sort_lex(t(k1), t(k2))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(n(g), np.asarray(w))


@pytest.mark.parametrize("c,m", [(40, 12), (332, 668), (3403, 332), (7, 1)])
def test_isin_rows_matches_broadcast_compare(c, m):
    # the ring, reseed and multihop membership test of the search loop: the
    # same mask as the reference's broadcast compare, on rows with repeats,
    # -1 pads and the sort-to-the-end sentinel
    rng = np.random.default_rng(c + m)
    x = rng.integers(-1, 60, size=(5, c)).astype(np.int32)
    ref = rng.integers(-1, 60, size=(5, m)).astype(np.int32)
    x[:, ::9] = tt.SENTINEL
    ref[0] = -1
    ref[1, : m // 2] = tt.SENTINEL
    want = (x[:, :, None] == ref[:, None, :]).any(-1)
    np.testing.assert_array_equal(n(tt.isin_rows(t(x), t(ref))), want)
    fresh = np.asarray(jt.mask_duplicates_sorted(np.sort(x, 1)))
    got_fresh = n(tt.mask_duplicates_sorted(t(np.sort(x, 1))))
    np.testing.assert_array_equal(got_fresh, fresh)
