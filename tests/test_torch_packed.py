"""The port's packed fat-row layout against the JAX package's.

Given identical codes and adjacency, the word tables must be byte-identical
(allocation, `refresh_rows`, `append_edges`, growth).  `encode` runs a
float32 product whose summation order differs between the frameworks, so
its codes may differ by one at a rounding boundary: at most 0.1% of them.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diskann_tpu.graph import packed as jpk
from diskann_tpu.ops.distance import Metric as JMetric
from diskann_tpu_torch.graph import packed as tpk
from diskann_tpu_torch.ops.distance import Metric
from torch_port_helpers import PACKED_FIELDS, n, t


@pytest.mark.parametrize("dp", [4, 8, 16, 32, 64, 128])
def test_geometry_helpers_match(dp):
    for r_slack in (1, 20, 41, 83, 127, 128, 129, 300):
        rp = jpk.padded_degree(r_slack, dp)
        assert tpk.padded_degree(r_slack, dp) == rp
        assert tpk.id_wrows(rp) == jpk.id_wrows(rp)
        assert tpk.code_wrows(rp, dp) == jpk.code_wrows(rp, dp)
        assert tpk.n_wrows(rp, dp) == jpk.n_wrows(rp, dp)


def test_main_path_geometry():
    # 1M main path: R=64 -> R_slack 83; dp=64 build table, dp=128 search table
    assert (tpk.padded_degree(83, 64), tpk.n_wrows(88, 64)) == (88, 16)
    assert (tpk.padded_degree(83, 128), tpk.n_wrows(84, 128)) == (84, 24)


def _states(cap=256, d=32, dp=16, rs=20, metric="l2"):
    """The same packed state in both packages, codes set from JAX's encode."""
    rng = np.random.default_rng(31)
    sample = rng.standard_normal((256, d)).astype(np.float32)
    jp = jpk.alloc_packed(*jpk.train_packed(sample, dp, JMetric(metric)), cap, rs)
    codes, aux = jpk.encode(
        jp, jnp.asarray(rng.standard_normal((cap, d)).astype(np.float32)),
        JMetric(metric),
    )
    jp = jpk.set_self_codes(jp, jnp.arange(cap, dtype=jnp.int32), codes, aux)
    tp = tpk.PackedState(**{f: t(getattr(jp, f)) for f in PACKED_FIELDS},
                         r_pack=jp.r_pack)
    return rng, jp, tp


def test_train_and_alloc_match():
    rng = np.random.default_rng(2)
    sample = rng.standard_normal((500, 24)).astype(np.float32)
    jt = jpk.train_packed(sample, 12, JMetric.L2, sigma=3.0)
    tt = tpk.train_packed(sample, 12, Metric.L2, sigma=3.0)
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(n(b), np.asarray(a))
    jp = jpk.alloc_packed(*jt, 100, 20)
    tp = tpk.alloc_packed(*tt, 100, 20)
    assert tp.r_pack == jp.r_pack and tp.nwr == jp.nwr
    for f in PACKED_FIELDS:
        np.testing.assert_array_equal(n(getattr(tp, f)), np.asarray(getattr(jp, f)))
    jg, tg = jpk.grow_packed(jp, 160), tpk.grow_packed(tp, 160)
    for f in PACKED_FIELDS:
        np.testing.assert_array_equal(n(getattr(tg, f)), np.asarray(getattr(jg, f)))


def test_word_helpers_match():
    rng = np.random.default_rng(4)
    codes = rng.integers(-128, 128, size=(5, 32)).astype(np.int8)
    words = np.asarray(jpk.codes_to_words(jnp.asarray(codes)))
    np.testing.assert_array_equal(n(tpk.codes_to_words(t(codes))), words)
    np.testing.assert_array_equal(n(tpk.words_to_codes(t(words), 32)), codes)
    x = rng.standard_normal(7).astype(np.float32)
    np.testing.assert_array_equal(n(tpk.f32_to_words(t(x))),
                                  np.asarray(jpk.f32_to_words(jnp.asarray(x))))
    np.testing.assert_array_equal(n(tpk.words_to_f32(tpk.f32_to_words(t(x)))), x)


@pytest.mark.parametrize("dp", [16, 32])
def test_refresh_rows_byte_identical(dp):
    rng, jp, tp = _states(dp=dp)
    cap, rs = jp.self_codes.shape[0], 20
    adj = rng.integers(-1, cap, size=(cap, rs)).astype(np.int32)
    rows = np.concatenate([rng.permutation(cap)[:150], [-1, cap, cap + 7]]).astype(np.int32)
    jr = jpk.refresh_rows(jp, jnp.asarray(adj), jnp.asarray(rows))
    tr = tpk.refresh_rows(tp, t(adj), t(rows))
    live = cap * jp.nwr          # the dump row holds garbage by design
    np.testing.assert_array_equal(n(tr.rows)[:live], np.asarray(jr.rows)[:live])


def test_append_edges_byte_identical():
    # mirror of tests/test_kernels.py::test_append_words_matches_refresh,
    # held against the JAX tables directly
    rng, jp, tp = _states()
    cap, rs = jp.self_codes.shape[0], 20
    e = 2048
    pairs = rng.choice(cap * rs, size=e, replace=False)
    tgt = (pairs // rs).astype(np.int32)
    slot = (pairs % rs).astype(np.int32)
    src = rng.integers(0, cap, size=e).astype(np.int32)
    ok = rng.random(e) > 0.1
    ja = jpk.append_edges(jp, jnp.asarray(tgt), jnp.asarray(slot),
                          jnp.asarray(src), jnp.asarray(ok))
    ta = tpk.append_edges(tp, t(tgt), t(slot), t(src), t(ok))
    live = cap * jp.nwr
    np.testing.assert_array_equal(n(ta.rows)[:live], np.asarray(ja.rows)[:live])
    # and appending one edge per cell writes what a refresh would
    tp2 = dataclasses.replace(tp, rows=tpk._empty_rows(cap + 1, tp.r_pack, tp.dp))
    tp2.self_codes[0] = 0
    adj = np.full((cap, rs), -1, np.int32)
    adj[tgt[ok], slot[ok]] = src[ok]
    via_append = tpk.append_edges(tp2, t(tgt), t(slot), t(src), t(ok)).rows.clone()
    via_refresh = tpk.refresh_rows(tp2, t(adj), torch.arange(cap)).rows
    assert torch.equal(via_append[:live], via_refresh[:live])


def test_layout_helpers_match_jax():
    # row_nbytes, the section offsets, logical_rows, and a table allocated
    # with the reference's writable=False (no guard to lift here)
    _, jp, tp = _states()
    assert (tp.aux_off_w, tp.code_off_w) == (jp.aux_off_w, jp.code_off_w)
    for rp, dp in ((20, 16), (84, 128), (88, 64), (16, 4)):
        assert tpk.row_nbytes(rp, dp) == jpk.row_nbytes(rp, dp)
    np.testing.assert_array_equal(n(tpk.logical_rows(tp)), np.asarray(jpk.logical_rows(jp)))
    jw = jpk.alloc_packed(jp.proj, jp.pscale, jp.pbias2, 64, 20, writable=False)
    tw = tpk.alloc_packed(tp.proj, tp.pscale, tp.pbias2, 64, 20, writable=False)
    for f in PACKED_FIELDS:
        np.testing.assert_array_equal(n(getattr(tw, f)), np.asarray(getattr(jw, f)))


def test_append_edges_deferred_byte_identical():
    rng, jp, tp = _states()
    cap, rs = jp.self_codes.shape[0], 20
    pairs = rng.choice(cap * rs, size=512, replace=False)
    tgt, slot = (pairs // rs).astype(np.int32), (pairs % rs).astype(np.int32)
    src = rng.integers(0, cap, size=512).astype(np.int32)
    ok = rng.random(512) > 0.1
    ja = jpk.append_edges_deferred(jp, tgt, slot, src, ok)
    ta = tpk.append_edges_deferred(tp, tgt, slot, src, ok)
    live = cap * jp.nwr
    np.testing.assert_array_equal(n(ta.rows)[:live], np.asarray(ja.rows)[:live])


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_encode_close_to_jax(metric):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4000, 32)).astype(np.float32)
    jt = jpk.train_packed(x[:1000], 32, JMetric(metric))
    jp = jpk.alloc_packed(*jt, 8, 20)
    tp = tpk.alloc_packed(*(t(a) for a in jt), 8, 20)
    jc, ja = jpk.encode(jp, jnp.asarray(x), JMetric(metric))
    tc, ta = tpk.encode(tp, t(x), Metric(metric))
    jc, tc = np.asarray(jc).astype(np.int32), n(tc).astype(np.int32)
    assert np.abs(jc - tc).max() <= 1
    assert (jc != tc).mean() <= 1e-3
    same = (jc == tc).all(axis=1)
    np.testing.assert_allclose(n(ta)[same], np.asarray(ja)[same], rtol=1e-5)


def test_set_self_codes_skips_negative_slots():
    _, jp, tp = _states(cap=16)
    slots = np.array([3, -1, 7, 20], np.int32)      # 20 >= cap: JAX drops it
    codes = np.full((4, tp.dp), 5, np.int8)
    aux = np.arange(4, dtype=np.float32)
    jr = jpk.set_self_codes(jp, jnp.asarray(slots), jnp.asarray(codes), jnp.asarray(aux))
    keep = slots < 16
    tr = tpk.set_self_codes(tp, t(slots[keep]), t(codes[keep]), t(aux[keep]))
    np.testing.assert_array_equal(n(tr.self_codes), np.asarray(jr.self_codes))
    np.testing.assert_array_equal(n(tr.self_aux), np.asarray(jr.self_aux))
