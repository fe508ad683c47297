"""The port's quantization stack and quantized scorers against the JAX
package's, on the same numpy inputs.

- Bit level, bitwise: `pack_bits` / `unpack_bits` at 1/2/4/8 bits (words
  equal JAX's uint32 words viewed as int32, bit 31 included), binary
  encode and `hamming_packed`.  `dot_packed`, `fwht` and the randomized
  Hadamard (forward, inverse, `as_matrix`, with JAX's signs) within 1e-5.
- Trained quantizers: `train_scalar` within 1e-6 relative; SQ, MinMax and
  spherical codes equal or off by one on <= 0.1% of entries (the float32
  sums run in another order); `lloyd` from JAX's init: centroids within
  1e-4, >= 99.9% equal assignments; `kmeans_pp_init` by property (its
  random stream differs): distinct data rows as centres, inertia after
  `lloyd` within 5% of JAX's; PQ encode with JAX's pivots >= 99.9% equal
  codes, decode bitwise.
- Scorers: PQ (k=256 and k=16), SQ, MinMax and spherical (2 and 4 bits)
  on the same ids and valid mask, for L2, inner product and cosine: the
  same infinite entries, finite ones within 1e-4 relative to the largest
  |distance| of the call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diskann_tpu.graph import scorers as jsc
from diskann_tpu.ops.distance import Metric as JMetric
from diskann_tpu.quant import bits as jbits
from diskann_tpu.quant.kmeans import kmeans_pp_init as jkmeans_pp_init
from diskann_tpu.quant.kmeans import lloyd as jlloyd
from diskann_tpu.quant import transforms as jtr
from diskann_tpu.quant.binary import BinaryQuantizer as JBinary
from diskann_tpu.quant.minmax import MinMaxQuantizer as JMinMax
from diskann_tpu.quant.pq import train_pq as jtrain_pq
from diskann_tpu.quant.scalar import train_scalar as jtrain_scalar
from diskann_tpu.quant.spherical import train_spherical as jtrain_spherical
from diskann_tpu_torch.graph import scorers as tsc
from diskann_tpu_torch.ops.distance import Metric
from diskann_tpu_torch.quant import bits as tbits
from diskann_tpu_torch.quant.kmeans import kmeans, kmeans_pp_init, lloyd
from diskann_tpu_torch.quant import transforms as ttr
from diskann_tpu_torch.quant.binary import BinaryQuantizer
from diskann_tpu_torch.quant.minmax import MinMaxQuantizer
from diskann_tpu_torch.quant.pq import PQ, train_pq
from diskann_tpu_torch.quant.scalar import ScalarQuantizer, train_scalar
from diskann_tpu_torch.quant.spherical import SphericalQuantizer, train_spherical
from torch_port_helpers import n, t

N, D = 1024, 32
METRICS = ("l2", "ip", "cosine")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0xC0DE)
    centers = rng.standard_normal((16, D)).astype(np.float32) * 2
    x = centers[rng.integers(0, 16, N)] + 0.3 * rng.standard_normal((N, D))
    return x.astype(np.float32)


def _words(a) -> np.ndarray:
    """JAX uint32 words as the port holds them."""
    return np.asarray(a).view(np.int32)


def _assert_codes_close(got, want, what):
    """Equal, or off by one on <= 0.1% of entries."""
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1, (what, diff.max())
    assert (diff > 0).mean() <= 1e-3, (what, (diff > 0).mean())


# ------------------------------------------------------------------ bits
@pytest.mark.parametrize("n_bits", [1, 2, 4, 8])
def test_pack_unpack_bits_match_jax(n_bits):
    rng = np.random.default_rng(n_bits)
    dim = 37                                      # a ragged last word
    codes = rng.integers(0, 1 << n_bits, size=(50, dim)).astype(np.uint8)
    codes[0] = (1 << n_bits) - 1                  # bit 31 set in each full word
    want = _words(jbits.pack_bits(jnp.asarray(codes), n_bits))
    got = n(tbits.pack_bits(t(codes), n_bits))
    assert got.dtype == np.int32 and (want[0, :-1] < 0).all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(n(tbits.unpack_bits(t(want), n_bits, dim)),
                                  np.asarray(jbits.unpack_bits(jnp.asarray(want.view(np.uint32)),
                                                               n_bits, dim)))
    np.testing.assert_array_equal(n(tbits.unpack_bits(t(want), n_bits, dim)), codes)
    q = rng.standard_normal((3, dim)).astype(np.float32)
    np.testing.assert_allclose(
        n(tbits.dot_packed(t(q), t(want), n_bits, dim)),
        np.asarray(jbits.dot_packed(jnp.asarray(q), jnp.asarray(want.view(np.uint32)),
                                    n_bits, dim)),
        rtol=1e-5, atol=1e-5)


def test_binary_encode_and_hamming_match_jax(data):
    x = data[:64] - data.mean(0)
    jq, tq = JBinary(D + 3), BinaryQuantizer(D + 3)   # a padded second word
    xx = np.concatenate([x, -np.ones((64, 3), np.float32)], 1)
    xx[0] = 1.0                                       # bit 31 of word 0 set
    want = _words(jq.encode(jnp.asarray(xx)))
    got = n(tq.encode(t(xx)))
    np.testing.assert_array_equal(got, want)
    assert (want[0, 0] < 0)
    ham = np.asarray(jq.hamming(jnp.asarray(want.view(np.uint32)),
                                jnp.asarray(want[::-1].copy().view(np.uint32))))
    np.testing.assert_array_equal(n(tq.hamming(t(want), t(want[::-1].copy()))), ham)
    np.testing.assert_array_equal(
        n(tbits.hamming_packed(t(want), t(want))),
        np.asarray(jbits.hamming_packed(jnp.asarray(want.view(np.uint32)),
                                        jnp.asarray(want.view(np.uint32)))))


# ------------------------------------------------------------ transforms
def test_fwht_and_randomized_hadamard_match_jax(data):
    x = data[:20, :D]
    np.testing.assert_allclose(n(ttr.fwht(t(x))), np.asarray(jtr.fwht(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(ttr.fwht(t(x), normalize=False)),
                               np.asarray(jtr.fwht(jnp.asarray(x), normalize=False)),
                               rtol=1e-5, atol=1e-5)
    jh = jtr.train_randomized_hadamard(jax.random.key(3), 20)
    th = ttr.RandomizedHadamard(signs=t(jh.signs), dim=20)
    y = np.asarray(jh.forward(jnp.asarray(x[:, :20])))
    np.testing.assert_allclose(n(th.forward(t(x[:, :20]))), y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(th.inverse(t(y))), np.asarray(jh.inverse(jnp.asarray(y))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(th.as_matrix()), np.asarray(jh.as_matrix()),
                               rtol=1e-5, atol=1e-5)
    # the port's own draw: +-1 signs, an orthonormal rotation
    own = ttr.train_randomized_hadamard(20, seed=3)
    assert own.signs.shape == (2, 32) and set(n(own.signs).ravel()) == {-1.0, 1.0}
    m = n(own.as_matrix())
    np.testing.assert_allclose(m @ m.T, np.eye(20), atol=1e-5)


# ---------------------------------------------------------- trained quant
def test_train_scalar_and_sq_codes_match_jax(data):
    js = jtrain_scalar(data, n_bits=8, sigma=2.5)
    ts = train_scalar(t(data), n_bits=8, sigma=2.5)
    np.testing.assert_allclose(n(ts.scale), np.asarray(js.scale), rtol=1e-6)
    np.testing.assert_allclose(n(ts.bias), np.asarray(js.bias), rtol=1e-6, atol=1e-6)
    # encode with JAX's range on both sides
    same = ScalarQuantizer(scale=t(js.scale), bias=t(js.bias), n_bits=8)
    _assert_codes_close(n(same.encode(t(data))), np.asarray(js.encode(data)), "sq")
    codes = np.asarray(js.encode(data))
    np.testing.assert_allclose(n(same.decode(t(codes))), np.asarray(js.decode(jnp.asarray(codes))),
                               rtol=1e-6, atol=1e-6)


def test_minmax_codes_match_jax(data):
    jc, jlo, jstep = JMinMax().encode(data)
    tc, tlo, tstep = MinMaxQuantizer().encode(t(data))
    _assert_codes_close(n(tc), np.asarray(jc), "minmax")
    np.testing.assert_array_equal(n(tlo), np.asarray(jlo))
    np.testing.assert_allclose(n(tstep), np.asarray(jstep), rtol=1e-6)


@pytest.mark.parametrize("rotation", ["qr", "hadamard"])
def test_spherical_codes_match_jax(data, rotation):
    js = jtrain_spherical(jax.random.key(5), D, n_bits=4, rotation=rotation)
    ts = SphericalQuantizer(rotation=t(js.rotation), n_bits=4)
    jc = js.encode(data)
    tc = ts.encode(t(data))
    _assert_codes_close(n(tc.codes), np.asarray(jc.codes), "spherical")
    np.testing.assert_allclose(n(tc.norms), np.asarray(jc.norms), rtol=1e-5)
    np.testing.assert_allclose(n(tc.cscale), np.asarray(jc.cscale), rtol=1e-5)
    jp = js.pack(jc)
    tp = ts.pack(tc._replace(codes=t(jc.codes)))
    np.testing.assert_array_equal(n(tp.words), _words(jp.words))
    np.testing.assert_array_equal(n(ts.unpack(tp).codes), np.asarray(jc.codes))
    np.testing.assert_allclose(n(ts.decode(tc._replace(codes=t(jc.codes)))),
                               np.asarray(js.decode(jc)), rtol=1e-4, atol=1e-4)
    q = data[:5] + 0.1
    np.testing.assert_allclose(n(ts.adc_l2(t(q), tp)), np.asarray(js.adc_l2(q, jp)),
                               rtol=1e-4, atol=1e-3)
    # the port's own rotation is orthogonal
    own = train_spherical(D, n_bits=4, rotation=rotation, seed=5).rotation
    np.testing.assert_allclose(n(own @ own.T), np.eye(D), atol=1e-5)


def test_lloyd_matches_jax_from_the_same_init(data):
    init = data[np.random.default_rng(1).choice(N, 24, replace=False)]
    jc, ja = jlloyd(jnp.asarray(data), jnp.asarray(init), iters=10)
    tc, ta = lloyd(t(data), t(init), iters=10)
    np.testing.assert_allclose(n(tc), np.asarray(jc), rtol=1e-4, atol=1e-4)
    assert (n(ta) == np.asarray(ja)).mean() >= 0.999


def test_kmeans_pp_init_by_property(data):
    k = 24
    cent = n(kmeans_pp_init(t(data), k, generator=torch.Generator().manual_seed(2)))
    rows = {tuple(r) for r in data}
    assert len({tuple(c) for c in cent}) == k and all(tuple(c) in rows for c in cent)

    def inertia(c):
        d = ((data[:, None, :] - c[None]) ** 2).sum(-1)
        return d.min(1).sum()

    tc, _ = lloyd(t(data), t(cent), iters=10)
    jinit = jkmeans_pp_init(jax.random.key(2), jnp.asarray(data), k)
    jc, _ = jlloyd(jnp.asarray(data), jinit, iters=10)
    assert inertia(n(tc)) <= 1.05 * inertia(np.asarray(jc))
    c2, a2 = kmeans(t(data), k, seed=2, max_train_points=512)
    assert c2.shape == (k, D) and a2.shape == (512,)


@pytest.mark.parametrize("n_centers", [256, 16])
def test_pq_encode_decode_match_jax(data, n_centers):
    jp = jtrain_pq(jax.random.key(0), data, n_chunks=8, n_centers=n_centers, iters=4)
    tp = PQ(pivots=t(jp.pivots), dim=jp.dim)
    jcodes = np.asarray(jp.encode(data))
    tcodes = n(tp.encode(data))
    assert tcodes.dtype == np.uint8
    assert (tcodes == jcodes).mean() >= 0.999
    np.testing.assert_array_equal(n(tp.decode(t(jcodes))), np.asarray(jp.decode(jcodes)))
    # the port's own training: a distortion close to JAX's
    own = train_pq(t(data), n_chunks=8, n_centers=n_centers, iters=4, seed=0)
    rec = n(own.decode(own.encode(data)))
    jrec = np.asarray(jp.decode(jcodes))
    assert ((rec - data) ** 2).sum() <= 1.10 * ((jrec - data) ** 2).sum()


# --------------------------------------------------------------- scorers
def _ids(seed, b=6, c=40):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N, size=(b, c)).astype(np.int32)
    valid = rng.random((b, c)) > 0.2
    ids[~valid & (rng.random((b, c)) > 0.5)] = -1
    return ids, valid


def _same_scores(jdef, jdata, tdef, tdata, q, seed):
    ids, valid = _ids(seed)
    jq = jdef.prep(jdata, jnp.asarray(q))
    want = np.asarray(jdef.score(jdata, jq, jnp.asarray(ids), jnp.asarray(valid)))
    got = n(tdef.score(tdata, tdef.prep(tdata, t(q)), t(ids), t(valid)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    scale = np.abs(want[fin]).max()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n_centers", [256, 16])
def test_pq_scorer_matches_jax(data, metric, n_centers):
    jp = jtrain_pq(jax.random.key(1), data, n_chunks=8, n_centers=n_centers, iters=3)
    codes = np.asarray(jp.encode(data))
    jdef, jdata = jsc.pq_scorer(jnp.asarray(codes), jp.pivots, JMetric(metric))
    tdef, tdata = tsc.pq_scorer(t(codes), t(jp.pivots), Metric(metric))
    _same_scores(jdef, jdata, tdef, tdata, data[:6] + 0.05, 11)


@pytest.mark.parametrize("metric", METRICS)
def test_sq_scorer_matches_jax(data, metric):
    js = jtrain_scalar(data, n_bits=8, sigma=4.0)
    ci8, bias2 = jsc.sq_center_codes(js.encode(data), js.scale, js.bias)
    aux = jsc.sq_aux_norms(ci8, js.scale)
    tci8, tbias2 = tsc.sq_center_codes(t(js.encode(data)), t(js.scale), t(js.bias))
    np.testing.assert_array_equal(n(tci8), np.asarray(ci8))
    np.testing.assert_array_equal(n(tbias2), np.asarray(bias2))
    np.testing.assert_allclose(n(tsc.sq_aux_norms(tci8, t(js.scale))), np.asarray(aux),
                               rtol=1e-6)
    jdef, jdata = jsc.sq_scorer(ci8, js.scale, bias2, aux, JMetric(metric))
    tdef, tdata = tsc.sq_scorer(t(ci8), t(js.scale), t(bias2), t(aux), Metric(metric))
    _same_scores(jdef, jdata, tdef, tdata, data[:6] + 0.05, 12)


def test_sq_scorer_refuses_inexact_widths():
    tsc.sq_scorer(torch.zeros((4, 1040), dtype=torch.int8), torch.ones(1040),
                  torch.zeros(1040), torch.zeros(4), Metric.L2)
    with pytest.raises(ValueError, match="exact"):
        tsc.sq_scorer(torch.zeros((4, 1041), dtype=torch.int8), torch.ones(1041),
                      torch.zeros(1041), torch.zeros(4), Metric.L2)


@pytest.mark.parametrize("metric", METRICS)
def test_minmax_scorer_matches_jax(data, metric):
    codes, lo, step = JMinMax().encode(data)
    ci8 = (np.asarray(codes).astype(np.int32) - 128).astype(np.int8)
    dec = np.asarray(JMinMax().decode(codes, lo, step))
    aux = (dec * dec).sum(1).astype(np.float32)
    args = (ci8, np.asarray(lo), np.asarray(step), aux)
    jdef, jdata = jsc.minmax_scorer(*map(jnp.asarray, args), JMetric(metric))
    tdef, tdata = tsc.minmax_scorer(*map(t, args), Metric(metric))
    _same_scores(jdef, jdata, tdef, tdata, data[:6] + 0.05, 13)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n_bits", [2, 4])
def test_spherical_scorer_matches_jax(data, metric, n_bits):
    js = jtrain_spherical(jax.random.key(7), D, n_bits=n_bits)
    pc = js.pack(js.encode(data))
    jdef, jdata = jsc.spherical_scorer(pc.words, pc.norms, pc.cscale, js.rotation, D,
                                       n_bits, JMetric(metric))
    tdef, tdata = tsc.spherical_scorer(t(_words(pc.words)), t(pc.norms), t(pc.cscale),
                                       t(js.rotation), D, n_bits, Metric(metric))
    _same_scores(jdef, jdata, tdef, tdata, data[:6] + 0.05, 14)
