"""Property-based tests of the port (`tests/test_property.py`'s three,
on the same hypothesis strategies): each property held by the port's
function, and the port's values held to the JAX package's on the same
draw.

XLA on the CPU flushes subnormal floats to zero and torch keeps them, so
a draw of -1e-45 is a negative sign bit to the port and a zero (>= 0) to
JAX.  The port is held to JAX on the draw with its subnormals flushed
(`_ftz`), and to each property on the draw as it is."""

import numpy as np
from hypothesis import given, settings, strategies as st

from diskann_tpu.ops.distance import Metric as JMetric
from diskann_tpu.ops.distance import pairwise_distance as j_pairwise_distance
from diskann_tpu.quant.binary import BinaryQuantizer as JBinary
from diskann_tpu.quant.minmax import MinMaxQuantizer as JMinMax
from diskann_tpu_torch.ops.distance import Metric, pairwise_distance
from diskann_tpu_torch.quant.binary import BinaryQuantizer
from diskann_tpu_torch.quant.minmax import MinMaxQuantizer
from torch_port_helpers import n, t

_finite = st.floats(-100, 100, allow_nan=False, width=32)


def _ftz(x: np.ndarray) -> np.ndarray:
    """``x`` with its subnormals flushed to a zero of the same sign."""
    return np.where(np.abs(x) < np.finfo(np.float32).tiny, np.copysign(0.0, x), x
                    ).astype(np.float32)


@settings(max_examples=20, deadline=None)
@given(
    st.lists(st.lists(_finite, min_size=4, max_size=4), min_size=2, max_size=6)
)
def test_l2_metric_axioms(rows):
    x = np.array(rows, np.float32)
    d = n(pairwise_distance(t(x), t(x), Metric.L2))
    assert (d >= 0).all()
    assert np.allclose(d, d.T, atol=1e-2)
    assert np.allclose(np.diag(d), 0, atol=1e-2)
    # the matmul form cancels to within a few float32 ulps of the norms
    d = n(pairwise_distance(t(_ftz(x)), t(_ftz(x)), Metric.L2))
    want = np.asarray(j_pairwise_distance(x, x, JMetric.L2))
    sq = (x.astype(np.float64) ** 2).sum(1)
    assert (np.abs(d - want) <= 1e-5 * np.abs(want) + 1e-6 * (sq[:, None] + sq[None, :])).all()


@settings(max_examples=20, deadline=None)
@given(
    st.lists(st.lists(_finite, min_size=8, max_size=8), min_size=1, max_size=5)
)
def test_minmax_roundtrip_bounded(rows):
    x = np.array(rows, np.float32)
    codes, lo, step = MinMaxQuantizer().encode(t(x))
    rec = n(MinMaxQuantizer().decode(codes, lo, step))
    bound = n(step)[:, None] * 0.51 + 1e-5
    assert (np.abs(rec - x) <= bound).all()
    codes, lo, step = MinMaxQuantizer().encode(t(_ftz(x)))
    jc, jlo, jstep = JMinMax().encode(x)
    np.testing.assert_array_equal(n(lo), np.asarray(jlo))
    np.testing.assert_allclose(n(step), np.asarray(jstep), rtol=1e-6)
    # a code on a rounding boundary may land one level apart
    assert (np.abs(n(codes).astype(int) - np.asarray(jc).astype(int)) <= 1).all()


@settings(max_examples=20, deadline=None)
@given(
    st.lists(st.lists(_finite, min_size=33, max_size=33), min_size=2, max_size=4)
)
def test_hamming_is_a_metric(rows):
    x = np.array(rows, np.float32)
    bq = BinaryQuantizer(dim=33)
    codes = bq.encode(t(x))
    h = n(bq.hamming(codes, codes))
    assert (h == h.T).all()
    assert (np.diag(h) == 0).all()
    # triangle inequality
    k = len(x)
    for i in range(k):
        for j in range(k):
            for m in range(k):
                assert h[i, j] <= h[i, m] + h[m, j]
    codes = bq.encode(t(_ftz(x)))
    jq = JBinary(dim=33)
    jcodes = np.asarray(jq.encode(x))
    np.testing.assert_array_equal(n(codes).view(np.uint32), jcodes.view(np.uint32))
    np.testing.assert_array_equal(n(bq.hamming(codes, codes)),
                                  np.asarray(jq.hamming(jcodes, jcodes)))
