"""The port's bf16 packed router against the JAX package's, on the same
numpy inputs: `_router_topk_packed_pre(compute="bf16")` of both packages
with one set of router codes, aux terms, projection, scale, bias and
queries.

S stays at or below 1024, where JAX picks with an exact `lax.top_k`
(lower columns first on ties) rather than `approx_min_k`.

- Grid inputs (an identity projection, queries and bias on a grid of 1/16,
  power-of-two scales): every float32 step is exact in both packages, so
  the ids must be equal for every query.
- Projected inputs (a random projection and scales): the two float32
  products may sum in other orders, so a query's ids may differ only where
  `router_topk.rounding_disagreements` explains it, a dot rounded to the
  neighbouring bf16 value at the selection's boundary.

On the CPU, XLA rounds the bf16 product and each bf16 step of the epilogue
as the port does: it keeps no excess precision there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diskann_tpu.graph import index as jindex
from diskann_tpu.ops.distance import Metric as JMetric
from diskann_tpu_torch.graph import index as tindex
from diskann_tpu_torch.graph.scorers import quantize_queries
from diskann_tpu_torch.ops.distance import Metric
from diskann_tpu_torch.ops.kernels import router_topk as k4

METRICS = {"l2": (JMetric.L2, Metric.L2), "ip": (JMetric.InnerProduct, Metric.InnerProduct)}


def router_inputs(seed: int, b: int, s: int, dp: int, grid: bool):
    """(rc, raux, proj, pscale, pbias2, router_ids, queries) as numpy."""
    rng = np.random.default_rng(seed)
    if grid:
        d = dp
        proj = np.eye(d, dp, dtype=np.float32)
        queries = rng.integers(-255, 256, (b, d)) / 16.0
        pbias2 = rng.integers(-64, 64, dp) / 16.0
        pscale = 2.0 ** rng.integers(-1, 2, dp)
    else:
        d = dp + 8
        proj = rng.standard_normal((d, dp)) / np.sqrt(d)
        queries = rng.standard_normal((b, d)) * 30.0
        pbias2 = rng.standard_normal(dp)
        pscale = rng.random(dp) * 2.0 + 1.0
    rc = rng.integers(-127, 128, (s, dp)).astype(np.int8)
    raux = (rc.astype(np.float32) ** 2).sum(1) * rng.uniform(0.5, 1.5, s)
    router_ids = rng.permutation(10 * s)[:s].astype(np.int32)
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    return rc, f32(raux), f32(proj), f32(pscale), f32(pbias2), router_ids, f32(queries)


@pytest.mark.parametrize("grid", [True, False], ids=["grid", "projected"])
@pytest.mark.parametrize("dp", [16, 128])
@pytest.mark.parametrize("s", [64, 1024])
@pytest.mark.parametrize("n_start", [1, 4, 8])
@pytest.mark.parametrize("metric", list(METRICS))
def test_bf16_router_matches_jax(metric, n_start, s, dp, grid):
    jm, tm = METRICS[metric]
    arrays = router_inputs(1000 * n_start + s + dp + grid, 200, s, dp, grid)
    want = np.array(jindex._router_topk_packed_pre(
        *map(jnp.asarray, arrays), jm, n_start, compute="bf16"))
    rc, raux, proj, pscale, pbias2, ids, queries = (torch.from_numpy(a.copy())
                                                    for a in arrays)
    got = tindex._router_topk_packed_pre(rc, raux, proj, pscale, pbias2, ids, queries,
                                         tm, n_start, compute="bf16")
    assert got.dtype == torch.int32 and got.shape == want.shape == (200, n_start)
    if grid:
        np.testing.assert_array_equal(got.numpy(), want)
        return
    _, _, qb, qs = quantize_queries(queries, proj, pscale, pbias2, tm)
    rows, bad = k4.rounding_disagreements(torch.from_numpy(want), got, qs,
                                          (qb * qb).sum(-1), rc, raux, ids, n_start,
                                          inner_product=metric == "ip")
    assert bad == [], [(r, got[r].tolist(), want[r].tolist()) for r in bad[:5]]
    assert len(rows) <= 2, rows
