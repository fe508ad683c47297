"""The port's RobustPrune against the JAX package's, on identical pools.

Pools carry -1 slots, duplicates and the pruned point itself.  With the
same candidate distances the promoted ids and counts are identical.  On
integer-valued vectors every float32 product is exact, so the case that
recomputes distances (``cand_dists=None``) is identical too; the scalar
oracle of `tests/reference_impl.py` ties both to DiskANN's occlude_list.
The stepping forms (`robust_prune_steps`, `chunked_robust_prune_steps`),
driven by hand, give bitwise the plain calls' results.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diskann_tpu.graph.build import chunked_robust_prune as j_chunked
from diskann_tpu.graph.config import GraphConfig as JConfig
from diskann_tpu.graph.prune import robust_prune as j_prune
from diskann_tpu.ops.distance import Metric as JMetric
from diskann_tpu.ops.distance import distance_to_set as j_dist
from diskann_tpu_torch.graph.build import chunked_robust_prune, chunked_robust_prune_steps
from diskann_tpu_torch.graph.config import GraphConfig
from diskann_tpu_torch.graph.prune import robust_prune, robust_prune_steps
from diskann_tpu_torch.ops.distance import Metric
from reference_impl import occlude_list
from torch_port_helpers import n, t


def _pools(seed, b=24, c=48, nvec=200, d=12, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        vecs = rng.integers(-6, 7, size=(nvec, d)).astype(np.float32)
    else:
        vecs = rng.standard_normal((nvec, d)).astype(np.float32)
    ids = rng.integers(0, nvec, size=(b, c)).astype(np.int32)
    ids[:, ::9] = -1
    self_ids = rng.integers(0, nvec, size=b).astype(np.int32)
    ids[:, 5] = self_ids                         # self loop in every pool
    ids[:, 7] = ids[:, 8]                        # duplicates
    p_vecs = vecs[self_ids]
    return vecs, p_vecs, ids, self_ids


def _configs(metric, degree, alpha, saturate):
    kw = dict(max_degree=degree, alpha=alpha, saturate_after_prune=saturate)
    return (JConfig(metric=JMetric(metric), **kw),
            GraphConfig(metric=Metric(metric), **kw))


@pytest.mark.parametrize("metric,degree,alpha,saturate", [
    ("l2", 8, 1.2, False),       # the default two-rung ladder
    ("l2", 12, 1.2, True),       # saturate after prune
    ("ip", 8, 1.2, False),       # the Occluding rule
    ("cosine", 16, 1.5, False),  # a four-rung ladder
    ("l2", 40, 1.0, False),      # degree above the pool's distinct ids
])
@pytest.mark.parametrize("integer", [False, True])
def test_robust_prune_matches_jax(metric, degree, alpha, saturate, integer):
    vecs, p_vecs, ids, self_ids = _pools(degree + int(alpha * 10), integer=integer)
    jcfg, tcfg = _configs(metric, degree, alpha, saturate)
    cvec = vecs[np.clip(ids, 0, len(vecs) - 1)]
    dists = np.asarray(j_dist(jnp.asarray(p_vecs), jnp.asarray(cvec), JMetric(metric)))
    want = j_prune(jnp.asarray(p_vecs), jnp.asarray(ids), jnp.asarray(dists),
                   jnp.asarray(cvec), jnp.asarray(self_ids), jcfg)
    got = robust_prune(t(p_vecs), t(ids), t(dists), t(cvec), t(self_ids), tcfg)
    np.testing.assert_array_equal(n(got.count), np.asarray(want.count))
    np.testing.assert_array_equal(n(got.ids), np.asarray(want.ids))
    np.testing.assert_array_equal(n(got.dists), np.asarray(want.dists))
    if integer:  # exact products: recomputed distances match as well
        want2 = j_prune(jnp.asarray(p_vecs), jnp.asarray(ids), None,
                        jnp.asarray(cvec), jnp.asarray(self_ids), jcfg)
        got2 = robust_prune(t(p_vecs), t(ids), None, t(cvec), t(self_ids), tcfg)
        np.testing.assert_array_equal(n(got2.ids), np.asarray(want2.ids))
        np.testing.assert_array_equal(n(got2.count), np.asarray(want2.count))


@pytest.mark.parametrize("alpha", [1.0, 1.2, 1.5])
def test_robust_prune_matches_scalar_oracle(alpha):
    rng = np.random.default_rng(int(alpha * 10))
    vecs = rng.standard_normal((64, 6)).astype(np.float32)
    tcfg = GraphConfig(max_degree=8, alpha=alpha)
    for _ in range(5):
        point = rng.standard_normal(6).astype(np.float32)
        pool = rng.choice(64, size=24, replace=False).astype(np.int32)
        pd = ((vecs[pool] - point) ** 2).sum(1).astype(np.float32)
        want = occlude_list(point, list(pool), list(pd), vecs, degree=8, alpha=alpha)
        got = robust_prune(t(point[None]), t(pool[None]), t(pd[None]),
                           t(vecs[pool][None]), torch.tensor([-5], dtype=torch.int32),
                           tcfg)
        assert n(got.ids[0, : int(got.count[0])]).tolist() == want


def test_chunked_robust_prune_matches_jax():
    vecs, p_vecs, ids, self_ids = _pools(3, b=200, c=32, integer=True)
    jcfg, tcfg = _configs("l2", 8, 1.2, False)
    want = j_chunked(jnp.asarray(vecs), jnp.asarray(p_vecs), jnp.asarray(ids), None,
                     jnp.asarray(self_ids), jcfg, degree=8, chunk=64)
    got = chunked_robust_prune(t(vecs), t(p_vecs), t(ids), None, t(self_ids), tcfg,
                               degree=8, chunk=64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), np.asarray(w))


def _by_hand(steps):
    """(result, flags yielded) of a stepping form, each flag answered with
    its value."""
    yields, reply = 0, None
    while True:
        try:
            flag = steps.send(reply)
        except StopIteration as stop:
            return stop.value, yields
        yields += 1
        reply = bool(flag)


@pytest.mark.parametrize("metric,degree,alpha,saturate", [
    ("l2", 8, 1.2, False),
    ("l2", 12, 1.2, True),
    ("ip", 8, 1.2, False),
    ("cosine", 16, 1.5, False),
])
def test_stepping_prune_matches_the_plain_call(metric, degree, alpha, saturate):
    vecs, p_vecs, ids, self_ids = _pools(degree + int(alpha * 10))
    _, tcfg = _configs(metric, degree, alpha, saturate)
    cvec = t(vecs[np.clip(ids, 0, len(vecs) - 1)])
    args = (t(p_vecs), t(ids), None, cvec, t(self_ids), tcfg)
    got, yields = _by_hand(robust_prune_steps(*args))
    want = robust_prune(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # each rung of the alpha ladder ends on a False flag
    assert yields > len(tcfg.alpha_ladder())
    got, _ = _by_hand(chunked_robust_prune_steps(t(vecs), t(p_vecs), t(ids), None,
                                                 t(self_ids), tcfg, degree=degree, chunk=7))
    for g, w in zip(got, chunked_robust_prune(t(vecs), t(p_vecs), t(ids), None,
                                              t(self_ids), tcfg, degree=degree, chunk=7)):
        assert torch.equal(g, w)
