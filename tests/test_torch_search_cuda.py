"""The packed list walk on the card with K3 (`ops/kernels/hop_merge.py`).

On a 20,000-point index built on the card, `GraphIndex.search(mode=
"packed")` gives the same ids, distances (bitwise), ``cmps`` and ``hops``
with K3 as with `hop_merge_plain` patched in its place, at the batch and
online cells' walk (L=24, W=4, 6 hops, dp=128) and the churn
checkpoint's (L=90, W=4, 9 hops, dp=64), with one K3 launch per K1
launch.  The walks that keep the generic body (an insert batch, a filtered
packed search, a beam too wide for one block) launch K1 and no K3.

Every case needs the card (a CUDA kernel has no CPU mode) and is skipped
on a host without one.  No JAX here: on the card's host run
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_search_cuda.py``.
"""

import numpy as np
import pytest
import torch

from diskann_tpu_torch import GraphConfig, GraphIndex
from diskann_tpu_torch.ops.kernels import hop_merge as k3
from torch_port_helpers import launches

N, NQ, D = 20_000, 1024, 128


def _clustered(rng, m, centers):
    x = centers[rng.integers(0, len(centers), m)]
    return (x + 0.35 * rng.standard_normal((m, D))).astype(np.float32)


@pytest.fixture(scope="module")
def card_index():
    """A packed build of N clustered points on card 0 (the main path's
    settings), its queries and fresh points to insert."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    rng = np.random.default_rng(18)
    centers = rng.standard_normal((256, D)).astype(np.float32)
    cfg = GraphConfig(max_degree=64, l_build=100, alpha=1.2, beam_width=4,
                      build_max_hops=12, max_occlusion_size=256)
    idx = GraphIndex.build(_clustered(rng, N, centers), cfg, device="cuda:0")
    return idx, _clustered(rng, NQ, centers), _clustered(rng, 2048, centers)


@pytest.mark.cuda
@pytest.mark.parametrize("dp,l,hops", [(128, 24, 6), (64, 90, 9)])
def test_packed_search_with_k3_matches_the_plain_hop(card_index, monkeypatch, dp, l, hops):
    idx, q, _ = card_index
    idx.attach_packed(dp=dp)
    kw = dict(l_search=l, beam_width=4, mode="packed", max_hops=hops)
    k1_before, k3_before = launches("fatrow_expand"), launches("hop_merge")
    got = idx.search(q, 10, **kw)
    n_k1, n_k3 = launches("fatrow_expand") - k1_before, launches("hop_merge") - k3_before
    assert n_k3 > 0 and n_k3 == n_k1
    monkeypatch.setattr(k3, "hop_merge", k3.hop_merge_plain)
    want = idx.search(q, 10, **kw)
    assert launches("hop_merge") == k3_before + n_k3
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].view(np.int32), want[0].view(np.int32))
    np.testing.assert_array_equal(got[2].cmps, want[2].cmps)
    np.testing.assert_array_equal(got[2].hops, want[2].hops)


@pytest.mark.cuda
def test_insert_filtered_and_wide_walks_launch_no_k3(card_index):
    idx, q, fresh = card_index
    idx.attach_packed(dp=64)
    k1_before, k3_before = launches("fatrow_expand"), launches("hop_merge")
    idx.insert(fresh)
    assert launches("fatrow_expand") > k1_before and launches("hop_merge") == k3_before
    rng = np.random.default_rng(3)
    idx.attach_labels([["hot"] if h else ["cold"] for h in rng.random(idx.n) < 0.5])
    k1_before = launches("fatrow_expand")
    _, ids, _ = idx.search_filtered(q, "hot", 10, l_search=90, mode="packed",
                                    max_hops=16, scan_threshold=0)
    assert launches("fatrow_expand") > k1_before and launches("hop_merge") == k3_before
    assert (ids >= 0).all()
    # W=64 at r_pack 84: 5,376 candidates a row, past one block's shared
    # memory; the walk keeps the generic body and answers
    idx.attach_packed(dp=128)
    assert not k3.fits(64 * idx.packed.r_pack, 128, 64)
    k1_before = launches("fatrow_expand")
    _, ids, stats = idx.search(q, 10, l_search=128, beam_width=64, mode="packed", max_hops=4)
    assert launches("fatrow_expand") > k1_before and launches("hop_merge") == k3_before
    assert (ids >= 0).all() and (stats.hops > 0).all()

