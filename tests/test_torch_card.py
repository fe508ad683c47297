"""The port on the card against the same index on the CPU, and real
out-of-memory errors in a one-card index.

A small packed index (20,000 clustered points in 128-d, labelled with one
of 32 categories by zipf-like weights) is built on card 0 once for the
module and carried to the CPU by `convert.py`, where the kernel wrappers
run their plain versions.  Each route, searched on both, must give
identical ids for >= 99% of (query, rank) entries: the float32 query
projection may round an int8 query code differently on the two devices,
and near-tied float distances may swap.  The routes:

- the packed search;
- the filtered search by the packed walk (forced with scan_threshold=0),
  by the posting-list scan and by the full inline route, each taking the
  route named and every result honouring its predicate, no id repeated;
- each quantized mode: sq, pq 8-bit (16 x 256) and 4-bit (32 x 16),
  minmax and spherical 4-bit, the quantizer trained on the CPU copy and
  carried to the card with its trained state (the devices' generators
  draw different streams);
- one delete cycle (1,000 ids by scan + fill, then 1,000 new vectors):
  the same freed and reused slots, and >= 99% identical adjacency entries
  and packed-search ids;
- a `TieredIndex` built on the card, carried to the CPU and searched with
  its router on both; saved on the card and loaded on the CPU, it returns
  the CPU copy's ids;
- the vectors stored as float16 and as uint8: the index built on the card
  and carried in its own dtype, the full-precision ids on >= 99.9% of the
  entries (the lift to float32 is exact on both devices; only the float32
  sum order differs), the packed walk's on >= 99%.

Out of memory: `GraphIndex.insert` and `GraphIndex.delete` (scan + fill)
on a copy of the index, under a memory cap of what the card holds plus 1
MiB, raise `torch.OutOfMemoryError` and leave every `GraphArrays` field,
the packed table and the counters as before; without the cap the same
call then succeeds.

Every case needs the card (a CUDA kernel has no CPU mode) and is skipped
on a host without one.  No JAX here: on the card's host run
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_card.py``.
"""

import tempfile

import numpy as np
import pytest
import torch

from diskann_tpu_torch import GraphConfig, GraphIndex
from diskann_tpu_torch.bench.harness import make_clustered
from diskann_tpu_torch.convert import graph_index_from_arrays, index_arrays
from diskann_tpu_torch.tiered import HostVectorStore, TieredIndex
from torch_port_helpers import CPU

N, NQ, D, K = 20_000, 512, 128, 10
CFG = GraphConfig(max_degree=32, l_build=64, beam_width=4)
PACKED = dict(l_search=24, beam_width=4, mode="packed", rerank_l=12, max_hops=6)
FILTER_WALK = dict(l_search=90, mode="packed", max_hops=16, query_dtype=np.float16)


def _data(seed: int = 1):
    return make_clustered(seed, N, NQ, D, n_clusters=256, sigma=0.35)


def _copy(idx, device, **kw):
    """``idx`` carried to ``device`` by `convert.py`, on fresh tensors."""
    kw.setdefault("insert_batch_size", idx.insert_batch_size)
    return graph_index_from_arrays(**index_arrays(idx), device=device, **kw)


def _build(x, device, **kw):
    idx = GraphIndex.build(x, CFG, insert_batch_size=4096, build_mode="packed", packed_dp=64,
                           device=device, **kw)
    idx.attach_packed(dp=128)
    return idx


@pytest.fixture(scope="module")
def pair():
    """The small index on card 0, its CPU copy, the queries and each
    point's category."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    x, q = _data()
    card = _build(x, torch.device("cuda", 0))
    rng = np.random.default_rng(0xF117)
    weights = 1.0 / np.arange(1, 33) ** 0.8
    cats = rng.choice(32, size=N, p=weights / weights.sum())
    card.attach_labels([[f"cat{c}"] for c in cats])
    return card, _copy(card, CPU), q, cats


def _packed(card, host, q, cats):
    return [("packed", card.search(q, K, **PACKED)[1], host.search(q, K, **PACKED)[1], 0.99)]


def _filtered(pred, kw, route):
    def run(card, host, q, cats):
        _, got, st = card.search_filtered(q, pred, K, **kw)
        _, want, _ = host.search_filtered(q, pred, K, **kw)
        assert ("scan" if int(st.hops.max()) == 0 else "walk") == route
        member = np.isin(cats, [int(p[3:]) for p in pred.split(" | ")])
        assert member[got[got >= 0]].all()
        s = np.sort(got, axis=1)
        assert not ((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any()
        return [(pred, got, want, 0.99)]
    return run


def _quantized(mode, attach, **attach_kw):
    def run(card, host, q, cats):
        trained = _copy(card, CPU)
        getattr(trained, attach)(**attach_kw)
        carried = _copy(trained, card.device)
        kw = dict(l_search=64, beam_width=4, mode=mode)
        return [(mode, carried.search(q, K, **kw)[1], trained.search(q, K, **kw)[1], 0.99)]
    return run


def _delete_cycle(card, host, q, cats):
    on_card, on_cpu = _copy(card, card.device), _copy(card, CPU)
    dead = np.random.default_rng(3).choice(N, 1000, replace=False)
    new, _ = make_clustered(4, 1000, 1, D, n_clusters=256, sigma=0.35)
    for idx in (on_card, on_cpu):
        idx.delete(dead, method="scan", repair="fill")
    assert on_card.free_slots == on_cpu.free_slots == dead.tolist()
    slots = [idx.insert(new) for idx in (on_card, on_cpu)]
    np.testing.assert_array_equal(slots[0], slots[1])
    np.testing.assert_array_equal(slots[0], dead[::-1])
    return [("adjacency", on_card.state.adjacency.cpu().numpy()[:N],
             on_cpu.state.adjacency.numpy()[:N], 0.99),
            ("packed after the cycle", on_card.search(q, K, **PACKED)[1],
             on_cpu.search(q, K, **PACKED)[1], 0.99)]


def _tiered(card, host, q, cats):
    x, qt = _data(2)
    on_card = TieredIndex.build_from_host(x, CFG, dp=64, insert_batch_size=4096,
                                          device=card.device)
    on_cpu = TieredIndex(_copy(on_card.graph, CPU, insert_batch_size=4096), HostVectorStore(x))
    kw = dict(l_search=64, batch_size=256, router_starts=4)
    for ti in (on_card, on_cpu):
        ti.attach_router(4096)
    want = on_cpu.search_batched(qt, K, **kw)[1]
    with tempfile.TemporaryDirectory() as tmp:
        on_card.save(f"{tmp}/tiered")
        back = TieredIndex.load(f"{tmp}/tiered", device=CPU)
    back.attach_router(4096)
    np.testing.assert_array_equal(back.search_batched(qt, K, **kw)[1], want)
    return [("tiered", on_card.search_batched(qt, K, **kw)[1], want, 0.99)]


def _stored(dtype):
    def run(card, host, q, cats):
        x, qq = _data()
        if dtype == torch.uint8:
            lo, hi = float(x.min()), float(x.max())
            x, qq = (np.clip(np.rint((a - lo) * (255.0 / (hi - lo))), 0, 255).astype(np.uint8)
                     for a in (x, qq))
        on_card = _build(x, card.device, dtype=dtype)
        on_cpu = _copy(on_card, CPU)
        assert on_card.state.vectors.dtype == on_cpu.state.vectors.dtype == dtype
        full = dict(l_search=40, mode="full")
        return [(f"{dtype} full", on_card.search(qq, K, **full)[1],
                 on_cpu.search(qq, K, **full)[1], 0.999),
                (f"{dtype} packed", on_card.search(qq, K, **PACKED)[1],
                 on_cpu.search(qq, K, **PACKED)[1], 0.99)]
    return run


ROUTES = {
    "packed": _packed,
    "filtered_walk": _filtered("cat0", dict(FILTER_WALK, scan_threshold=0), "walk"),
    "filtered_scan": _filtered("cat7", FILTER_WALK, "scan"),
    "filtered_full_inline": _filtered("cat0", dict(l_search=90, mode="full", scan_threshold=0),
                                      "walk"),
    "sq": _quantized("sq", "attach_sq"),
    "pq8": _quantized("pq", "attach_pq", n_chunks=16, n_centers=256),
    "pq4": _quantized("pq", "attach_pq", n_chunks=32, n_centers=16),
    "minmax": _quantized("minmax", "attach_minmax"),
    "spherical": _quantized("spherical", "attach_spherical", n_bits=4),
    "delete_cycle": _delete_cycle,
    "tiered": _tiered,
    "float16": _stored(torch.float16),
    "uint8": _stored(torch.uint8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTES))
def test_card_matches_the_cpu(pair, route):
    for what, got, want, bar in ROUTES[route](*pair):
        share = float((got == want).mean())
        assert share >= bar, f"{what}: identical ids {share:.4f}, need >= {bar}"


def _tensors(idx) -> dict:
    """Every tensor of a `GraphIndex`'s graph state and packed table."""
    out = dict(idx.state._asdict())
    out |= {f"packed.{f}": getattr(idx.packed, f) for f in ("self_codes", "self_aux", "rows")}
    return out


def _host_fields(idx) -> tuple:
    return idx.n, idx.n_deleted, list(idx.free_slots), idx._start().tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["insert", "delete"])
def test_out_of_memory_under_a_cap_restores_the_index(pair, op):
    card = pair[0]
    dev = card.device
    # batches of 256: the insert fits the index's spare rows, so it fails
    # inside the batch, not in a growth
    idx = _copy(card, dev, insert_batch_size=256)
    new, _ = make_clustered(5, 256, 1, D, n_clusters=256, sigma=0.35)
    dead = np.random.default_rng(7).choice(N, 1000, replace=False)

    def call():
        if op == "insert":
            return idx.insert(new)
        return idx.delete(dead, method="scan", repair="fill")

    before = {f: t.clone() for f, t in _tensors(idx).items()}
    fields = _host_fields(idx)
    torch.cuda.empty_cache()
    in_use = torch.cuda.memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    torch.cuda.set_per_process_memory_fraction((in_use + (1 << 20)) / total, dev)
    try:
        with pytest.raises(torch.OutOfMemoryError):
            call()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
    for f, t in _tensors(idx).items():
        assert torch.equal(t, before[f]), f
    assert _host_fields(idx) == fields
    call()
    if op == "insert":
        assert idx.n == N + 256
    else:
        assert sorted(idx.free_slots) == sorted(dead.tolist()) and idx.n_deleted == len(dead)
