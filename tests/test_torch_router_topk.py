"""The port's kernel K4 (`ops/kernels/router_topk.py`): the bf16 router's
product, epilogue and top-n_start.

On the CPU the wrapper runs `router_topk_plain`, which must equal a numpy
emulation of the router's arithmetic (the dot summed exactly and rounded
once to bf16, then the epilogue's bf16 roundings in order, then a stable
sort), give ties to the lower column, and leave `GraphIndex.search` with
the bf16 router as it was before K4 (the router's PyTorch code, patched
back in).  The inputs make every float32 sum exact (bf16 queries on a grid
of 1/16, int8 codes), so the emulation is bitwise.

The CUDA kernel against its plain version runs on a CUDA card only (marker
`cuda`), where the float32 sums run in the tensor cores' order: ids must
be equal for every query but those where a dot rounds to the neighbouring
bf16 value at the selection's boundary.  This file does not import JAX;
on the card's host:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_router_topk.py
"""

import numpy as np
import pytest
import torch

from diskann_tpu_torch import GraphConfig, GraphIndex
from diskann_tpu_torch.graph import index as index_mod
from diskann_tpu_torch.graph.scorers import quantize_queries, smallest_ids
from diskann_tpu_torch.ops.distance import Metric
from diskann_tpu_torch.ops.kernels import router_topk as k4
from torch_port_helpers import CPU, cuda_device, launches  # noqa: F401

METRICS = ["l2", "ip"]
# the packed layout's code widths (dp/4 divides 128)
WIDTHS = [4, 8, 16, 32, 64, 128, 256, 512]


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float64 -> the nearest bfloat16 value (ties to even), in float64."""
    m, e = np.frexp(x)
    return np.ldexp(np.round(m * 256.0), e - 8)


def emulate(qs, qsq, rc, raux, ids, n_start: int, ip: bool) -> np.ndarray:
    """The router's arithmetic in float64: each operation's exact result
    rounded to bf16 once, then the stable smallest ``n_start``."""
    dot = bf16_round(bf16_round(qs.astype(np.float64)) @ rc.astype(np.float64).T)
    if ip:
        d = -dot
    else:
        t = bf16_round(bf16_round(qsq.astype(np.float64))[:, None]
                       + bf16_round(raux.astype(np.float64))[None, :])
        d = bf16_round(t - 2.0 * dot)
    order = np.argsort(d + 0.0, axis=1, kind="stable")[:, :min(n_start, d.shape[1])]
    return ids[order]


def inputs(seed: int, b: int, s: int, dp: int, ties: int = 1):
    """Queries on a grid of 1/16 in [-16, 16] (bf16 values whose float32
    products with int8 codes sum exactly), int8 codes, squared norms at the
    scale of real ones, distinct router ids.  ``ties`` > 1 repeats each
    code row and its raux over ``ties`` consecutive rows: exact ties."""
    rng = np.random.default_rng(seed)
    qs = (rng.integers(-255, 256, (b, dp)) / 16.0).astype(np.float32)
    qsq = (rng.random(b) * 85.0 * dp).astype(np.float32)
    base = -(-s // ties)
    rc = np.repeat(rng.integers(-127, 128, (base, dp)), ties, axis=0)[:s].astype(np.int8)
    raux = np.repeat(rng.random(base) * 5400.0 * dp, ties)[:s].astype(np.float32)
    ids = rng.permutation(10 * s)[:s].astype(np.int32)
    return qs, qsq, rc, raux, ids


def tensors(arrays, device=CPU):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n_start", [1, 4, 32])
@pytest.mark.parametrize("dp", [4, 16, 128, 512])
@pytest.mark.parametrize("s", [64, 1000])
@pytest.mark.parametrize("b", [1, 7, 64])
def test_plain_matches_emulation(b, s, dp, n_start, metric):
    ip = metric == "ip"
    arrays = inputs(b * 7 + s + dp + n_start, b, s, dp)
    qs, qsq, rc, raux, ids = tensors(arrays)
    got = k4.router_topk_plain(qs, qsq, rc, raux, ids, n_start, inner_product=ip)
    assert got.dtype == torch.int32 and got.shape == (b, n_start)
    np.testing.assert_array_equal(got.numpy(), emulate(*arrays, n_start, ip))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n_start", [1, 3, 8, 32])
def test_ties_go_to_the_lower_column(n_start, metric):
    ip = metric == "ip"
    # every code row repeated over 8 consecutive columns: whole groups tie
    arrays = inputs(40 + n_start, 16, 256, 32, ties=8)
    qs, qsq, rc, raux, ids = tensors(arrays)
    got = k4.router_topk(qs, qsq, rc, raux, ids, n_start, inner_product=ip)
    np.testing.assert_array_equal(got.numpy(), emulate(*arrays, n_start, ip))
    # within each chosen group the columns taken are its first ones
    col = {int(v): c for c, v in enumerate(arrays[4])}
    for row in got.numpy():
        cols = [col[int(v)] for v in row]
        for c in cols:
            assert all(g in cols for g in range(c - c % 8, c))
    # all distances equal: the first n_start columns, in column order
    zero = torch.zeros_like(qs)
    flat = torch.full_like(raux, 7.0)
    got = k4.router_topk(zero, torch.zeros_like(qsq), rc, flat, ids, n_start,
                         inner_product=ip)
    np.testing.assert_array_equal(got.numpy(), np.tile(arrays[4][:n_start], (16, 1)))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    qs, qsq, rc, raux, ids = tensors(inputs(3, 5, 100, 16))
    calls = []
    plain = k4.router_topk_plain

    def spy(*a, **kw):
        calls.append(a[5])
        return plain(*a, **kw)

    monkeypatch.setattr(k4, "router_topk_plain", spy)
    before = launches("router_topk")
    out = k4.router_topk(qs, qsq, rc, raux, ids, 6, inner_product=False)
    assert calls == [6] and launches("router_topk") == before and out.shape == (5, 6)
    # n_start beyond the router's rows: every row, nearest first
    out = k4.router_topk(qs[:, :16], qsq, rc[:5], raux[:5], ids[:5], 8,
                         inner_product=False)
    assert out.shape == (5, 5)


BAD = {
    "qs float64": dict(qs=lambda a: a.double()),
    "qs 1-d": dict(qs=lambda a: a[0]),
    "rc int16": dict(rc=lambda a: a.to(torch.int16)),
    "rc width": dict(rc=lambda a: a[:, :12]),
    "qsq shape": dict(qsq=lambda a: a[:3]),
    "qsq missing": dict(qsq=lambda a: None),
    "raux shape": dict(raux=lambda a: a[:50]),
    "raux float16": dict(raux=lambda a: a.half()),
    "router_ids int64": dict(router_ids=lambda a: a.long()),
    "router_ids shape": dict(router_ids=lambda a: a[:99]),
    "n_start 0": dict(n_start=0),
    "n_start -1": dict(n_start=-1),
}
# the kernel's limits: the plain version on the CPU takes these
KERNEL_LIMITS = {
    "n_start 33": dict(n_start=33),
    "dp 2": dict(dp=2),
    "dp 6": dict(dp=6),
    "dp 516": dict(dp=516),
    "dp 12": dict(dp=12),
    "no rows": dict(rows=0),
}


def case_args(case: dict, device=CPU):
    """(inputs as numpy, the wrapper's arguments) for a case of BAD or
    KERNEL_LIMITS: 5 queries over 100 router rows of width 16 as changed."""
    dp = case.get("dp", 16)
    rows = case.get("rows", 100)
    arrays = [a[:rows] if i >= 2 else a
              for i, a in enumerate(inputs(5, 5, max(rows, 1), dp))]
    qs, qsq, rc, raux, ids = tensors(arrays, device)
    args = dict(qs=qs, qsq=qsq, rc=rc, raux=raux, router_ids=ids)
    for name, f in case.items():
        if name in args:
            args[name] = f(args[name])
    return arrays, (*args.values(), case.get("n_start", 4))


@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_raises_beyond_its_limits(case):
    with pytest.raises(ValueError, match="router_topk"):
        k4.router_topk(*case_args(BAD[case])[1], inner_product=False)


@pytest.mark.parametrize("case", list(KERNEL_LIMITS))
def test_cpu_takes_what_the_kernel_does_not(case):
    arrays, args = case_args(KERNEL_LIMITS[case])
    got = k4.router_topk(*args, inner_product=False)
    np.testing.assert_array_equal(got.numpy(), emulate(*arrays, args[-1], False))


@pytest.mark.parametrize("dp", WIDTHS)
def test_plan_fits_the_card(dp):
    for b in (1, 37, 128, 8192, 65536):
        for s in (64, 1000, 65536):
            for n_start in (1, 4, 5, 32):
                p = k4.plan(b, s, dp, n_start)
                assert p.smem_bytes <= k4.SMEM_PER_BLOCK
                assert p.tiles == -(-s // k4.TILE_ROWS)
                assert 1 <= p.splits <= p.tiles
                assert p.query_tiles * p.splits <= max(k4.H100_SMS, p.query_tiles)
                assert min(n_start, s) <= p.list_size <= 32
    main = k4.plan(8192, 65536, 128, 4)
    if dp == 128:
        assert (main.splits, main.query_tiles, main.list_size) == (2, 64, 4)
        assert k4.plan(1, 65536, 128, 4).splits == 132


def _parent_router(rc, raux, proj, pscale, pbias2, router_ids, queries, metric,
                   n_start, compute="int8"):
    """The packed bf16 router as the port ran it before K4: the [B, S]
    block through bf16 tensor ops, then `smallest_ids`."""
    assert compute == "bf16"
    _, _, qb, qs = quantize_queries(queries, proj, pscale, pbias2, metric)
    dots = qs.bfloat16() @ rc.bfloat16().T
    if metric == Metric.InnerProduct:
        d = -dots
    else:
        qsq = (qb * qb).sum(-1, keepdim=True)
        d = qsq.bfloat16() + raux[None, :].bfloat16() - 2.0 * dots
    return smallest_ids(d, router_ids, n_start)


@pytest.mark.parametrize("metric", [Metric.L2, Metric.InnerProduct])
def test_graph_search_with_the_bf16_router_keeps_its_ids(monkeypatch, metric):
    rng = np.random.default_rng(21)
    centres = rng.standard_normal((32, 32)).astype(np.float32)
    x = (centres[rng.integers(0, 32, 2048)]
         + 0.35 * rng.standard_normal((2048, 32))).astype(np.float32)
    q = (centres[rng.integers(0, 32, 200)]
         + 0.35 * rng.standard_normal((200, 32))).astype(np.float32)
    idx = GraphIndex.build(x, GraphConfig(max_degree=16, l_build=32, beam_width=4,
                                          metric=metric),
                           insert_batch_size=512, build_mode="packed", packed_dp=16,
                           device=CPU)
    idx.router_compute = "bf16"
    kw = dict(l_search=24, beam_width=4, mode="packed", rerank_l=12, max_hops=6)
    router_ids = idx._router_ids_live("packed")
    assert router_ids is not None and router_ids.shape[0] == 512
    rows = idx._router_rows(True)
    qt = torch.from_numpy(q)
    for n_start in (1, 4, 8):
        new = index_mod._router_topk_packed_pre(*rows, router_ids, qt, metric, n_start,
                                                compute="bf16")
        old = _parent_router(*rows, router_ids, qt, metric, n_start, compute="bf16")
        assert torch.equal(new, old)
    d_new, i_new, _ = idx.search(q, 10, **kw)
    monkeypatch.setattr(index_mod, "_router_topk_packed_pre", _parent_router)
    d_old, i_old, _ = idx.search(q, 10, **kw)
    np.testing.assert_array_equal(i_new, i_old)
    np.testing.assert_array_equal(d_new, d_old)


@pytest.mark.parametrize("metric", METRICS)
def test_rounding_disagreements_explain_only_a_rounding(metric):
    ip = metric == "ip"
    g = torch.Generator().manual_seed(1)
    qs = torch.randn(50, 64, generator=g) * 8
    rc = torch.randint(-127, 128, (3000, 64), generator=g, dtype=torch.int8)
    args = (qs, (qs * qs).sum(1), rc, (rc.float() ** 2).sum(1),
            torch.randperm(12000, generator=g)[:3000].int())
    want = k4.router_topk_plain(*args, 4, inner_product=ip)
    assert k4.rounding_disagreements(want.clone(), want, *args, 4, inner_product=ip) == ([], [])
    # the fourth entry swapped for the fifth: explained where the two lie
    # within a dot's bf16 rounding of each other, and only there
    five = k4.router_topk_plain(*args, 5, inner_product=ip)
    got = want.clone()
    got[:, 3] = five[:, 4]
    ok, bad = k4.rounding_disagreements(got, want, *args, 4, inner_product=ip)
    assert sorted(ok + bad) == list(range(50)) and 0 < len(ok) < 50
    # an id the router does not hold, a repeated id, the first n_start ids
    got = want.clone()
    got[3, 0], got[7, 1], got[9] = -5, got[7, 0], args[4][:4]
    ok, bad = k4.rounding_disagreements(got, want, *args, 4, inner_product=ip)
    assert 3 in bad and 7 in bad and 9 in bad


# ------------------------------------------------------------ on the card
def check_on_card(device, b, s, dp, n_start, ip, ties=1, seed=0):
    """K4 against its plain version on the card; returns the queries whose
    ids differ, each a right answer under one bf16 ulp of its dots."""
    g = torch.Generator(device=device).manual_seed(seed + b + s + dp + n_start)
    qs = torch.randn((b, dp), generator=g, device=device) * 8
    qsq = (qs * qs).sum(1)
    base = -(-s // ties)
    rc = torch.randint(-127, 128, (base, dp), generator=g, device=device,
                       dtype=torch.int8).repeat_interleave(ties, 0)[:s].contiguous()
    raux = (rc.float() ** 2).sum(1)
    ids = torch.randperm(4 * s, generator=g, device=device)[:s].to(torch.int32)
    before = launches("router_topk")
    got = k4.router_topk(qs, qsq, rc, raux, ids, n_start, inner_product=ip)
    assert launches("router_topk") == before + 1
    want = k4.router_topk_plain(qs, qsq, rc, raux, ids, n_start, inner_product=ip)
    torch.cuda.synchronize(device)
    assert got.shape == want.shape == (b, min(n_start, s))
    rows, bad = k4.rounding_disagreements(got, want, qs, qsq, rc, raux, ids, n_start,
                                          inner_product=ip)
    assert bad == [], [(r, got[r].tolist(), want[r].tolist()) for r in bad[:5]]
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("n_start", [1, 4, 32])
@pytest.mark.parametrize("dp", [8, 64, 128, 512])
@pytest.mark.parametrize("s", [64, 65536])
@pytest.mark.parametrize("b", [1, 37, 8192])
def test_kernel_matches_plain(cuda_device, b, s, dp, n_start):
    ip = (b + dp) % 3 == 0
    rows = check_on_card(cuda_device, b, s, dp, n_start, ip)
    print(f"B={b} S={s} dp={dp} n_start={n_start} {'ip' if ip else 'l2'}: "
          f"{len(rows)} queries differ at a bf16 rounding of the boundary")


@pytest.mark.cuda
@pytest.mark.parametrize("n_start", [1, 4, 32])
@pytest.mark.parametrize("s", [1, 5, 65, 1001, 4099])
@pytest.mark.parametrize("b", [1, 129])
def test_kernel_ragged_router_matches_plain(cuda_device, b, s, n_start):
    # router rows that fill no whole tile of 64 or chunk of 8, fewer rows
    # than n_start, and a ragged second query tile
    check_on_card(cuda_device, b, s, 128, n_start, s % 2 == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n_start", [1, 4, 32])
@pytest.mark.parametrize("s", [64, 65536])
@pytest.mark.parametrize("b", [37, 8192])
def test_kernel_ties_match_plain(cuda_device, b, s, n_start, metric):
    # runs of 8 equal code rows: the kernel and the library sum a row's
    # products in one order for every column, so the ties stay exact
    rows = check_on_card(cuda_device, b, s, 128, n_start, metric == "ip", ties=8, seed=1)
    assert rows == []


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(KERNEL_LIMITS))
def test_kernel_raises_beyond_its_limits(cuda_device, case):
    before = launches("router_topk")
    with pytest.raises(ValueError, match="router_topk"):
        k4.router_topk(*case_args(KERNEL_LIMITS[case], cuda_device)[1], inner_product=False)
    assert launches("router_topk") == before


@pytest.mark.cuda
def test_profiler_credits_k4_to_the_router_span(cuda_device):
    from torch.profiler import ProfilerActivity, profile

    from diskann_tpu_torch import trace

    qs, qsq, rc, raux, ids = tensors(inputs(11, 8192, 65536, 128), cuda_device)
    k4.router_topk(qs, qsq, rc, raux, ids, 4, inner_product=False)
    torch.cuda.synchronize(cuda_device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with trace.span("search.router"):
            k4.router_topk(qs, qsq, rc, raux, ids, 4, inner_product=False)
        torch.cuda.synchronize(cuda_device)
    dev = torch.autograd.DeviceType.CUDA
    kernel_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == dev and "router_" in e.name)
    span = next(e for e in prof.key_averages() if e.key == "search.router")
    span_us = getattr(span, "device_time_total", getattr(span, "cuda_time_total", 0))
    print(f"K4 {kernel_us:.1f} us; the search.router span {span_us:.1f} us")
    assert kernel_us > 0 and span_us >= 0.99 * kernel_us


@pytest.mark.cuda
def test_kernel_raises_on_a_refused_plan(cuda_device, monkeypatch):
    import dataclasses

    qs, qsq, rc, raux, ids = tensors(inputs(9, 64, 1000, 128), cuda_device)
    plan = k4.plan
    monkeypatch.setattr(k4, "plan", lambda *a, **kw: dataclasses.replace(
        plan(*a, **kw), smem_bytes=1024))
    before = launches("router_topk")
    with pytest.raises(RuntimeError, match="router_topk"):
        k4.router_topk(qs, qsq, rc, raux, ids, 4, inner_product=False)
    assert launches("router_topk") == before


@pytest.mark.cuda
def test_graph_search_launches_k4_once_a_batch(cuda_device):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4096, 64)).astype(np.float32)
    idx = GraphIndex.build(x, GraphConfig(max_degree=16, l_build=32, beam_width=4),
                           insert_batch_size=1024, build_mode="packed", packed_dp=32,
                           device=cuda_device)
    idx.search_batch_size = 100
    q = rng.standard_normal((250, 64)).astype(np.float32)
    before = launches("router_topk")
    idx.router_compute = "int8"
    idx.search(q, 10, l_search=24, mode="packed")
    assert launches("router_topk") == before
    idx.router_compute = "bf16"
    idx.search(q, 10, l_search=24, mode="packed")
    assert launches("router_topk") == before + 3
