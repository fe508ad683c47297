"""The yardstick on tiny data: the seeded generator and arrivals repeat
per seed, the exact answers match brute-force NumPy, the live set follows
the stream, the comparison flags what it should, and the byte counts of
the roofline match hand-worked shapes."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from annbench import driver, roofline
from annbench.reference import check, exact, synth
from annbench.reference.flat import Exact, round_tf32

DATA = {"dim": 16, "sigma": 0.35, "clusters": 8, "slice_rows": 50}
BIG_SEED = 2**31 + 12345


def test_synth_repeats_per_seed_and_slices_stand_alone():
    a = synth.Clustered(BIG_SEED, DATA, "cpu")
    b = synth.Clustered(BIG_SEED, DATA, "cpu")
    c = synth.Clustered(BIG_SEED + 1, DATA, "cpu")
    assert torch.equal(a.rows(0, 170), b.rows(0, 170))
    assert torch.equal(a.queries(32), b.queries(32))
    assert not torch.equal(a.rows(0, 50), c.rows(0, 50))
    assert torch.equal(a.rows(120, 170), b.rows(0, 170)[120:])
    assert torch.equal(a.slice(3), a.rows(150, 200))
    assert a.rows(0, 170).shape == (170, 16)


def test_schedule_is_one_fixed_draw():
    arr = {"kind": "poisson", "rate_per_s": 400.0}
    a = driver.schedule(arr, 5.0)
    assert np.array_equal(a, driver.schedule(arr, 5.0))
    assert np.array_equal(a, driver.schedule(arr, 9.0)[: len(a)])
    assert abs(len(a) / 5.0 - 400) < 60 and (np.diff(a) >= 0).all() and a[0] == 0


@pytest.mark.parametrize("arrivals", [{"kind": "onoff", "rate_per_s": 10.0},
                                      {"kind": "poisson", "rate_per_s": 0}])
def test_validate_refuses_arrivals_it_cannot_run(arrivals):
    mix = {"loop": "open", "arrivals": arrivals, "cycle": [{"op": "search", "queries": 1}],
           "query_pool": 8, "warmup_cycles": 0, "trace_seconds": 0.1}
    with pytest.raises(ValueError):
        driver.validate(mix)


def test_topk_matches_bruteforce_numpy():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(700, 16, generator=g)
    q = torch.randn(33, 16, generator=g)
    d, i = exact.topk(q, x, 10, q_chunk=8, n_chunk=128)
    ref = ((q.double().numpy()[:, None] - x.double().numpy()[None]) ** 2).sum(-1)
    want = np.argsort(ref, axis=1, kind="stable")[:, :10]
    assert np.array_equal(i.numpy(), want)
    assert np.allclose(d.numpy(), np.take_along_axis(ref, want, 1), rtol=0, atol=1e-9)


def test_hits_count_each_true_row_once():
    rows = torch.tensor([[1, 2, 3], [4, 4, -1], [-1, -1, -1]])
    truth = torch.tensor([[3, 2, 9], [4, 5, 6], [-1, 1, 2]])
    assert exact.hits(rows, truth).tolist() == [2, 1, 0]


def test_percentile_is_numpys():
    v = np.random.default_rng(1).exponential(size=999)
    assert exact.percentile(v, 95) == float(np.percentile(v, 95))


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-13, -3.0 - 2**-12, 0.0])
    want = torch.tensor([1.0 + 2**-10, 1.0 + 2**-10, -3.0, 0.0])
    assert torch.equal(round_tf32(x), want)
    bits = round_tf32(torch.randn(1000)).view(torch.int32)
    assert ((bits & 0x1FFF) == 0).all()


CFG = {"k": 10, "build": {"capacity": 400}, "serve": {"search": {}}}


def test_live_set_follows_the_stream():
    """Delete the oldest rows, insert the next, search: the driver's live
    rows and row <-> slot map, judged against brute force on the rows it
    says are live, give every exact answer back."""
    data = synth.Clustered(5, DATA, "cpu")
    pool = data.queries(40)
    mix = {"loop": "closed", "query_pool": 40, "warmup_cycles": 0, "trace_seconds": 0,
           "cycle": [{"op": "delete", "rows": 70}, {"op": "insert", "rows": 70},
                     {"op": "search", "queries": 40}]}
    sys_ = Exact(CFG, data.rows(0, 300), precision="float32")
    drv = driver.Driver(mix, sys_, data, pool.numpy(), 300, seed=0)
    for c in range(3):
        drv.cycle()
        lo, hi = drv.live
        assert (lo, hi) == (70 * (c + 1), 300 + 70 * (c + 1))
        a = drv.answers[-1]
        x = data.rows(0, hi).double().numpy()
        ref = ((pool.double().numpy()[:, None] - x[None, lo:hi]) ** 2).sum(-1)
        want = np.sort(np.argsort(ref, axis=1)[:, :10] + lo, axis=1)
        assert np.array_equal(np.sort(a["rows"], axis=1), want)
        assert a["live"] == (lo, hi)
    # freed slots are reused last freed first, and the map follows them
    assert sorted(drv.row_slot[300:510]) == sorted(set(drv.row_slot[300:510]))
    nums = check.measure(drv.answers, [], data, pool, k=10, query_dtype=None, failed=0)
    assert nums["bad_ids"] == 0 and nums["recall_at_10"] == 1.0
    assert nums["recall_min"] == 1.0 and nums["dist_gap"] < 1e-5


def test_open_loop_serves_every_due_request_in_order():
    """The online mix's loop (`traffic/open-poisson-single.json`):
    one cycle per due time, each timed from its due time."""
    data = synth.Clustered(5, DATA, "cpu")
    pool = data.queries(64)
    mix = json.loads((Path(driver.__file__).parent / "traffic"
                      / "open-poisson-single.json").read_text())
    mix = dict(mix, query_pool=64, arrivals={"kind": "poisson", "rate_per_s": 200.0})
    drv = driver.Driver(mix, Exact(CFG, data.rows(0, 300), precision="float32"), data,
                        pool.numpy(), 300, seed=3)
    rec = drv.run(0.5)
    due = driver.schedule(mix["arrivals"], 0.5)
    assert rec["attempted"] == len(due) == len(rec["latencies"]) == len(drv.answers)
    assert all(lat >= svc > 0 for lat, svc in zip(rec["latencies"], rec["service"]))
    assert min(rec["late"]) >= 0
    nums = check.measure(drv.answers, [], data, pool, k=10, query_dtype=None, failed=0)
    assert nums["bad_ids"] == 0 and nums["recall_at_10"] == 1.0


def _answer(rows, dists, live=(10, 60)):
    return {"q": np.arange(len(rows)), "rows": np.array(rows), "dists": np.array(dists),
            "live": live}


def test_measure_flags_dead_repeated_and_missing_rows_and_wrong_distances():
    data = synth.Clustered(9, DATA, "cpu")
    pool = data.queries(3)
    x = data.rows(0, 60).double()
    _, truth = exact.topk(pool, x[10:60].float(), 10)
    truth = (truth + 10).numpy()
    d = ((pool.double()[:, None] - x[torch.as_tensor(truth)]) ** 2).sum(-1).numpy()
    good = check.measure([_answer(truth, d)], [], data, pool, k=10, query_dtype=None,
                         failed=0)
    assert good["bad_ids"] == 0 and good["recall_at_10"] == 1.0 and good["dist_gap"] < 1e-6
    bad = truth.copy()
    bad[0, 0] = 5           # a deleted row (below the live range)
    bad[1, 1] = bad[1, 0]   # a repeat
    bad[2, 2] = -1          # no row
    got = check.measure([_answer(bad, d)], [], data, pool, k=10, query_dtype=None,
                        failed=0)
    assert got["bad_ids"] == 3 and got["recall_at_10"] == pytest.approx(27 / 30)
    off = d.copy()
    off[1, 3] *= 1.01
    got = check.measure([_answer(truth, off)], [], data, pool, k=10, query_dtype=None,
                        failed=0)
    # over the larger of the row's distance and the answer's median one
    want = 0.01 * d[1, 3] / max(d[1, 3], float(torch.as_tensor(d).median()))
    assert got["dist_gap"] == pytest.approx(want, rel=1e-6)
    probes = [{"expect": np.array([11, 12]), "rows": np.array([[11, 3], [1, 2]])}]
    assert check.measure([], probes, data, pool, k=2, query_dtype=None,
                         failed=0)["insert_miss"] == 0.5


def test_judge_fails_a_missing_number_and_failed_calls():
    ok, rows = check.judge({"failed_calls": 0, "bad_ids": 0}, {"bad_ids": {"max": 0},
                                                               "recall_min": {"min": 0.9}})
    assert not ok and [r["ok"] for r in rows] == [True, False, True]
    ok, _ = check.judge({"failed_calls": 1}, {})
    assert not ok


def test_wire_rounds_through_float16():
    q = torch.tensor([[1.0 + 2**-12, 3.0]])
    assert exact.wire(q, "float16")[0, 0] == 1.0 and torch.equal(exact.wire(q, None), q)


def test_k1_bytes_on_a_hand_worked_shape():
    # rp=84, dp=128: one id word row, 21 code word rows, 4 codes a row;
    # a fat row is 23 word rows of 512 bytes
    assert roofline.k1_geometry(84, 128) == (1, 21, 4)
    beam = torch.tensor([3, 3, 7, -1, 99], dtype=torch.int32)   # 99 clamps to 9
    table_rows = 10 * 23
    moved, ops = roofline.k1_bound(beam, table_rows, 84, 128)
    nodes = 4   # 3, 7, 0 (from -1), 9
    assert moved == nodes * 23 * 512 + 5 * (4 + 128) + 5 * (2 * 128 + 84) * 4
    assert ops == 2 * 5 * 21 * 4 * 128


def test_k2_bytes_on_a_hand_worked_shape():
    idx = torch.tensor([0, 5, 5, 99, -1, 2], dtype=torch.int32)
    # blocks 0, 5, 2 in range (10 blocks), each read and written once
    assert roofline.k2_bound(idx, 10, 4096) == 2 * 3 * 4096 + 4 * 6


def test_least_seconds_takes_the_larger_bound():
    peak = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    assert roofline.least_seconds(3.35e12, 0.0, peak) == pytest.approx(1.0)
    assert roofline.least_seconds(0.0, 1.979e15, peak) == pytest.approx(1.0)


def test_measure_reads_as_before_on_a_recorded_unfiltered_answer_set():
    """Answers of the bf16 control through four churn cycles, with a deleted
    row, a repeat and a missing row planted, give the numbers the
    comparison gave before it judged filtered answers (recorded then)."""
    data = synth.Clustered(2**31 + 4242, DATA, "cpu")
    pool = data.queries(48)
    mix = {"loop": "closed", "query_pool": 48, "warmup_cycles": 0, "trace_seconds": 0,
           "cycle": [{"op": "delete", "rows": 40}, {"op": "insert", "rows": 40},
                     {"op": "search", "queries": 20}]}
    drv = driver.Driver(mix, Exact(CFG, data.rows(0, 300), precision="bf16"), data,
                        pool.numpy(), 300, seed=7)
    for _ in range(4):
        drv.cycle()
    a = drv.answers
    a[0]["rows"][0, 0] = 3
    a[1]["rows"][2, 1] = a[1]["rows"][2, 0]
    a[2]["rows"][5, 9] = -1
    recorded = {None: 0.07277025458686856, "float16": 0.07307833437703065}
    for wire, gap in recorded.items():
        got = check.measure(a, [], data, pool, k=10, query_dtype=wire, failed=0)
        assert got == {"failed_calls": 0, "bad_ids": 3, "dist_gap": gap,
                       "recall_at_10": 0.96625, "recall_min": 0.95}
