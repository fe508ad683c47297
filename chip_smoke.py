#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py [--n 1000000]

Phases, each printing one line:

1. device: card name, power limit, torch and CUDA versions, TF32 flags;
2. kernel build: one nvcc per source of `diskann_tpu_torch/ops/kernels/csrc/`,
   all started together, then one link;
3. K1 `fatrow_expand` against its plain version, bitwise, at (r_pack, dp) =
   (16, 64), (32, 32), (88, 64), (84, 128), with repeated and out-of-range
   beam ids, and at the main path's BW = 8192 x 4 slots;
4. K2 `block_patch` against its plain version, bitwise, on int32 and int8
   tables with many patches aimed at the dump block, then a small index
   (20k points, with the benchmark's labels) searched on the card and,
   carried across, on the CPU: the packed search, and the filtered search
   by the packed walk, the posting-list scan and the full inline route;
   then one delete cycle on both (delete 1,000 ids by scan + fill, insert
   1,000 vectors): the same freed and reused slots, and >= 99% identical
   adjacency entries and packed-search ids;
5. main path: clustered n x 128 data, exact top-10 by `FlatIndex`, packed
   build (R=64, L=100, alpha=1.2, W=4, build_max_hops=12, occlusion cap
   256, batch 8192, dp=64), `attach_packed(dp=128)`, packed search at
   L = 16..40 (W=4, rerank_l=12, max_hops=6, bf16 router); fails unless
   some L reaches recall@10 >= 0.95 and both kernels ran on that path;
6. filtered family of the JAX package's `bench.py` on the same index:
   zipf-weighted labels cat0..cat31, then `search_filtered(..., l_search=90,
   mode="packed", query_dtype=float16, max_hops=16)` for "cat0", "cat7" and
   "cat0 | cat1" against an exact top-10 over each predicate's members;
   fails unless cat7 takes the scan at recall >= 0.999, the other two take
   the packed walk at recall >= 0.95 with K1 launched, and every result
   honours its predicate without duplicates;
7. full route on the first 1024 queries: `search(mode="full")` and the
   full-precision filtered walk (inline with AdaptiveL, and multihop);
8. kernel times against the plain versions at the main path's shapes, on
   random tables of the main path's size, where each kernel is also held
   bitwise against its plain version: K1 on the dp=64 and dp=128 tables,
   K2 on the dp=128 table (both past 2^31 words at 1M rows); each beside
   its least time on the card (bytes over 3.35 TB/s) and, for K2, the one
   library call that does the same (`index_copy_`);
9. stream: the JAX package's 1M streaming setting (`BENCH_STREAM1M_r05`):
   a packed index over 1M of 1.5M clustered points (capacity 1,040,000),
   then 10 cycles of delete 50,000 (scan, fill, max_dead=8) + insert
   50,000 + a recall checkpoint (L=90, packed, float16 queries,
   max_hops=9) through `RunbookExecutor`; fails unless every checkpoint
   reaches recall@10 >= 0.92 and, after every delete and cycle, no deleted
   id is returned, no live row refers to a deleted id, the packed id words
   equal adjacency, the live count matches and capacity never grows;
10. runbook: an empty full-precision index (no packed layout) through
   insert 100,000, three deletes of 2% (two_hop_one_hop + prune, one_hop +
   fill, visited_topk + prune), consolidate, a refill of the freed slots,
   a replace of 2% (scan + fill) and consolidate, a full-precision
   checkpoint (L=90) after each; fails below recall@10 0.95 at any
   checkpoint, or if a live row still refers to a deleted id after a scan
   delete or a consolidate;
11. quantized traversal on the main path's index (after phase 7): attach
   SQ, PQ 8-bit (32 x 256), MinMax, spherical 4-bit, then 4-bit PQ (64 x
   16); every mode and the full route at L = 32, 64, 100 (W=4, rerank of
   all L); fails below the JAX tests' bars at each mode's best L (0.90;
   8-bit PQ the full route's recall less 0.08; 4-bit PQ 0.88);
12. search modes on the same index: range search (full: resume route;
   packed: restart route) against a brute-force scan, PagedSearch (5
   pages of 10, full and packed), search_diverse (both enforce routes,
   packed) and determinant_rerank (packed); fails on an id outside the
   radius, coverage < 0.9, overlapping or unsorted pages, a broken
   quota, an invalid selection, or a packed route without K1;
13. tiered search on the same index (`scripts/bench_tiered.py`'s setting):
   its vectors written to an .fbin and dropped from the card, the native
   host reader (65536-row cache) under `TieredIndex`, a 65536-row router,
   `search_batched` (k=10, L=100, batch 4096, router_starts=4) at io_limit
   16, 32, 64, 100 and with float16 rows, `search_filtered("cat0")` and
   `search_range`, one call traced; fails unless some io_limit reaches
   recall@10 >= 0.95 through the native reader with K1 launched, every
   range result lies in the radius and every filtered result honours
   "cat0";
14. the 100k x 768 inner-product shape of `scripts/bench_wiki100k.py`:
   full build, attach_packed(dp=128) / attach_sq / attach_pq(192 chunks),
   k=100 search at L=200, W=8, router_starts=16, max_hops=12 in packed,
   sq and pq mode; fails below recall@100 0.99 for packed or sq; then the
   index saved and loaded, with identical ids, distances and hops in full,
   packed, sq and pq mode;
15. the merged build: `scripts/bench_deep20m.py`'s recipe cut to 2M points
   in 4 shards (clustered, 32768 clusters, exact top-10), `build_merged(R=40,
   L=64, overlap 2, dp=32, codes="sq")`, the native reader and a 65536-row
   router, a sweep of L = 40, 80, 160 x rerank_l = 16, 64 (float16 rows),
   then save and `TieredIndex.load`; fails unless some point reaches
   recall@10 >= 0.95, both kernels launched in the build, every merge
   invariant holds and the reload returns identical ids.

Phase 4 also trains every quantizer on the CPU copy of its small index,
carries the trained state to the card and holds each quantized mode's
ids card against CPU (>= 99% identical); and on a second 20k input builds
a `TieredIndex` on the card, carries it to the CPU (>= 99% identical ids),
saves it on the card and loads it on the CPU (identical ids), and runs a
3-shard `build_merged` with codes "packed" and "sq" on both devices
(invariants, recall@10 within 0.01).  Every temporary directory is
removed, on failure too.

Phase 6 also traces one filtered walk call with torch.profiler and splits
its device time between K1, the matched-list merges and the rest; phase 9
traces one more delete and splits its device time between discovery,
`fill_rows` and `refresh_rows` (of which K2); phase 13 splits a tiered
call between the walk, the wait on the host gather, the row upload and
the rerank.

Then a JSON line with the kernels, the `nvidia-smi` name/power-limit line,
and last the result line `{"ok": true, "device": {...}}`.  Any failed phase
raises, and the script exits non-zero without the result line; so does a
host without a CUDA card, or a directory without the package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

K1_REPLACES = "diskann_tpu/ops/kernels/fatrow_expand.py:146"
K2_REPLACES = "diskann_tpu/ops/kernels/block_patch.py:68"
K1_SOURCE = "diskann_tpu_torch/ops/kernels/csrc/fatrow_expand.cu"
K2_SOURCE = "diskann_tpu_torch/ops/kernels/csrc/block_patch.cu"
D = 128
NQ = 8192
K = 10
L_SWEEP = (16, 20, 24, 30, 40)
TARGET_RECALL = 0.95
# the filtered family of `bench.py`: predicates, and the walk's settings
FILTER_PREDS = ("cat0", "cat7", "cat0 | cat1")
FILTER_KW = dict(l_search=90, mode="packed", max_hops=16)
FULL_NQ = 1024
# the JAX package's 1M streaming setting (`BENCH_STREAM1M_r05.json`)
STREAM_N = 1_000_000
STREAM_CYCLES = 10
STREAM_FRAC = 0.05
STREAM_NQ = 2048
STREAM_CAP_MARGIN = 40_000
STREAM_MIN_RECALL = 0.92
R05_TRAJECTORY = [0.948, 0.9398, 0.9345, 0.9334, 0.9336, 0.9397, 0.9406, 0.9427,
                  0.9441, 0.9442]
RUNBOOK_N = 100_000
# quantized traversal on the 1M index: L sweep (W=4, rerank of all L);
# bars of the JAX package's own tests (`tests/test_pq_search.py:30, 60,
# 158, 261`, `tests/test_modes.py:181`)
QUANT_L = (32, 64, 100)
QUANT_MIN_RECALL = 0.90
PQ8_SLACK = 0.08
PQ4_MIN_RECALL = 0.88
# the search modes on the 1M index
RANGE_NQ = 256
PAGED_NQ = 64
PAGES, PAGE_K = 5, 10
DET_NQ = 1024
# the 100k x 768 inner-product shape (`scripts/bench_wiki100k.py`)
WIKI_N, WIKI_NQ, WIKI_D = 100_000, 4096, 768
WIKI_SEARCH = dict(l_search=200, beam_width=8, router_starts=16, max_hops=12)
WIKI_MIN_RECALL100 = 0.99
# `BENCH_WIKI100K_r04.json` at mh12 / W8 / rs16: (recall@10, recall@100)
R04_WIKI = {"packed": (0.9999, 0.9993), "sq": (0.9999, 0.9993), "pq": None}
# the tiered search on the 1M index (`scripts/bench_tiered.py`'s setting)
TIERED_IO = (16, 32, 64, 100)
TIERED_KW = dict(l_search=100, batch_size=4096, router_starts=4)
# the merged build: `scripts/bench_deep20m.py`'s recipe cut from 20M points
# in 24 shards to 2M in 4 (about 1M points per shard, against 1.67M)
MERGED_N, MERGED_NQ, MERGED_SHARDS = 2_000_000, 1024, 4
MERGED_L, MERGED_RL = (40, 80, 160), (16, 64)
# `BENCH_DEEP20M_r04.json` (20M, codes sq): recall@10 at (L, rerank_l)
R04_DEEP20M = {(40, 16): 0.9739, (80, 16): 0.9922, (80, 64): 0.9924, (160, 16): 0.994,
               (160, 64): 0.9942}
# the H100 SXM's published peaks (NVIDIA data sheet): HBM bytes and dense
# int8 operations per millisecond
HBM_BYTES_PER_MS = 3.35e12 / 1e3
INT8_OPS_PER_MS = 1979e12 / 1e3


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(torch, device) -> None:
    """Wait for the card (a no-op on the CPU, where the phases rehearse)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_cats(n: int):
    """The category of each point, as `bench.py` assigns it: one of 32
    labels with zipf-like weights 1/rank^0.8, seeded."""
    import numpy as np

    rng = np.random.default_rng(0xF117)
    weights = 1.0 / np.arange(1, 33) ** 0.8
    return rng.choice(32, size=n, p=weights / weights.sum())


def pred_mask(cats, pred: str):
    """[n] bool: the points that satisfy one of FILTER_PREDS."""
    if pred == "cat0 | cat1":
        return (cats == 0) | (cats == 1)
    return cats == int(pred[3:])


def check_filtered_ids(ids, mask, what: str) -> None:
    """Every returned id carries the predicate's label; no row repeats an
    id."""
    import numpy as np

    got = ids[ids >= 0]
    if not mask[got].all():
        raise RuntimeError(f"{what}: {int((~mask[got]).sum())} results miss the predicate")
    s = np.sort(ids, axis=1)
    if ((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any():
        raise RuntimeError(f"{what}: a result row holds a duplicate id")


def rand_words(torch, n_rows: int, gen, device):
    """Random int32 words [n_rows, 128] from a seeded CPU generator."""
    w = torch.randint(-(2**31), 2**31, (n_rows, 128), generator=gen,
                      dtype=torch.int64)
    return w.to(torch.int32).to(device)


def check_fatrow_expand(torch, device) -> int:
    """K1 vs plain, bitwise.  Returns the largest |dot difference| (0)."""
    from diskann_tpu_torch.graph.packed import n_wrows
    from diskann_tpu_torch.ops.kernels.fatrow_expand import (
        fatrow_expand, fatrow_expand_plain,
    )

    gen = torch.Generator().manual_seed(7)
    worst = 0
    cases = [(16, 64, 4096, 1000), (32, 32, 4096, 1000),
             (88, 64, 4096, 1000), (84, 128, 4096, 1000),
             (88, 64, 1 << 16, NQ * 4), (84, 128, 1 << 16, NQ * 4)]
    for rp, dp, n, bw in cases:
        rows = rand_words(torch, n * n_wrows(rp, dp), gen, device)
        beam = torch.randint(0, n, (bw,), generator=gen, dtype=torch.int32)
        beam[::7] = beam[0]                       # repeated ids
        beam[1::97] = -3                          # out of range, both sides
        beam[2::89] = n + 5
        beam[3] = 2**31 - 1
        beam = beam.to(device)
        qiw = torch.randint(-127, 128, (bw, dp), generator=gen,
                            dtype=torch.int8).to(device)
        got = fatrow_expand(rows, beam, qiw, rp=rp, dp=dp)
        want = fatrow_expand_plain(rows, beam, qiw, rp=rp, dp=dp)
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        log(f"[k1] fatrow_expand rp={rp} dp={dp} n={n} bw={bw}: "
            f"tolerance=bitwise bitwise_equal={same} max_abs_err={err}")
        if not same:
            raise RuntimeError(f"fatrow_expand disagrees with its plain version at rp={rp} dp={dp}")
        worst = max(worst, err)
    return worst


def check_block_patch(torch, device) -> int:
    """K2 vs plain, bitwise, outside the dump block.  Returns the largest
    |difference| (0)."""
    from diskann_tpu_torch.ops.kernels.block_patch import block_patch, block_patch_plain

    gen = torch.Generator().manual_seed(23)
    worst = 0
    n_blocks, g = 4096, 3000
    dump = n_blocks - 1
    for dt in (torch.int32, torch.int8):
        lo, hi = (-(2**31), 2**31) if dt == torch.int32 else (-128, 128)
        table = torch.randint(lo, hi, (n_blocks * 8, 128), generator=gen,
                              dtype=torch.int64).to(dt).to(device)
        idx = torch.randperm(n_blocks - 1, generator=gen)[:g].to(torch.int32)
        idx[::3] = dump                          # many patches on the dump block
        idx[1::101] = n_blocks + 2               # outside the table: skipped
        vals = torch.randint(lo, hi, (g * 8, 128), generator=gen,
                             dtype=torch.int64).to(dt).to(device)
        idx = idx.to(device)
        got = block_patch(table.clone(), idx, vals)
        want = block_patch_plain(table.clone(), idx, vals)
        torch.cuda.synchronize()
        live = slice(0, dump * 8)                # the dump block is garbage by design
        err = int((got[live].long() - want[live].long()).abs().max())
        same = torch.equal(got[live], want[live])
        log(f"[k2] block_patch {dt}: blocks={n_blocks} patches={g} "
            f"tolerance=bitwise bitwise_equal={same} max_abs_err={err}")
        if not same:
            raise RuntimeError(f"block_patch disagrees with its plain version ({dt})")
        worst = max(worst, err)
    return worst


def check_small_input(torch, device) -> float:
    """The packed path on a small input: one index built on the card,
    searched there (kernels) and, carried to the CPU by `convert.py` with
    its labels, with the plain versions.  Compared: the packed search, and
    the filtered search by the packed walk (the walk forced with
    scan_threshold=0), the posting-list scan and the full inline route.
    Each must give identical ids for >= 99% of (query, rank) entries (the
    float32 query projection may round an int8 query code differently on
    the two devices, and near-tied float distances may swap).  Returns the
    smallest share."""
    import numpy as np

    from diskann_tpu_torch import GraphConfig, GraphIndex
    from diskann_tpu_torch.bench.harness import make_clustered
    from diskann_tpu_torch.convert import graph_index_from_arrays, index_arrays

    n = 20_000
    x, q = make_clustered(1, n, 512, D, n_clusters=256, sigma=0.35)
    cfg = GraphConfig(max_degree=32, l_build=64, beam_width=4)
    card = GraphIndex.build(torch.from_numpy(x).to(device), cfg,
                            insert_batch_size=4096, build_mode="packed",
                            packed_dp=64)
    card.attach_packed(dp=128)
    cats = bench_cats(n)
    card.attach_labels([[f"cat{c}"] for c in cats])
    host = graph_index_from_arrays(**index_arrays(card), device="cpu",
                                   insert_batch_size=card.insert_batch_size)
    walk = dict(FILTER_KW, query_dtype=np.float16)
    cases = [
        ("packed search", None, dict(l_search=24, beam_width=4, mode="packed",
                                     rerank_l=12, max_hops=6), "walk"),
        ("filtered packed walk cat0", "cat0", dict(walk, scan_threshold=0), "walk"),
        ("filtered scan cat7", "cat7", walk, "scan"),
        ("filtered full inline cat0", "cat0",
         dict(l_search=90, mode="full", scan_threshold=0), "walk"),
    ]
    worst = 1.0
    for name, pred, kw, route in cases:
        if pred is None:
            _, ids_card, st = card.search(q, K, **kw)
            _, ids_host, _ = host.search(q, K, **kw)
        else:
            _, ids_card, st = card.search_filtered(q, pred, K, **kw)
            _, ids_host, _ = host.search_filtered(q, pred, K, **kw)
            check_filtered_ids(ids_card, pred_mask(cats, pred), f"[small] {name}")
        took = "scan" if int(st.hops.max()) == 0 else "walk"
        share = float((ids_card == ids_host).mean())
        log(f"[small] n={n} {name} ({took}) on the card vs the same index on the "
            f"CPU (plain versions): identical ids {share:.4f} (need >= 0.99)")
        if took != route:
            raise RuntimeError(f"[small] {name} took the {took}, not the {route}")
        if share < 0.99:
            raise RuntimeError(f"card and CPU disagree on {name}: {share:.4f} identical ids")
        worst = min(worst, share)
    worst = min(worst, check_small_quant(card, host, q))
    return min(worst, check_small_delete(card, host, q, n))


def check_small_quant(card, host, q) -> float:
    """The quantized modes on the small index: each quantizer is trained on
    the CPU copy (SQ, MinMax, spherical 4-bit, PQ 8-bit 16 x 256, then PQ
    4-bit 32 x 16), carried to the card by `convert.py` with its trained
    state (the two devices' generators draw different streams), and every
    quant mode searched on both at L=64, W=4: >= 99% identical (query,
    rank) ids.  Returns the smallest share."""
    from diskann_tpu_torch.convert import graph_index_from_arrays, index_arrays

    host.attach_sq()
    host.attach_minmax()
    host.attach_spherical(n_bits=4)
    worst = 1.0
    for label, pq_kw, modes in (("pq8", dict(n_chunks=16, n_centers=256),
                                 ("pq", "sq", "minmax", "spherical")),
                                ("pq4", dict(n_chunks=32, n_centers=16), ("pq",))):
        host.attach_pq(**pq_kw)
        carried = graph_index_from_arrays(**index_arrays(host), device=card.device,
                                          insert_batch_size=card.insert_batch_size)
        for mode in modes:
            kw = dict(l_search=64, beam_width=4, mode=mode)
            _, ids_card, _ = carried.search(q, K, **kw)
            _, ids_host, _ = host.search(q, K, **kw)
            share = float((ids_card == ids_host).mean())
            name = label if mode == "pq" else mode
            log(f"[small] n={host.n} {name} search (state trained on the CPU, carried "
                f"to the card) on the card vs the CPU: identical ids {share:.4f} "
                f"(need >= 0.99)")
            if share < 0.99:
                raise RuntimeError(f"card and CPU disagree on mode {name}: {share:.4f}")
            worst = min(worst, share)
        del carried
    return worst


def check_small_delete(card, host, q, n: int) -> float:
    """One delete cycle on the card and on its CPU copy: delete the same
    1,000 ids (scan discovery, fill repair), insert the same 1,000 new
    vectors.  Both sides must free the same slots and reuse them in the
    same order, and hold the same adjacency entry at >= 99% of cells and
    the same packed-search ids at >= 99% of (query, rank) entries (near-
    tied float distances may order a repaired row differently).  Returns
    the smaller share."""
    import numpy as np

    from diskann_tpu_torch.bench.harness import make_clustered

    dead = np.random.default_rng(3).choice(n, 1000, replace=False)
    new, _ = make_clustered(4, 1000, 1, D, n_clusters=256, sigma=0.35)
    for idx in (card, host):
        idx.delete(dead, method="scan", repair="fill")
    if card.free_slots != host.free_slots or card.free_slots != dead.tolist():
        raise RuntimeError("[small] card and CPU free different slots")
    slots = [idx.insert(new) for idx in (card, host)]
    if not (np.array_equal(*slots) and np.array_equal(slots[0], dead[::-1])):
        raise RuntimeError("[small] the inserts did not reuse the freed slots alike")
    adj = (card.state.adjacency.cpu().numpy()[:n] == host.state.adjacency.numpy()[:n]).mean()
    kw = dict(l_search=24, beam_width=4, mode="packed", rerank_l=12, max_hops=6)
    _, ids_card, _ = card.search(q, K, **kw)
    _, ids_host, _ = host.search(q, K, **kw)
    share = float((ids_card == ids_host).mean())
    log(f"[small] n={n} delete 1000 (scan, fill) + insert 1000 on the card vs the "
        f"CPU: same freed and reused slots; identical adjacency entries {adj:.4f}, "
        f"identical packed-search ids {share:.4f} (need >= 0.99 each); "
        f"affected rows {card.last_delete_stats['affected']} / "
        f"{host.last_delete_stats['affected']}")
    if adj < 0.99 or share < 0.99:
        raise RuntimeError(f"card and CPU disagree after a delete cycle: adjacency "
                           f"{adj:.4f}, search ids {share:.4f}")
    return min(float(adj), share)


def run_main_path(n: int, device, *, search_batch: int = NQ):
    """Data, groundtruth, packed build, dp=128 re-attach and the L sweep.
    Returns (the measured figures, the index, the queries on the device,
    the exact top-10 ids); raises if no L reaches the recall target or a
    result is malformed."""
    import numpy as np
    import torch

    from diskann_tpu_torch import FlatIndex, GraphConfig, GraphIndex
    from diskann_tpu_torch.bench.harness import make_clustered
    from diskann_tpu_torch.bench.recall import knn_recall

    out: dict = {"n": n, "nq": NQ}
    t0 = time.time()
    x, q = make_clustered(0, n, NQ, D, n_clusters=4096, sigma=0.35)
    xd = torch.from_numpy(x).to(device)
    qd = torch.from_numpy(q).to(device)
    sync(torch, device)
    out["data_s"] = time.time() - t0
    del x
    log(f"[main] data n={n} d={D} nq={NQ}: {out['data_s']:.1f}s")

    t0 = time.time()
    flat = FlatIndex(xd)
    gt_d, gt = flat.search(qd, K)
    del flat
    out["gt_s"] = time.time() - t0
    if gt.shape != (NQ, K) or (gt < 0).any():
        raise RuntimeError("groundtruth scan returned malformed ids")
    log(f"[main] exact top-{K} groundtruth: {out['gt_s']:.1f}s")

    cfg = GraphConfig(max_degree=64, l_build=100, alpha=1.2, beam_width=4,
                      build_max_hops=12, max_occlusion_size=256)
    t0 = time.time()
    idx = GraphIndex.build(xd, cfg, insert_batch_size=8192,
                           search_batch_size=search_batch, build_mode="packed",
                           packed_dp=64, build_backedge_src_cap=64)
    sync(torch, device)
    out["build_s"] = time.time() - t0
    out["build_points_per_s"] = n / out["build_s"]
    del xd
    log(f"[main] packed build (dp=64, r_pack={idx.packed.r_pack}, "
        f"nwr={idx.packed.nwr}): {out['build_s']:.1f}s "
        f"({out['build_points_per_s']:.0f} points/s)")

    adj = idx.state.adjacency[: idx.n]
    deg = idx.state.degrees[: idx.n]
    if not torch.equal((adj >= 0).sum(1).to(torch.int32), deg):
        raise RuntimeError("degrees do not match adjacency rows")
    if (adj == torch.arange(idx.n, device=device)[:, None]).any():
        raise RuntimeError("self-loop in the built graph")

    t0 = time.time()
    idx.attach_packed(dp=128)
    sync(torch, device)
    out["attach_s"] = time.time() - t0
    log(f"[main] attach_packed dp=128 (r_pack={idx.packed.r_pack}, "
        f"nwr={idx.packed.nwr}, table {idx.packed.rows.numel() * 4 / 1e9:.2f} GB): "
        f"{out['attach_s']:.1f}s")

    idx.router_compute = "bf16"
    sweep = []
    for l in L_SWEEP:
        kw = dict(l_search=l, beam_width=4, mode="packed", rerank_l=12, max_hops=6)
        dists, ids, stats = idx.search(qd, K, **kw)       # warm-up
        dts = []
        for _ in range(2):
            sync(torch, device)
            t0 = time.time()
            dists, ids, stats = idx.search(qd, K, **kw)
            sync(torch, device)
            dts.append(time.time() - t0)
        if ids.shape != (NQ, K) or not np.isfinite(dists[ids >= 0]).all():
            raise RuntimeError(f"L={l}: malformed search result")
        r = knn_recall(ids, gt, K)
        pt = {"l": l, "recall": r, "qps": NQ / min(dts),
              "qps_reps": [NQ / t for t in dts],
              "mean_hops": float(stats.hops.mean()),
              "mean_cmps": float(stats.cmps.mean())}
        sweep.append(pt)
        log(f"[main] search L={l} W=4 rerank_l=12 max_hops=6: "
            f"recall@{K}={r:.4f} qps={pt['qps']:.0f} "
            f"(reps {[round(v) for v in pt['qps_reps']]}) "
            f"mean_hops={pt['mean_hops']:.2f}")
    out["sweep"] = sweep
    best = max(p["recall"] for p in sweep)
    if best < TARGET_RECALL:
        raise RuntimeError(f"no L reached recall@{K} >= {TARGET_RECALL} (best {best:.4f})")
    return out, idx, qd, gt


def run_filtered(idx, qd, k1) -> tuple[list, dict]:
    """The filtered family of `bench.py` on the main path's index.  Returns
    (one row per predicate, the filtered groundtruth per predicate); raises
    unless each predicate takes its route at its recall bar and honours
    the predicate."""
    import numpy as np
    import torch

    from diskann_tpu_torch import FlatIndex
    from diskann_tpu_torch.bench.recall import knn_recall

    device = qd.device
    cats = bench_cats(idx.n)
    t0 = time.time()
    idx.attach_labels([[f"cat{c}"] for c in cats])
    log(f"[filtered] attach_labels (32 zipf-weighted categories): {time.time() - t0:.1f}s")
    kw = dict(FILTER_KW, query_dtype=np.float16)
    rows, gts = [], {}
    for pred in FILTER_PREDS:
        mask = pred_mask(cats, pred)
        members = np.nonzero(mask)[0]
        sub = FlatIndex(idx.state.vectors[torch.from_numpy(members).to(device)])
        _, local = sub.search(qd, K)
        del sub
        gts[pred] = members[local]
        idx.search_filtered(qd, pred, K, **kw)                # warm-up
        dts, calls = [], []
        for _ in range(2):
            sync(torch, device)
            before = k1.launches
            t0 = time.time()
            dists, ids, stats = idx.search_filtered(qd, pred, K, **kw)
            sync(torch, device)
            dts.append(time.time() - t0)
            calls.append(k1.launches - before)
        if ids.shape != (NQ, K) or not np.isfinite(dists[ids >= 0]).all():
            raise RuntimeError(f"filtered {pred!r}: malformed result")
        check_filtered_ids(ids, mask, f"filtered {pred!r}")
        route = "scan" if int(stats.hops.max()) == 0 else "walk"
        row = {"predicate": pred, "members": len(members),
               "recall": knn_recall(ids, gts[pred], K), "qps": NQ / min(dts),
               "qps_reps": [NQ / t for t in dts], "route": route,
               "mean_hops": float(stats.hops.mean()), "k1_launches": calls[-1]}
        rows.append(row)
        log(f"[filtered] {pred!r} ({len(members)} members): recall@{K}="
            f"{row['recall']:.4f} qps={row['qps']:.0f} "
            f"(reps {[round(v) for v in row['qps_reps']]}) route={route} "
            f"mean_hops={row['mean_hops']:.2f} k1_launches={row['k1_launches']}")
        want_route, bar = ("scan", 0.999) if pred == "cat7" else ("walk", TARGET_RECALL)
        if route != want_route or row["recall"] < bar:
            raise RuntimeError(f"filtered {pred!r}: route {route} recall "
                               f"{row['recall']:.4f}, want {want_route} >= {bar}")
        if route == "walk" and row["k1_launches"] < 1:
            raise RuntimeError(f"filtered {pred!r}: the walk never launched K1")
    return rows, gts


def run_full_route(idx, qd, gt, gt_cat0) -> dict:
    """The full-precision route on the first FULL_NQ queries: unfiltered
    search, the inline filtered walk with AdaptiveL, and multihop.  Raises
    unless the first two reach the recall target and the filtered results
    honour their predicate."""
    import numpy as np
    import torch

    from diskann_tpu_torch.bench.recall import knn_recall

    device = qd.device
    q = qd[:FULL_NQ]
    mask = pred_mask(bench_cats(idx.n), "cat0")
    calls = [
        ("search", None, gt[:FULL_NQ], dict(mode="full", l_search=40, beam_width=4)),
        ("inline", "cat0", gt_cat0[:FULL_NQ],
         dict(mode="full", l_search=90, scan_threshold=0)),
        ("multihop", "cat0", gt_cat0[:FULL_NQ],
         dict(mode="full", l_search=90, method="multihop")),
    ]
    out = {}
    for name, pred, want, kw in calls:
        sync(torch, device)
        t0 = time.time()
        if pred is None:
            dists, ids, stats = idx.search(q, K, **kw)
        else:
            dists, ids, stats = idx.search_filtered(q, pred, K, **kw)
        sync(torch, device)
        dt = time.time() - t0
        if ids.shape != (FULL_NQ, K) or not np.isfinite(dists[ids >= 0]).all():
            raise RuntimeError(f"full route {name}: malformed result")
        if pred is not None:
            check_filtered_ids(ids, mask, f"full route {name}")
        r = knn_recall(ids, want, K)
        out[name] = {"recall": r, "s": dt, "mean_hops": float(stats.hops.mean()),
                     "mean_cmps": float(stats.cmps.mean())}
        log(f"[full] {name} {pred or ''} {kw}: recall@{K}={r:.4f} {dt:.3f}s "
            f"mean_hops={out[name]['mean_hops']:.1f} mean_cmps={out[name]['mean_cmps']:.0f}")
        if name != "multihop" and r < TARGET_RECALL:
            raise RuntimeError(f"full route {name}: recall {r:.4f} < {TARGET_RECALL}")
    if device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        log(f"[full] max_memory_allocated after the phase {out['peak_gib']:.2f} GiB")
    return out


def _device_ms(e, total: bool = False) -> float:
    """Device milliseconds of a profiler event (self, or with children)."""
    name = "device_time_total" if total else "self_device_time_total"
    old = "cuda_time_total" if total else "self_cuda_time_total"
    return getattr(e, name, getattr(e, old, 0)) / 1e3


def profile_call(fn, device, ranges, names=()) -> dict:
    """Run ``fn()`` once under torch.profiler, each (name, module, attr) of
    ``ranges`` traced as a range called name, beside the ranges ``names``
    that the code opens itself.  Returns the wall time, the device's busy
    time (kernels only) and idle share, the device time of each range
    (kernels launched inside it), the host time spent inside each range
    and the kernel events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    saved = []
    for name, mod, attr in ranges:
        orig = getattr(mod, attr)

        def traced(*a, _orig=orig, _name=name, **kw):
            with record_function(_name):
                return _orig(*a, **kw)

        saved.append((mod, attr, orig))
        setattr(mod, attr, traced)
    try:
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            t0 = time.time()
            fn()
            sync(torch, device)
            wall = (time.time() - t0) * 1e3
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)
    names = {name for name, _, _ in ranges} | set(names)
    ev = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # kernels are the device-side events; a range also shows there as one
    # span from its first kernel to its last, gaps included
    kern = [e for e in ev if e.device_type == cuda and e.key not in names]
    busy = sum(_device_ms(e) for e in kern)
    per = {name: sum(_device_ms(e, total=True) for e in ev
                     if e.key == name and e.device_type != cuda) for name in names}
    host = {name: sum(e.cpu_time_total for e in ev
                      if e.key == name and e.device_type != cuda) / 1e3 for name in names}
    return {"wall_ms": wall, "device_ms": busy,
            "idle_share": 1 - busy / wall if wall > 0 else None,
            "ranges": per, "host_ms": host, "kernels": kern}


def log_top_kernels(tag: str, kernels, n: int = 10) -> list:
    top = sorted(kernels, key=_device_ms, reverse=True)[:n]
    for e in top:
        log(f"[{tag}]   {_device_ms(e):8.3f} ms  x{e.count:<5d} {e.key[:70]}")
    return [(e.key[:70], _device_ms(e), e.count) for e in top]


def profile_filtered_walk(idx, qd) -> dict:
    """torch.profiler over one filtered walk call ("cat0"): device time of
    K1, of the matched-list merges (`search._match_merge`, traced as one
    range) and of the rest, and the device's idle share of the call."""
    import numpy as np
    import torch

    from diskann_tpu_torch.graph import search as search_mod

    kw = dict(FILTER_KW, query_dtype=np.float16)
    idx.search_filtered(qd, "cat0", K, **kw)
    sync(torch, qd.device)
    p = profile_call(lambda: idx.search_filtered(qd, "cat0", K, **kw), qd.device,
                     [("match_merge", search_mod, "_match_merge")])
    k1 = sum(_device_ms(e) for e in p["kernels"] if "fatrow_expand" in e.key)
    mm = p["ranges"]["match_merge"]
    out = {"wall_ms": p["wall_ms"], "device_ms": p["device_ms"], "k1_ms": k1,
           "match_merge_ms": mm, "rest_ms": p["device_ms"] - k1 - mm,
           "idle_share": p["idle_share"]}
    log(f"[profile] filtered walk 'cat0' ({NQ} queries, L=90, max_hops=16): wall "
        f"{out['wall_ms']:.1f} ms, device busy {out['device_ms']:.2f} ms (idle share "
        f"{out['idle_share']:.3f}): K1 {k1:.2f} ms, matched-list merges {mm:.2f} ms, "
        f"rest {out['rest_ms']:.2f} ms")
    out["top"] = log_top_kernels("profile", p["kernels"])
    return out


def stream_invariants(idx, cap0: int, rows0: int, what: str) -> None:
    """The stream's structural checks on the device: no live row refers to
    a deleted id, the packed id words equal adjacency on every row, the
    live count matches the liveness bits, and capacity never grew."""
    import torch

    from diskann_tpu_torch.graph.delete import rows_referencing_deleted

    st = idx.state
    if idx.state.capacity != cap0 or idx.packed.rows.shape[0] != rows0:
        raise RuntimeError(f"{what}: capacity grew ({cap0} -> {st.capacity})")
    dangling = int(rows_referencing_deleted(st).sum())
    if dangling:
        raise RuntimeError(f"{what}: {dangling} live rows refer to deleted ids")
    cap, rs = st.adjacency.shape
    fat_ids = idx.packed.rows.view(cap + 1, idx.packed.nwr * 128)[:cap, :rs]
    if not torch.equal(fat_ids, st.adjacency):
        raise RuntimeError(f"{what}: the packed id words differ from adjacency")
    live = int(st.valid.sum())
    if live != idx.n_live:
        raise RuntimeError(f"{what}: n_live {idx.n_live} != valid.sum() {live}")
    if not torch.equal((st.adjacency >= 0).sum(1, dtype=torch.int32), st.degrees):
        raise RuntimeError(f"{what}: degrees do not match adjacency rows")


def no_deleted_results(idx, q, freed, what: str, **kw) -> None:
    """A search returns neither a freed slot nor an invalid id."""
    import numpy as np

    _, ids, _ = idx.search(q, K, **kw)
    got = ids[ids >= 0]
    valid = idx.state.valid.cpu().numpy()
    if np.isin(got, np.asarray(freed)).any() or not valid[got].all():
        raise RuntimeError(f"{what}: a search returned a deleted id")


def stream_data(n: int = STREAM_N, cycles: int = STREAM_CYCLES):
    """The stream's data: n + cycles x 5% clustered points and its
    queries, as `scripts/bench_stream1m.py` draws them."""
    from diskann_tpu_torch.bench.harness import make_clustered

    t0 = time.time()
    x, q = make_clustered(11, n + cycles * int(n * STREAM_FRAC), STREAM_NQ, D,
                          n_clusters=4096, sigma=0.35)
    log(f"[stream] data {x.shape[0]} x {D}, {STREAM_NQ} queries: {time.time() - t0:.1f}s")
    return x, q


def run_stream(x, q, device, k1, k2, *, n: int = STREAM_N,
               cycles: int = STREAM_CYCLES,
               min_recall: float = STREAM_MIN_RECALL) -> dict:
    """The JAX package's 1M streaming setting (`scripts/bench_stream1m.py`
    as `BENCH_STREAM1M_r05.json` recorded it): a packed index over the
    first n points of `stream_data`, then `cycles` cycles of delete 5% (scan, fill,
    max_dead=8) + insert 5% + search (L=90, packed, float16 queries,
    max_hops=9) through `RunbookExecutor`, with the invariants checked
    after each delete and each cycle.  Then one more delete of the same
    size under torch.profiler.  Raises on a failed check or a checkpoint
    below min_recall."""
    import numpy as np
    import torch

    from diskann_tpu_torch import GraphConfig, GraphIndex
    from diskann_tpu_torch.bench.runbook import RunbookExecutor
    from diskann_tpu_torch.graph import delete as delete_mod
    from diskann_tpu_torch.graph import packed as packed_mod

    step = int(n * STREAM_FRAC)
    cfg = GraphConfig(max_degree=64, l_build=100, alpha=1.2, beam_width=4,
                      build_max_hops=12, max_occlusion_size=256)
    t0 = time.time()
    idx = GraphIndex.build(torch.from_numpy(x[:n]).to(device), cfg,
                           insert_batch_size=8192, search_batch_size=STREAM_NQ,
                           build_mode="packed", packed_dp=64,
                           capacity=n + STREAM_CAP_MARGIN)
    sync(torch, device)
    build_s = time.time() - t0
    cap0, rows0 = idx.state.capacity, idx.packed.rows.shape[0]
    log(f"[stream] packed build n={n} (dp=64, capacity {cap0}): {build_s:.1f}s")
    search_kw = {"mode": "packed", "query_dtype": np.float16, "max_hops": 9}
    ex = RunbookExecutor(idx, x, q, k=K, l_search=90, delete_method="scan",
                         delete_repair="fill", delete_kwargs={"max_dead": 8},
                         search_kwargs=search_kw)
    ex.tag_to_id = dict(zip(range(n), range(n)))
    ex.tag_to_row = dict(zip(range(n), range(n)))

    cycles_out = []
    k1.launches = 0
    k2.launches = 0
    for c in range(cycles):
        lo = c * step
        l1, l2 = k1.launches, k2.launches
        dele = ex.run([{"operation": "delete", "start": lo, "end": lo + step}])[-1]
        affected = idx.last_delete_stats["affected"]
        freed = list(idx.free_slots)
        stream_invariants(idx, cap0, rows0, f"[stream] cycle {c} after the delete")
        no_deleted_results(idx, q, freed, f"[stream] cycle {c}", l_search=90, **search_kw)
        ins, srch = ex.run([
            {"operation": "insert", "start": n + lo, "end": n + lo + step},
            {"operation": "search"},
        ])[-2:]
        stream_invariants(idx, cap0, rows0, f"[stream] cycle {c} after the insert")
        if idx.free_slots:
            raise RuntimeError(f"[stream] cycle {c}: {len(idx.free_slots)} slots not reused")
        row = {"cycle": c, "recall": srch["recall"], "delete_s": dele["wall_s"],
               "insert_s": ins["wall_s"], "search_s": srch["wall_s"],
               "affected": affected, "k1": k1.launches - l1, "k2": k2.launches - l2}
        cycles_out.append(row)
        log(f"[stream] cycle {c}: recall@{K}={row['recall']:.4f} delete {step} "
            f"{row['delete_s']:.2f}s (affected rows {affected}) insert {step} "
            f"{row['insert_s']:.2f}s checkpoint {row['search_s']:.2f}s "
            f"launches K1={row['k1']} K2={row['k2']}")
        if row["recall"] < min_recall:
            raise RuntimeError(f"[stream] cycle {c}: recall {row['recall']:.4f} < {min_recall}")
    launches = {"fatrow_expand": k1.launches, "block_patch": k2.launches}

    traj = [r["recall"] for r in cycles_out]
    out = {"n": n, "cycles": cycles, "build_s": build_s, "cycles_out": cycles_out,
           "launches": launches,
           "deletes_per_s": cycles * step / sum(r["delete_s"] for r in cycles_out),
           "inserts_per_s": cycles * step / sum(r["insert_s"] for r in cycles_out),
           "recall_end": traj[-1], "recall_min": min(traj)}
    log(f"[stream] recall@{K} trajectory {[round(r, 4) for r in traj]} (end "
        f"{traj[-1]:.4f}, min {min(traj):.4f}); the JAX package's r05 run on data of "
        f"the same distribution: {R05_TRAJECTORY} (end 0.9442, min 0.9334)")
    log(f"[stream] {out['deletes_per_s']:.0f} deletes/s, {out['inserts_per_s']:.0f} "
        f"inserts/s; kernel launches over the {cycles} cycles: {launches}")

    # one more delete of the same size, traced
    lo = cycles * step
    kill = np.array([ex.tag_to_id[t] for t in range(lo, lo + step)], np.int64)
    sync(torch, device)
    p = profile_call(
        lambda: idx.delete(kill, method="scan", repair="fill", max_dead=8), device,
        [("discovery", delete_mod, "mark_deleted"),
         ("discovery", delete_mod, "rows_referencing_deleted"),
         ("fill_rows", delete_mod, "fill_rows"),
         ("drop_rows", delete_mod, "drop_deleted_rows"),
         ("refresh_rows", packed_mod, "refresh_rows")])
    stream_invariants(idx, cap0, rows0, "[stream] after the traced delete")
    k2_ms = sum(_device_ms(e) for e in p["kernels"] if "block_patch" in e.key)
    prof = {"wall_ms": p["wall_ms"], "device_ms": p["device_ms"],
            "idle_share": p["idle_share"], "k2_ms": k2_ms,
            "affected": idx.last_delete_stats["affected"], **p["ranges"]}
    prof["rest_ms"] = p["device_ms"] - sum(p["ranges"].values())
    log(f"[stream] traced delete of {step} (scan, fill, affected rows "
        f"{prof['affected']}): wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['device_ms']:.2f} ms (idle share {prof['idle_share']:.3f}): discovery "
        f"{prof['discovery']:.2f} ms, fill_rows {prof['fill_rows']:.2f} ms, "
        f"refresh_rows {prof['refresh_rows']:.2f} ms (K2 {k2_ms:.2f} ms), drop rows "
        f"{prof['drop_rows']:.2f} ms, rest {prof['rest_ms']:.2f} ms")
    prof["top"] = log_top_kernels("stream", p["kernels"])
    out["delete_profile"] = prof
    if device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    return out


def run_runbook(x, q, device, *, n: int = RUNBOOK_N,
                min_recall: float = TARGET_RECALL) -> dict:
    """A streaming runbook from an empty full-precision index (no packed
    layout) over the first n points of the stream's data (x, q): insert n, delete
    2% three times (two_hop_one_hop + prune, one_hop + fill, visited_topk +
    prune), consolidate, insert the deleted rows again into the freed
    slots, replace 2% of the tags (scan + fill) with 2% more rows,
    consolidate; a search
    checkpoint (mode="full", L=90) after every stage.  Raises on a
    checkpoint below min_recall or a failed check."""
    import numpy as np
    import torch

    from diskann_tpu_torch import GraphConfig, GraphIndex
    from diskann_tpu_torch.bench.runbook import RunbookExecutor
    from diskann_tpu_torch.graph.delete import rows_referencing_deleted

    p = n // 50
    cfg = GraphConfig(max_degree=64, l_build=100, alpha=1.2, beam_width=4,
                      build_max_hops=12, max_occlusion_size=256)
    idx = GraphIndex(D, cfg, insert_batch_size=8192, search_batch_size=STREAM_NQ,
                     device=device)
    ex = RunbookExecutor(idx, x[: n + p], q, k=K, l_search=90,
                         search_kwargs={"mode": "full"})
    search = {"operation": "search"}
    stages = [
        ("insert", None, [{"operation": "insert", "start": 0, "end": n}]),
        ("delete", ("two_hop_one_hop", "prune"), [{"operation": "delete", "start": 0, "end": p}]),
        ("delete", ("one_hop", "fill"), [{"operation": "delete", "start": p, "end": 2 * p}]),
        ("delete", ("visited_topk", "prune"),
         [{"operation": "delete", "start": 2 * p, "end": 3 * p}]),
        # sweeps the references the approximate methods left behind
        ("consolidate", None, [{"operation": "consolidate"}]),
        ("refill", None, [{"operation": "insert", "start": 0, "end": 3 * p}]),
        ("replace", ("scan", "fill"), [{"operation": "replace", "tags_start": 3 * p,
                                        "tags_end": 4 * p, "ids_start": n,
                                        "ids_end": n + p}]),
        ("consolidate", None, [{"operation": "consolidate"}]),
    ]
    rows = []
    for name, how, ops in stages:
        if how is not None:
            ex.delete_method, ex.delete_repair = how
        entry, chk = ex.run(ops + [search])[-2:]
        st = idx.state
        dangling = int(rows_referencing_deleted(st).sum())
        if int(st.valid.sum()) != idx.n_live:
            raise RuntimeError(f"[runbook] {name}: n_live != valid.sum()")
        if not torch.equal((st.adjacency >= 0).sum(1, dtype=torch.int32), st.degrees):
            raise RuntimeError(f"[runbook] {name}: degrees do not match adjacency")
        no_deleted_results(idx, q, idx.free_slots, f"[runbook] {name}",
                           l_search=90, mode="full")
        if name == "refill" and (idx.free_slots or idx.n != n):
            raise RuntimeError(f"[runbook] the refill did not reuse the freed slots "
                               f"({len(idx.free_slots)} left, n={idx.n})")
        if dangling and (name == "consolidate" or (how and how[0] == "scan")):
            raise RuntimeError(f"[runbook] {name}: {dangling} rows refer to deleted ids")
        row = {"stage": name, "method": how, "count": entry.get("count"),
               "s": entry["wall_s"], "recall": chk["recall"], "dangling_rows": dangling,
               "n_live": idx.n_live}
        rows.append(row)
        log(f"[runbook] {name} {'/'.join(how) if how else ''} count={row['count']} "
            f"{row['s']:.2f}s: recall@{K}={row['recall']:.4f} n_live={idx.n_live} "
            f"rows still referring to deleted ids {dangling}")
        if row["recall"] < min_recall:
            raise RuntimeError(f"[runbook] {name}: recall {row['recall']:.4f} < {min_recall}")
    return {"n": n, "stages": rows}


def take_launches(k1, k2, phase: str | None = None) -> dict:
    """Both kernels' launch counts since the last call (logged under
    ``phase`` when given); the counts restart at 0."""
    out = {"fatrow_expand": k1.launches, "block_patch": k2.launches}
    k1.launches = k2.launches = 0
    if phase:
        log(f"[{phase}] kernel launches: {out}")
    return out


def _timed(torch, device, fn):
    """(result of fn(), wall seconds) with the device drained on both ends."""
    sync(torch, device)
    t0 = time.time()
    out = fn()
    sync(torch, device)
    return out, time.time() - t0


def run_quant(idx, qd, gt, *, min_recall: float = QUANT_MIN_RECALL,
              pq4_min_recall: float = PQ4_MIN_RECALL) -> dict:
    """Quantized traversal on the main path's index: attach SQ, PQ 8-bit
    (32 x 256), MinMax and spherical 4-bit, then 4-bit PQ (64 x 16) in
    place of the first PQ; search the queries in every mode at L in
    QUANT_L (W=4, router on, full-precision rerank of all L) beside the
    full route at the same L.  Raises unless, at each mode's best L, SQ,
    MinMax and spherical reach min_recall, 8-bit PQ the full route's
    recall less PQ8_SLACK and 4-bit PQ pq4_min_recall."""
    import numpy as np
    import torch

    from diskann_tpu_torch.bench.recall import knn_recall

    device = qd.device
    nq = qd.shape[0]
    out = {"attach_s": {}, "rows": []}

    def attach(name, fn):
        _, dt = _timed(torch, device, fn)
        out["attach_s"][name] = dt
        log(f"[quant] attach {name}: {dt:.2f}s")

    def sweep(label, mode):
        idx.search(qd[:1024], K, l_search=QUANT_L[0], beam_width=4, mode=mode)  # warm-up
        for l in QUANT_L:
            (dists, ids, st), dt = _timed(torch, device, lambda: idx.search(
                qd, K, l_search=l, beam_width=4, mode=mode))
            if ids.shape != (nq, K) or not np.isfinite(dists[ids >= 0]).all():
                raise RuntimeError(f"[quant] {label} L={l}: malformed result")
            row = {"mode": label, "l": l, "recall": knn_recall(ids, gt, K),
                   "qps": nq / dt, "mean_hops": float(st.hops.mean()),
                   "mean_cmps": float(st.cmps.mean())}
            out["rows"].append(row)
            log(f"[quant] {label} L={l} W=4 rerank_l={l}: recall@{K}={row['recall']:.4f} "
                f"qps={row['qps']:.0f} mean_hops={row['mean_hops']:.2f} "
                f"mean_cmps={row['mean_cmps']:.0f}")

    attach("sq", idx.attach_sq)
    attach("pq8", lambda: idx.attach_pq(n_chunks=32, n_centers=256))
    attach("minmax", idx.attach_minmax)
    attach("spherical", lambda: idx.attach_spherical(n_bits=4))
    sweep("full", "full")
    for mode in ("sq", "pq", "minmax", "spherical"):
        sweep("pq8" if mode == "pq" else mode, mode)
    attach("pq4", lambda: idx.attach_pq(n_chunks=64, n_centers=16))
    sweep("pq4", "pq")
    out["profile"] = {m: profile_quant_walk(idx, qd, m) for m in ("full", "sq", "pq")}

    def best(label):
        return max((r for r in out["rows"] if r["mode"] == label), key=lambda r: r["recall"])

    full = {r["l"]: r["recall"] for r in out["rows"] if r["mode"] == "full"}
    bars = {"sq": min_recall, "minmax": min_recall, "spherical": min_recall,
            "pq4": pq4_min_recall}
    bars["pq8"] = full[best("pq8")["l"]] - PQ8_SLACK
    out["best"] = {}
    for label, bar in bars.items():
        b = best(label)
        out["best"][label] = {"l": b["l"], "recall": b["recall"], "bar": bar}
        log(f"[quant] {label}: best recall@{K} {b['recall']:.4f} at L={b['l']} "
            f"(need >= {bar:.4f})")
        if b["recall"] < bar:
            raise RuntimeError(f"[quant] {label}: recall {b['recall']:.4f} < {bar:.4f}")
    return out


def profile_quant_walk(idx, qd, mode: str, l: int = QUANT_L[-1]) -> dict:
    """torch.profiler over one search call of ``mode`` at L=l, W=4: the
    device time of the best-list and ring membership tests
    (`ops/topk.isin_rows`), of the payload sorts of the hop loop
    (`sort_with`, the list merges and the rerank) and of the rest (the
    scorer's gathers and products among it), and the device's idle share."""
    from diskann_tpu_torch.graph import search as search_mod

    p = profile_call(lambda: idx.search(qd, K, l_search=l, beam_width=4, mode=mode),
                     qd.device, [("membership", search_mod, "isin_rows"),
                                 ("sorts", search_mod, "sort_with")])
    out = {"wall_ms": p["wall_ms"], "device_ms": p["device_ms"],
           "idle_share": p["idle_share"], **p["ranges"]}
    out["rest_ms"] = p["device_ms"] - sum(p["ranges"].values())
    log(f"[quant] profile {mode} L={l} ({qd.shape[0]} queries): wall {out['wall_ms']:.1f} ms, "
        f"device busy {out['device_ms']:.2f} ms (idle share {out['idle_share']:.3f}): "
        f"membership {out['membership']:.2f} ms, sorts {out['sorts']:.2f} ms, rest "
        f"{out['rest_ms']:.2f} ms")
    out["top"] = log_top_kernels("quant", p["kernels"], n=6)
    return out


def run_modes(idx, qd, k1, *, min_cover: float = 0.9) -> dict:
    """The search modes of `graph/modes.py` on the main path's index, each
    on the packed walk (K1 must launch) and the full route where asked:
    range search on RANGE_NQ queries (full: the resume route; packed: the
    restart route) at the median exact 20th-neighbour distance, against a
    brute-force scan (every id inside the radius, coverage >= min_cover);
    `PagedSearch`, PAGES pages of PAGE_K for PAGED_NQ queries (disjoint,
    distance-sorted pages; in full mode pages 1-2 equal one search(k=20)
    at the same L); `search_diverse` with the zipf categories of the
    filtered phase, one per category, both enforce routes (quota held, no
    repeated id; recall against the exact diverse top-10 of each query's
    exact top-1000); `determinant_rerank` on DET_NQ queries (k distinct
    ids from each query's top-L).  Raises on a failed gate."""
    import numpy as np
    import torch

    from diskann_tpu_torch.graph import modes
    from diskann_tpu_torch.ops.distance import distance_to_set

    device = qd.device
    n = idx.n
    out = {"k1_launches": {}}
    q = qd[:RANGE_NQ]
    dm = distance_to_set(q, idx.state.vectors[:n], idx.metric,
                         x_sq_norms=idx.state.sq_norms[:n])       # [RANGE_NQ, n]
    top_d, top_i = torch.topk(dm, 1000, dim=1, largest=False, sorted=True)
    radius = float(top_d[:, 19].median())
    inside = dm <= radius
    want = [set(torch.nonzero(row).squeeze(1).tolist()) for row in inside]
    dm_h = dm.cpu().numpy()
    del dm, inside

    def launches(name, fn):
        before = k1.launches
        res, dt = _timed(torch, device, fn)
        out["k1_launches"][name] = k1.launches - before
        return res, dt

    # ---- range search ----
    out["range"] = {"radius": radius, "in_radius_mean": float(np.mean([len(w) for w in want]))}
    for mode, route in (("full", "resume"), ("packed", "restart")):
        (res, complete), dt = launches(f"range_{mode}", lambda: modes.range_search(
            idx, q, radius, mode=mode, return_complete=True))
        hit = tot = 0
        for i, got in enumerate(res):
            if len(got) and (dm_h[i, got] > radius * (1 + 1e-4)).any():
                raise RuntimeError(f"[modes] range {mode}: an id outside the radius")
            if len(set(got.tolist())) != len(got):
                raise RuntimeError(f"[modes] range {mode}: a repeated id")
            hit += len(set(got.tolist()) & want[i])
            tot += len(want[i])
        cover = hit / max(tot, 1)
        out["range"][mode] = {"route": route, "coverage": cover, "s": dt,
                              "complete": float(complete.mean()),
                              "returned_mean": float(np.mean([len(r) for r in res]))}
        log(f"[modes] range_search {mode} ({route} route) {RANGE_NQ} queries, radius "
            f"{radius:.3f} (mean {out['range']['in_radius_mean']:.1f} exact ids inside): "
            f"coverage {cover:.4f} (need >= {min_cover}), complete "
            f"{complete.mean():.3f}, {dt:.2f}s, K1 launches "
            f"{out['k1_launches'][f'range_{mode}']}")
        if cover < min_cover:
            raise RuntimeError(f"[modes] range {mode}: coverage {cover:.4f} < {min_cover}")

    # ---- paged search ----
    l_pg = max(16, idx.config.l_build)
    _, ids_s, _ = idx.search(qd[:PAGED_NQ], 2 * PAGE_K, l_search=l_pg, mode="full")
    out["paged"] = {}
    for mode in ("full", "packed"):
        def pages():
            rows = []
            for i in range(PAGED_NQ):
                pager = modes.PagedSearch(idx, qd[i], l_search=l_pg, mode=mode)
                rows.append([pager.next_page(PAGE_K) for _ in range(PAGES)])
            return rows
        rows, dt = launches(f"paged_{mode}", pages)
        hit, same12 = 0, 0
        for i, pg in enumerate(rows):
            ids = np.concatenate([p[1] for p in pg])
            if len(set(ids.tolist())) != len(ids):
                raise RuntimeError(f"[modes] paged {mode}: pages overlap (query {i})")
            if any((np.diff(p[0]) < 0).any() for p in pg):
                raise RuntimeError(f"[modes] paged {mode}: a page is not distance-sorted")
            hit += len(set(ids.tolist()) & set(top_i[i, :PAGES * PAGE_K].tolist()))
            same12 += list(np.concatenate([pg[0][1], pg[1][1]])) == list(ids_s[i])
        rec = hit / (PAGED_NQ * PAGES * PAGE_K)
        out["paged"][mode] = {"recall_union": rec, "pages_1_2_equal_search": same12, "s": dt}
        log(f"[modes] PagedSearch {mode} {PAGED_NQ} queries x {PAGES} pages of {PAGE_K} "
            f"(L={l_pg}): disjoint, sorted; recall@{PAGES * PAGE_K} of the union "
            f"{rec:.4f}; pages 1-2 equal search(k={2 * PAGE_K}) on {same12}/{PAGED_NQ} "
            f"queries; "
            f"{dt:.2f}s, K1 launches {out['k1_launches'][f'paged_{mode}']}")
        if mode == "full" and same12 != PAGED_NQ:
            raise RuntimeError(f"[modes] paged full: pages 1-2 differ from search(k=20) "
                               f"on {PAGED_NQ - same12} queries")

    # ---- diverse search ----
    cats = bench_cats(n).astype(np.int32)
    cats_d = torch.as_tensor(cats, device=device)
    _, exact = modes.diverse_topk_device(top_d, top_i.to(torch.int32), cats_d, K, 1)
    exact = exact.cpu().numpy()
    out["diverse"] = {}
    for enforce in ("post", "traversal"):
        (d, ids, st), dt = launches(f"diverse_{enforce}", lambda: modes.search_diverse(
            idx, q, cats, k=K, max_per_attribute=1, mode="packed", enforce=enforce))
        for row in ids:
            got = row[row >= 0]
            if len(set(got.tolist())) != len(got) or len(set(cats[got].tolist())) != len(got):
                raise RuntimeError(f"[modes] diverse {enforce}: quota broken or id repeated")
        rec = float(np.mean([len(set(a[a >= 0].tolist()) & set(b.tolist())) / K
                             for a, b in zip(ids, exact)]))
        out["diverse"][enforce] = {"recall": rec, "s": dt, "full_rows": float((ids >= 0).all(1).mean()),
                                   "mean_hops": float(st.hops.mean())}
        log(f"[modes] search_diverse packed enforce={enforce} {RANGE_NQ} queries, one per "
            f"category: quota held, no repeats; recall against the exact diverse top-{K} "
            f"{rec:.4f}; rows with {K} results {out['diverse'][enforce]['full_rows']:.3f}; "
            f"{dt:.2f}s, K1 launches {out['k1_launches'][f'diverse_{enforce}']}")

    # ---- determinant rerank ----
    qdet = qd[:DET_NQ]
    (d, ids, st), dt = launches("determinant", lambda: modes.determinant_rerank(
        idx, qdet, k=K, mode="packed"))
    l_det = max(4 * K, idx.config.l_build)
    _, top, _ = idx.search(qdet, l_det, l_search=l_det, mode="packed")
    for i, row in enumerate(ids):
        if (row < 0).any() or len(set(row.tolist())) != K or not set(row.tolist()) <= set(top[i].tolist()):
            raise RuntimeError(f"[modes] determinant_rerank: bad selection on query {i}")
    out["determinant"] = {"s": dt, "l": l_det}
    log(f"[modes] determinant_rerank packed {DET_NQ} queries, k={K} of L={l_det}: {K} "
        f"distinct ids from each top-L; {dt:.2f}s, K1 launches "
        f"{out['k1_launches']['determinant']}")
    for name, c in out["k1_launches"].items():
        if ("packed" in name or "diverse" in name or name == "determinant") and c < 1:
            raise RuntimeError(f"[modes] {name}: K1 never launched on a packed route")
    return out


def merged_invariants(ti, what: str) -> None:
    """A tiered graph's structure on its device: no self loop, no repeated
    id in a row, degrees equal row contents, and the packed id words equal
    adjacency when a packed layout is attached."""
    import torch

    g = ti.graph
    adj = g.state.adjacency[: g.n]
    if (adj == torch.arange(g.n, device=adj.device)[:, None]).any():
        raise RuntimeError(f"{what}: self-loop")
    s = torch.sort(torch.where(adj < 0, 2**31 - 1, adj), dim=1).values
    if ((s[:, 1:] == s[:, :-1]) & (s[:, 1:] < 2**31 - 1)).any():
        raise RuntimeError(f"{what}: a row repeats an id")
    if not torch.equal((adj >= 0).sum(1, dtype=torch.int32), g.state.degrees[: g.n]):
        raise RuntimeError(f"{what}: degrees do not match adjacency rows")
    if g.packed is not None:
        cap, rs = g.state.adjacency.shape
        words = g.packed.rows.view(cap + 1, g.packed.nwr * 128)[:cap, :rs]
        if not torch.equal(words, g.state.adjacency):
            raise RuntimeError(f"{what}: the packed id words differ from adjacency")


def check_small_tiered(torch, device, n: int = 20_000) -> float:
    """The tiered index and the merged build on a small input (n points):
    a `TieredIndex.build_from_host` on the card, carried to the CPU, both
    searched with the router (>= 99% identical ids); the card's tier saved
    and loaded on the CPU (ids identical to the carried copy's); then
    `build_merged` (3 shards, R=24, L=48, occlusion cap 64) with codes
    "packed" and "sq" on both devices: every invariant, and recall@10
    within 0.01 (the two devices' k-means draw different partitions).  Returns the smallest share."""
    import shutil
    import tempfile

    import numpy as np

    from diskann_tpu_torch import FlatIndex, GraphConfig
    from diskann_tpu_torch.bench.harness import make_clustered
    from diskann_tpu_torch.bench.recall import knn_recall
    from diskann_tpu_torch.convert import graph_index_from_arrays, index_arrays
    from diskann_tpu_torch.tiered import HostVectorStore, TieredIndex, build_merged

    cpu = torch.device("cpu")
    x, q = make_clustered(2, n, 512, D, n_clusters=256, sigma=0.35)
    _, gt = FlatIndex(x, device=device).search(q, K)
    cfg = GraphConfig(max_degree=32, l_build=64, beam_width=4)
    card = TieredIndex.build_from_host(x, cfg, dp=64, insert_batch_size=4096, device=device)
    host = TieredIndex(graph_index_from_arrays(**index_arrays(card.graph), device=cpu,
                                               insert_batch_size=4096), HostVectorStore(x))
    kw = dict(l_search=64, batch_size=256, router_starts=4)
    for ti in (card, host):
        ti.attach_router(4096)
    _, ids_card, _ = card.search_batched(q, K, **kw)
    _, ids_host, _ = host.search_batched(q, K, **kw)
    share = float((ids_card == ids_host).mean())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_small_")
    try:
        card.save(f"{tmp}/tiered")
        back = TieredIndex.load(f"{tmp}/tiered", device=cpu)
        back.attach_router(4096)
        _, ids_back, _ = back.search_batched(q, K, **kw)
    finally:
        shutil.rmtree(tmp)
    same = bool(np.array_equal(ids_back, ids_host))
    log(f"[small] n={n} tiered search (router 4096, L=64) on the card vs the CPU: identical "
        f"ids {share:.4f} (need >= 0.99), recall@{K} {knn_recall(ids_card, gt, K):.4f}; saved "
        f"on the card, loaded on the CPU: ids identical to the CPU copy's {same}")
    if share < 0.99 or not same:
        raise RuntimeError(f"[small] tiered: card vs CPU {share:.4f}, reload identical {same}")
    # an occlusion cap of 64 keeps the two CPU builds' prune near 15 s each
    # (at 256 they took 85-102 s of the card host's CPU)
    mcfg = GraphConfig(max_degree=24, l_build=48, beam_width=4, build_max_hops=12,
                       max_occlusion_size=64)
    for codes in ("packed", "sq"):
        rec = {}
        for name, dev in (("card", device), ("cpu", cpu)):
            (t, dt) = _timed(torch, dev, lambda: build_merged(
                x, mcfg, n_shards=3, dp=32, insert_batch_size=4096, codes=codes, device=dev))
            merged_invariants(t, f"[small] merged {codes} on the {name}")
            _, ids, _ = t.search_batched(q, K, l_search=64, batch_size=512)
            rec[name] = (knn_recall(ids, gt, K), dt)
            del t
        diff = abs(rec["card"][0] - rec["cpu"][0])
        log(f"[small] n={n} build_merged 3 shards codes={codes}: invariants held on both; "
            f"recall@{K} card {rec['card'][0]:.4f} ({rec['card'][1]:.1f}s) vs CPU "
            f"{rec['cpu'][0]:.4f} ({rec['cpu'][1]:.1f}s), |diff| {diff:.4f} (need <= 0.01)")
        if diff > 0.01:
            raise RuntimeError(f"[small] merged {codes}: recall differs by {diff:.4f}")
    return share


def run_tiered(idx, qd, gt, gt_cat0, radius, k1) -> dict:
    """`scripts/bench_tiered.py`'s setting on the main path's 1M index: its
    vectors written to an .fbin, the start pinned and the device copy
    dropped, `TieredIndex(graph, HostVectorStore.from_fbin(path,
    cache_rows=65536))` with a 65536-row router; `search_batched` on all
    queries (k=10, L=100, batch 4096, router_starts=4) at io_limit in
    TIERED_IO, float16 rows at io_limit 32, `search_filtered("cat0", L=90)`
    and `search_range` on RANGE_NQ queries at the modes phase's radius; one
    call traced.  Raises unless some io_limit reaches TARGET_RECALL, K1
    launched, the store is the native reader, every range result lies in
    the radius and every filtered result honours its predicate."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from diskann_tpu_torch.bench.recall import knn_recall
    from diskann_tpu_torch.io_ import write_fbin
    from diskann_tpu_torch.ops.distance import distance_to_set
    from diskann_tpu_torch.tiered import HostVectorStore, TieredIndex

    device = qd.device
    q = qd.cpu().numpy()
    n = idx.n
    out = {"rows": []}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tiered_")
    try:
        x = idx.state.vectors[:n].cpu().numpy()
        path = os.path.join(tmp, "base.fbin")
        t0 = time.time()
        write_fbin(path, x)
        out["write_s"] = time.time() - t0
        idx.drop_vectors()
        torch.cuda.empty_cache()
        ti = TieredIndex(idx, HostVectorStore.from_fbin(path, cache_rows=1 << 16))
        if not ti.store.is_native:
            raise RuntimeError("[tiered] the store is not the native reader")
        ti.attach_router(65536)
        log(f"[tiered] {n} x {D} vectors to {path} ({os.path.getsize(path) / 1e9:.2f} GB, "
            f"{out['write_s']:.1f}s); device copy dropped; native reader, 65536-row LRU "
            f"cache, router 65536 rows")

        def run(label, io, **kw):
            ti.io_limit = io
            ti.search_batched(q[:4096], K, **TIERED_KW, **kw)          # warm-up
            ti.io_stats = {"rows_staged": 0, "stage_s": 0.0}
            before = k1.launches
            (d, ids, st), dt = _timed(torch, device,
                                      lambda: ti.search_batched(q, K, **TIERED_KW, **kw))
            if ids.shape != (NQ, K) or not np.isfinite(d[ids >= 0]).all():
                raise RuntimeError(f"[tiered] {label}: malformed result")
            row = {"run": label, "io_limit": io, "recall": knn_recall(ids, gt, K),
                   "qps": NQ / dt, "rows_staged": ti.io_stats["rows_staged"],
                   "stage_submit_s": ti.io_stats["stage_s"], "k1_launches": k1.launches - before,
                   "mean_hops": float(st.hops.mean())}
            out["rows"].append(row)
            log(f"[tiered] {label} io_limit={io} L=100 batch 4096 router_starts=4: "
                f"recall@{K}={row['recall']:.4f} qps={row['qps']:.0f} rows staged "
                f"{row['rows_staged']} (submit {row['stage_submit_s'] * 1e3:.1f} ms) "
                f"K1 launches {row['k1_launches']} mean_hops={row['mean_hops']:.2f}")

        for io in TIERED_IO:
            run("float32 rows", io)
        run("float16 rows", 32, row_wire=np.float16)
        best = max(r["recall"] for r in out["rows"])
        if best < TARGET_RECALL:
            raise RuntimeError(f"[tiered] no io_limit reached recall {TARGET_RECALL} ({best:.4f})")
        if min(r["k1_launches"] for r in out["rows"]) < 1:
            raise RuntimeError("[tiered] K1 never launched")

        ti.io_limit = None
        mask = pred_mask(bench_cats(n), "cat0")
        before = k1.launches
        (d, ids, st), dt = _timed(torch, device, lambda: ti.search_filtered(
            q, "cat0", K, l_search=90, batch_size=4096))
        check_filtered_ids(ids, mask, "[tiered] filtered 'cat0'")
        out["filtered"] = {"recall": knn_recall(ids, gt_cat0, K), "qps": NQ / dt,
                           "k1_launches": k1.launches - before}
        log(f"[tiered] search_filtered 'cat0' L=90: recall@{K}="
            f"{out['filtered']['recall']:.4f} qps={out['filtered']['qps']:.0f} "
            f"K1 launches {out['filtered']['k1_launches']}; every result honours 'cat0'")
        if out["filtered"]["k1_launches"] < 1:
            raise RuntimeError("[tiered] the filtered walk never launched K1")

        qr = q[:RANGE_NQ]
        res, dt = _timed(torch, device, lambda: ti.search_range(qr, radius, l_init=32))
        xd = torch.from_numpy(x).to(device)
        dm = distance_to_set(torch.from_numpy(qr).to(device), xd, idx.metric).cpu().numpy()
        del xd
        hit = tot = 0
        for i, got in enumerate(res):
            if len(got) and (dm[i, got] > radius * (1 + 1e-4)).any():
                raise RuntimeError("[tiered] a range result lies outside the radius")
            want = np.nonzero(dm[i] <= radius)[0]
            hit += len(np.intersect1d(got, want))
            tot += len(want)
        out["range"] = {"radius": radius, "coverage": hit / max(tot, 1), "s": dt}
        log(f"[tiered] search_range {RANGE_NQ} queries radius {radius:.3f}: every id inside "
            f"the radius, coverage {out['range']['coverage']:.4f}, {dt:.2f}s")

        ti.io_limit = 32
        p = profile_call(lambda: ti.search_batched(q, K, **TIERED_KW), device, [],
                         names=("tiered.traverse", "tiered.stage_wait", "tiered.upload",
                                "tiered.rerank"))
        k1_ms = sum(_device_ms(e) for e in p["kernels"] if "fatrow_expand" in e.key)
        out["profile"] = {"wall_ms": p["wall_ms"], "device_ms": p["device_ms"],
                          "idle_share": p["idle_share"], "k1_ms": k1_ms,
                          "host_ms": p["host_ms"], "device_ranges_ms": p["ranges"]}
        hm, dr = p["host_ms"], p["ranges"]
        log(f"[profile] tiered search_batched io_limit=32 ({NQ} queries, L=100): wall "
            f"{p['wall_ms']:.1f} ms = traverse {hm['tiered.traverse']:.1f} + gather wait "
            f"{hm['tiered.stage_wait']:.1f} + upload {hm['tiered.upload']:.1f} + rerank "
            f"{hm['tiered.rerank']:.1f} ms (host time in each range); device busy "
            f"{p['device_ms']:.2f} ms (idle share {p['idle_share']:.3f}): traverse "
            f"{dr['tiered.traverse']:.2f}, upload {dr['tiered.upload']:.2f}, rerank "
            f"{dr['tiered.rerank']:.2f} ms, K1 {k1_ms:.2f} ms")
        out["profile"]["top"] = log_top_kernels("profile", p["kernels"], n=6)
    finally:
        shutil.rmtree(tmp)
    return out


def run_merged(device, k1, k2) -> dict:
    """The JAX package's 20M recipe (`scripts/bench_deep20m.py`, codes
    "sq"), cut to MERGED_N points in MERGED_SHARDS shards: clustered data
    (32768 clusters, sigma 0.35) with exact top-10 by `FlatIndex`, written
    to an .fbin; `build_merged(R=40, L=64, alpha=1.2, W=4,
    build_max_hops=12, occlusion cap 256, overlap 2, dp=32, batch 8192)`;
    the store swapped for the native reader (1M-row cache) and a
    65536-row router; the sweep of MERGED_L x MERGED_RL (batch 1024,
    router_starts=4, float16 rows) and the full-list recall per L; then
    save (copy_vectors=False) and load.  Raises unless some point reaches
    TARGET_RECALL, K1 and K2 launched in the build and the reload returns
    identical ids."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from diskann_tpu_torch import FlatIndex, GraphConfig
    from diskann_tpu_torch.bench.harness import make_clustered
    from diskann_tpu_torch.bench.recall import knn_recall
    from diskann_tpu_torch.io_ import write_fbin
    from diskann_tpu_torch.tiered import HostVectorStore, TieredIndex, build_merged

    out = {"n": MERGED_N, "nq": MERGED_NQ, "shards": MERGED_SHARDS, "rows": []}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_merged_")
    try:
        (x, q), dt = _timed(torch, device, lambda: make_clustered(
            7, MERGED_N, MERGED_NQ, D, n_clusters=32768, sigma=0.35))
        (_, gt), dt_gt = _timed(torch, device, lambda: FlatIndex(x, device=device).search(q, K))
        path = os.path.join(tmp, "base.fbin")
        write_fbin(path, x)
        log(f"[merged] data {MERGED_N} x {D} (32768 clusters, sigma 0.35): {dt:.1f}s; exact "
            f"top-{K} of {MERGED_NQ} queries: {dt_gt:.1f}s; .fbin written")
        cfg = GraphConfig(max_degree=40, l_build=64, alpha=1.2, beam_width=4,
                          build_max_hops=12, max_occlusion_size=256)
        take_launches(k1, k2)
        ti, dt = _timed(torch, device, lambda: build_merged(
            x, cfg, n_shards=MERGED_SHARDS, overlap=2, dp=32, insert_batch_size=8192,
            codes="sq", device=device, verbose=True))
        out["build_launches"] = take_launches(k1, k2, "merged build")
        out["build_s"] = dt
        out["build_points_per_s"] = MERGED_N / dt
        merged_invariants(ti, "[merged]")
        log(f"[merged] build_merged {MERGED_SHARDS} shards overlap 2 codes=sq: {dt:.1f}s "
            f"({MERGED_N / dt:.0f} points/s); invariants held")
        if min(out["build_launches"].values()) < 1:
            raise RuntimeError(f"[merged] a kernel never launched in the build: "
                               f"{out['build_launches']}")
        ti.store = HostVectorStore.from_fbin(path, cache_rows=1 << 20)
        if not ti.store.is_native:
            raise RuntimeError("[merged] the store is not the native reader")
        ti.attach_router(65536)
        for l in MERGED_L:
            for rl in MERGED_RL:
                kw = dict(l_search=l, beam_width=4, batch_size=1024, rerank_l=rl,
                          router_starts=4, row_wire=np.float16)
                ti.search_batched(q, K, **kw)                          # warm-up
                (d, ids, st), dt = _timed(torch, device, lambda: ti.search_batched(q, K, **kw))
                if ids.shape != (MERGED_NQ, K) or not np.isfinite(d[ids >= 0]).all():
                    raise RuntimeError(f"[merged] L={l} rl={rl}: malformed result")
                row = {"l": l, "rl": rl, "recall": knn_recall(ids, gt, K),
                       "qps": MERGED_NQ / dt, "mean_hops": float(st.hops.mean())}
                out["rows"].append(row)
                r04 = R04_DEEP20M.get((l, rl))
                log(f"[merged] L={l} rerank_l={rl} W=4 batch 1024 router_starts=4 float16 "
                    f"rows: recall@{K}={row['recall']:.4f} qps={row['qps']:.0f} mean_hops="
                    f"{row['mean_hops']:.2f}"
                    + (f" (JAX package at 20M: {r04})" if r04 else ""))
            _, ids_l, _ = ti.search_batched(q, K, l_search=l, beam_width=4, batch_size=1024,
                                            rerank_l=l, router_starts=4)
            out["rows"].append({"l": l, "rl": l, "recall": knn_recall(ids_l, gt, K),
                                "qps": None})
            log(f"[merged] L={l}: recall@{K} of the full L list {out['rows'][-1]['recall']:.4f}")
        out["search_launches"] = take_launches(k1, k2, "merged search")
        best = max(r["recall"] for r in out["rows"] if r["qps"])
        if best < TARGET_RECALL:
            raise RuntimeError(f"[merged] no point reached recall {TARGET_RECALL} ({best:.4f})")

        kw = dict(l_search=80, beam_width=4, batch_size=1024, rerank_l=16, router_starts=4)
        _, want, _ = ti.search_batched(q, K, **kw)
        rec = os.path.join(tmp, "tiered")
        _, save_s = _timed(torch, device, lambda: ti.save(rec, copy_vectors=False))
        nbytes = sum(os.path.getsize(os.path.join(dp_, f))
                     for dp_, _, fs in os.walk(rec) for f in fs)
        back, load_s = _timed(torch, device, lambda: TieredIndex.load(rec, device=device))
        back.attach_router(65536)
        _, got, _ = back.search_batched(q, K, **kw)
        same = bool(np.array_equal(got, want))
        out["save_load"] = {"bytes": nbytes, "save_s": save_s, "load_s": load_s,
                            "identical": same}
        log(f"[merged] save (copy_vectors=False) {nbytes / 1e9:.3f} GB in {save_s:.2f}s "
            f"({nbytes / save_s / 1e9:.2f} GB/s), TieredIndex.load {load_s:.2f}s "
            f"({nbytes / load_s / 1e9:.2f} GB/s): ids identical {same}")
        if not same:
            raise RuntimeError("[merged] the reloaded tier returns other ids")
    finally:
        shutil.rmtree(tmp)
    return out


def save_load_wiki(idx, qd) -> dict:
    """Save the 100k x 768 index (packed, sq and pq attached), load it, and
    hold ids and distances identical in full, packed, sq and pq mode on
    1024 queries.  Returns the bytes and the GB/s of each way."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from diskann_tpu_torch import GraphIndex

    device = qd.device
    q = qd[:1024]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_wiki_")
    try:
        path = os.path.join(tmp, "wiki")
        _, save_s = _timed(torch, device, lambda: idx.save(path))
        nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        back, load_s = _timed(torch, device, lambda: GraphIndex.load(
            path, device=device, insert_batch_size=idx.insert_batch_size,
            search_batch_size=idx.search_batch_size))
    finally:
        shutil.rmtree(tmp)
    for mode in ("full", "packed", "sq", "pq"):
        kw = dict(WIKI_SEARCH, mode=mode)
        d0, i0, s0 = idx.search(q, 100, **kw)
        d1, i1, s1 = back.search(q, 100, **kw)
        if not (np.array_equal(i0, i1) and np.array_equal(d0, d1)
                and np.array_equal(s0.hops, s1.hops)):
            raise RuntimeError(f"[wiki] {mode}: the reloaded index returns other results")
    out = {"bytes": nbytes, "save_s": save_s, "load_s": load_s,
           "save_gb_per_s": nbytes / save_s / 1e9, "load_gb_per_s": nbytes / load_s / 1e9}
    log(f"[wiki] save {nbytes / 1e9:.3f} GB in {save_s:.2f}s ({out['save_gb_per_s']:.2f} GB/s), "
        f"GraphIndex.load {load_s:.2f}s ({out['load_gb_per_s']:.2f} GB/s): ids, distances and "
        f"hops identical in full, packed, sq and pq mode (1024 queries, k=100)")
    return out


def wiki_data(n: int = WIKI_N, nq: int = WIKI_NQ, seed: int = 42):
    """`scripts/bench_wiki100k.py`'s embeddings, drawn with numpy: 1024
    clusters in 64 latent dimensions (noise 0.35), a random lift to 768
    (noise 0.02), unit norm."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dlat, nc = 64, 1024
    centers = rng.standard_normal((nc, dlat), dtype=np.float32)
    lift = rng.standard_normal((dlat, WIKI_D), dtype=np.float32) / np.float32(np.sqrt(dlat))

    def emb(m):
        z = centers[rng.integers(0, nc, m)] + 0.35 * rng.standard_normal((m, dlat), dtype=np.float32)
        e = z @ lift + 0.02 * rng.standard_normal((m, WIKI_D), dtype=np.float32)
        return e / np.linalg.norm(e, axis=1, keepdims=True)

    return emb(n), emb(nq)


def run_wiki(device, k1, *, n: int = WIKI_N, nq: int = WIKI_NQ,
             min_recall100: float = WIKI_MIN_RECALL100) -> dict:
    """The 100k x 768 inner-product shape: exact top-100 by `FlatIndex`,
    the full build (R=60, L=80, alpha=1.2, W=4, build_max_hops=12,
    occlusion cap 256, batch 8192), `attach_packed(dp=128)`, `attach_sq()`
    and `attach_pq(n_chunks=192)`, then k=100 searches at L=200, W=8,
    router_starts=16, max_hops=12, float16 queries for packed, sq and pq.
    Raises unless sq and packed reach recall@100 >= min_recall100."""
    import numpy as np
    import torch

    from diskann_tpu_torch import FlatIndex, GraphConfig, GraphIndex, Metric
    from diskann_tpu_torch.bench.recall import knn_recall

    out = {"n": n, "nq": nq, "rows": []}
    (x, q), dt = _timed(torch, device, lambda: wiki_data(n, nq))
    log(f"[wiki] data {n} x {WIKI_D} unit vectors, {nq} queries: {dt:.1f}s")
    xd, qd = torch.from_numpy(x).to(device), torch.from_numpy(q).to(device)
    del x
    (_, gt), dt = _timed(torch, device, lambda: FlatIndex(xd, Metric.InnerProduct).search(qd, 100))
    log(f"[wiki] exact inner-product top-100: {dt:.1f}s")
    cfg = GraphConfig(max_degree=60, l_build=80, alpha=1.2, beam_width=4,
                      metric=Metric.InnerProduct, build_max_hops=12, max_occlusion_size=256)
    idx, dt = _timed(torch, device, lambda: GraphIndex.build(
        xd, cfg, insert_batch_size=8192, search_batch_size=2048, build_mode="full"))
    out["build_s"] = dt
    log(f"[wiki] full build (R=60, L=80, alpha=1.2, W=4, build_max_hops=12): {dt:.1f}s "
        f"({n / dt:.0f} points/s)")
    del xd
    out["attach_s"] = {}
    for name, fn in (("packed", lambda: idx.attach_packed(dp=128)), ("sq", idx.attach_sq),
                     ("pq", lambda: idx.attach_pq(n_chunks=192))):
        _, out["attach_s"][name] = _timed(torch, device, fn)
        log(f"[wiki] attach {name}: {out['attach_s'][name]:.2f}s")
    out["k1_launches"] = 0
    for mode in ("packed", "sq", "pq"):
        kw = dict(WIKI_SEARCH, mode=mode, query_dtype=np.float16)
        idx.search(qd[:256], 100, **kw)                                    # warm-up
        before = k1.launches
        (dists, ids, st), dt = _timed(torch, device, lambda: idx.search(qd, 100, **kw))
        if mode == "packed":
            out["k1_launches"] = k1.launches - before
        if ids.shape != (nq, 100) or not np.isfinite(dists[ids >= 0]).all():
            raise RuntimeError(f"[wiki] {mode}: malformed result")
        row = {"mode": mode, "recall10": knn_recall(ids[:, :10], gt[:, :10], 10),
               "recall100": knn_recall(ids, gt, 100), "qps": nq / dt,
               "mean_hops": float(st.hops.mean())}
        out["rows"].append(row)
        r04 = R04_WIKI[mode]
        r04_txt = (f"r04 recall@10 {r04[0]} recall@100 {r04[1]}" if r04
                   else "r04 recorded no row")
        log(f"[wiki] {mode} k=100 L=200 W=8 router_starts=16 max_hops=12 float16: "
            f"recall@10={row['recall10']:.4f} recall@100={row['recall100']:.4f} "
            f"qps={row['qps']:.0f} mean_hops={row['mean_hops']:.2f} ({r04_txt})")
        if mode in ("packed", "sq") and row["recall100"] < min_recall100:
            raise RuntimeError(f"[wiki] {mode}: recall@100 {row['recall100']:.4f} "
                               f"< {min_recall100}")
    if out["k1_launches"] < 1:
        raise RuntimeError("[wiki] K1 never launched on the packed search")
    out["save_load"] = save_load_wiki(idx, qd)
    if device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    return out


def time_ms(torch, fn, reps: int = 20) -> float:
    """Mean milliseconds per call on the card, after warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_k1_full(torch, rows, beam, qiw, rp: int, dp: int, n: int) -> int:
    """K1 vs plain, bitwise, on a full-size table; returns the largest
    |difference| (0) or raises."""
    from diskann_tpu_torch.ops.kernels.fatrow_expand import (
        fatrow_expand, fatrow_expand_plain,
    )

    got = fatrow_expand(rows, beam, qiw, rp=rp, dp=dp)
    want = fatrow_expand_plain(rows, beam, qiw, rp=rp, dp=dp)
    torch.cuda.synchronize()
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    nwr = rows.shape[0] // (n + 1)
    past = int((beam.long().clamp(0, n - 1) * nwr * 128 >= 2**31).sum())
    log(f"[k1-full] fatrow_expand rp={rp} dp={dp} n={n} bw={beam.shape[0]} table "
        f"{rows.numel() / 1e9:.2f}e9 words, {past} slots at word offsets >= 2^31: "
        f"tolerance=bitwise bitwise_equal={same} max_abs_err={err}")
    if not same:
        raise RuntimeError(f"fatrow_expand disagrees with its plain version on the "
                           f"full rp={rp} dp={dp} table")
    return err


def check_k2_full(torch, table, dump: int, g) -> int:
    """K2 vs plain, bitwise, on a full-size int32 table: one search-table
    refresh's worth of patches spread over every block, a fifth of them
    on the dump block and some outside the table.  Compares everything
    but the dump block; returns the largest |difference| (0) or raises."""
    from diskann_tpu_torch.ops.kernels.block_patch import block_patch, block_patch_plain

    n_blocks = table.shape[0] // 8
    gk = min(8192 * 3, dump)
    idx = torch.randperm(dump, generator=g, device=table.device)[:gk].to(torch.int32)
    idx[::5] = dump
    idx[1::101] = n_blocks + 2                   # outside the table: skipped
    idx[2] = dump - 1                            # the last live block
    vals = torch.empty((gk * 8, 128), dtype=table.dtype, device=table.device)
    vals.random_(generator=g)
    ref = table.clone()
    block_patch(table, idx, vals)
    block_patch_plain(ref, idx, vals)
    torch.cuda.synchronize()
    lo, hi = dump * 8, (dump + 1) * 8
    same = torch.equal(table[:lo], ref[:lo]) and torch.equal(table[hi:], ref[hi:])
    live = idx[(idx >= 0) & (idx < n_blocks) & (idx != dump)].long()
    past = int((live * 8 * 128 >= 2**31).sum())
    log(f"[k2-full] block_patch int32 table {table.numel() / 1e9:.2f}e9 words "
        f"patches={gk} ({int((idx == dump).sum())} on the dump block, {past} at word "
        f"offsets >= 2^31): tolerance=bitwise outside the dump block "
        f"bitwise_equal={same} max_abs_err={0 if same else 'n/a'}")
    if not same:
        raise RuntimeError("block_patch disagrees with its plain version on the full table")
    return 0


def k1_bound(torch, beam, rp: int, dp: int, n: int) -> dict:
    """K1's least time on the card for this call: the fat rows of the
    distinct beam nodes read once (ids clamped to the table as the wrapper
    does), the beam ids and int8 queries read once, the three outputs
    written once, over 3.35 TB/s; against its int8 multiply-adds over
    1,979 TOP/s.  The larger bounds it."""
    idw, codr, cpr = -(-rp // 128), -(-rp * dp // 512), 512 // dp
    bw = beam.shape[0]
    nodes = int(beam.long().clamp(0, n).unique().numel())
    moved = (nodes * (2 * idw + codr) * 512 + bw * (4 + dp)
             + bw * (2 * idw * 128 + codr * cpr) * 4)
    ops = 2 * bw * codr * cpr * dp
    t_bytes, t_ops = moved / HBM_BYTES_PER_MS, ops / INT8_OPS_PER_MS
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": moved}


def time_kernels(torch, device, n: int) -> dict:
    """Kernel vs plain at the main path's shapes, on random tables of the
    main path's size: K1 at BW = 8192 x 4 slots on the dp=64 build table
    and the dp=128 search table (past 2^31 words at 1M rows); K2 at one
    build commit's refresh (8192 rows x 2 blocks of the dp=64 table).  On
    the same tables each kernel's output is held bitwise against its plain
    version's: K1 at both geometries, K2 on the dp=128 table."""
    from diskann_tpu_torch.graph.packed import n_wrows
    from diskann_tpu_torch.ops.kernels.block_patch import block_patch, block_patch_plain
    from diskann_tpu_torch.ops.kernels.fatrow_expand import (
        fatrow_expand, fatrow_expand_plain,
    )

    g = torch.Generator(device=device).manual_seed(5)
    res = {"k1_err": 0}
    bw = NQ * 4
    for rp, dp in ((88, 64), (84, 128)):
        nwr = n_wrows(rp, dp)
        rows = torch.empty(((n + 1) * nwr, 128), dtype=torch.int32, device=device)
        rows.random_(generator=g)
        beam = torch.randint(0, n, (bw,), generator=g, device=device, dtype=torch.int32)
        # the last row, and ids the wrapper clamps
        beam[:4] = torch.tensor([n - 1, n + 5, -3, 2**31 - 1], dtype=torch.int32)
        qiw = torch.randint(-127, 128, (bw, dp), generator=g, device=device,
                            dtype=torch.int8)
        res["k1_err"] = max(res["k1_err"], check_k1_full(torch, rows, beam, qiw, rp, dp, n))
        ms = time_ms(torch, lambda: fatrow_expand(rows, beam, qiw, rp=rp, dp=dp))
        plain = time_ms(torch, lambda: fatrow_expand_plain(rows, beam, qiw, rp=rp, dp=dp))
        read = bw * (2 * -(-rp // 128) + -(-rp * dp // 512)) * 512
        res[f"k1_rp{rp}_dp{dp}"] = {"ms": ms, "plain_ms": plain,
                                     "gb_per_s": read / ms / 1e6,
                                     **k1_bound(torch, beam, rp, dp, n)}
        b = res[f"k1_rp{rp}_dp{dp}"]
        log(f"[time] fatrow_expand rp={rp} dp={dp} bw={bw} table {rows.numel() * 4 / 1e9:.2f} GB: "
            f"kernel {ms:.3f} ms ({read / ms / 1e6:.0f} GB/s of rows read), "
            f"plain {plain:.3f} ms, bound {b['bound_ms']:.3f} ms "
            f"({b['bound_bytes'] / 1e6:.1f} MB at 3.35 TB/s, by {b['bound_by']})")
        if dp == 64:
            n_blocks = rows.shape[0] // 8
            nb = 8192 * (nwr // 8)
            idx = torch.randperm(n_blocks - 1, generator=g, device=device)[:nb]
            idx = idx.to(torch.int32)
            vals = torch.empty((nb * 8, 128), dtype=torch.int32, device=device)
            vals.random_(generator=g)
            ms = time_ms(torch, lambda: block_patch(rows, idx, vals))
            plain = time_ms(torch, lambda: block_patch_plain(rows, idx, vals))
            # the one library call that computes the same function
            ridx = (idx.long()[:, None] * 8
                    + torch.arange(8, device=device)[None, :]).reshape(-1)
            lib = time_ms(torch, lambda: rows.index_copy_(0, ridx, vals))
            moved = 2 * nb * 8 * 128 * 4 + nb * 4
            res["k2_int32"] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                               "patches": nb, "gb_per_s": 2 * nb * 4096 / ms / 1e6,
                               "bound_ms": moved / HBM_BYTES_PER_MS,
                               "bound_by": "bytes"}
            log(f"[time] block_patch int32 patches={nb} table "
                f"{rows.numel() * 4 / 1e9:.2f} GB: kernel {ms:.3f} ms "
                f"({2 * nb * 4096 / ms / 1e6:.0f} GB/s moved), plain {plain:.3f} ms, "
                f"index_copy_ {lib:.3f} ms, bound {res['k2_int32']['bound_ms']:.3f} ms "
                f"({moved / 1e6:.1f} MB at 3.35 TB/s)")
            del idx, vals, ridx
        else:
            res["k2_err"] = check_k2_full(torch, rows, n * nwr // 8, g)
        del rows, beam, qiw
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="database size of the main path (default 1,000,000)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA card")
    from diskann_tpu_torch.ops.kernels import block_patch as k2
    from diskann_tpu_torch.ops.kernels import fatrow_expand as k1
    from diskann_tpu_torch.ops.kernels import native

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"[device] {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | python {sys.version.split()[0]} | "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.time()
    lib = native.build()
    native.library()
    log(f"[build] nvcc {' '.join(native.NVCC_FLAGS)} -> {lib.name}: "
        f"{time.time() - t0:.1f}s")

    k1_err = check_fatrow_expand(torch, device)
    k2_err = check_block_patch(torch, device)
    check_small_input(torch, device)
    check_small_tiered(torch, device)
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(device)
    k1.launches = 0
    k2.launches = 0
    main_out, idx, qd, gt = run_main_path(args.n, device)
    launches = {"fatrow_expand": k1.launches, "block_patch": k2.launches}
    peak = torch.cuda.max_memory_allocated(device)
    log(f"[main] kernel launches on the main path: {launches}; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    if min(launches.values()) == 0:
        raise RuntimeError(f"a kernel of the main path never launched: {launches}")

    # the filtered path runs K1 only: K2 writes the table it reads
    k1.launches = 0
    k2.launches = 0
    filt_rows, filt_gt = run_filtered(idx, qd, k1)
    filt_launches = {"fatrow_expand": k1.launches, "block_patch": k2.launches}
    log(f"[filtered] kernel launches on the filtered path: {filt_launches}")
    if filt_launches["fatrow_expand"] == 0:
        raise RuntimeError("K1 never launched on the filtered path")
    profiled = profile_filtered_walk(idx, qd)
    full = run_full_route(idx, qd, gt, filt_gt["cat0"])

    # the quantized walks launch no kernel (their scorers are torch ops);
    # every packed route of the modes phase runs K1
    phase_launches = {}
    take_launches(k1, k2)
    quant = run_quant(idx, qd, gt)
    phase_launches["quant"] = take_launches(k1, k2, "quant")
    modes_out = run_modes(idx, qd, k1)
    phase_launches["modes"] = take_launches(k1, k2, "modes")
    # the tiered search walks the packed table (K1) and writes nothing
    tiered = run_tiered(idx, qd, gt, filt_gt["cat0"], modes_out["range"]["radius"], k1)
    phase_launches["tiered"] = take_launches(k1, k2, "tiered")
    del idx, qd
    torch.cuda.empty_cache()

    times = time_kernels(torch, device, args.n)
    torch.cuda.empty_cache()

    # the stream path: deletes launch K2 (refresh_rows), inserts and the
    # checkpoint searches launch both
    x, q = stream_data()
    torch.cuda.reset_peak_memory_stats(device)
    stream = run_stream(x, q, device, k1, k2)
    stream_launches = stream["launches"]
    if min(stream_launches.values()) == 0:
        raise RuntimeError(f"a kernel of the stream path never launched: {stream_launches}")
    torch.cuda.empty_cache()
    k1.launches = 0
    k2.launches = 0
    runbook = run_runbook(x, q, device)
    runbook["launches"] = {"fatrow_expand": k1.launches, "block_patch": k2.launches}
    log(f"[runbook] kernel launches (full precision, no packed layout): "
        f"{runbook['launches']}")
    del x, q
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    take_launches(k1, k2)
    wiki = run_wiki(device, k1)
    phase_launches["wiki"] = take_launches(k1, k2, "wiki")
    torch.cuda.empty_cache()
    # the merged build runs both kernels in every shard's packed build; its
    # sq search walks no packed table
    merged = run_merged(device, k1, k2)
    phase_launches["merged_build"] = merged["build_launches"]
    phase_launches["merged_search"] = merged["search_launches"]

    k1t, k2t = times["k1_rp84_dp128"], times["k2_int32"]
    kernels = [
        {"name": "fatrow_expand", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches["fatrow_expand"],
         "filtered_launches": filt_launches["fatrow_expand"],
         "stream_launches": stream_launches["fatrow_expand"],
         **{f"{p}_launches": phase_launches[p]["fatrow_expand"] for p in phase_launches},
         "max_abs_err": max(k1_err, times["k1_err"]),
         "ms": k1t["ms"], "plain_ms": k1t["plain_ms"],
         "bound_ms": k1t["bound_ms"], "bound_by": k1t["bound_by"],
         "library_ms": None,
         "shape": "rp=84 dp=128 bw=32768",
         "ms_rp88_dp64": times["k1_rp88_dp64"]["ms"],
         "plain_ms_rp88_dp64": times["k1_rp88_dp64"]["plain_ms"],
         "bound_ms_rp88_dp64": times["k1_rp88_dp64"]["bound_ms"]},
        {"name": "block_patch", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["block_patch"],
         "filtered_launches": filt_launches["block_patch"],
         "stream_launches": stream_launches["block_patch"],
         **{f"{p}_launches": phase_launches[p]["block_patch"] for p in phase_launches},
         "max_abs_err": max(k2_err, times["k2_err"]),
         "ms": k2t["ms"], "plain_ms": k2t["plain_ms"],
         "bound_ms": k2t["bound_ms"], "bound_by": k2t["bound_by"],
         "library_ms": k2t["library_ms"],
         "shape": f"int32 patches={k2t['patches']}"},
    ]
    summary = {k: main_out[k] for k in ("n", "build_s", "build_points_per_s", "attach_s")}
    summary["peak_gib"] = peak / 2**30
    summary["sweep"] = [{k: p[k] for k in ("l", "recall", "qps", "mean_hops")}
                        for p in main_out["sweep"]]
    summary["filtered"] = filt_rows
    summary["full_route"] = full
    summary["filtered_profile"] = profiled
    summary["stream"] = stream
    summary["runbook"] = runbook
    summary["quant"] = quant
    summary["modes"] = modes_out
    summary["wiki"] = wiki
    summary["tiered"] = tiered
    summary["merged"] = merged
    log("[summary] " + json.dumps(summary))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
