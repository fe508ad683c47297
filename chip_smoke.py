#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py [--n 1000000]
        [--only kernels|sharded|sharded-trace|sharded6m|build|delete|rollback]

Phases, each printing one line:

1. device: card name, power limit, torch and CUDA versions, TF32 flags;
2. kernel build: one nvcc per source of `diskann_tpu_torch/ops/kernels/csrc/`,
   all started together, then one link; ptxas's report (registers, shared
   memory, spills of every kernel instantiation) is printed;
3. K1 `fatrow_expand` against its plain version, bitwise, at (r_pack, dp) =
   (16, 64), (32, 32), (88, 64), (84, 128) and at the other packed widths
   (16, 4), (16, 8), (84, 256), (40, 512), with repeated and out-of-range
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
   library call that does the same (`index_copy_`).  Every time is the
   device's alone: the timed calls queue behind a `torch.cuda._sleep`
   longer than their enqueue, so the events bracket back-to-back device
   work; the host's time per wrapper call is printed on its own line, and
   the main path's K1 launches at each width times that width's gap to its
   bound;
9. stream: the JAX package's 1M streaming setting (`BENCH_STREAM1M_r05`):
   a packed index over 1M of 1.3M clustered points (capacity 1,040,000),
   then 6 cycles of delete 50,000 (scan, fill,
   max_dead=8) + insert 50,000 + a recall checkpoint (L=90, packed, float16 queries,
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
15. the vector-set service over the wire at the 100k x 768 shape:
   `VectorService` on the card, 99,000 elements by `add_batch` with the
   zipf labels as attributes, then a `VectorSetServer` on 127.0.0.1 driven
   by a `VectorSetClient`: PING, VLIST, VCARD, 1,000 VADDs, 1,024 VSIMs
   (recall@10 against the exact inner-product top-10: >= 0.999 on the flat
   route, >= 0.95 on the graph), 64 VSIM FILTER "cat0", 100 VSIM ELE,
   250 VREMs, VSETATTR / VGETATTR with a FILTER on the new label, VSCAN
   of 5 pages x 10 for 16 queries, VQUANT sq and 128 VSIMs on the sq
   walk (recall >= 0.95); the wall latency p50 / p99 of every command
   kind;
16. the merged build: `scripts/bench_deep20m.py`'s recipe cut to 1.5M points
   in 3 shards (clustered, 32768 clusters, exact top-10), `build_merged(R=40,
   L=64, overlap 2, dp=32, codes="sq")`, the native reader and a 65536-row
   router, a sweep of L = 40, 80, 160 x rerank_l = 16, 64 (float16 rows),
   then save and `TieredIndex.load`; fails unless some point reaches
   recall@10 >= 0.95, both kernels launched in the build, every merge
   invariant holds and the reload returns identical ids;
17. [dtypes] the main path's data stored as float16: the packed build with
   the main path's settings, attach_packed(dp=128) and its L sweep against
   the float32 groundtruth (recall@10 within 0.005 of the float32 main
   path at every L), the vectors' device bytes (half of float32's) and a
   save / load round trip (identical ids); a uint8 set in the shape of
   BigANN's SIFT (the same data mapped to 0..255, its own exact top-10),
   the same build and a sweep to L=100 that must reach recall@10 >= 0.95;
   both builds must launch K1 and K2.  Then bfloat16 and int8 at 20k,
   built on the card and carried to the CPU in their own dtype: identical
   ids on >= 0.999 of entries (full precision; the packed walk >= 0.99),
   and a bfloat16 save / load with identical ids;
18. [bench] `python -m diskann_tpu_torch.bench` in process on the card:
   `list` (six families), `run` of every example job file and a flat job,
   `check` of one result against itself under `example/tolerances.json`,
   then `abgate` on the main path's 1M index (saved as phase 5 built it,
   without its packed table, loaded through `--idx-cache` and re-attached
   at dp=128): an A/A run and an A/B run of merge_trunc off against on, 3
   reps a side, each rep bracketed by the bf16 probe; fails if a command
   fails, a family is missing or the abgate's packed walk launches no K1;
19. [sharded] `ShardedGraphIndex` on the one card: the main path's 1M x
   128 data in 4 shards by the k-means partition with overlap 2, inserts
   of 8192 (R=64, L=100, alpha=1.2; the calls before the last timed),
   attach_packed(dp=128), full and packed search at L = 16..100, the
   filtered "cat0" search, a delete of 50,000 external ids, save and a
   load onto card 0 alone, and `sharded_flat_search` over the same cards
   against `FlatIndex`; fails unless the packed walk reaches recall@10 >=
   0.95, every card that holds a shard launches K2 in the attach and the
   delete and K1 in the packed walk, no deleted id and no duplicate copy
   comes back, and the one-card reload and the flat search give identical
   ids.  Then the JAX package's sharded scale,
   `scripts/bench_sharded10m.py`'s bookkeeping at 10M x 32 over 8 shards
   on the same cards: a synthetic ring graph adopted on the cards, insert
   8192 with overlap 2, delete 8192, re-insert 8192 (freed slots
   recycled), save and load onto the same placement (identical ids), each
   time beside `SHARDED10M_r04.json`'s CPU-mesh figures.  On a host with
   several cards the phase runs three times with every shard on card 0
   and three times spread over every card (shard s on card s % the
   cards), interleaved; every run's ids at every L must equal the first
   one-card run's, each placement's first run traces its last insert call
   and one packed search (every card's busy share), and each operation's
   medians and their ratio are printed;
20. [rollback], run right after phase 5: insert batches and sharded calls
   that fail part-way commit nothing.  (a) A copy of the 1M main index
   with room for one more batch takes an insert of 8192 more points of
   the main path's mixture under device-memory caps (the memory in use
   plus 16, 64, 256 and 1,024 MiB, and, with the build-side router off,
   half and 0.7 of that batch's own peak): each must end in a real
   `torch.cuda.OutOfMemoryError`, the port's function whose frame raised
   is logged, and every state and packed tensor's fingerprint (two int64
   sums of its words), the counters, freelist and start must be as
   before; then the L=24 ids must be as before, the insert must commit
   (its journal's bytes printed) and the grown index must reach
   recall@10 >= 0.95.  (b) A 100k x 128 packed index (dp=64) takes the
   same insert failing at each of six points of `insert_batch_steps`
   (the walk, the first prune, the 3a refresh, the backedge append, the
   3c prune, the 3c refresh; injected by replacing the module attribute
   for the call): bitwise as before, then a retry bitwise a copy that
   never failed, K1 and K2 launched inside the failing batches; then
   `tests/test_failure.py`'s corrupted adjacency on a copy, searched
   packed (recall@10 >= 0.85, no id past the index).  (c) The one-card
   [sharded] layout at 100k: an insert failing in shard 1's walk, a
   delete failing in shard 1's repair and in its second packed refresh,
   each leaving every shard and the bookkeeping bitwise as before; the
   retries bitwise a copy that never failed.  (d) Deletes and
   consolidations that fail part-way commit nothing: a copy of the 1M
   main index deletes 5% (50,000 ids over the whole index) with the
   stream's settings (scan, fill, max_dead=8) and with the default (scan,
   prune), uncapped (its wall, its `max_memory_allocated` above the
   memory in use and its journal's bytes printed), then another copy
   takes the same delete under caps of the memory in use plus half and
   0.7 of that peak and, with the stream's settings, of the memory in
   use plus 64 MiB set from the start of its last repair batch and of its
   last refresh chunk (the undo runs under the same cap): each must
   raise a real `torch.cuda.OutOfMemoryError`
   (the raising function logged) and leave every fingerprint, counter,
   the freelist, the start, the delete's stats and the L=24 ids as
   before; uncapped, the delete must then commit, free exactly its ids
   with no live row naming one, and equal the first copy's
   fingerprints.  On the 100k index of (b), a 5% delete (scan, fill)
   fails once at the mark, discovery, the first and the last repair
   batch, the drop and the first and the last packed refresh chunk, and
   a consolidate after a one_hop delete at its last refresh chunk: each
   bitwise as before, each retry bitwise a copy that never failed, K2
   launched inside the failing calls.  The main build also reports its
   `max_memory_allocated` and each batch's journal bytes.

Phase 4 also builds a packed index of 20k 8-d points (dp=8) and attaches
dp=256 to 2k x 256-d data, each searched packed on the card and on its CPU
copy (>= 99% identical ids).  Phases 12 and 14 also time `mode="auto"`:
the flat route (`_flat_auto_search`: bf16 shortlist, float32 rerank)
against the packed walk, at a batch of 8192 queries (best of 3) and one
query at a time (median and p99 of 100 calls), on the 1M index, the 100k
x 768 index and a 25k prefix of it (and the flat route alone on a 600k
prefix of the 1M index); the flat route must reach recall@10
>= 0.999, `search(mode="auto")` must take the route `FLAT_AUTO_CROSSOVER`
implies, and after 1% of the 768-d index is deleted the flat route must
return no deleted id.  Phase 8 also times K1 at the other packed widths
(100 launches each; the merged build's rp=64 / dp=32 on a table of one
merged shard's rows; rp=16 also at 262,144 slots, a bound >= 0.1 ms).

Phase 4 also trains every quantizer on the CPU copy of its small index,
carries the trained state to the card and holds each quantized mode's
ids card against CPU (>= 99% identical); and on a second 20k input builds
a `TieredIndex` on the card, carries it to the CPU (>= 99% identical ids),
saves it on the card and loads it on the CPU (identical ids), and runs a
3-shard `build_merged` of its first 10k points with codes "packed" and
"sq" on both devices (invariants, recall@10 within 0.01).  Every temporary directory is
removed, on failure too.

Phase 6 also traces one filtered walk call with torch.profiler and splits
its device time between K1, the matched-list merges and the rest; phase 9
traces one more delete and splits its device time between discovery,
`fill_rows` and `refresh_rows` (of which K2); phase 13 splits a tiered
call between the walk, the wait on the host gather, the row upload and
the rerank.

On a host with several cards, phases 3 and 4's bitwise kernel checks run
on every card.  Every timed span drains every card on both ends.

`--only kernels` runs phases 1-3, the kernel checks on every card and
phase 8's kernel times alone; `--only build` the main path's data and
packed build alone (its wall, `max_memory_allocated` and journal bytes;
run from another checkout's root to measure that tree's build); `--only
delete` that build re-attached at dp=128 and (d)'s 5% delete on fresh
copies, twice with each setting (wall, `max_memory_allocated`, journal
bytes; from another checkout's root it measures that tree's delete);
`--only rollback` phases 1-3, 5 and 20; `--only sharded` runs phases 1-3, the
kernel checks on every card and [sharded] alone; `--only sharded-trace` builds phase 19's index on card 0,
traces one insert call and one packed search there, loads it onto every
card and traces both again; `--only sharded6m` needs four cards (it
raises on fewer): 6M x 128 points of the main path's generator at its
points per cluster (24,576 clusters), 4 shards by the k-means partition
with overlap 2, one per card (~3.1M nodes and a 38 GB packed table at
dp=128 a card, ~152 GB on one card), inserts of 8192, attach, packed and
full search at L = 16, 24, 40, 100 against `FlatIndex`'s exact top-10, a
delete of 50,000 ids and a search after it; fails below recall@10 0.95
on the packed walk, on a deleted id, or on a card whose peak reaches its
memory.  Each prints a summary line and no result line.

Then a JSON line with the kernels, the `nvidia-smi` name/power-limit line,
and last the result line `{"ok": true, "device": {...}}`.  Any failed phase
raises, and the script exits non-zero without the result line; so does a
host without a CUDA card, or a directory without the package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
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
STREAM_CYCLES = 6
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
# in 24 shards to 1.5M in 3 (about 1M points per shard, against 1.67M;
# fewer shards than 2M in 4 keep the smoke inside its time)
MERGED_N, MERGED_NQ, MERGED_SHARDS = 1_500_000, 1024, 3
MERGED_L, MERGED_RL = (40, 80, 160), (16, 64)
# `BENCH_DEEP20M_r04.json` (20M, codes sq): recall@10 at (L, rerank_l)
R04_DEEP20M = {(40, 16): 0.9739, (80, 16): 0.9922, (80, 64): 0.9924, (160, 16): 0.994,
               (160, 64): 0.9942}
# K1 at the packed widths beyond the main path's (dp/4 divides 128):
# (r_pack, dp); the merged build's (R=40, dp=32) is timed on a table of
# one merged shard's rows, the others on 2^17-node tables, each over
# K1_WIDTH_REPS launches
K1_MERGED = (64, 32)
K1_WIDTHS = ((16, 4), (16, 8), (16, 16), (84, 256), (40, 512), K1_MERGED)
K1_WIDTH_REPS = 100
# rp=16 is also timed at this many slots: a bound of >= 0.1 ms
K1_WIDE_SLOTS = 1 << 18
# mode="auto": the flat route against the graph walk at a batch of
# AUTO_BATCH queries (best of 3) and AUTO_SINGLES single-query calls;
# the flat route's recall@10 bar; the bracket point below the 768-d shape
AUTO_BATCH, AUTO_SINGLES = 8192, 100
AUTO_MIN_RECALL = 0.999
AUTO_BRACKET_N = 25_000
# rows of the 1M x 128 index at the 768-d shape's element count (76.8M):
# the flat route timed there alone, to see whether its cost follows rows
AUTO_ROWS_N = 600_000
# the service over the wire at the 100k x 768 shape: elements by add_batch,
# then VADDs, VSIMs, filtered VSIMs, VSIM ELEs, VREMs and VSCAN queries
SVC_N, SVC_WIRE_ADDS = 99_000, 1_000
# (FILTERs, VREMs and the sq VSIMs cut from 256, 1,000 and 1,024 to keep
# the smoke inside its time with the dtypes, bench and sharded phases: the
# walks take 130-300 ms a request)
SVC_NQ, SVC_FILTER_NQ, SVC_ELE_NQ, SVC_REMOVES, SVC_SCAN_NQ = 1024, 64, 100, 250, 16
SVC_SQ_NQ = 128
SVC_GRAPH_MIN_RECALL = 0.95
# [dtypes]: float16 recall may stray this far from the float32 main path's
# at each L; the uint8 sweep; card-vs-CPU identical-id share at 20k
DTYPE_RECALL_GAP = 0.005
DTYPE_UINT8_L = (16, 24, 40, 64, 100)
DTYPE_SMALL_SHARE = 0.999
# [bench]: the abgate's shared index size, its A side (B is the same with
# merge_trunc on) and its reps per side
BENCH_N, BENCH_SIDE, BENCH_REPS = 1_000_000, "l=24,mh=6,rl=12,mtrunc=0", 3
# [sharded]: the main path's data over SHARD_S shards on the visible cards;
# the JAX package's 10M x 32 bookkeeping scale over 8 shards
SHARD_S, SHARD_L, SHARD_DELETE = 4, (16, 24, 40, 64, 100), 50_000
# runs of [sharded] on each placement when several cards are visible
SHARD_REPS = 3
# [sharded6m] (`--only sharded6m`, four cards): the main path's generator
# at 6M points and its points per cluster, its queries, the search Ls and
# the packed width (a 12,288 B fat row at dp=128)
SH6M_N, SH6M_NQ, SH6M_CLUSTERS, SH6M_L, SH6M_DP = 6_000_000, 1024, 24_576, (16, 24, 40, 100), 128
# every card's peak must stay below this (an 80 GB card)
SH6M_PEAK_BYTES = 80e9
SH10M_N, SH10M_D, SH10M_S, SH10M_R, SH10M_BATCH = 10_000_000, 32, 8, 16, 8192
# `SHARDED10M_r04.json` (the JAX package on an 8-device CPU mesh), seconds
SH10M_R04 = {"insert": 26.43, "delete": 63.88, "reinsert": 26.13, "save": 7.97,
             "load": 19.75}
# [rollback]: the device-memory headroom of each out-of-memory cap (MiB
# above the memory in use), the size of the injected-failure indexes, the
# ids the sharded delete removes and the rows of corrupted adjacency
ROLLBACK_CAPS_MIB = (16, 64, 256, 1024)
# ... and, with the build-side router off, caps at these shares of that
# batch's own peak (measured on a probe copy): with the router on, its
# [2048, 65536] score block is the batch's peak, so every cap fails there
ROLLBACK_PEAK_SHARES = (0.5, 0.7)
ROLLBACK_N, ROLLBACK_DELETE, ROLLBACK_CORRUPT = 100_000, 5_000, 1_000
# rows of the insert that fails (the main path's batch)
ROLLBACK_BATCH = 8192
# [rollback] (d) and `--only delete`: the share of the index a delete
# removes (the stream's 5%), its settings (the stream's, and the default),
# and the deletes a setting takes in `--only delete`, each on a fresh copy
ROLLBACK_DEL_FRAC = 0.05
DELETE_SETTINGS = {"fill": dict(method="scan", repair="fill", max_dead=8),
                   "prune": dict(method="scan", repair="prune")}
DELETE_REPS = 2
# ... and the headroom of (d)'s caps set from the start of the stream
# setting's last repair batch and last refresh chunk (MiB above the memory
# in use then): less than either step's own temporaries
ROLLBACK_LATE_MIB = 64
# the H100 SXM's published peaks (NVIDIA data sheet): HBM bytes and dense
# int8 operations per millisecond
HBM_BYTES_PER_MS = 3.35e12 / 1e3
INT8_OPS_PER_MS = 1979e12 / 1e3


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(torch, device) -> None:
    """Wait for every card (a no-op on the CPU, where the phases rehearse):
    a sharded index spans several, and a clock stopped when one card is
    drained would miss the others' work."""
    if device.type == "cuda":
        for card in range(torch.cuda.device_count()):
            torch.cuda.synchronize(card)


def shard_cards(torch, device, n_shards: int) -> list:
    """The [sharded] phase's placement: shard ``s`` on card ``s % the
    visible cards`` (every shard on ``device`` off the card)."""
    if device.type != "cuda":
        return [device] * n_shards
    return [torch.device("cuda", s % torch.cuda.device_count()) for s in range(n_shards)]


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


def check_fatrow_expand(torch, device) -> tuple[int, set]:
    """K1 vs plain, bitwise.  Returns the largest |dot difference| (0) and
    the dps whose cases passed."""
    from diskann_tpu_torch.graph.packed import n_wrows
    from diskann_tpu_torch.ops.kernels.fatrow_expand import (
        fatrow_expand, fatrow_expand_plain,
    )

    gen = torch.Generator().manual_seed(7)
    worst, dps = 0, set()
    cases = [(16, 64, 4096, 1000), (32, 32, 4096, 1000),
             (88, 64, 4096, 1000), (84, 128, 4096, 1000),
             (88, 64, 1 << 16, NQ * 4), (84, 128, 1 << 16, NQ * 4)]
    cases += [(rp, dp, 4096, 1000) for rp, dp in K1_WIDTHS]
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
        torch.cuda.synchronize(device)
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        log(f"[k1] {device} fatrow_expand rp={rp} dp={dp} n={n} bw={bw}: "
            f"tolerance=bitwise bitwise_equal={same} max_abs_err={err}")
        if not same:
            raise RuntimeError(f"fatrow_expand disagrees with its plain version at rp={rp} dp={dp}")
        worst = max(worst, err)
        dps.add(dp)
    return worst, dps


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
        torch.cuda.synchronize(device)
        live = slice(0, dump * 8)                # the dump block is garbage by design
        err = int((got[live].long() - want[live].long()).abs().max())
        same = torch.equal(got[live], want[live])
        log(f"[k2] {device} block_patch {dt}: blocks={n_blocks} patches={g} "
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
    import torch

    from diskann_tpu_torch import FlatIndex, GraphIndex
    from diskann_tpu_torch.bench.harness import make_clustered

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

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    with journal_sizes() as sizes:
        idx = GraphIndex.build(xd, main_config(), insert_batch_size=8192,
                               search_batch_size=search_batch, build_mode="packed",
                               packed_dp=64, build_backedge_src_cap=64)
        sync(torch, device)
    out["build_s"] = time.time() - t0
    out["build_points_per_s"] = n / out["build_s"]
    if device.type == "cuda":
        out["build_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    out["journal_bytes"] = {"batches": len(sizes), "min": min(sizes), "max": max(sizes),
                            "median": sorted(sizes)[len(sizes) // 2]}
    del xd
    log(f"[main] packed build (dp=64, r_pack={idx.packed.r_pack}, "
        f"nwr={idx.packed.nwr}): {out['build_s']:.1f}s "
        f"({out['build_points_per_s']:.0f} points/s), max_memory_allocated "
        f"{out.get('build_peak_bytes', 0) / 2**30:.3f} GiB; each batch's journal "
        f"{json.dumps(out['journal_bytes'])} bytes")

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
    out["sweep"] = sweep = sweep_packed(idx, qd, gt, L_SWEEP, "[main]")
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
    k1.launches_by_device.clear()
    k2.launches_by_device.clear()
    if phase:
        log(f"[{phase}] kernel launches: {out}")
    return out


def card_launches(k1, k2, cards) -> dict:
    """Both kernels' launches since the last `take_launches`, per card of
    ``cards`` (CUDA device indices)."""
    return {c: {"fatrow_expand": k1.launches_by_device.get(c, 0),
                "block_patch": k2.launches_by_device.get(c, 0)} for c in cards}


def lap_clock():
    """(lap, walls): ``lap(name)`` records under ``name`` in ``walls`` the
    wall seconds since the previous lap (or since this call)."""
    walls, last = {}, [time.time()]

    def lap(name: str) -> None:
        now = time.time()
        walls[name] = round(now - last[0], 1)
        last[0] = now
        log(f"[wall] {name}: {walls[name]}s")

    return lap, walls


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
    `build_merged` (3 shards, R=24, L=48, occlusion cap 64) of the first
    n / 2 points with codes "packed" and "sq" on both devices: every
    invariant, and recall@10 within 0.01 (the two devices' k-means draw
    different partitions).  Returns the smallest share."""
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
    # an occlusion cap of 64 and half the points keep the two CPU builds'
    # prune near 15 s each (20k points at cap 256 took 85-102 s of the card
    # host's CPU; at cap 64, 27-29 s)
    mcfg = GraphConfig(max_degree=24, l_build=48, beam_width=4, build_max_hops=12,
                       max_occlusion_size=64)
    xm = x[: n // 2]
    _, gtm = FlatIndex(xm, device=device).search(q, K)
    for codes in ("packed", "sq"):
        rec = {}
        for name, dev in (("card", device), ("cpu", cpu)):
            (t, dt) = _timed(torch, dev, lambda: build_merged(
                xm, mcfg, n_shards=3, dp=32, insert_batch_size=4096, codes=codes, device=dev))
            merged_invariants(t, f"[small] merged {codes} on the {name}")
            _, ids, _ = t.search_batched(q, K, l_search=64, batch_size=512)
            rec[name] = (knn_recall(ids, gtm, K), dt)
            del t
        diff = abs(rec["card"][0] - rec["cpu"][0])
        log(f"[small] n={n // 2} build_merged 3 shards codes={codes}: invariants held on both; "
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
    walk = dict(WIKI_SEARCH, mode="packed", query_dtype=np.float16)
    out["auto"] = time_auto(f"{n // 1000}k x {WIKI_D}", idx, qd, gt[:, :K], walk, k1)
    out["auto_bracket"] = auto_bracket(idx.state.vectors, qd, k1)
    out["auto_deletes"] = check_auto_deletes(idx, qd)
    if device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    return out

def check_packed_widths(torch, device, k1) -> float:
    """The packed widths beyond the main path's, through the index: a packed
    build of 20k 8-d points (dp=8, K1 on every build hop) and
    `attach_packed(dp=256)` on 2k x 256-d data, each searched packed on
    the card (K1 must launch) and, carried to the CPU by `convert.py`,
    with the plain versions: >= 99% identical ids.  Returns the smaller
    share."""
    from diskann_tpu_torch import GraphConfig, GraphIndex
    from diskann_tpu_torch.bench.harness import make_clustered
    from diskann_tpu_torch.convert import graph_index_from_arrays, index_arrays

    worst = 1.0
    for name, n, d, build in (("packed build dp=8", 20_000, 8, "packed"),
                              ("attach_packed dp=256", 2_000, 256, "full")):
        x, q = make_clustered(6, n, 512, d, n_clusters=64, sigma=0.35)
        before = k1.launches
        card = GraphIndex.build(torch.from_numpy(x).to(device),
                                GraphConfig(max_degree=32, l_build=64, beam_width=4),
                                insert_batch_size=4096, build_mode=build, packed_dp=d)
        if build == "full":
            card.attach_packed(dp=d)
        kw = dict(l_search=48, beam_width=4, mode="packed")
        _, ids_card, _ = card.search(q, K, **kw)
        launched = k1.launches - before
        host = graph_index_from_arrays(**index_arrays(card), device="cpu",
                                       insert_batch_size=card.insert_batch_size)
        _, ids_host, _ = host.search(q, K, **kw)
        share = float((ids_card == ids_host).mean())
        log(f"[widths] {name} ({n} x {d}, dp={card.packed.dp}): packed search on the card vs "
            f"the CPU copy: identical ids {share:.4f} (need >= 0.99); K1 launches {launched}")
        if card.packed.dp != d or launched == 0 or share < 0.99:
            raise RuntimeError(f"[widths] {name}: dp {card.packed.dp}, K1 launches {launched}, "
                               f"identical ids {share:.4f}")
        worst = min(worst, share)
    return worst


def _single_ms(fn, q, reps: int) -> tuple[float, float]:
    """Median and p99 milliseconds of ``reps`` one-query calls (each returns
    numpy, so each waits for the card)."""
    import numpy as np

    dts = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn(q[i:i + 1])
        dts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(dts)), float(np.percentile(dts, 99))


def time_auto(tag: str, idx, qd, gt, walk_kw: dict, k1) -> dict:
    """mode="auto" at one shape: the flat route (`_flat_auto_search`) and the
    graph walk (``walk_kw``) at AUTO_BATCH queries (best of 3 calls) and
    one query at a time (median and p99 of AUTO_SINGLES calls), with the
    recall@10 of each against ``gt``; then `search(mode="auto")` must take
    the route `FLAT_AUTO_CROSSOVER` implies, with K1 launched when it walks
    packed.  Raises below AUTO_MIN_RECALL for the flat route."""
    import numpy as np
    import torch

    from diskann_tpu_torch.bench.recall import knn_recall
    from diskann_tpu_torch.graph import index as gindex

    device = qd.device
    # fewer queries than the batch: repeat them (and their truth)
    reps = -(-AUTO_BATCH // qd.shape[0])
    q = qd.repeat(reps, 1)[:AUTO_BATCH]
    gt = np.tile(gt, (reps, 1))[:AUTO_BATCH]
    elems = idx.n_live * idx.dim
    out = {"n": idx.n_live, "dim": idx.dim, "elems": elems, "batch": q.shape[0]}
    routes = {"flat": lambda qq: idx._flat_auto_search(qq, K),
              "walk": lambda qq: idx.search(qq, K, **walk_kw)}
    for route, fn in routes.items():
        fn(q[:64])                                                   # warm-up
        dts = []
        for _ in range(3):
            (_, ids, st), dt = _timed(torch, device, lambda: fn(q))
            dts.append(dt)
        p50, p99 = _single_ms(fn, q, AUTO_SINGLES)
        row = {"qps": q.shape[0] / min(dts), "batch_s": dts,
               "recall": knn_recall(ids, gt[: q.shape[0]], K),
               "single_ms_p50": p50, "single_ms_p99": p99}
        out[route] = row
        log(f"[auto] {tag} ({idx.n_live} x {idx.dim} = {elems / 1e6:.1f}M elements) {route}: "
            f"batch {q.shape[0]}: {row['qps']:.0f} QPS (calls {[round(t * 1e3, 1) for t in dts]} ms), "
            f"recall@{K} {row['recall']:.4f}; one query: p50 {p50:.2f} ms, p99 {p99:.2f} ms")
        if route == "flat" and (row["recall"] < AUTO_MIN_RECALL or (st.hops != 0).any()):
            raise RuntimeError(f"[auto] {tag}: flat route recall {row['recall']:.4f} "
                               f"< {AUTO_MIN_RECALL} or hops taken")
    out["batch_winner"] = max(("flat", "walk"), key=lambda r: out[r]["qps"])
    out["single_winner"] = min(("flat", "walk"), key=lambda r: out[r]["single_ms_p50"])
    expect_flat = elems <= gindex.FLAT_AUTO_CROSSOVER
    before = k1.launches
    kw = {k: v for k, v in walk_kw.items() if k != "mode"}
    _, ids, st = idx.search(q[:1024], K, mode="auto", **kw)
    took_flat = bool((st.hops == 0).all())
    launched = k1.launches - before
    out["auto_route"] = "flat" if took_flat else "walk"
    log(f"[auto] {tag}: faster at batch {q.shape[0]}: {out['batch_winner']}, at one query: "
        f"{out['single_winner']}; FLAT_AUTO_CROSSOVER={gindex.FLAT_AUTO_CROSSOVER} -> "
        f"search(mode='auto') took the {out['auto_route']} route (expected "
        f"{'flat' if expect_flat else 'walk'}; K1 launches {launched})")
    if took_flat != expect_flat:
        raise RuntimeError(f"[auto] {tag}: mode='auto' took the {out['auto_route']} route")
    if not took_flat and idx.packed is not None and launched == 0:
        raise RuntimeError(f"[auto] {tag}: the packed walk of mode='auto' launched no K1")
    return out


def check_auto_deletes(idx, qd) -> dict:
    """Delete 1% of the index (scan + prune), then the flat route on 1024
    queries: no deleted id, no hops, and recall@10 >= AUTO_MIN_RECALL
    against the exact top-10 of the live rows."""
    import numpy as np

    from diskann_tpu_torch import FlatIndex
    from diskann_tpu_torch.bench.recall import knn_recall

    n = idx.n
    dead = np.random.default_rng(13).choice(n, n // 100, replace=False)
    t0 = time.time()
    idx.delete(dead)
    delete_s = time.time() - t0
    q = qd[:1024]
    _, ids, st = idx._flat_auto_search(q, K)
    live = np.setdiff1d(np.arange(n), dead)
    vec = idx.state.vectors[:n][live]
    _, gt = FlatIndex(vec, idx.metric).search(q, K)
    r = knn_recall(ids, live[gt], K)
    bad = int(np.isin(ids, dead).sum())
    log(f"[auto] flat route after deleting {len(dead)} of {n} ({delete_s:.1f}s): "
        f"{bad} deleted ids returned, recall@{K} {r:.4f} against the live rows")
    if bad or r < AUTO_MIN_RECALL or (st.hops != 0).any():
        raise RuntimeError(f"[auto] flat route after deletes: {bad} deleted ids, recall {r:.4f}")
    return {"deleted": len(dead), "delete_s": delete_s, "recall": r}


def auto_bracket(xd, qd, k1) -> dict:
    """The bracket point below the 768-d shape: the first AUTO_BRACKET_N
    rows of the same data (``xd``, on the card), full build and
    attach_packed(dp=128) as in the wiki phase, timed by `time_auto`."""
    import numpy as np

    from diskann_tpu_torch import FlatIndex, GraphConfig, GraphIndex, Metric

    xd = xd[:AUTO_BRACKET_N]
    _, gt = FlatIndex(xd, Metric.InnerProduct).search(qd, K)
    cfg = GraphConfig(max_degree=60, l_build=80, alpha=1.2, beam_width=4,
                      metric=Metric.InnerProduct, build_max_hops=12, max_occlusion_size=256)
    idx = GraphIndex.build(xd, cfg, insert_batch_size=8192, search_batch_size=2048)
    idx.attach_packed(dp=128)
    return time_auto(f"{AUTO_BRACKET_N // 1000}k x {WIKI_D} prefix", idx, qd, gt,
                     dict(WIKI_SEARCH, mode="packed", query_dtype=np.float16), k1)


def time_flat_rows(idx, qd) -> dict:
    """The flat route's bf16 shortlist and float32 rerank over the first
    AUTO_ROWS_N rows of the 1M x 128 index (`FlatIndex`, no validity mask:
    every row is live) at AUTO_BATCH queries, best of 3, with its
    recall@10 against the exact float32 scan of the same rows on 1024
    queries."""
    import torch

    from diskann_tpu_torch import FlatIndex
    from diskann_tpu_torch.bench.recall import knn_recall

    device = qd.device
    flat = FlatIndex(idx.state.vectors[:AUTO_ROWS_N], idx.metric)
    q = qd.repeat(-(-AUTO_BATCH // qd.shape[0]), 1)[:AUTO_BATCH]
    flat.search(q[:64], K, compute="bf16")                          # warm-up
    dts = [_timed(torch, device, lambda: flat.search(q, K, compute="bf16"))[1]
           for _ in range(3)]
    _, ids = flat.search(q[:1024], K, compute="bf16")
    _, gt = flat.search(q[:1024], K)
    out = {"n": AUTO_ROWS_N, "dim": idx.dim, "elems": AUTO_ROWS_N * idx.dim,
           "qps": q.shape[0] / min(dts), "batch_s": dts, "recall": knn_recall(ids, gt, K)}
    log(f"[auto] {AUTO_ROWS_N // 1000}k x {idx.dim} prefix ({out['elems'] / 1e6:.1f}M elements) "
        f"flat: batch {q.shape[0]}: {out['qps']:.0f} QPS (calls "
        f"{[round(t * 1e3, 1) for t in dts]} ms), recall@{K} {out['recall']:.4f}")
    if out["recall"] < AUTO_MIN_RECALL:
        raise RuntimeError(f"[auto] flat scan of the {AUTO_ROWS_N} prefix: recall "
                           f"{out['recall']:.4f} < {AUTO_MIN_RECALL}")
    return out


def _pct(v, p):
    import numpy as np

    return float(np.percentile(v, p)) if v else float("nan")


def run_service(device, *, n: int = SVC_N, adds: int = SVC_WIRE_ADDS, nq: int = SVC_NQ,
                filter_nq: int = SVC_FILTER_NQ, ele_nq: int = SVC_ELE_NQ,
                removes: int = SVC_REMOVES, scan_nq: int = SVC_SCAN_NQ,
                sq_nq: int = SVC_SQ_NQ) -> dict:
    """The vector-set service over the wire at the 100k x 768 shape (the
    reference CI's wikipedia-100K, inner product): `VectorService` on the
    card, `create_index("wiki", 768, metric="ip", max_degree=60,
    l_build=80, insert_batch_size=8192)`, ``n`` named elements by
    `add_batch` with the zipf labels cat0..cat31 as attributes, then a
    `VectorSetServer` on 127.0.0.1 in a background thread driven by a
    `VectorSetClient`: PING, VLIST, VCARD; ``adds`` VADDs; ``nq`` VSIMs
    (recall@10 against the exact inner-product top-10 of the live set:
    >= AUTO_MIN_RECALL on the flat route, >= SVC_GRAPH_MIN_RECALL on the
    graph); ``filter_nq`` VSIM FILTER "cat0" (every result labelled cat0,
    recall >= 0.95); ``ele_nq`` VSIM ELE (the element never returned);
    ``removes`` VREMs (no removed name in a following VSIM, VCARD drops);
    VSETATTR / VGETATTR and a FILTER that sees the new label; VSCAN of 5
    pages x 10 for ``scan_nq`` queries (disjoint, sorted); VQUANT sq, then
    ``sq_nq`` VSIMs on the sq walk (recall >= 0.95).  Returns the gates, the
    add_batch rate and every command kind's wall latency p50 / p99."""
    import json as _json
    import threading

    import numpy as np
    import torch

    from diskann_tpu_torch import FlatIndex, Metric
    from diskann_tpu_torch.bench.recall import knn_recall
    from diskann_tpu_torch.graph import index as gindex
    from diskann_tpu_torch.server import VectorSetClient, VectorSetServer
    from diskann_tpu_torch.service import VectorService

    x, qs = wiki_data(n + adds, max(nq, 1024))
    cats = bench_cats(n + adds)
    names = [f"e{i}" for i in range(n + adds)]
    svc = VectorService(device=device)
    vs = svc.create_index("wiki", WIKI_D, metric="ip", max_degree=60, l_build=80,
                          insert_batch_size=8192)
    (_, add_s) = _timed(torch, device, lambda: vs.add_batch(
        names[:n], x[:n], [f"cat{c}" for c in cats[:n]]))
    out = {"n": n, "adds": adds, "add_batch_s": add_s, "add_batch_points_per_s": n / add_s}
    log(f"[service] add_batch {n} x {WIKI_D} (ip, R=60, L=80, batch 8192) with zipf labels: "
        f"{add_s:.1f}s ({n / add_s:.0f} points/s)")
    flat_route = (n + adds) * WIKI_D <= gindex.FLAT_AUTO_CROSSOVER
    bar = AUTO_MIN_RECALL if flat_route else SVC_GRAPH_MIN_RECALL
    lat: dict = {}

    def timed(kind, fn, *args, **kw):
        t0 = time.perf_counter()
        r = fn(*args, **kw)
        lat.setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)
        return r

    def ids_of(res):
        return [int(nm[1:]) for nm in res]

    def padded(rows):
        return np.array([r + [-1] * (K - len(r)) for r in rows])

    def exact(live, queries, k=K):
        """Exact inner-product top-k ids over the rows ``live``."""
        _, i = FlatIndex(torch.from_numpy(x[live]).to(device), Metric.InnerProduct).search(
            torch.from_numpy(queries).to(device), k)
        return live[i]

    srv = VectorSetServer("127.0.0.1", 0, service=svc)
    host, port = srv.serve_background()
    cl = VectorSetClient(host, port, timeout=600.0)
    try:
        if timed("PING", cl.execute, "PING") != "PONG":
            raise RuntimeError("[service] PING")
        if timed("VLIST", cl.execute, "VLIST") != [b"wiki"]:
            raise RuntimeError("[service] VLIST")
        if timed("VCARD", cl.card, "wiki") != n:
            raise RuntimeError("[service] VCARD after add_batch")
        for i in range(n, n + adds):
            if timed("VADD", cl.add, "wiki", names[i], x[i], attribute=f"cat{cats[i]}") != 1:
                raise RuntimeError(f"[service] VADD {names[i]}")
        if timed("VCARD", cl.card, "wiki") != n + adds:
            raise RuntimeError("[service] VCARD after the VADDs")
        # the first read commits the buffered VADDs (one padded insert batch)
        t0 = time.perf_counter()
        cl.sim("wiki", qs[0], k=K)
        out["commit_ms"] = (time.perf_counter() - t0) * 1e3
        live = np.arange(n + adds)
        gt = exact(live, qs[:nq])
        got = [ids_of(n_ for n_, _ in timed("VSIM", cl.sim, "wiki", qs[i], k=K,
                                            withscores=True)) for i in range(nq)]
        out["vsim_recall"] = knn_recall(padded(got), gt, K)
        out["route"] = "flat" if flat_route else "graph"
        log(f"[service] {nq} VSIM VALUES 768 COUNT {K} WITHSCORES ({out['route']} route; the "
            f"first read committed the {adds} buffered VADDs in {out['commit_ms']:.0f} ms): "
            f"recall@{K} {out['vsim_recall']:.4f} (need >= {bar})")
        if out["vsim_recall"] < bar:
            raise RuntimeError(f"[service] VSIM recall {out['vsim_recall']:.4f} < {bar}")

        cat0 = live[cats[live] == 0]
        fq = qs[:filter_nq]
        gt0 = exact(cat0, fq)
        got = [ids_of(timed("VSIM FILTER", cl.sim, "wiki", fq[i], k=K, filter="cat0"))
               for i in range(filter_nq)]
        if (cats[np.concatenate([np.array(r, np.int64) for r in got])] != 0).any():
            raise RuntimeError("[service] a FILTER cat0 result is not labelled cat0")
        out["filter_recall"] = knn_recall(padded(got), gt0, K)
        log(f"[service] {filter_nq} VSIM ... FILTER cat0 ({len(cat0)} members): every result "
            f"labelled cat0, recall@{K} {out['filter_recall']:.4f} (need >= 0.95)")
        if out["filter_recall"] < 0.95:
            raise RuntimeError(f"[service] FILTER recall {out['filter_recall']:.4f}")

        rng = np.random.default_rng(17)
        for j in rng.choice(n + adds, ele_nq, replace=False):
            res = timed("VSIM ELE", cl.sim_element, "wiki", names[j], k=K)
            if names[j] in res or len(res) != K:
                raise RuntimeError(f"[service] VSIM ELE {names[j]} returned {res}")
        log(f"[service] {ele_nq} VSIM ELE: the element never returned, {K} results each")

        gone = rng.choice(n + adds, removes, replace=False)
        for j in gone:
            if timed("VREM", cl.remove, "wiki", names[j]) != 1:
                raise RuntimeError(f"[service] VREM {names[j]}")
        if timed("VCARD", cl.card, "wiki") != n + adds - removes:
            raise RuntimeError("[service] VCARD after the VREMs")
        gone_names = {names[j] for j in gone}
        for j in gone[:256]:
            res = timed("VSIM", cl.sim, "wiki", x[j], k=K)
            if gone_names & set(res):
                raise RuntimeError("[service] a removed element came back from VSIM")
        log(f"[service] {removes} VREM: VCARD {n + adds - removes}; 256 VSIMs at the removed "
            f"elements' own vectors return none of them")

        keep = np.setdiff1d(live, gone)
        e = names[keep[0]]
        if timed("VSETATTR", cl.execute, "VSETATTR", "wiki", e, '"fresh"') != 1:
            raise RuntimeError("[service] VSETATTR")
        if _json.loads(timed("VGETATTR", cl.execute, "VGETATTR", "wiki", e)) != "fresh":
            raise RuntimeError("[service] VGETATTR")
        res = timed("VSIM FILTER", cl.sim, "wiki", x[keep[0]], k=K, filter="fresh")
        if res != [e]:
            raise RuntimeError(f"[service] FILTER fresh returned {res}")
        log(f"[service] VSETATTR {e} \"fresh\", VGETATTR, FILTER fresh -> [{e}]")

        for i in range(scan_nq):
            vals = [repr(float(v)) for v in qs[i]]
            first = timed("VSCAN", cl.execute, "VSCAN", "wiki", "VALUES", WIKI_D, *vals,
                          "COUNT", PAGE_K)
            cursor, pages = int(first[0]), [[b.decode() for b in first[1:]]]
            for _ in range(PAGES - 1):
                pages.append([b.decode() for b in timed(
                    "VSCAN CONT", cl.execute, "VSCAN", "wiki", "CONT", cursor, "COUNT", PAGE_K)])
            timed("VSCAN END", cl.execute, "VSCAN", "wiki", "END", cursor)
            seen = [nm for p in pages for nm in p]
            if len(seen) != len(set(seen)) or any(len(p) != PAGE_K for p in pages):
                raise RuntimeError(f"[service] VSCAN pages overlap or run short: {pages}")
            for p in pages:
                d = -(x[ids_of(p)] @ qs[i])
                if (np.diff(d) < -1e-5).any():
                    raise RuntimeError(f"[service] a VSCAN page is not sorted: {d}")
        log(f"[service] VSCAN {PAGES} pages x {PAGE_K} for {scan_nq} queries: disjoint, sorted")

        t0 = time.perf_counter()
        if timed("VQUANT", cl.execute, "VQUANT", "wiki", "sq") != "OK":
            raise RuntimeError("[service] VQUANT")
        out["vquant_s"] = time.perf_counter() - t0
        gt = exact(keep, qs[:sq_nq])
        got = [ids_of(timed("VSIM sq", cl.sim, "wiki", qs[i], k=K)) for i in range(sq_nq)]
        out["sq_recall"] = knn_recall(padded(got), gt, K)
        log(f"[service] VQUANT sq ({out['vquant_s']:.1f}s), then {sq_nq} VSIM on the sq walk: "
            f"recall@{K} {out['sq_recall']:.4f} (need >= 0.95)")
        if out["sq_recall"] < 0.95:
            raise RuntimeError(f"[service] sq VSIM recall {out['sq_recall']:.4f}")
    finally:
        cl.close()
        srv.shutdown()
        srv.server_close()
    out["latency_ms"] = {k: {"count": len(v), "p50": _pct(v, 50), "p99": _pct(v, 99)}
                         for k, v in lat.items()}
    for k, v in out["latency_ms"].items():
        log(f"[service] {k:12s} x{v['count']:<5d} wall p50 {v['p50']:.2f} ms  p99 {v['p99']:.2f} ms")
    return out



_SLEEP_RATE: list = []


def sleep_rate(torch) -> float:
    """Cycles of `torch.cuda._sleep` per device millisecond on the current
    card (its SM clock), timed once per process."""
    if not _SLEEP_RATE:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        cycles = 20_000_000
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_RATE.append(cycles / start.elapsed_time(end))
    return _SLEEP_RATE[0]


def time_ms(torch, fn, reps: int = 20, tries: int = 3) -> dict:
    """Device milliseconds per call, with the host kept out of the events'
    window: the timed calls are queued behind a `torch.cuda._sleep` twice
    as long as their enqueue (plus 1 ms), so the two events bracket
    back-to-back device work only.  A window whose enqueue outlasted its
    sleep (the host was held up) is taken again with a sleep twice as long,
    up to ``tries`` windows.  Returns {"ms": device ms per call, "host_ms":
    the host's ms per call (the enqueue alone, timed on its own beforehand),
    "sleep_ms": the last sleep's length, "covered": whether its enqueue
    ended inside it}; a call that synchronises (a plain version's boolean
    index) is never covered, and its "ms" then holds host time too."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    sleep_ms = 2.0 * host_ms * reps + 1.0
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_ms * sleep_rate(torch)))
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        out = {"ms": start.elapsed_time(end) / reps, "host_ms": host_ms,
               "sleep_ms": sleep_ms, "covered": enqueue_ms < sleep_ms}
        if out["covered"]:
            break
        sleep_ms *= 2
    return out


def timing_note(t: dict, reps: int) -> str:
    """How one `time_ms` window was taken, for the log."""
    return (f"{reps} reps behind a {t['sleep_ms']:.2f} ms sleep "
            f"({'covered' if t['covered'] else 'NOT covered: host in the window'}), "
            f"host {t['host_ms']:.4f} ms a call")


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


def k1_row(torch, k1mod, rows, beam, qiw, rp: int, dp: int, nodes: int, reps: int,
           what: str) -> dict:
    """Time K1 and its plain version on one table (`time_ms`), log the
    line with its bound and return the row."""
    bw = beam.shape[0]
    t = time_ms(torch, lambda: k1mod.fatrow_expand(rows, beam, qiw, rp=rp, dp=dp), reps)
    p = time_ms(torch, lambda: k1mod.fatrow_expand_plain(rows, beam, qiw, rp=rp, dp=dp),
                reps, tries=1)
    b = k1_bound(torch, beam, rp, dp, nodes)
    plan = getattr(k1mod, "plan", None)
    how = ("" if plan is None else
           f", {plan(rp, dp, bw, n_sms=k1mod.sm_count(rows.device.index))}")
    log(f"[time] fatrow_expand rp={rp} dp={dp} bw={bw} {what} "
        f"{rows.numel() * 4 / 1e9:.2f} GB: kernel {t['ms']:.4f} ms "
        f"({b['bound_ms'] / t['ms']:.1%} of its bound), plain {p['ms']:.3f} ms, "
        f"bound {b['bound_ms']:.4f} ms ({b['bound_bytes'] / 1e6:.1f} MB, by "
        f"{b['bound_by']}); {timing_note(t, reps)}{how}")
    return {"ms": t["ms"], "plain_ms": p["ms"], "host_ms": t["host_ms"],
            "share": b["bound_ms"] / t["ms"], **b}


def time_kernels(torch, device, n: int) -> dict:
    """Kernel vs plain at the main path's shapes, on random tables of the
    main path's size, each timed on the device alone (`time_ms`): K1 at
    BW = 8192 x 4 slots on the dp=64 build table and the dp=128 search
    table (past 2^31 words at 1M rows); K2 at one build commit's refresh
    (8192 rows x 2 blocks of the dp=64 table) beside `index_copy_`.  Then
    K1 at the other packed widths, and at rp=16 also at K1_WIDE_SLOTS
    slots, where the bound is long enough (>= 0.1 ms) that launch latency
    does not set the share.  On the same tables each kernel's output is
    held bitwise against its plain version's: K1 at every geometry, K2 on
    the dp=128 table."""
    from diskann_tpu_torch.graph.packed import n_wrows
    from diskann_tpu_torch.ops.kernels import fatrow_expand as k1mod
    from diskann_tpu_torch.ops.kernels.block_patch import block_patch, block_patch_plain

    g = torch.Generator(device=device).manual_seed(5)
    res = {"k1_err": 0, "k1_dps": set(), "sleep_cycles_per_ms": sleep_rate(torch)}
    log(f"[time] timing: the timed calls queue behind torch.cuda._sleep "
        f"({res['sleep_cycles_per_ms']:.0f} cycles a device ms), so the events "
        f"bracket device work only")
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
        res["k1_dps"].add(dp)
        res[f"k1_rp{rp}_dp{dp}"] = k1_row(torch, k1mod, rows, beam, qiw, rp, dp, n, 20,
                                          f"table {n} nodes")
        if dp == 64:
            n_blocks = rows.shape[0] // 8
            nb = 8192 * (nwr // 8)
            idx = torch.randperm(n_blocks - 1, generator=g, device=device)[:nb]
            idx = idx.to(torch.int32)
            vals = torch.empty((nb * 8, 128), dtype=torch.int32, device=device)
            vals.random_(generator=g)
            t = time_ms(torch, lambda: block_patch(rows, idx, vals))
            p = time_ms(torch, lambda: block_patch_plain(rows, idx, vals), tries=1)
            # the one library call that computes the same function
            ridx = (idx.long()[:, None] * 8
                    + torch.arange(8, device=device)[None, :]).reshape(-1)
            lib = time_ms(torch, lambda: rows.index_copy_(0, ridx, vals))
            moved = 2 * nb * 8 * 128 * 4 + nb * 4
            res["k2_int32"] = {"ms": t["ms"], "plain_ms": p["ms"], "library_ms": lib["ms"],
                               "host_ms": t["host_ms"], "library_host_ms": lib["host_ms"],
                               "patches": nb, "gb_per_s": 2 * nb * 4096 / t["ms"] / 1e6,
                               "bound_ms": moved / HBM_BYTES_PER_MS,
                               "bound_by": "bytes"}
            k2t = res["k2_int32"]
            k2t["share"] = k2t["bound_ms"] / t["ms"]
            log(f"[time] block_patch int32 patches={nb} table "
                f"{rows.numel() * 4 / 1e9:.2f} GB: kernel {t['ms']:.4f} ms "
                f"({k2t['share']:.1%} of its bound), plain {p['ms']:.3f} ms, "
                f"index_copy_ {lib['ms']:.4f} ms (host {lib['host_ms']:.4f} ms a call), "
                f"bound {k2t['bound_ms']:.4f} ms ({moved / 1e6:.1f} MB at 3.35 TB/s); "
                f"{timing_note(t, 20)}")
            del idx, vals, ridx
        else:
            res["k2_err"] = check_k2_full(torch, rows, n * nwr // 8, g)
        del rows, beam, qiw
        torch.cuda.empty_cache()
    # the other packed widths
    for rp, dp in K1_WIDTHS:
        nodes = MERGED_N // MERGED_SHARDS if (rp, dp) == K1_MERGED else 1 << 17
        nwr = n_wrows(rp, dp)
        rows = torch.empty(((nodes + 1) * nwr, 128), dtype=torch.int32, device=device)
        rows.random_(generator=g)
        for slots in (bw, K1_WIDE_SLOTS) if rp == 16 else (bw,):
            beam = torch.randint(0, nodes, (slots,), generator=g, device=device,
                                 dtype=torch.int32)
            beam[:3] = torch.tensor([nodes - 1, nodes + 5, -3], dtype=torch.int32)
            qiw = torch.randint(-127, 128, (slots, dp), generator=g, device=device,
                                dtype=torch.int8)
            res["k1_err"] = max(res["k1_err"],
                                check_k1_full(torch, rows, beam, qiw, rp, dp, nodes))
            res["k1_dps"].add(dp)
            key = f"k1_rp{rp}_dp{dp}" + ("" if slots == bw else f"_bw{slots}")
            res[key] = k1_row(torch, k1mod, rows, beam, qiw, rp, dp, nodes, K1_WIDTH_REPS,
                              f"table {nodes} nodes")
            del beam, qiw
        del rows
        torch.cuda.empty_cache()
    host = {k: round(v["host_ms"], 4) for k, v in res.items()
            if isinstance(v, dict) and "host_ms" in v}
    log(f"[time] host ms per wrapper call (the enqueue alone, no sync): {json.dumps(host)}")
    return res


# ------------------------------------------- the dtypes, bench and sharded phases
def main_config():
    """`bench.py`'s build settings (the main path's)."""
    from diskann_tpu_torch import GraphConfig

    return GraphConfig(max_degree=64, l_build=100, alpha=1.2, beam_width=4,
                       build_max_hops=12, max_occlusion_size=256)


def sweep_packed(idx, qd, gt, ls, tag: str) -> list:
    """The main path's packed search (W=4, rerank_l=12, max_hops=6) at each
    L: recall@10 and QPS (best of 2 timed calls after a warm-up)."""
    import numpy as np
    import torch

    from diskann_tpu_torch.bench.recall import knn_recall

    nq = qd.shape[0]
    out = []
    for l in ls:
        kw = dict(l_search=l, beam_width=4, mode="packed", rerank_l=12, max_hops=6)
        idx.search(qd, K, **kw)
        dts = []
        for _ in range(2):
            (dists, ids, stats), dt = _timed(torch, qd.device, lambda: idx.search(qd, K, **kw))
            dts.append(dt)
        if ids.shape != (nq, K) or not np.isfinite(dists[ids >= 0]).all():
            raise RuntimeError(f"{tag} L={l}: malformed search result")
        pt = {"l": l, "recall": knn_recall(ids, gt, K), "qps": nq / min(dts),
              "qps_reps": [nq / t for t in dts], "mean_hops": float(stats.hops.mean()),
              "mean_cmps": float(stats.cmps.mean())}
        out.append(pt)
        log(f"{tag} search L={l} W=4 rerank_l=12 max_hops=6: recall@{K}={pt['recall']:.4f} "
            f"qps={pt['qps']:.0f} (reps {[round(v) for v in pt['qps_reps']]}) "
            f"mean_hops={pt['mean_hops']:.2f}")
    return out


def save_without_packed(idx, path: str) -> None:
    """Save ``idx`` without its packed table (tens of GB at 1M rows and
    dp=128); a load re-derives it with `attach_packed`, which is
    deterministic."""
    packed, idx.packed = idx.packed, None
    try:
        idx.save(path)
    finally:
        idx.packed = packed


def to_uint8(a, lo: float, hi: float):
    """Affine map of [lo, hi] onto 0..255, rounded: a uint8 set in the
    shape of BigANN's SIFT."""
    import numpy as np

    return np.clip(np.rint((a - lo) * (255.0 / (hi - lo))), 0, 255).astype(np.uint8)


def run_dtypes(device, n: int, gt, main_sweep, k1, k2) -> dict:
    """[dtypes] The main path's data stored as float16: the packed build
    with `bench.py`'s settings, attach_packed(dp=128) and the L sweep
    against the main path's float32 groundtruth (recall within
    DTYPE_RECALL_GAP of the float32 main path at each L), the vectors'
    device bytes (half of float32's), and a save/load round trip with
    identical ids.  Then a uint8 set (the same data mapped to 0..255, as
    BigANN's SIFT holds it, with its own exact groundtruth): the same build
    and a sweep to L=100 that must reach TARGET_RECALL.  Both builds must
    launch K1 and K2.  Then `check_small_dtypes`."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from diskann_tpu_torch import FlatIndex, GraphIndex
    from diskann_tpu_torch.bench.harness import make_clustered

    out = {}
    x, q = make_clustered(0, n, NQ, D, n_clusters=4096, sigma=0.35)
    qd = torch.from_numpy(q).to(device)
    build_kw = dict(insert_batch_size=8192, search_batch_size=NQ, build_mode="packed",
                    packed_dp=64, build_backedge_src_cap=64, device=device)
    cases = [("float16", torch.float16, x.astype(np.float16), qd, gt, L_SWEEP)]
    lo, hi = float(x.min()), float(x.max())
    xu, qu = to_uint8(x, lo, hi), to_uint8(q, lo, hi)
    del x
    qud = torch.from_numpy(qu.astype(np.float32)).to(device)
    (_, gtu), dt = _timed(torch, device, lambda: FlatIndex(
        torch.from_numpy(xu.astype(np.float32)).to(device)).search(qud, K))
    log(f"[dtypes] uint8 set {n} x {D} (affine [{lo:.3f}, {hi:.3f}] -> 0..255): exact "
        f"top-{K} in {dt:.1f}s")
    cases.append(("uint8", torch.uint8, xu, qud, gtu, DTYPE_UINT8_L))
    for name, dtype, data, qq, truth, ls in cases:
        take_launches(k1, k2)
        idx, dt = _timed(torch, device, lambda: GraphIndex.build(
            data, main_config(), dtype=dtype, **build_kw))
        launches = take_launches(k1, k2, f"dtypes {name} build")
        vec = idx.state.vectors
        row = {"dtype": name, "build_s": dt, "build_points_per_s": n / dt,
               "vector_bytes": vec.numel() * vec.element_size(),
               "float32_bytes": vec.numel() * 4, "build_launches": launches}
        log(f"[dtypes] {name} packed build: {dt:.1f}s ({n / dt:.0f} points/s); vectors "
            f"{vec.dtype} {row['vector_bytes'] / 1e6:.1f} MB on the device (float32: "
            f"{row['float32_bytes'] / 1e6:.1f} MB)")
        if vec.dtype != dtype or min(launches.values()) == 0:
            raise RuntimeError(f"[dtypes] {name}: stored {vec.dtype}, launches {launches}")
        idx.attach_packed(dp=128)
        idx.router_compute = "bf16"
        row["sweep"] = sweep_packed(idx, qq, truth, ls, f"[dtypes] {name}")
        row["launches"] = take_launches(k1, k2, f"dtypes {name}")
        if name == "float16":
            if row["vector_bytes"] * 2 != row["float32_bytes"]:
                raise RuntimeError("[dtypes] float16 vectors do not take half the bytes")
            gaps = [abs(p["recall"] - m["recall"]) for p, m in zip(row["sweep"], main_sweep)]
            row["max_recall_gap"] = max(gaps)
            log(f"[dtypes] float16 against the float32 main path: recall@{K} gaps per L "
                f"{[round(g, 4) for g in gaps]} (need <= {DTYPE_RECALL_GAP})")
            if max(gaps) > DTYPE_RECALL_GAP:
                raise RuntimeError(f"[dtypes] float16 recall strays {max(gaps):.4f} from float32")
            kw = dict(l_search=24, beam_width=4, mode="packed", rerank_l=12, max_hops=6)
            _, want, _ = idx.search(qq, K, **kw)
            tmp = tempfile.mkdtemp(prefix="chip_smoke_f16_")
            try:
                _, dt_save = _timed(torch, device, lambda: save_without_packed(idx, tmp))
                re, dt_load = _timed(torch, device, lambda: GraphIndex.load(
                    tmp, device=device, search_batch_size=NQ))
            finally:
                shutil.rmtree(tmp)
            re.attach_packed(dp=128)
            re.router_compute = "bf16"
            _, got, _ = re.search(qq, K, **kw)
            row.update(save_s=dt_save, load_s=dt_load,
                       reload_identical=bool(np.array_equal(got, want)))
            log(f"[dtypes] float16 save {dt_save:.1f}s, load {dt_load:.1f}s "
                f"({re.state.vectors.dtype}), re-attach, search L=24: identical ids "
                f"{row['reload_identical']}")
            if re.state.vectors.dtype != torch.float16 or not row["reload_identical"]:
                raise RuntimeError("[dtypes] the float16 save/load round trip changed results")
            del re
            take_launches(k1, k2)
        else:
            best = max(p["recall"] for p in row["sweep"])
            if best < TARGET_RECALL:
                raise RuntimeError(f"[dtypes] uint8: no L <= 100 reached recall@{K} "
                                   f">= {TARGET_RECALL} (best {best:.4f})")
        out[name] = row
        del idx
        torch.cuda.empty_cache()
    out["small"] = check_small_dtypes(torch, device)
    return out


def check_small_dtypes(torch, device) -> dict:
    """bfloat16 and int8 vectors at 20k: a packed index built on the card
    with each dtype, carried to the CPU by `convert.py` in its own dtype,
    searched on both: full-precision ids identical on >= DTYPE_SMALL_SHARE
    of (query, rank) entries (the lift to float32 is exact on both; only
    float32 sum order differs), the packed walk on >= 0.99 (as the other
    small checks: the query's int8 code may round differently).  The
    bfloat16 index is then saved and loaded on the card: identical ids."""
    import shutil
    import tempfile

    import numpy as np

    from diskann_tpu_torch import GraphConfig, GraphIndex
    from diskann_tpu_torch.bench.harness import make_clustered
    from diskann_tpu_torch.convert import graph_index_from_arrays, index_arrays

    n = 20_000
    x, q = make_clustered(2, n, 512, D, n_clusters=256, sigma=0.35)
    cfg = GraphConfig(max_degree=32, l_build=64, beam_width=4)
    full = dict(l_search=40, mode="full")
    packed = dict(l_search=24, beam_width=4, mode="packed", rerank_l=12, max_hops=6)
    out = {}
    for name, dtype, data, qq in (
        ("bfloat16", torch.bfloat16, x, q),
        ("int8", torch.int8, np.clip(np.rint(x * 24), -127, 127).astype(np.int8),
         np.rint(q * 24).astype(np.float32)),
    ):
        card = GraphIndex.build(data, cfg, insert_batch_size=4096, build_mode="packed",
                                packed_dp=64, dtype=dtype, device=device)
        card.attach_packed(dp=128)
        host = graph_index_from_arrays(**index_arrays(card), device="cpu",
                                       insert_batch_size=card.insert_batch_size)
        if host.state.vectors.dtype != dtype or card.state.vectors.dtype != dtype:
            raise RuntimeError(f"[small-dtypes] {name}: the vectors lost their dtype")
        row = {}
        for mode, kw, bar in (("full", full, DTYPE_SMALL_SHARE), ("packed", packed, 0.99)):
            _, ids_card, _ = card.search(qq, K, **kw)
            _, ids_host, _ = host.search(qq, K, **kw)
            row[mode] = float((ids_card == ids_host).mean())
            log(f"[small-dtypes] n={n} {name} {mode} search on the card vs the CPU copy: "
                f"identical ids {row[mode]:.4f} (need >= {bar})")
            if row[mode] < bar:
                raise RuntimeError(f"[small-dtypes] {name} {mode}: card and CPU disagree")
        if name == "bfloat16":
            tmp = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
            try:
                card.save(tmp)
                re = GraphIndex.load(tmp, device=device)
            finally:
                shutil.rmtree(tmp)
            same = all(np.array_equal(re.search(qq, K, **kw)[1], card.search(qq, K, **kw)[1])
                       for kw in (full, packed))
            row["reload_identical"] = same
            log(f"[small-dtypes] bfloat16 save/load on the card ({re.state.vectors.dtype}): "
                f"identical ids {same}")
            if re.state.vectors.dtype != torch.bfloat16 or not same:
                raise RuntimeError("[small-dtypes] the bfloat16 round trip changed results")
        out[name] = row
    return out


def run_bench(device, idx_dir: str, k1, k2, *, example: str | None = None) -> dict:
    """[bench] `python -m diskann_tpu_torch.bench`, in process on the card:
    `list` (the six families), `run` of every example job file and of a
    flat job (the six families), `check` of one search result against
    itself under `example/tolerances.json` (must pass), then `abgate` on
    the main path's 1M index (loaded from ``idx_dir``, re-attached at
    dp=128): an A/A run of BENCH_SIDE with itself and one A/B run of
    merge_trunc off against on, BENCH_REPS reps each, the probe's clean
    threshold calibrated on the card.  Prints each side's median QPS, the
    spread of its reps and its probe times; the A/A spread is the noise
    floor.  ``example``: the job files' directory (default: the package's
    `bench/example/`)."""
    import contextlib
    import glob
    import io
    import os
    import shutil
    import tempfile

    import torch

    import diskann_tpu_torch.bench as bench_pkg
    from diskann_tpu_torch.bench.__main__ import main as bench_main

    def cli(argv):
        buf = io.StringIO()
        code = 0
        with contextlib.redirect_stdout(buf):
            try:
                bench_main(argv)
            except SystemExit as e:
                code = e.code
        return code, buf.getvalue()

    example = example or os.path.join(os.path.dirname(bench_pkg.__file__), "example")
    out = {"families": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    try:
        _, listed = cli(["list"])
        names = listed.split()
        log(f"[bench] list: {names}")
        if len(names) != 6:
            raise RuntimeError(f"[bench] list printed {names}, not six families")
        flat_job = os.path.join(tmp, "flat.json")
        with open(flat_job, "w") as f:
            json.dump([{"benchmark": "flat", "n": 100_000, "dim": 64, "n_queries": 1000}], f)
        jobs = [p for p in sorted(glob.glob(os.path.join(example, "*.json")))
                if "tolerances" not in p] + [flat_job]
        for path in jobs:
            res_path = os.path.join(tmp, "res_" + os.path.basename(path))
            (code, _), dt = _timed(torch, device, lambda: cli(
                ["run", path, "-o", res_path, "--device", str(device)]))
            if code:
                raise RuntimeError(f"[bench] run {path} exited {code}")
            with open(res_path) as f:
                for r in json.load(f):
                    res = r["result"]
                    fam = r["benchmark"]
                    if fam == "graph-index":
                        brief = {"build_points_per_s": res["build"]["points_per_s"],
                                 "search": [{k: p[k] for k in ("l_search", "recall", "qps")}
                                            for p in res["search"]]}
                        out["sweep_point"] = res["search"][0]
                    elif fam == "streaming":
                        brief = {"checkpoints": [round(e.get("recall", -1), 4)
                                                 for e in res["log"] if "recall" in e]}
                    else:
                        brief = {k: v for k, v in res.items() if not isinstance(v, (list, dict))}
                    out["families"].setdefault(fam, []).append(
                        {"job": {k: v for k, v in r["job"].items()}, "wall_s": r["wall_s"],
                         **brief})
                    log(f"[bench] {fam} {json.dumps(r['job'])}: {json.dumps(brief)} "
                        f"({r['wall_s']:.1f}s)")
            log(f"[bench] run {os.path.basename(path)}: {dt:.1f}s")
        if sorted(out["families"]) != sorted(names):
            raise RuntimeError(f"[bench] ran {sorted(out['families'])}, listed {names}")
        point = os.path.join(tmp, "point.json")
        with open(point, "w") as f:
            json.dump(out["sweep_point"], f)
        code, text = cli(["check", point, point, os.path.join(example, "tolerances.json")])
        log(f"[bench] check of a graph-index result against itself: exit {code}, "
            f"{text.strip().splitlines()[-1]}")
        if code:
            raise RuntimeError("[bench] check of a result against itself failed")
        take_launches(k1, k2)
        for tag, side_b in (("A/A", BENCH_SIDE), ("A/B", BENCH_SIDE.replace("mtrunc=0",
                                                                           "mtrunc=1"))):
            art = os.path.join(tmp, "gate.txt")
            (code, _), dt = _timed(torch, device, lambda: cli([
                "abgate", "--n", str(BENCH_N), "--nq", str(NQ), "--a", BENCH_SIDE,
                "--b", side_b, "--reps", str(BENCH_REPS), "--idx-cache", idx_dir,
                "--device", str(device), "-o", art]))
            with open(art) as f:
                text = f.read()
            raw = json.loads(text.strip().splitlines()[-1])
            row = {"a": BENCH_SIDE, "b": side_b, "verdict": raw["verdict"], "exit": code,
                   "s": dt, "clean_s": float(text.split("--clean-s ")[1].split()[0])}
            for name, side in raw["search"].items():
                qps = [r["qps"] for r in side["reps"] if r["clean"]]
                probes = [p for r in side["reps"] for p in (r["probe_before"], r["probe_after"])]
                row[name] = {"median_qps": side["qps"], "recall": side["recall"],
                             "reps": [r["qps"] for r in side["reps"]],
                             "spread": (max(qps) - min(qps)) / side["qps"] if qps else None,
                             "probe_ms": [round(p * 1e3, 3) for p in probes]}
                log(f"[bench] abgate {tag} side {name} ({row['a'] if name == 'A' else side_b}): "
                    f"median qps {side['qps']}, recall {side['recall']}, reps {row[name]['reps']} "
                    f"(spread {row[name]['spread']}), probe ms {row[name]['probe_ms']}")
            log(f"[bench] abgate {tag}: verdict {raw['verdict']} (exit {code}), clean "
                f"threshold {row['clean_s'] * 1e3:.3f} ms, {dt:.1f}s")
            if raw["search"]["A"]["recall"] < TARGET_RECALL or (
                    tag == "A/A" and raw["search"]["A"]["recall"] != raw["search"]["B"]["recall"]):
                raise RuntimeError(f"[bench] abgate {tag}: recall {raw['search']}")
            out[tag] = row
        out["launches"] = take_launches(k1, k2, "bench abgate")
        if out["launches"]["fatrow_expand"] == 0:
            raise RuntimeError("[bench] K1 never launched in the abgate's packed search")
    finally:
        shutil.rmtree(tmp)
    return out


def sharded_placements(torch, device) -> dict:
    """The [sharded] placements: every shard on ``device`` ("one"), and
    with more than one visible card, shard s on card s % the cards
    ("all", `shard_cards`)."""
    one = [device] * SHARD_S
    if device.type != "cuda" or torch.cuda.device_count() < 2:
        return {"one": one}
    return {"one": one, "all": shard_cards(torch, device, SHARD_S)}


def run_sharded(device, n: int, gt, k1, k2) -> dict:
    """[sharded] The main path's data over SHARD_S shards: the k-means
    partition with overlap 2, then `sharded_run` and `run_sharded_10m` on
    each placement of `sharded_placements`.  With one card, one run.  With
    several, SHARD_REPS runs with every shard on card 0 and SHARD_REPS
    spread over every card, interleaved one, all, all, one, one, all;
    every run's ids at every L must equal the first one-card run's, each
    placement's first run traces one insert call and one packed search
    (`trace_fanout`: every card's busy share), and the medians of each
    operation on both placements are printed with their ratio."""
    import numpy as np
    import torch

    from diskann_tpu_torch.bench.harness import make_clustered
    from diskann_tpu_torch.parallel import kmeans_partition

    x, q = make_clustered(0, n, NQ, D, n_clusters=4096, sigma=0.35)
    qd = torch.from_numpy(q).to(device)
    (_, assign), dt = _timed(torch, device, lambda: kmeans_partition(
        x, SHARD_S, overlap=2, device=device))
    counts = np.bincount(assign.ravel(), minlength=SHARD_S)
    log(f"[sharded] k-means partition of {n} into {SHARD_S} shards, overlap 2: "
        f"{dt:.1f}s, rows per shard {counts.tolist()}")
    places = sharded_placements(torch, device)
    if len(places) == 1:
        out = sharded_run(torch, x, qd, gt, assign, counts, places["one"], k1, k2,
                          first=True, trace=False)
        out.pop("ids")
        out["10m"] = run_sharded_10m(device, k1, k2)
        return out
    runs, ref = {"one": [], "all": []}, None
    for which in ("one", "all", "all", "one", "one", "all")[:2 * SHARD_REPS]:
        first = not runs[which]
        log(f"[sharded] run {len(runs[which]) + 1} of {SHARD_REPS} on placement {which!r}")
        r = sharded_run(torch, x, qd, gt, assign, counts, places[which], k1, k2,
                        first=first, trace=first)
        r["10m"] = run_sharded_10m(device, k1, k2, None if which == "all" else device,
                                   save_load=first)
        ids = r.pop("ids")
        ref = ids if ref is None else ref
        r["ids_identical"] = all(np.array_equal(ids[key], ref[key]) for key in ref)
        log(f"[sharded] ids at every L identical to the first one-card run's: "
            f"{r['ids_identical']}")
        if not r["ids_identical"]:
            raise RuntimeError(f"[sharded] placement {which!r} changed the ids")
        runs[which].append(r)
    out = {"placements": {k: [str(c) for c in v] for k, v in places.items()},
           "runs": runs, "medians": {}, "ratio": {}}
    ops = {"inserts_s": lambda r: r["build_s"], "attach_s": lambda r: r["attach_s"],
           "delete_s": lambda r: r["delete"]["s"],
           **{f"10m_{k}_s": (lambda r, k=k: r["10m"][f"{k}_s"])
              for k in ("insert", "delete", "reinsert")},
           **{f"{m}_qps_l{l}": (lambda r, m=m, l=l: next(
               p["qps"] for p in r["sweep"] if p["mode"] == m and p["l"] == l))
              for m in ("full", "packed") for l in SHARD_L}}
    for name, get in ops.items():
        med = {w: float(np.median([get(r) for r in runs[w]])) for w in runs}
        out["medians"][name] = med
        # >1 means the spread placement is better: less time, more QPS
        out["ratio"][name] = (med["all"] / med["one"] if "qps" in name
                              else med["one"] / med["all"])
        log(f"[sharded] {name}: median of {SHARD_REPS}, one card {med['one']:.3f}, "
            f"{len(set(places['all']))} cards {med['all']:.3f}: "
            f"{out['ratio'][name]:.2f}x for the spread placement")
    return out


def sharded_run(torch, x, qd, gt, assign, counts, cards, k1, k2, *, first: bool,
                trace: bool) -> dict:
    """One [sharded] run on the placement ``cards``: inserts of 8192 rows
    with the main path's settings (every call but the last timed; the last
    traced with ``trace``), attach_packed(dp=128), full and packed search
    at SHARD_L (the packed walk must reach TARGET_RECALL; with ``trace``
    one more packed search at L=24 traced), a delete of SHARD_DELETE
    external ids (none may come back); with ``first`` also the filtered
    "cat0" search, save and a load onto the first card alone (identical
    ids at L=40) and `sharded_flat_search` over the same cards against
    `FlatIndex` (identical ids).  Every card that holds a shard must
    launch K2 in the attach and the delete and K1 in the packed walk.
    Returns the run's figures, with the ids of every sweep point under
    "ids"."""
    import numpy as np

    from diskann_tpu_torch import FlatIndex
    from diskann_tpu_torch.bench.recall import knn_recall
    from diskann_tpu_torch.parallel import ShardedGraphIndex, sharded_flat_search

    device = qd.device
    n = x.shape[0]
    used = sorted({c.index for c in cards if c.type == "cuda"})
    out = {"n": n, "shards": SHARD_S, "cards": len(used) or 1,
           "placement": [str(c) for c in cards], "sweep": [], "ids": {}}
    if used:
        out["card_names"] = {c: torch.cuda.get_device_name(c) for c in used}
        for c in used:
            torch.cuda.reset_peak_memory_stats(c)
    log(f"[sharded] {SHARD_S} shards over {out['cards']} card(s): shard s on "
        f"{out['placement']}; {out.get('card_names', {})}")

    def per_card(phase: str, need: str | None = None) -> dict:
        """The phase's per-card launches (then restart the counts); with
        ``need``, every card that holds a shard must have launched it."""
        got = card_launches(k1, k2, used)
        log(f"[sharded] {phase} kernel launches per card: {got}")
        missing = [c for c in used if need and got[c][need] == 0]
        if missing:
            raise RuntimeError(f"[sharded] {phase}: cards {missing} never launched {need}")
        return {"per_card": got, **take_launches(k1, k2)}

    idx = ShardedGraphIndex(cards, D, main_config(), cap_per_shard=int(counts.max()))
    take_launches(k1, k2)
    last = (n - 1) // 8192 * 8192

    def insert_all():
        for off in range(0, last, 8192):
            idx.insert(x[off:off + 8192], assign[off:off + 8192])

    _, dt = _timed(torch, device, insert_all)
    routed = int((assign[:last] >= 0).sum())
    out.update(build_s=dt, build_points_per_s=last / dt, routed_rows_per_s=routed / dt)

    def insert_last():
        idx.insert(x[last:], assign[last:])

    if trace:
        out["trace_insert"] = trace_fanout(torch, insert_last, f"the last insert call "
                                           f"({n - last} rows) on {out['placement']}")
    else:
        _timed(torch, device, insert_last)
    log(f"[sharded] inserts of 8192 (full precision; the {last // 8192} calls before the "
        f"last): {dt:.1f}s ({last / dt:.0f} points/s, {routed / dt:.0f} routed rows/s); "
        f"capacity per shard {idx.cap_per_shard}")
    out["build_launches"] = take_launches(k1, k2, "sharded build")
    ecol = idx._host_arrays()["ext"]
    if not (np.bincount(ecol[ecol >= 0], minlength=n) == 2).all():
        raise RuntimeError("[sharded] an external id is not stored in exactly two shards")
    _, dt = _timed(torch, device, lambda: idx.attach_packed(dp=128))
    out["attach_s"] = dt
    out["attach_launches"] = per_card("attach_packed", "block_patch")
    log(f"[sharded] attach_packed dp=128: {dt:.1f}s")
    for mode in ("full", "packed"):
        idx.search(qd[:1024], K, l_search=SHARD_L[0], mode=mode)
        for l in SHARD_L:
            (dists, ids, _), dt = _timed(torch, device, lambda: idx.search(
                qd, K, l_search=l, mode=mode))
            s = np.sort(ids, axis=1)
            if ((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any():
                raise RuntimeError(f"[sharded] {mode} L={l}: an overlap copy came back twice")
            pt = {"mode": mode, "l": l, "recall": knn_recall(ids, gt, K), "qps": NQ / dt}
            out["sweep"].append(pt)
            out["ids"][(mode, l)] = ids
            log(f"[sharded] {mode} search L={l}: recall@{K}={pt['recall']:.4f} "
                f"qps={pt['qps']:.0f}")
        out[f"{mode}_launches"] = per_card(f"{mode} search",
                                           "fatrow_expand" if mode == "packed" else None)
    best = max(p["recall"] for p in out["sweep"] if p["mode"] == "packed")
    if best < TARGET_RECALL or out["packed_launches"]["fatrow_expand"] == 0:
        raise RuntimeError(f"[sharded] packed search: best recall {best:.4f}, "
                           f"launches {out['packed_launches']}")
    if trace:
        out["trace_search"] = trace_fanout(
            torch, lambda: idx.search(qd, K, l_search=24, mode="packed"),
            f"one packed search of {NQ} queries at L=24 on {out['placement']}")
        take_launches(k1, k2)

    if first:
        cats = bench_cats(n)
        idx.attach_labels([[f"cat{c}"] for c in cats])
        mask = pred_mask(cats, "cat0")
        members = np.nonzero(mask)[0]
        _, local = FlatIndex(x[members], device=device).search(qd, K)
        (_, ids, _), dt = _timed(torch, device, lambda: idx.search_filtered(
            qd, "cat0", K, l_search=90))
        check_filtered_ids(ids, mask, "[sharded] cat0")
        out["cat0"] = {"recall": knn_recall(ids, members[local], K), "qps": NQ / dt}
        log(f"[sharded] filtered cat0 (inline walk, L=90): recall@{K}="
            f"{out['cat0']['recall']:.4f} qps={out['cat0']['qps']:.0f}")

    dead = np.random.default_rng(5).choice(n, size=SHARD_DELETE, replace=False)
    take_launches(k1, k2)
    _, dt = _timed(torch, device, lambda: idx.delete(dead))
    out["delete"] = {"n": SHARD_DELETE, "s": dt, "freed": idx._free_total,
                     "launches": per_card("delete", "block_patch")}
    for mode in ("full", "packed"):
        _, ids, _ = idx.search(qd, K, l_search=40, mode=mode)
        if np.isin(ids[ids >= 0], dead).any():
            raise RuntimeError(f"[sharded] {mode} search returned a deleted id")
        out["delete"][f"{mode}_recall"] = knn_recall(ids, gt, K)
    log(f"[sharded] delete {SHARD_DELETE} external ids ({idx._free_total} slots freed): "
        f"{dt:.1f}s; no deleted id returned; recall@{K} at L=40 against the "
        f"pre-delete truth: full {out['delete']['full_recall']:.4f}, packed "
        f"{out['delete']['packed_recall']:.4f}")
    take_launches(k1, k2)
    if used:
        out["peak_gib_per_card"] = {c: torch.cuda.max_memory_allocated(c) / 2**30
                                    for c in used}
        log(f"[sharded] max_memory_allocated per card (GiB): {out['peak_gib_per_card']}")
    if not first:
        del idx
        torch.cuda.empty_cache()
        return out

    # the record holds no placement: load it onto the first card alone and
    # hold its ids against the placement's
    _, want, _ = idx.search(qd, K, l_search=40)
    one_card = cards[0]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        _, dt_save = _timed(torch, device, lambda: idx.save(tmp))
        re, dt_load = _timed(torch, device, lambda: ShardedGraphIndex.load(
            tmp, device=one_card))
    finally:
        shutil.rmtree(tmp)
    _, got, _ = re.search(qd, K, l_search=40)
    out["save_s"], out["load_s"] = dt_save, dt_load
    out["reload_identical"] = bool(np.array_equal(got, want))
    log(f"[sharded] save {dt_save:.1f}s, load onto {one_card} alone {dt_load:.1f}s: "
        f"identical ids at L=40 to the {out['cards']}-card placement "
        f"{out['reload_identical']}")
    if not out["reload_identical"]:
        raise RuntimeError("[sharded] the save/load onto one card changed results")
    del re, idx
    torch.cuda.empty_cache()

    xd = torch.from_numpy(x).to(device)
    (fd, fi), dt = _timed(torch, device, lambda: sharded_flat_search(cards, xd, qd, K))
    (gd, gi), dt_flat = _timed(torch, device, lambda: FlatIndex(xd).search(qd, K))
    out["flat"] = {"s": dt, "flat_index_s": dt_flat,
                   "identical_ids": float((fi.cpu().numpy() == gi).mean())}
    log(f"[sharded] sharded_flat_search ({SHARD_S} blocks over {out['cards']} card(s)) "
        f"{dt:.2f}s vs FlatIndex {dt_flat:.2f}s: identical ids "
        f"{out['flat']['identical_ids']:.6f}")
    if out["flat"]["identical_ids"] != 1.0:
        raise RuntimeError("[sharded] sharded_flat_search disagrees with FlatIndex")
    del xd
    torch.cuda.empty_cache()
    return out


def _merge_spans(spans):
    """Sorted, merged [start, end) intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


# host calls that block until a card has drained its queue (or a copy ends)
_BLOCKING = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
             "cudaMemcpy", "cudaMemcpyAsync")


def trace_fanout(torch, fn, what: str, *, gaps: int = 3) -> dict:
    """torch.profiler (CPU and CUDA) over one call of ``fn`` on a sharded
    index: the call's wall, each card's busy time (the union of its kernel
    and copy spans) and busy share of the wall, each host thread's time in
    calls that block on a card (`_BLOCKING`) and its dispatch time (the
    rest of the wall), and each card's ``gaps`` longest idle gaps, each
    named by what the host was doing then: its blocked time inside the gap
    and the ops it issued (count, and the two that overlap the gap most)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cards = list(range(torch.cuda.device_count()))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("trace_window"):
            fn()
            for c in cards:
                torch.cuda.synchronize(c)
    events = prof.events()
    win = next(e for e in events if e.name == "trace_window").time_range
    t0, t1 = win.start, win.end
    wall = (t1 - t0) / 1e3
    cuda = torch.autograd.DeviceType.CUDA
    # the window's own range also shows on each card, as one span from its
    # first kernel to its last: kernels and copies only
    dev = [e for e in events if e.device_type == cuda and e.name != "trace_window"]
    host = [e for e in events if e.device_type != cuda and e.name != "trace_window"]
    blocking = [e for e in host if e.name.startswith(_BLOCKING)]
    out = {"what": what, "wall_ms": wall, "cards": {}, "threads": {}}
    for th in sorted({e.thread for e in host}):
        blocked = sum(s[1] - s[0] for s in _merge_spans(
            (e.time_range.start, e.time_range.end) for e in blocking if e.thread == th)) / 1e3
        ops = sum(1 for e in host if e.thread == th and e.name.startswith("aten::"))
        if ops:
            out["threads"][str(th)] = {"blocked_ms": blocked, "dispatch_ms": wall - blocked,
                                       "aten_ops": ops}
    aten = [e for e in host if e.name.startswith("aten::")]
    for c in sorted({e.device_index for e in dev}):
        spans = _merge_spans((max(e.time_range.start, t0), min(e.time_range.end, t1))
                             for e in dev if e.device_index == c)
        busy = sum(b - a for a, b in spans) / 1e3
        edges = [t0] + [x for s in spans for x in s] + [t1]
        idle = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:gaps]
        named = []
        for length, a in idle:
            b = a + length

            def overlap(e):
                return max(0.0, min(e.time_range.end, b) - max(e.time_range.start, a))

            inside = [e for e in aten if overlap(e) > 0]
            top = sorted(inside, key=overlap, reverse=True)[:2]
            named.append({
                "at_ms": (a - t0) / 1e3, "ms": length / 1e3,
                "host_blocked_ms": sum(overlap(e) for e in blocking) / 1e3,
                "ops_issued": len(inside),
                "longest_ops": [f"{e.name} {overlap(e) / 1e3:.2f}ms" for e in top]})
        by_name = {}
        for e in dev:
            if e.device_index == c:
                by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                              - e.time_range.start) / 1e3
        out["cards"][c] = {
            "busy_ms": busy, "busy_share": busy / wall if wall > 0 else None,
            "kernels": sum(1 for e in dev if e.device_index == c),
            "copies": sum(1 for e in dev if e.device_index == c and "emcpy" in e.name),
            "top_ms": sorted(((ms, name[:60]) for name, ms in by_name.items()),
                             reverse=True)[:4],
            "longest_gaps": named}
    log(f"[trace] {what}: wall {wall:.1f} ms; per card busy ms (share): "
        + ", ".join(f"{c} {v['busy_ms']:.1f} ({v['busy_share']:.3f})"
                    for c, v in out["cards"].items())
        + "; host threads blocked / dispatch ms: "
        + ", ".join(f"{v['blocked_ms']:.1f} / {v['dispatch_ms']:.1f} ({v['aten_ops']} ops)"
                    for v in out["threads"].values()))
    for c, v in out["cards"].items():
        log(f"[trace]   card {c}: most device time in "
            + "; ".join(f"{name} {ms:.1f} ms" for ms, name in v["top_ms"]))
        log(f"[trace]   card {c}: {v['kernels']} device events ({v['copies']} copies); "
            "longest gaps: " + "; ".join(
                f"{g['ms']:.2f} ms at {g['at_ms']:.1f} (host blocked {g['host_blocked_ms']:.2f}"
                f" ms, {g['ops_issued']} ops, {', '.join(g['longest_ops'])})"
                for g in v["longest_gaps"]))
    return out


def only_sharded_trace(torch, device, n: int) -> int:
    """`--only sharded-trace`: the [sharded] index (the main path's data
    in SHARD_S shards, k-means overlap 2, main_config) built on card 0 but
    for its last three insert calls of 8192.  On card 0: one insert call
    traced (`trace_fanout`), attach_packed(dp=128), one untraced packed
    search of the NQ queries at L=24 and one traced.  Then saved, loaded
    onto `shard_cards`, one untraced insert call, the last one traced,
    attach_packed(dp=128) and the two searches again.  Prints a summary
    line."""
    import numpy as np

    from diskann_tpu_torch.bench.harness import make_clustered
    from diskann_tpu_torch.parallel import ShardedGraphIndex, kmeans_partition

    x, q = make_clustered(0, n, NQ, D, n_clusters=4096, sigma=0.35)
    qd = torch.from_numpy(q).to(device)
    _, assign = kmeans_partition(x, SHARD_S, overlap=2, device=device)
    counts = np.bincount(assign.ravel(), minlength=SHARD_S)
    calls = [min(n, n - 8192 * k) for k in (3, 2, 1, 0)]
    idx = ShardedGraphIndex([device] * SHARD_S, D, main_config(),
                            cap_per_shard=int(counts.max()))
    lap, walls = lap_clock()
    for off in range(0, calls[0], 8192):
        idx.insert(x[off:min(off + 8192, calls[0])], assign[off:min(off + 8192, calls[0])])
    sync(torch, device)
    lap("build_on_card_0")
    out = {"n": n}

    def insert(k):
        return lambda: idx.insert(x[calls[k]:calls[k + 1]], assign[calls[k]:calls[k + 1]])

    def trace_placement(tag: str, first_call: int) -> dict:
        got = {"placement": [str(c) for c in idx.devices]}
        got["insert"] = trace_fanout(torch, insert(first_call),
                                     f"{tag}: one insert call of 8192 rows (full precision)")
        idx.attach_packed(dp=128)
        idx.search(qd, K, l_search=24, mode="packed")
        sync(torch, device)
        got["packed_search"] = trace_fanout(
            torch, lambda: idx.search(qd, K, l_search=24, mode="packed"),
            f"{tag}: one packed search of {NQ} queries at L=24")
        return got

    out["one_card"] = trace_placement("one card", 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        idx.save(tmp)
        del idx
        torch.cuda.empty_cache()
        idx = ShardedGraphIndex.load(tmp, device=shard_cards(torch, device, SHARD_S))
    finally:
        shutil.rmtree(tmp)
    lap("one_card_traces_save_and_load")
    insert(1)()
    sync(torch, device)
    out["spread"] = trace_placement(f"{len(set(idx.devices))} cards", 2)
    lap("spread_traces")
    log("[summary] " + json.dumps({"sharded_trace": out, "walls": walls}))
    return 0


def run_sharded6m(device, k1, k2, *, n: int = SH6M_N, nq: int = SH6M_NQ) -> dict:
    """[sharded6m] A collection only four cards hold: `make_clustered(0,
    n, nq, 128, n_clusters=SH6M_CLUSTERS * n / SH6M_N, sigma=0.35)` (the
    main path's generator at its points per cluster), the exact top-10 by
    `FlatIndex` on card 0, the k-means partition into SHARD_S shards with
    overlap 2, one shard per card, capacity the largest shard's rows
    rounded up to 8192 (no grow), inserts of 8192 (main_config),
    attach_packed(dp=SH6M_DP), packed and full search at SH6M_L, a delete
    of SHARD_DELETE external ids and a search after it.  Prints the byte
    arithmetic of the packed table (per card, and what one card would
    need), and fails unless the packed walk reaches TARGET_RECALL at some
    L, no deleted id comes back, every card launches K2 in the attach and
    the delete and K1 in the packed walk, and every card's peak stays
    below SH6M_PEAK_BYTES."""
    import numpy as np
    import torch

    from diskann_tpu_torch import FlatIndex
    from diskann_tpu_torch.bench.harness import make_clustered
    from diskann_tpu_torch.bench.recall import knn_recall
    from diskann_tpu_torch.graph import packed as packed_mod
    from diskann_tpu_torch.parallel import ShardedGraphIndex, kmeans_partition

    cards = shard_cards(torch, device, SHARD_S)
    if len(set(cards)) < SHARD_S:
        raise RuntimeError(f"[sharded6m] needs {SHARD_S} cards, one shard each; "
                           f"{len(set(cards))} visible")
    used = sorted({c.index for c in cards if c.type == "cuda"})
    lap, walls = lap_clock()
    clusters = SH6M_CLUSTERS * n // SH6M_N
    x, q = make_clustered(0, n, nq, D, n_clusters=clusters, sigma=0.35)
    qd = torch.from_numpy(q).to(device)
    xd = torch.from_numpy(x).to(device)
    _, gt = FlatIndex(xd).search(qd, K)
    _, assign = kmeans_partition(xd, SHARD_S, overlap=2)
    del xd
    if device.type == "cuda":
        torch.cuda.empty_cache()
        for c in used:
            torch.cuda.reset_peak_memory_stats(c)
    counts = np.bincount(assign.ravel(), minlength=SHARD_S)
    cap = -(-int(counts.max()) // 8192) * 8192
    cfg = main_config()
    rp = packed_mod.padded_degree(cfg.max_degree_with_slack, SH6M_DP)
    row_b = packed_mod.row_nbytes(rp, SH6M_DP)
    out = {"n": n, "nq": nq, "clusters": clusters, "shards": SHARD_S,
           "placement": [str(c) for c in cards], "rows_per_shard": counts.tolist(),
           "cap_per_shard": cap, "packed_row_bytes": row_b,
           "packed_table_bytes_per_card": (cap + 1) * row_b,
           "packed_table_bytes_one_card": int(counts.sum()) * row_b, "sweep": []}
    log(f"[sharded6m] {n} x {D} in {clusters} clusters, {nq} queries; {SHARD_S} shards "
        f"(k-means, overlap 2) on {out['placement']}: rows {counts.tolist()}, "
        f"{int(counts.sum())} routed; capacity {cap} a shard")
    log(f"[sharded6m] bytes (arithmetic): a packed row at dp={SH6M_DP} is {row_b} B, so "
        f"each card's table is ({cap} + 1) x {row_b} B = "
        f"{out['packed_table_bytes_per_card'] / 1e9:.1f} GB; one card would need "
        f"{int(counts.sum())} x {row_b} B = {out['packed_table_bytes_one_card'] / 1e9:.1f} GB "
        f"for the table alone")
    lap("data_truth_partition")

    idx = ShardedGraphIndex(cards, D, cfg, cap_per_shard=cap)
    take_launches(k1, k2)
    t0 = time.time()
    for i, off in enumerate(range(0, n, 8192)):
        idx.insert(x[off:off + 8192], assign[off:off + 8192])
        if (i + 1) % 128 == 0:
            log(f"[sharded6m] inserted {off + 8192} points in {time.time() - t0:.1f}s")
    sync(torch, device)
    dt = time.time() - t0
    if idx.cap_per_shard != cap:
        raise RuntimeError("[sharded6m] a shard grew")
    out.update(build_s=dt, routed_rows_per_s=int(counts.sum()) / dt)
    log(f"[sharded6m] inserts of 8192 (full precision): {dt:.1f}s "
        f"({n / dt:.0f} points/s, {out['routed_rows_per_s']:.0f} routed rows/s)")
    take_launches(k1, k2)
    lap("inserts")

    def per_card(phase: str, need: str) -> dict:
        got = card_launches(k1, k2, used)
        log(f"[sharded6m] {phase} kernel launches per card: {got}")
        if any(got[c][need] == 0 for c in used):
            raise RuntimeError(f"[sharded6m] {phase}: a card never launched {need}")
        return {"per_card": got, **take_launches(k1, k2)}

    _, out["attach_s"] = _timed(torch, device, lambda: idx.attach_packed(dp=SH6M_DP))
    out["attach_launches"] = per_card("attach_packed", "block_patch")
    log(f"[sharded6m] attach_packed dp={SH6M_DP}: {out['attach_s']:.1f}s")
    for mode in ("packed", "full"):
        idx.search(qd, K, l_search=SH6M_L[0], mode=mode)
        for l in SH6M_L:
            (_, ids, _), dt = _timed(torch, device, lambda: idx.search(
                qd, K, l_search=l, mode=mode))
            pt = {"mode": mode, "l": l, "recall": knn_recall(ids, gt, K), "qps": nq / dt}
            out["sweep"].append(pt)
            log(f"[sharded6m] {mode} search L={l}: recall@{K}={pt['recall']:.4f} "
                f"qps={pt['qps']:.0f}")
        if mode == "packed":
            out["packed_launches"] = per_card("packed search", "fatrow_expand")
    take_launches(k1, k2)
    best = max(p["recall"] for p in out["sweep"] if p["mode"] == "packed")
    lap("search")

    dead = np.random.default_rng(5).choice(n, size=SHARD_DELETE, replace=False)
    _, dt = _timed(torch, device, lambda: idx.delete(dead))
    out["delete"] = {"n": SHARD_DELETE, "s": dt, "freed": idx._free_total,
                     "launches": per_card("delete", "block_patch")}
    for mode in ("packed", "full"):
        _, ids, _ = idx.search(qd, K, l_search=SH6M_L[-1], mode=mode)
        out["delete"][f"{mode}_returned_deleted"] = int(np.isin(ids[ids >= 0], dead).sum())
        out["delete"][f"{mode}_recall"] = knn_recall(ids, gt, K)
    log(f"[sharded6m] delete {SHARD_DELETE} external ids ({idx._free_total} slots freed): "
        f"{dt:.1f}s; deleted ids returned at L={SH6M_L[-1]}: packed "
        f"{out['delete']['packed_returned_deleted']}, full "
        f"{out['delete']['full_returned_deleted']}; recall@{K} against the pre-delete "
        f"truth: packed {out['delete']['packed_recall']:.4f}, full "
        f"{out['delete']['full_recall']:.4f}")
    lap("delete")
    if device.type == "cuda":
        out["peak_bytes_per_card"] = {c: torch.cuda.max_memory_allocated(c) for c in used}
        out["card_bytes"] = {c: torch.cuda.get_device_properties(c).total_memory for c in used}
        log("[sharded6m] max_memory_allocated per card (GB): " + ", ".join(
            f"{c}: {out['peak_bytes_per_card'][c] / 1e9:.2f} of "
            f"{out['card_bytes'][c] / 1e9:.2f}" for c in used))
        if any(out["peak_bytes_per_card"][c] >= SH6M_PEAK_BYTES for c in used):
            raise RuntimeError(f"[sharded6m] a card's peak reached {SH6M_PEAK_BYTES / 1e9} GB")
    if best < TARGET_RECALL:
        raise RuntimeError(f"[sharded6m] packed recall@{K} {best:.4f} < {TARGET_RECALL}")
    if out["delete"]["packed_returned_deleted"] or out["delete"]["full_returned_deleted"]:
        raise RuntimeError("[sharded6m] a search returned a deleted id")
    out["walls"] = walls
    del idx
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def adopt_synthetic(torch, idx, n_total: int, r: int) -> None:
    """Fill the sharded index with a structurally valid synthetic graph
    (`scripts/bench_sharded10m.py`'s recipe): a ring adjacency (slot i ->
    i+1..i+r mod the shard's rows; no repeats, no self-loops, degrees
    consistent), random Gaussian vectors, round-robin external ids (slot i
    of shard s holds s + i * n_shards).  The vectors are drawn on the first
    shard's device, shard by shard, and copied to each shard's: the data
    are the same on any placement."""
    s_count = idx.n_shards
    ns = n_total // s_count
    cap = idx.cap_per_shard
    g = torch.Generator(device=idx.device).manual_seed(0)
    for s in range(s_count):
        dev = idx.devices[s]
        slot = torch.arange(cap, device=dev, dtype=torch.int32)
        live = slot < ns
        adj = (slot[:, None] + torch.arange(1, r + 1, device=dev, dtype=torch.int32)) % ns
        adj = torch.where(live[:, None], adj, -1)
        adj = torch.nn.functional.pad(adj, (0, idx.config.max_degree_with_slack - r),
                                      value=-1)
        vecs = torch.randn((cap, idx.dim), generator=g, device=idx.device).to(dev)
        vecs[~live] = 0.0
        st = idx.shard(s)
        st.vectors.copy_(vecs)
        st.sq_norms.copy_((vecs * vecs).sum(1))
        st.adjacency.copy_(adj)
        st.degrees.copy_(torch.where(live, r, 0))
        st.valid.copy_(live)
        st.vec_sum.copy_(vecs.sum(0))
        idx.ext[s].copy_(torch.where(live, slot * s_count + s, -1))
        idx.starts[s].zero_()
    idx.ns[:] = ns
    idx.next_ext = ns * s_count


def run_sharded_10m(device, k1, k2, one_card=None, *, save_load: bool = True) -> dict:
    """The JAX package's own sharded scale (`scripts/bench_sharded10m.py`):
    SH10M_N x SH10M_D over SH10M_S shards on the visible cards
    (`shard_cards`), or all on ``one_card``, a synthetic ring
    graph adopted on the card, then insert SH10M_BATCH rows with overlap 2,
    delete SH10M_BATCH adopted ids, re-insert SH10M_BATCH (freed slots
    recycle first), search (valid external ids), and with ``save_load``
    save and load (identical ids).  Each time is printed beside the JAX
    package's CPU-mesh figures (`SHARDED10M_r04.json`), which are not a
    yardstick for speed."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from diskann_tpu_torch import GraphConfig
    from diskann_tpu_torch.parallel import ShardedGraphIndex

    s_count, bsz = SH10M_S, SH10M_BATCH
    cfg = GraphConfig(max_degree=SH10M_R, l_build=32, beam_width=4, build_max_hops=8,
                      max_occlusion_size=64)
    cap = SH10M_N // s_count + 3 * bsz
    out = {"n": SH10M_N, "d": SH10M_D, "shards": s_count}
    cards = (shard_cards(torch, device, s_count) if one_card is None
             else [one_card] * s_count)
    idx = ShardedGraphIndex(cards, SH10M_D, cfg, cap_per_shard=cap)
    _, out["adopt_s"] = _timed(torch, device, lambda: adopt_synthetic(torch, idx, SH10M_N,
                                                                      SH10M_R))
    rng = np.random.default_rng(3)

    def free_slots():
        return sum(int((~idx.shard(s).valid[: int(idx.ns[s])]).sum())
                   for s in range(s_count))

    take_launches(k1, k2)
    ext_ids, out["insert_s"] = _timed(torch, device, lambda: idx.insert(
        rng.standard_normal((bsz, SH10M_D)).astype(np.float32),
        rng.integers(0, s_count, size=(bsz, 2))))
    if len(ext_ids) != bsz or idx.next_ext != SH10M_N + bsz:
        raise RuntimeError("[sharded-10m] insert assigned the wrong external ids")
    dead = rng.choice(SH10M_N, size=bsz, replace=False)
    _, out["delete_s"] = _timed(torch, device, lambda: idx.delete(dead))
    freed = free_slots()
    if freed < bsz:
        raise RuntimeError(f"[sharded-10m] {freed} slots freed for {bsz} deleted ids")
    ns_before = idx.ns.copy()
    _, out["reinsert_s"] = _timed(torch, device, lambda: idx.insert(
        rng.standard_normal((bsz, SH10M_D)).astype(np.float32),
        rng.integers(0, s_count, size=(bsz, 2))))
    out["recycled_slots"] = freed - free_slots()
    out["hwm_growth"] = int((idx.ns - ns_before).sum())
    q = rng.standard_normal((64, SH10M_D)).astype(np.float32)
    _, i, _ = idx.search(q, K)
    if not ((i >= 0) & (i < idx.next_ext)).all() or np.isin(i, dead).any():
        raise RuntimeError("[sharded-10m] search returned an invalid or deleted id")
    out["launches"] = take_launches(k1, k2, "sharded-10m")
    for key in ("insert", "delete", "reinsert"):
        log(f"[sharded-10m] {key} {out[key + '_s']:.2f}s on the card (the JAX package's "
            f"8-device CPU mesh, SHARDED10M_r04.json: {SH10M_R04[key]}s)")
    log(f"[sharded-10m] adopt {out['adopt_s']:.1f}s; recycled {out['recycled_slots']} freed "
        f"slots (high-water marks grew {out['hwm_growth']})")
    if out["recycled_slots"] < bsz // 2:
        raise RuntimeError("[sharded-10m] slot recycling failed")
    if save_load:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_sh10m_")
        try:
            _, out["save_s"] = _timed(torch, device, lambda: idx.save(tmp))
            out["saved_bytes"] = sum(os.path.getsize(os.path.join(tmp, f))
                                     for f in os.listdir(tmp))
            re, out["load_s"] = _timed(torch, device, lambda: ShardedGraphIndex.load(
                tmp, device=idx.devices))
        finally:
            shutil.rmtree(tmp)
        _, i2, _ = re.search(q, K)
        out["reload_identical"] = bool(np.array_equal(i, i2))
        for key in ("save", "load"):
            log(f"[sharded-10m] {key} {out[key + '_s']:.2f}s on the card (the JAX package's "
                f"8-device CPU mesh, SHARDED10M_r04.json: {SH10M_R04[key]}s)")
        log(f"[sharded-10m] saved {out['saved_bytes'] / 1e9:.2f} GB; reload identical ids "
            f"{out['reload_identical']}")
        if not out["reload_identical"]:
            raise RuntimeError("[sharded-10m] the reload changed results")
        del re
    del idx
    torch.cuda.empty_cache()
    return out


def only_sharded(torch, device, n: int, k1, k2) -> int:
    """`--only sharded`: the main path's data and exact top-10, then the
    [sharded] phase alone; prints its summary."""
    from diskann_tpu_torch import FlatIndex
    from diskann_tpu_torch.bench.harness import make_clustered

    x, q = make_clustered(0, n, NQ, D, n_clusters=4096, sigma=0.35)
    _, gt = FlatIndex(torch.from_numpy(x).to(device)).search(torch.from_numpy(q).to(device), K)
    del x, q
    torch.cuda.empty_cache()
    lap, walls = lap_clock()
    sharded = run_sharded(device, n, gt, k1, k2)
    lap("sharded")
    log("[summary] " + json.dumps({"sharded": sharded, "walls": walls}))
    return 0


# ------------------------------------------------------------------ rollback
# where `graph/build.insert_batch_steps` is made to fail: (module, attribute,
# failing call, a stepping generator?); each fails after its real call ran
ROLLBACK_POINTS = {
    "walk": ("build", "beam_search_scored_steps", 1, True),
    "prune": ("build", "chunked_robust_prune_steps", 1, True),
    "refresh_3a": ("packed", "refresh_rows", 1, False),
    "append_edges": ("packed", "append_edges", 1, False),
    "prune_3c": ("build", "chunked_robust_prune_steps", 2, True),
    "refresh_3c": ("packed", "refresh_rows", 2, False),
}


def more_points(seed: int, m: int, n_clusters: int = 4096):
    """``m`` more points of the main path's mixture: the cluster centres of
    `make_clustered(0, ...)`, assignments and noise drawn from ``seed``."""
    import numpy as np

    centers = np.random.default_rng(0).standard_normal((n_clusters, D)).astype(np.float32)
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n_clusters, size=m)
    return centers[a] + 0.35 * rng.standard_normal((m, D)).astype(np.float32)


def clone_index(idx, capacity: int | None = None):
    """A copy of `GraphIndex` ``idx`` on fresh graph and packed tensors with
    room for ``capacity`` rows, so that inserts into it leave ``idx`` as it
    is; its label and quantized attachments are left off."""
    import copy
    import dataclasses

    from diskann_tpu_torch.graph import packed as packed_mod
    from diskann_tpu_torch.graph import state as graph_state

    cap = capacity or idx.state.capacity
    c = copy.copy(idx)
    # grow pads into new tensors, also by 0 rows; the sum is shared
    c.state = graph_state.grow(idx.state._replace(vec_sum=idx.state.vec_sum.clone()), cap)
    p = idx.packed
    if cap == p.self_codes.shape[0]:
        p = dataclasses.replace(p, self_codes=p.self_codes.clone(),
                                self_aux=p.self_aux.clone(), rows=p.rows.clone())
    c.packed = packed_mod.grow_packed(p, cap)
    c.free_slots = list(idx.free_slots)
    c.labels = c.pq = c.sq = c.mm = c.sph = None
    c._pred_count_cache = {}
    return c


def clone_sharded(idx):
    """A copy of `ShardedGraphIndex` ``idx`` on fresh tensors."""
    import copy
    import dataclasses

    from diskann_tpu_torch.graph.state import GraphArrays

    c = copy.copy(idx)
    c.arrays = [GraphArrays(*(t.clone() for t in st)) for st in idx.arrays]
    c.ext = [e.clone() for e in idx.ext]
    c.starts = [t.clone() for t in idx.starts]
    c.ns = idx.ns.copy()
    c.packed = [dataclasses.replace(p, self_codes=p.self_codes.clone(),
                                    self_aux=p.self_aux.clone(), rows=p.rows.clone())
                for p in idx.packed]
    return c


def index_tensors(idx) -> dict:
    """Every tensor of a `GraphIndex`'s state and packed table, by name."""
    out = dict(idx.state._asdict())
    out |= {f"packed.{f}": getattr(idx.packed, f) for f in ("self_codes", "self_aux", "rows")}
    return out


def index_host(idx) -> tuple:
    return idx.n, idx.n_deleted, list(idx.free_slots), idx._start().tolist()


def sharded_tensors(idx) -> dict:
    """Every tensor of a `ShardedGraphIndex`, by shard and name."""
    out = {}
    for s in range(idx.n_shards):
        out |= {f"{s}.{f}": t for f, t in idx.shard(s)._asdict().items()}
        out |= {f"{s}.packed.{f}": getattr(idx.packed[s], f)
                for f in ("self_codes", "self_aux", "rows")}
        out[f"{s}.ext"], out[f"{s}.start"] = idx.ext[s], idx.starts[s]
    return out


def sharded_host(idx) -> tuple:
    return idx.ns.tolist(), idx.next_ext, idx.n_deleted, idx._free_total, idx.cap_per_shard


def differing(torch, got: dict, want: dict, nwr: int = 0) -> list:
    """The names whose tensors differ bitwise; with ``nwr``, a packed
    table's last fat row (``nwr`` word rows: the dump row that masked
    writes hit, in no fixed order) is left out."""
    bad = []
    for name, w in want.items():
        g = got[name]
        if nwr and name.endswith("packed.rows"):
            g, w = g[:-nwr], w[:-nwr]
        if not torch.equal(g, w):
            bad.append(name)
    return bad


def fingerprint(torch, tensors: dict) -> dict:
    """Per tensor, two int64 sums over its words (4-, 2- or 1-byte, as
    stored): unweighted, and weighted by the fixed pattern 1 + i % 65521
    of the word's index i (int64 arithmetic wraps, deterministically).
    Plain torch reductions, chunked to bound their temporaries."""
    views = {4: torch.int32, 2: torch.int16, 1: torch.uint8}
    out = {}
    for name, t in tensors.items():
        w = t.reshape(-1).view(views[t.element_size()])
        s0 = torch.zeros((), dtype=torch.int64, device=t.device)
        s1 = torch.zeros((), dtype=torch.int64, device=t.device)
        for off in range(0, w.numel(), 1 << 24):
            c = w[off:off + (1 << 24)].long()
            s0 += c.sum()
            s1 += (c * (torch.arange(off, off + c.numel(), device=t.device) % 65521 + 1)).sum()
        out[name] = (int(s0), int(s1))
    return out


def raised_in(exc) -> str:
    """The innermost `diskann_tpu_torch` frame of ``exc``'s traceback, as
    module.function:line."""
    where, tb = "outside diskann_tpu_torch", exc.__traceback__
    while tb is not None:
        path = tb.tb_frame.f_code.co_filename.replace("\\", "/")
        if "/diskann_tpu_torch/" in path:
            mod = path.rsplit("/diskann_tpu_torch/", 1)[1].removesuffix(".py").replace("/", ".")
            where = f"{mod}.{tb.tb_frame.f_code.co_name}:{tb.tb_lineno}"
        tb = tb.tb_next
    return where


@contextlib.contextmanager
def journal_sizes():
    """Collect the bytes every committed batch's `RowJournal` held (its own
    count, read as the batch drops it) into the yielded list."""
    from diskann_tpu_torch.graph import state as graph_state

    sizes, drop = [], graph_state.RowJournal.drop

    def counted(self):
        sizes.append(self.nbytes)
        drop(self)

    graph_state.RowJournal.drop = counted
    try:
        yield sizes
    finally:
        graph_state.RowJournal.drop = drop


@contextlib.contextmanager
def failing(module, name: str, make):
    """``module.name`` replaced by ``make(original)`` for the block."""
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def fail_after(torch, nth: int, generator: bool):
    """A maker for `failing`: the call runs, and its ``nth`` call then
    raises an injected `torch.cuda.OutOfMemoryError`."""
    def make(orig):
        calls = [0]

        def gen(*a, **k):
            calls[0] += 1
            out = yield from orig(*a, **k)
            if calls[0] == nth:
                raise torch.cuda.OutOfMemoryError("injected")
            return out

        def call(*a, **k):
            calls[0] += 1
            out = orig(*a, **k)
            if calls[0] == nth:
                raise torch.cuda.OutOfMemoryError("injected")
            return out

        return gen if generator else call
    return make


def fail_on_shard(torch, state, flags: int):
    """A maker for `failing` on a stepping generator function whose first
    argument is a shard's `GraphArrays`: on ``state``'s shard it raises an
    injected out-of-memory error after ``flags`` flags."""
    def make(orig):
        def gen(st, *a, **k):
            g = orig(st, *a, **k)
            if st is not state:
                return (yield from g)
            answer = None
            for _ in range(flags):
                answer = yield g.send(answer)
            g.close()
            raise torch.cuda.OutOfMemoryError("injected")
        return gen
    return make


def expect_injected(torch, fn) -> None:
    """Run ``fn``; it must raise the injected out-of-memory error."""
    try:
        fn()
    except torch.cuda.OutOfMemoryError as exc:
        if "injected" not in str(exc):
            raise
    else:
        raise RuntimeError("[rollback] the injected failure never fired")


def run_rollback_main(idx, qd, k1, k2) -> dict:
    """[rollback] (a): real out-of-memory errors on the main path's 1M
    index.  A copy with room for one more batch (the index itself stays as
    the later phases need it) takes one insert of ROLLBACK_BATCH more
    points of the main path's mixture under a device-memory cap of the
    memory in use
    plus each of ROLLBACK_CAPS_MIB, and, with the build-side router off
    (as in every index below 4 x router_size rows), of ROLLBACK_PEAK_SHARES
    of that batch's own peak (the same insert into another copy,
    beforehand): each must raise a real `torch.cuda.OutOfMemoryError` (the
    function of the port whose frame raised is logged) and leave every
    state and packed tensor's
    `fingerprint`, the counters, the freelist and the start as before.
    Then, uncapped, the L=24 packed search must return the ids it returned
    before the failures, and the insert must commit; its journal's bytes
    and the grown index's recall@10 against its exact top-10 are
    reported (below TARGET_RECALL fails)."""
    import dataclasses

    import numpy as np
    import torch

    from diskann_tpu_torch import FlatIndex
    from diskann_tpu_torch.bench.recall import knn_recall

    device = qd.device
    kw = dict(l_search=24, beam_width=4, mode="packed", rerank_l=12, max_hops=6)
    config = idx.config
    no_router = dataclasses.replace(config, router_starts=0)
    new = torch.from_numpy(more_points(1, ROLLBACK_BATCH)).to(device)
    bs = idx.insert_batch_size
    room = max(idx.state.capacity, idx.n + -(-ROLLBACK_BATCH // bs) * bs)
    probe = clone_index(idx, room)
    probe.config = no_router
    torch.cuda.empty_cache()
    in_use = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    probe.insert(new)
    out = {"batch_peak_bytes": torch.cuda.max_memory_allocated(device) - in_use, "caps": []}
    del probe
    twin = clone_index(idx, room)
    ids0 = twin.search(qd, K, **kw)[1]
    fp0, host0 = fingerprint(torch, index_tensors(twin)), index_host(twin)
    total = torch.cuda.get_device_properties(device).total_memory
    caps = [(cap, config) for cap in ROLLBACK_CAPS_MIB] + [
        (int(share * out["batch_peak_bytes"]) >> 20, no_router)
        for share in ROLLBACK_PEAK_SHARES]
    log(f"[rollback] one batch of {ROLLBACK_BATCH} into a copy of the main index, the "
        f"build-side router off, peaks {out['batch_peak_bytes'] / 2**20:.1f} MiB above "
        f"the memory in use; caps at + {[c for c, _ in caps]} MiB")
    for cap_mib, cap_config in caps:
        twin.config = cap_config
        torch.cuda.empty_cache()
        in_use = torch.cuda.memory_reserved(device)
        take_launches(k1, k2)
        torch.cuda.set_per_process_memory_fraction((in_use + cap_mib * 2**20) / total, device)
        try:
            twin.insert(new)
        except torch.cuda.OutOfMemoryError as exc:
            where = raised_in(exc)
        else:
            raise RuntimeError(f"[rollback] the insert fit under +{cap_mib} MiB: no "
                               f"out-of-memory error")
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0, device)
        launches = take_launches(k1, k2)
        same = fingerprint(torch, index_tensors(twin)) == fp0 and index_host(twin) == host0
        log(f"[rollback] cap in use + {cap_mib} MiB ({in_use / 2**30:.2f} GiB in use), "
            f"router {'on' if twin.config is config else 'off'}: out of memory in "
            f"{where}; kernel launches before it {launches}; fingerprints and host "
            f"fields as before: {same}")
        if not same:
            raise RuntimeError(f"[rollback] the failed insert under +{cap_mib} MiB "
                               f"changed the index")
        out["caps"].append({"cap_mib": cap_mib, "router": twin.config is config,
                            "in_use_gib": in_use / 2**30, "raised_in": where,
                            "launches": launches})
    twin.config = config
    torch.cuda.empty_cache()
    ids1 = twin.search(qd, K, **kw)[1]
    if not np.array_equal(ids1, ids0):
        raise RuntimeError("[rollback] the L=24 ids changed after the failed inserts")
    with journal_sizes() as sizes:
        _, out["insert_s"] = _timed(torch, device, lambda: twin.insert(new))
    out["journal_bytes"] = sizes
    _, gt = FlatIndex(twin.state.vectors[: twin.n]).search(qd, K)
    out["recall_grown"] = knn_recall(twin.search(qd, K, **kw)[1], gt, K)
    log(f"[rollback] the same L=24 ids after the failures; the insert then "
        f"committed in {out['insert_s']:.2f}s, its journal {sizes[0] / 2**20:.1f} MiB; "
        f"recall@{K} of the grown {twin.n}-point index at L=24: {out['recall_grown']:.4f}")
    if out["recall_grown"] < TARGET_RECALL:
        raise RuntimeError(f"[rollback] recall@{K} of the grown index "
                           f"{out['recall_grown']:.4f} < {TARGET_RECALL}")
    del twin
    torch.cuda.empty_cache()
    return out


def run_rollback_points(device, k1, k2) -> dict:
    """[rollback] (b): failures injected at each of ROLLBACK_POINTS into an
    insert of ROLLBACK_BATCH points on a ROLLBACK_N x 128 index of the main
    path's mixture (the main build's settings, packed at dp=64): each failed
    insert must leave the index bitwise as it was, and its retry bitwise
    equal to a copy that never failed (the dump row aside); K1 and K2
    must have launched inside the failing batches.  Then the corrupted-
    adjacency search on a copy of the same index (`check_corrupt_adjacency`)."""
    import torch

    from diskann_tpu_torch import GraphIndex
    from diskann_tpu_torch.graph import build as build_mod
    from diskann_tpu_torch.graph import packed as packed_mod

    modules = {"build": build_mod, "packed": packed_mod}
    xd = torch.from_numpy(more_points(2, ROLLBACK_N + ROLLBACK_BATCH)).to(device)
    base = GraphIndex.build(xd[:ROLLBACK_N], main_config(),
                            insert_batch_size=ROLLBACK_BATCH, build_mode="packed",
                            packed_dp=64, build_backedge_src_cap=64,
                            capacity=ROLLBACK_N + ROLLBACK_BATCH)
    new = xd[ROLLBACK_N:]
    twin = clone_index(base)
    twin.insert(new)
    want_t, want_h = index_tensors(base), index_host(base)
    done_t, done_h = index_tensors(twin), index_host(twin)
    nwr = base.packed.nwr
    out = {"points": {}}
    total = {"fatrow_expand": 0, "block_patch": 0}
    for point, (mod, name, nth, gen) in ROLLBACK_POINTS.items():
        c = clone_index(base)
        take_launches(k1, k2)
        with failing(modules[mod], name, fail_after(torch, nth, gen)):
            expect_injected(torch, lambda: c.insert(new))
        launches = take_launches(k1, k2)
        bad = differing(torch, index_tensors(c), want_t)
        same = not bad and index_host(c) == want_h
        c.insert(new)
        bad_retry = differing(torch, index_tensors(c), done_t, nwr)
        retry = not bad_retry and index_host(c) == done_h
        log(f"[rollback] failure at {point}: kernel launches in the failed batch "
            f"{launches}; bitwise as before {same} {bad}; retry bitwise the twin's "
            f"{retry} {bad_retry}")
        if not (same and retry):
            raise RuntimeError(f"[rollback] failure at {point}: the index differs")
        out["points"][point] = {"launches": launches}
        for k in total:
            total[k] += launches[k]
        del c
    if min(total.values()) == 0:
        raise RuntimeError(f"[rollback] a kernel never ran in the failing batches: {total}")
    out["failing_launches"] = total
    out["corrupt"] = check_corrupt_adjacency(base, xd[:ROLLBACK_N], k1)
    del twin
    out["delete_points"] = run_rollback_delete_points(base, k1, k2)
    del base
    torch.cuda.empty_cache()
    return out


def check_corrupt_adjacency(base, xd, k1) -> dict:
    """`tests/test_failure.py`'s corrupted adjacency on the card: a copy of
    ``base`` re-attached at dp=128 (as the main path searches), then
    ROLLBACK_CORRUPT rows get an out-of-range id and -7, and their fat
    rows are rebuilt with them; the packed walk hands those ids to K1 as
    beam ids.  1024 queries next to indexed points at L=32 must return no
    id past the index, with recall@10 >= 0.85 and K1 launched."""
    import numpy as np
    import torch

    from diskann_tpu_torch import FlatIndex
    from diskann_tpu_torch.bench.recall import knn_recall
    from diskann_tpu_torch.graph import packed as packed_mod

    c = clone_index(base)
    c.attach_packed(dp=128)
    cap = c.state.capacity
    rows = torch.as_tensor(np.random.default_rng(9).choice(c.n, ROLLBACK_CORRUPT, replace=False),
                           device=xd.device)
    c.state.adjacency[rows, 0] = cap + 1000
    c.state.adjacency[rows, 1] = -7
    packed_mod.refresh_rows(c.packed, c.state.adjacency, rows)
    q = xd[:1024] + 0.01
    _, gt = FlatIndex(xd).search(q, K)
    before = k1.launches
    _, ids, _ = c.search(q, K, l_search=32, mode="packed")
    sync(torch, xd.device)
    out = {"recall": knn_recall(ids, gt, K), "k1_launches": k1.launches - before,
           "max_id": int(ids.max())}
    log(f"[rollback] corrupted adjacency ({ROLLBACK_CORRUPT} rows: id {cap + 1000} and -7), "
        f"packed walk at L=32: recall@{K} {out['recall']:.4f}, largest id {out['max_id']} "
        f"of {c.n}, K1 launches {out['k1_launches']}")
    if out["max_id"] > c.n or out["recall"] < 0.85 or out["k1_launches"] == 0:
        raise RuntimeError(f"[rollback] corrupted adjacency: {out}")
    return out


def run_rollback_sharded(device, k1, k2) -> dict:
    """[rollback] (c): the one-card [sharded] layout at ROLLBACK_N points
    (SHARD_S shards on ``device``, the k-means partition with overlap 2,
    inserts of ROLLBACK_BATCH, attach_packed(dp=128)).  An insert of
    ROLLBACK_BATCH more rows fails in shard 1's walk; a delete of ROLLBACK_DELETE external ids fails
    in shard 1's repair, then in its second packed refresh: each call must
    leave every shard's tensors and the host bookkeeping bitwise as they
    were.  The insert and delete then commit, bitwise equal to a copy that
    never failed (the dump rows aside)."""
    import numpy as np
    import torch

    from diskann_tpu_torch.parallel import ShardedGraphIndex, kmeans_partition
    from diskann_tpu_torch.parallel import sharded as sharded_mod

    x = more_points(3, ROLLBACK_N + ROLLBACK_BATCH)
    _, assign = kmeans_partition(x[:ROLLBACK_N], SHARD_S, overlap=2, device=device)
    counts = np.bincount(assign.ravel(), minlength=SHARD_S)
    idx = ShardedGraphIndex([device] * SHARD_S, D, main_config(),
                            cap_per_shard=int(counts.max()) + ROLLBACK_BATCH)
    x, new = x[:ROLLBACK_N], x[ROLLBACK_N:]
    for off in range(0, ROLLBACK_N, ROLLBACK_BATCH):
        idx.insert(x[off:off + ROLLBACK_BATCH], assign[off:off + ROLLBACK_BATCH])
    idx.attach_packed(dp=128)
    rr = np.arange(ROLLBACK_BATCH)
    new_assign = np.stack([rr % SHARD_S, (rr + 1) % SHARD_S], 1)
    doomed = np.random.default_rng(4).choice(ROLLBACK_N, ROLLBACK_DELETE, replace=False)
    twin = clone_sharded(idx)
    twin.insert(new, new_assign)
    twin.delete(doomed)
    want_t, want_h = sharded_tensors(clone_sharded(idx)), sharded_host(idx)
    out = {"shards": SHARD_S, "rows_per_shard": counts.tolist(), "calls": {}}

    def refresh_fails(orig):
        calls = [0]

        def call(packed, adjacency, rows, journal=None):
            orig(packed, adjacency, rows, journal)
            if packed is idx.packed[1]:
                calls[0] += 1
                if calls[0] == 2:
                    raise torch.cuda.OutOfMemoryError("injected")
        return call

    for what, module, name, make, fn in (
            ("insert, shard 1's walk", sharded_mod, "insert_batch_steps",
             fail_on_shard(torch, idx.shard(1), 3), lambda: idx.insert(new, new_assign)),
            ("delete, shard 1's repair", sharded_mod.delete_mod, "patch_rows_steps",
             fail_on_shard(torch, idx.shard(1), 1), lambda: idx.delete(doomed)),
            ("delete, shard 1's second packed refresh", sharded_mod.packed_mod,
             "refresh_rows", refresh_fails, lambda: idx.delete(doomed))):
        take_launches(k1, k2)
        with failing(module, name, make):
            expect_injected(torch, fn)
        launches = take_launches(k1, k2)
        bad = differing(torch, sharded_tensors(idx), want_t)
        same = not bad and sharded_host(idx) == want_h
        log(f"[rollback] sharded {what}: kernel launches {launches}; every shard and "
            f"the bookkeeping bitwise as before {same} {bad}")
        if not same:
            raise RuntimeError(f"[rollback] sharded {what}: the index differs")
        out["calls"][what] = {"launches": launches}
    idx.insert(new, new_assign)
    idx.delete(doomed)
    nwr = idx.packed[0].nwr
    bad = differing(torch, sharded_tensors(idx), sharded_tensors(twin), nwr)
    retry = not bad and sharded_host(idx) == sharded_host(twin)
    log(f"[rollback] sharded retry of the insert and the delete bitwise the twin's: "
        f"{retry} {bad}")
    if not retry:
        raise RuntimeError("[rollback] the sharded retry differs from the twin")
    del idx, twin
    torch.cuda.empty_cache()
    return out


def delete_ids(n: int):
    """The ids [rollback] (d) and `--only delete` remove: ROLLBACK_DEL_FRAC
    of ``n``, drawn over the whole index, ascending."""
    import numpy as np

    rng = np.random.default_rng(6)
    return np.sort(rng.choice(n, int(ROLLBACK_DEL_FRAC * n), replace=False))


def measure_delete(torch, idx, ids, setting: dict) -> dict:
    """One ``idx.delete(ids, **setting)``: its wall seconds (the device
    drained on both ends), its `max_memory_allocated` above the memory
    allocated before it, its journal's bytes (None for a package whose
    delete keeps none) and its affected rows."""
    device = idx.device
    torch.cuda.empty_cache()
    in_use = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    with journal_sizes() as sizes:
        _, wall = _timed(torch, device, lambda: idx.delete(ids, **setting))
    return {"wall_s": wall, "peak_bytes": torch.cuda.max_memory_allocated(device) - in_use,
            "journal_bytes": sizes[0] if sizes else None,
            "affected": idx.last_delete_stats["affected"]}


def check_deleted(torch, idx, ids, what: str) -> None:
    """After a committed delete of ``ids`` (all live before it): every one
    freed once and counted, none live, and no live row naming one."""
    from diskann_tpu_torch.graph import delete as delete_mod

    freed = idx.free_slots[-len(ids):]
    dead = torch.as_tensor(ids, device=idx.device)
    dangling = int(delete_mod.rows_referencing_deleted(idx.state).sum())
    if (sorted(freed) != sorted(int(i) for i in ids)
            or idx.last_delete_stats["deleted"] != len(ids)
            or bool(idx.state.valid[dead].any()) or dangling):
        raise RuntimeError(f"{what}: the delete did not free exactly its ids "
                           f"({dangling} live rows name a deleted node)")


def counting(calls: list):
    """A maker for `failing`: the call runs, and ``calls[0]`` counts it."""
    def make(orig):
        def call(*a, **k):
            calls[0] += 1
            return orig(*a, **k)
        return call
    return make


@contextlib.contextmanager
def memory_cap(torch, device, headroom_mib: int):
    """Cached blocks released, then the device memory capped at what is
    allocated plus ``headroom_mib`` MiB, for the block.  Mid-call the
    cached segments that live blocks pin stay reserved above the cap:
    what their free space cannot serve fails."""
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(device).total_memory
    in_use = torch.cuda.memory_allocated(device)
    torch.cuda.set_per_process_memory_fraction((in_use + (headroom_mib << 20)) / total, device)
    try:
        yield in_use
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, device)


def capped_from(torch, device, nth: int, headroom_mib: int, stack):
    """A maker for `failing`: just before the ``nth`` call, `memory_cap`
    enters ``stack`` (an `ExitStack` that outlives the failing call)."""
    def make(orig):
        calls = [0]

        def call(*a, **k):
            calls[0] += 1
            if calls[0] == nth:
                stack.enter_context(memory_cap(torch, device, headroom_mib))
            return orig(*a, **k)
        return call
    return make


def run_rollback_delete(idx, qd, k1, k2) -> dict:
    """[rollback] (d): real out-of-memory errors in a 5% delete of the main
    path's 1M index.  For each of DELETE_SETTINGS, a copy deletes
    `delete_ids` uncapped first (its wall, peak above the memory in use
    and journal bytes measured, its repair batches and refresh chunks
    counted, its fingerprints kept); another copy takes the same delete
    under device-memory caps of the memory in use plus
    ROLLBACK_PEAK_SHARES of that peak, and, for the stream's setting,
    capped at the memory in use plus ROLLBACK_LATE_MIB from the start of
    its last repair batch and of its last refresh chunk (the journal
    nearly full, the undo under the same cap): each must raise a real
    `torch.cuda.OutOfMemoryError` (the port's function whose frame raised
    is logged) and leave every state and packed tensor's `fingerprint`,
    the counters, the freelist, the start and ``last_delete_stats`` as
    before, and the L=24 ids unchanged.  Then the delete runs uncapped:
    it must commit, free exactly its ids with no live row naming one, and
    equal the first copy's fingerprints."""
    import numpy as np
    import torch

    from diskann_tpu_torch.graph import delete as delete_mod
    from diskann_tpu_torch.graph import packed as packed_mod

    device = qd.device
    kw = dict(l_search=24, beam_width=4, mode="packed", rerank_l=12, max_hops=6)
    doomed = delete_ids(idx.n)
    out = {"deleted": len(doomed)}
    for name, setting in DELETE_SETTINGS.items():
        repair_fn = {"fill": "fill_rows", "prune": "patch_rows"}[setting["repair"]]
        probe = clone_index(idx)
        repairs, refreshes = [0], [0]
        with failing(delete_mod, repair_fn, counting(repairs)), \
                failing(packed_mod, "refresh_rows", counting(refreshes)):
            clean = measure_delete(torch, probe, doomed, setting)
        done = fingerprint(torch, index_tensors(probe)), index_host(probe)
        del probe
        twin = clone_index(idx)
        ids0 = twin.search(qd, K, **kw)[1]
        fp0, host0 = fingerprint(torch, index_tensors(twin)), index_host(twin)
        stats0 = twin.last_delete_stats
        res = {"clean": clean, "repair_batches": repairs[0], "refresh_chunks": refreshes[0],
               "caps": []}
        log(f"[rollback] (d) delete {len(doomed)} of {idx.n} ({name}: {setting}) on a copy "
            f"of the main index: {clean['wall_s']:.2f}s, peak "
            f"{clean['peak_bytes'] / 2**20:.1f} MiB above the memory in use, journal "
            f"{(clean['journal_bytes'] or 0) / 2**20:.1f} MiB, affected rows "
            f"{clean['affected']}, {repairs[0]} repair batches, {refreshes[0]} refresh "
            f"chunks")
        caps = [(f"under in use + {mib} MiB",
                 lambda stack, mib=mib: stack.enter_context(memory_cap(torch, device, mib)))
                for mib in (int(share * clean["peak_bytes"]) >> 20
                            for share in ROLLBACK_PEAK_SHARES)]
        if name == "fill":
            for what, module, fn, nth in (("repair batch", delete_mod, repair_fn, repairs[0]),
                                          ("refresh chunk", packed_mod, "refresh_rows",
                                           refreshes[0])):
                caps.append((f"capped at in use + {ROLLBACK_LATE_MIB} MiB from its last {what} "
                             f"(call {nth})",
                             lambda stack, module=module, fn=fn, nth=nth: stack.enter_context(
                                 failing(module, fn, capped_from(torch, device, nth,
                                                                 ROLLBACK_LATE_MIB, stack)))))
        for what, enter in caps:
            take_launches(k1, k2)
            with contextlib.ExitStack() as stack:
                enter(stack)
                try:
                    twin.delete(doomed, **setting)
                except torch.cuda.OutOfMemoryError as exc:
                    where = raised_in(exc)
                else:
                    raise RuntimeError(f"[rollback] (d) the {name} delete {what}: no "
                                       f"out-of-memory error")
            launches = take_launches(k1, k2)
            same = (fingerprint(torch, index_tensors(twin)) == fp0
                    and index_host(twin) == host0 and twin.last_delete_stats == stats0)
            log(f"[rollback] (d) {name} delete {what}: out of memory in {where}; kernel "
                f"launches in the call and its undo {launches}; fingerprints, host fields "
                f"and stats as before: {same}")
            if not same:
                raise RuntimeError(f"[rollback] (d) the failed {name} delete {what} changed "
                                   f"the index")
            res["caps"].append({"cap": what, "raised_in": where, "launches": launches})
        torch.cuda.empty_cache()
        if not np.array_equal(twin.search(qd, K, **kw)[1], ids0):
            raise RuntimeError(f"[rollback] (d) the L=24 ids changed after the failed "
                               f"{name} deletes")
        res["retry"] = measure_delete(torch, twin, doomed, setting)
        check_deleted(torch, twin, doomed, f"[rollback] (d) the {name} retry")
        same = fingerprint(torch, index_tensors(twin)) == done[0] and index_host(twin) == done[1]
        log(f"[rollback] (d) the same L=24 ids after the failures; the {name} delete then "
            f"committed in {res['retry']['wall_s']:.2f}s (peak "
            f"{res['retry']['peak_bytes'] / 2**20:.1f} MiB above the memory in use, journal "
            f"{(res['retry']['journal_bytes'] or 0) / 2**20:.1f} MiB), freed its "
            f"{len(doomed)} ids with no live row naming one; bitwise the copy that never "
            f"failed: {same}")
        if not same:
            raise RuntimeError(f"[rollback] (d) the {name} retry differs from the clean copy")
        out[name] = res
        del twin
        torch.cuda.empty_cache()
    return out


def run_rollback_delete_points(base, k1, k2) -> dict:
    """[rollback] (d) on the 100k index of (b): a delete of ROLLBACK_DEL_FRAC
    of it with the stream's settings fails once at each of its writers
    (the mark, discovery, the first and the last repair batch, the drop,
    the first and the last packed refresh chunk), and a `consolidate`
    after a one_hop delete fails at its last refresh chunk (injected by
    replacing the module attribute for the call, after the call wrote):
    each failed call must leave the index bitwise as it was, and its retry
    bitwise equal to a copy that never failed (the dump row aside).  The
    K2 launches inside the failing calls are counted."""
    import torch

    from diskann_tpu_torch.graph import delete as delete_mod
    from diskann_tpu_torch.graph import packed as packed_mod

    setting = DELETE_SETTINGS["fill"]
    doomed = delete_ids(base.n)
    nwr = base.packed.nwr

    twin = clone_index(base)
    repairs, refreshes = [0], [0]
    with failing(delete_mod, "fill_rows", counting(repairs)), \
            failing(packed_mod, "refresh_rows", counting(refreshes)):
        twin.delete(doomed, **setting)
    points = {"mark": (delete_mod, "mark_deleted", 1),
              "discovery": (delete_mod, "rows_referencing_deleted", 1),
              "repair_first": (delete_mod, "fill_rows", 1),
              "repair_last": (delete_mod, "fill_rows", repairs[0]),
              "drop": (delete_mod, "drop_deleted_rows", 1),
              "refresh_first": (packed_mod, "refresh_rows", 1),
              "refresh_last": (packed_mod, "refresh_rows", refreshes[0])}
    want_t, want_h = index_tensors(base), index_host(base)
    done_t, done_h = index_tensors(twin), index_host(twin)
    out = {"deleted": len(doomed), "affected": twin.last_delete_stats["affected"],
           "repair_batches": repairs[0], "refresh_chunks": refreshes[0], "points": {}}

    def check(what, c, fn, module, name, nth, before, after) -> dict:
        take_launches(k1, k2)
        with failing(module, name, fail_after(torch, nth, False)):
            expect_injected(torch, fn)
        launches = take_launches(k1, k2)
        bad = differing(torch, index_tensors(c), before[0])
        same = not bad and index_host(c) == before[1]
        fn()
        bad_retry = differing(torch, index_tensors(c), after[0], nwr)
        retry = not bad_retry and index_host(c) == after[1]
        log(f"[rollback] (d) {what}: kernel launches in the failed call {launches}; "
            f"bitwise as before {same} {bad}; retry bitwise the twin's {retry} {bad_retry}")
        if not (same and retry):
            raise RuntimeError(f"[rollback] (d) {what}: the index differs")
        return launches

    for point, (module, name, nth) in points.items():
        c = clone_index(base)
        out["points"][point] = check(f"delete failing at {point} (call {nth})", c,
                                     lambda: c.delete(doomed, **setting), module, name, nth,
                                     (want_t, want_h), (done_t, done_h))
        del c
    del twin
    # consolidate after a one_hop delete (which leaves rows naming deleted
    # nodes), failing at its last refresh chunk
    c = clone_index(base)
    c.delete(doomed, method="one_hop", repair="fill")
    before = clone_index(c)
    twin = clone_index(c)
    chunks = [0]
    with failing(packed_mod, "refresh_rows", counting(chunks)):
        twin.consolidate()
    out["points"]["consolidate"] = check(
        f"consolidate failing at its last refresh chunk (call {chunks[0]})", c, c.consolidate,
        packed_mod, "refresh_rows", chunks[0], (index_tensors(before), index_host(before)),
        (index_tensors(twin), index_host(twin)))
    total = sum(p["block_patch"] for p in out["points"].values())
    out["failing_launches"] = {"fatrow_expand": sum(p["fatrow_expand"]
                                                    for p in out["points"].values()),
                               "block_patch": total}
    log(f"[rollback] (d) {len(doomed)} of {base.n} deleted ({out['affected']} affected rows, "
        f"{repairs[0]} repair batches, {refreshes[0]} refresh chunks): kernel launches "
        f"inside the failing calls {out['failing_launches']}")
    if total == 0:
        raise RuntimeError("[rollback] (d) K2 never ran in the failing calls")
    del c, before, twin
    torch.cuda.empty_cache()
    return out


def only_delete(torch, device, n: int) -> int:
    """`--only delete`: the main path's data, packed build and dp=128
    re-attach, then [rollback] (d)'s 5% delete on fresh copies of that
    index, DELETE_REPS times with each of DELETE_SETTINGS (alternating):
    each one's wall, `max_memory_allocated` above the memory in use and
    journal bytes (`measure_delete`).  From another checkout's root (the
    package there, this script copied in) it measures that tree's delete,
    whose package may keep no journal."""
    from diskann_tpu_torch import GraphIndex
    from diskann_tpu_torch.bench.harness import make_clustered

    x, _ = make_clustered(0, n, NQ, D, n_clusters=4096, sigma=0.35)
    xd = torch.from_numpy(x).to(device)
    del x
    idx = GraphIndex.build(xd, main_config(), insert_batch_size=8192, search_batch_size=NQ,
                           build_mode="packed", packed_dp=64, build_backedge_src_cap=64)
    del xd
    idx.attach_packed(dp=128)
    doomed = delete_ids(idx.n)
    out = {"n": idx.n, "deleted": len(doomed), "runs": {k: [] for k in DELETE_SETTINGS}}
    for _ in range(DELETE_REPS):
        for name, setting in DELETE_SETTINGS.items():
            c = clone_index(idx)
            run = measure_delete(torch, c, doomed, setting)
            check_deleted(torch, c, doomed, f"[delete] {name}")
            del c
            out["runs"][name].append(run)
            log(f"[delete] {name} {setting}: {json.dumps(run)}")
    log("[summary] " + json.dumps(out))
    return 0


def only_build(torch, device, n: int) -> int:
    """`--only build`: the main path's data and its packed build alone; prints
    the build's wall seconds, its `max_memory_allocated` and the bytes of
    each batch's `RowJournal`.  From another checkout's root (the package
    there, this script copied in) it measures that tree's build, whose
    package may predate the journal."""
    from diskann_tpu_torch import GraphIndex
    from diskann_tpu_torch.bench.harness import make_clustered
    from diskann_tpu_torch.graph import state as graph_state

    x, _ = make_clustered(0, n, NQ, D, n_clusters=4096, sigma=0.35)
    xd = torch.from_numpy(x).to(device)
    del x
    sizes = contextlib.nullcontext([])
    if hasattr(graph_state, "RowJournal"):
        sizes = journal_sizes()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    with sizes as journal:
        idx, dt = _timed(torch, device, lambda: GraphIndex.build(
            xd, main_config(), insert_batch_size=8192, search_batch_size=NQ,
            build_mode="packed", packed_dp=64, build_backedge_src_cap=64))
    out = {"n": idx.n, "build_s": dt,
           "max_memory_allocated": torch.cuda.max_memory_allocated(device),
           "journal_bytes": journal or None}
    log("[summary] " + json.dumps(out))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="database size of the main path (default 1,000,000)")
    ap.add_argument("--only", choices=["kernels", "sharded", "sharded-trace", "sharded6m",
                                       "build", "delete", "rollback"],
                    help="after the build and the kernel checks, run only this phase "
                         "and print its summary; no result line (kernels: the kernel "
                         "times of phase 8; sharded6m needs four cards; build: the "
                         "main path's packed build alone; delete: that build's 5% "
                         "delete alone; rollback: the main path, then [rollback])")
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

    lap, walls = lap_clock()
    t0 = time.time()
    lib = native.build()
    native.library()
    log(f"[build] nvcc {' '.join(native.NVCC_FLAGS)} -> {lib.name}: "
        f"{time.time() - t0:.1f}s")
    for line in native.ptxas_report().splitlines():
        log(f"[build] {line.strip()}")

    k1_err, k1_dps = check_fatrow_expand(torch, device)
    k2_err = check_block_patch(torch, device)
    cards = torch.cuda.device_count()
    log(f"[device] {cards} card(s): "
        f"{[torch.cuda.get_device_name(c) for c in range(cards)]}")
    for c in range(1, cards):
        check_fatrow_expand(torch, torch.device("cuda", c))
        check_block_patch(torch, torch.device("cuda", c))
        torch.cuda.empty_cache()
    if args.only == "kernels":
        times = time_kernels(torch, device, args.n)
        log("[summary] " + json.dumps({k: v for k, v in times.items() if k != "k1_dps"}))
        return 0
    if args.only == "sharded":
        return only_sharded(torch, device, args.n, k1, k2)
    if args.only == "sharded-trace":
        return only_sharded_trace(torch, device, args.n)
    if args.only == "sharded6m":
        log("[summary] " + json.dumps({"sharded6m": run_sharded6m(device, k1, k2)}))
        return 0
    if args.only == "build":
        return only_build(torch, device, args.n)
    if args.only == "delete":
        return only_delete(torch, device, args.n)
    if args.only != "rollback":
        check_small_input(torch, device)
        check_small_tiered(torch, device)
        check_packed_widths(torch, device, k1)
    torch.cuda.empty_cache()
    lap("build_and_small_checks")

    torch.cuda.reset_peak_memory_stats(device)
    k1.launches = 0
    k2.launches = 0
    k1.launches_by_dp.clear()
    main_out, idx, qd, gt = run_main_path(args.n, device)
    launches = {"fatrow_expand": k1.launches, "block_patch": k2.launches}
    k1_main_by_dp = dict(k1.launches_by_dp)
    peak = torch.cuda.max_memory_allocated(device)
    log(f"[main] kernel launches on the main path: {launches}, K1 by dp "
        f"{k1_main_by_dp} (dp=64 the build, dp=128 the search); "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    if min(launches.values()) == 0:
        raise RuntimeError(f"a kernel of the main path never launched: {launches}")
    lap("main")

    # [rollback]: inserts and sharded calls that fail commit nothing
    rollback = {"main": run_rollback_main(idx, qd, k1, k2),
                "points": run_rollback_points(device, k1, k2),
                "sharded": run_rollback_sharded(device, k1, k2),
                "delete": run_rollback_delete(idx, qd, k1, k2)}
    take_launches(k1, k2)
    torch.cuda.empty_cache()
    lap("rollback")
    if args.only == "rollback":
        log("[summary] " + json.dumps({"main": main_out, "rollback": rollback,
                                       "walls": walls}))
        return 0

    # the main path's index as built, for the [bench] phase's abgate
    # (`--idx-cache`); later phases attach codes and drop its vectors
    main_dir = tempfile.mkdtemp(prefix="chip_smoke_main_")
    try:
        save_without_packed(idx, main_dir)
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
        lap("filtered_and_full")

        # the quantized walks launch no kernel (their scorers are torch ops);
        # every packed route of the modes phase runs K1
        phase_launches = {}
        take_launches(k1, k2)
        quant = run_quant(idx, qd, gt)
        phase_launches["quant"] = take_launches(k1, k2, "quant")
        lap("quant")
        modes_out = run_modes(idx, qd, k1)
        phase_launches["modes"] = take_launches(k1, k2, "modes")
        lap("modes")
        # mode="auto" on the 1M index: the flat route against the packed walk
        # at the main path's operating point
        auto_1m = time_auto("1M x 128", idx, qd, gt, dict(
            l_search=24, beam_width=4, mode="packed", rerank_l=12, max_hops=6), k1)
        auto_1m["flat_rows"] = time_flat_rows(idx, qd)
        phase_launches["auto"] = take_launches(k1, k2, "auto")
        lap("auto")
        # the tiered search walks the packed table (K1) and writes nothing
        tiered = run_tiered(idx, qd, gt, filt_gt["cat0"], modes_out["range"]["radius"], k1)
        phase_launches["tiered"] = take_launches(k1, k2, "tiered")
        lap("tiered")
        del idx, qd
        torch.cuda.empty_cache()

        times = time_kernels(torch, device, args.n)
        torch.cuda.empty_cache()
        lap("kernel_times")

        # the stream path: deletes launch K2 (refresh_rows), inserts and the
        # checkpoint searches launch both
        x, q = stream_data()
        torch.cuda.reset_peak_memory_stats(device)
        stream = run_stream(x, q, device, k1, k2)
        stream_launches = stream["launches"]
        if min(stream_launches.values()) == 0:
            raise RuntimeError(f"a kernel of the stream path never launched: {stream_launches}")
        torch.cuda.empty_cache()
        lap("stream")
        k1.launches = 0
        k2.launches = 0
        runbook = run_runbook(x, q, device)
        runbook["launches"] = {"fatrow_expand": k1.launches, "block_patch": k2.launches}
        log(f"[runbook] kernel launches (full precision, no packed layout): "
            f"{runbook['launches']}")
        del x, q
        torch.cuda.empty_cache()
        lap("runbook")
        torch.cuda.reset_peak_memory_stats(device)
        take_launches(k1, k2)
        wiki = run_wiki(device, k1)
        phase_launches["wiki"] = take_launches(k1, k2, "wiki")
        torch.cuda.empty_cache()
        lap("wiki")
        # the service: no packed layout, so neither kernel runs
        service = run_service(device)
        phase_launches["service"] = take_launches(k1, k2, "service")
        torch.cuda.empty_cache()
        lap("service")
        # the merged build runs both kernels in every shard's packed build; its
        # sq search walks no packed table
        merged = run_merged(device, k1, k2)
        phase_launches["merged_build"] = merged["build_launches"]
        phase_launches["merged_search"] = merged["search_launches"]
        torch.cuda.empty_cache()
        lap("merged")

        # [dtypes]: float16 and uint8 packed builds and walks (both kernels)
        dtypes = run_dtypes(device, args.n, gt, main_out["sweep"], k1, k2)
        for name in ("float16", "uint8"):
            phase_launches[f"dtypes_{name}_build"] = dtypes[name]["build_launches"]
            phase_launches[f"dtypes_{name}_search"] = dtypes[name]["launches"]
        torch.cuda.empty_cache()
        lap("dtypes")
        # [bench]: the six families and the abgate's packed walk (K1) after
        # its attach_packed (K2)
        bench = run_bench(device, main_dir, k1, k2)
        phase_launches["bench"] = bench["launches"]
        torch.cuda.empty_cache()
        lap("bench")
        # [sharded]: the full-precision inserts run no kernel; attach_packed
        # and the delete's refresh run K2, the packed search K1
        sharded = run_sharded(device, args.n, gt, k1, k2)
        # several visible cards: the counts of the spread placement's first run
        sh = sharded["runs"]["all"][0] if "runs" in sharded else sharded
        for key in ("build", "attach", "full", "packed"):
            phase_launches[f"sharded_{key}"] = sh[f"{key}_launches"]
        phase_launches["sharded_delete"] = sh["delete"]["launches"]
        phase_launches["sharded_10m"] = sh["10m"]["launches"]
        lap("sharded")
        log(f"[walls] seconds per phase: {json.dumps(walls)}; total {sum(walls.values()):.1f}")

        k1t, k2t = times["k1_rp84_dp128"], times["k2_int32"]
        # where K1 loses time: its launches at a width times its gap to the bound
        lost = {}
        for what, n_launch, key in (
                ("main build dp=64", k1_main_by_dp.get(64, 0), "k1_rp88_dp64"),
                ("main search dp=128", k1_main_by_dp.get(128, 0), "k1_rp84_dp128"),
                ("merged build dp=32", phase_launches["merged_build"]["fatrow_expand"],
                 "k1_rp64_dp32")):
            gap = times[key]["ms"] - times[key]["bound_ms"]
            lost[what] = {"launches": n_launch, "gap_ms": gap, "lost_ms": n_launch * gap}
        log(f"[time] K1 launches x (kernel - bound) per width: {json.dumps(lost)}")
        kernels = [
            {"name": "fatrow_expand", "route": "cuda", "source": K1_SOURCE,
             "replaces": K1_REPLACES, "launches": launches["fatrow_expand"],
             "filtered_launches": filt_launches["fatrow_expand"],
             "stream_launches": stream_launches["fatrow_expand"],
             **{f"{p}_launches": phase_launches[p]["fatrow_expand"] for p in phase_launches},
             "rollback_failing_launches":
                 rollback["points"]["failing_launches"]["fatrow_expand"],
             "rollback_delete_failing_launches":
                 rollback["points"]["delete_points"]["failing_launches"]["fatrow_expand"],
             "max_abs_err": max(k1_err, times["k1_err"]),
             "ms": k1t["ms"], "plain_ms": k1t["plain_ms"],
             "bound_ms": k1t["bound_ms"], "bound_by": k1t["bound_by"],
             "library_ms": None,
             "shape": "rp=84 dp=128 bw=32768",
             "main_launches_by_dp": {str(k): v for k, v in sorted(k1_main_by_dp.items())},
             "host_ms": k1t["host_ms"],
             # the dps whose bitwise checks passed in this run
             "dps_checked": sorted(k1_dps | times["k1_dps"]),
             **{f"{key}_rp{rp}_dp{dp}": times[f"k1_rp{rp}_dp{dp}"][key]
                for rp, dp in ((88, 64),) + K1_WIDTHS for key in ("ms", "plain_ms", "bound_ms")},
             **{f"{key}_rp16_dp{dp}_bw{K1_WIDE_SLOTS}":
                times[f"k1_rp16_dp{dp}_bw{K1_WIDE_SLOTS}"][key]
                for dp in (4, 8, 16) for key in ("ms", "plain_ms", "bound_ms")}},
            {"name": "block_patch", "route": "cuda", "source": K2_SOURCE,
             "replaces": K2_REPLACES, "launches": launches["block_patch"],
             "filtered_launches": filt_launches["block_patch"],
             "stream_launches": stream_launches["block_patch"],
             **{f"{p}_launches": phase_launches[p]["block_patch"] for p in phase_launches},
             "rollback_failing_launches":
                 rollback["points"]["failing_launches"]["block_patch"],
             "rollback_delete_failing_launches":
                 rollback["points"]["delete_points"]["failing_launches"]["block_patch"],
             "max_abs_err": max(k2_err, times["k2_err"]),
             "ms": k2t["ms"], "plain_ms": k2t["plain_ms"],
             "bound_ms": k2t["bound_ms"], "bound_by": k2t["bound_by"],
             "library_ms": k2t["library_ms"], "host_ms": k2t["host_ms"],
             "shape": f"int32 patches={k2t['patches']}"},
        ]
        summary = {k: main_out[k] for k in ("n", "build_s", "build_points_per_s", "attach_s",
                                            "build_peak_bytes", "journal_bytes")}
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
        summary["auto_1m"] = auto_1m
        summary["service"] = service
        summary["dtypes"] = dtypes
        summary["bench"] = bench
        summary["sharded"] = sharded
        summary["rollback"] = rollback
        summary["walls"] = walls
        log("[summary] " + json.dumps(summary))
        print(json.dumps({"kernels": kernels}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0

    finally:
        shutil.rmtree(main_dir)

if __name__ == "__main__":
    sys.exit(main())
