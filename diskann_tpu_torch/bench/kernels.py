"""Device op microbenchmarks (PyTorch port of `diskann_tpu/bench/kernels.py`;
the reference's `diskann-benchmark-simd` analogue).

Each op times what the reference's times, as plain torch:

- ``pairwise``: [M, d] x [N, d] distance matrix (the flat-scan / k-means /
  prune core), with GFLOP/s;
- ``expand_score``: a gather of int8 neighbour-code rows and their dot with
  int8 queries (the hop core as plain ops), with the gather's GB/s;
- ``sort_merge``: the [B, L+C] multi-operand sort of the search loop;
- ``lut_score``: PQ ADC table-gather scoring.

Method: the iterations are chained (each one's input depends on the last
one's output) and run eagerly; on a CUDA card the loop is timed with CUDA
events around all of it and one synchronize at its end, on the CPU with
the host clock.  So the launch cost of each op counts here: the
reference chained its iterations inside one jitted `fori_loop`, where it
did not.  Regression gating reuses the registry's `check_tolerances`.

Four more ops time the port's CUDA kernels alone, each beside its plain
version, on random inputs at the main path's shapes by default
(`KERNEL_SHAPES`):

- ``fatrow_expand`` (K1): rp=84, dp=128 over a 1M-node word table, a beam
  of 8192 x 4 slots;
- ``block_patch`` (K2): 16,384 int32 blocks into the 1M-node rp=88, dp=64
  table;
- ``hop_merge`` (K3): one packed list-walk hop of B=8192, W=4, rp=84,
  L=24, each call on a fresh copy of the hop's state, made before the
  timed window (in place, repeat calls would merge nothing fresh);
- ``router_topk`` (K4): B=8192 queries over 65,536 router rows, dp=128,
  n_start=4.

Each returns the kernel's ms a call, its plain version's, the kernel's
bound (its least time on an H100 SXM: the bytes it needs read or written
once at 3.35 TB/s; for K4 the larger of that and its product's FLOP at
989 TFLOP/s, the data sheet's dense bf16 rate), the bound's share of the
kernel's time, and the host's ms per wrapper call.  On a CUDA card the ms
are the device's alone (`_device_ms`); on the CPU the wrappers run their
plain versions and the host clock times them.
"""

from __future__ import annotations

import time

import torch

from diskann_tpu_torch.devices import default_device, generator
from diskann_tpu_torch.graph.packed import n_wrows
from diskann_tpu_torch.ops.distance import Metric, pairwise_distance
from diskann_tpu_torch.ops.kernels import hop_merge as k3
from diskann_tpu_torch.ops.kernels.block_patch import block_patch, block_patch_plain
from diskann_tpu_torch.ops.kernels.fatrow_expand import (
    _geometry, fatrow_expand, fatrow_expand_plain,
)
from diskann_tpu_torch.ops.kernels.router_topk import router_topk, router_topk_plain

#: An H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes and dense
#: bf16 FLOP per millisecond.
HBM_BYTES_PER_MS = 3.35e12 / 1e3
BF16_FLOPS_PER_MS = 989e12 / 1e3

#: The kernel ops' default shapes: the main path's, as PERF.md's kernel
#: table gives them.
KERNEL_SHAPES = {
    "fatrow_expand": {"rp": 84, "dp": 128, "n_rows": 1_000_000, "slots": 8192 * 4},
    "block_patch": {"rp": 88, "dp": 64, "n_rows": 1_000_000, "blocks": 16_384},
    "hop_merge": {"b": 8192, "w": 4, "rp": 84, "dp": 128, "l": 24},
    "router_topk": {"b": 8192, "s": 65_536, "dp": 128, "n_start": 4},
}


def _timed(step, carry, iters: int, device: torch.device) -> float:
    """Seconds per call of ``carry = step(carry)``, chained ``iters`` times
    after one warm-up call."""
    carry = step(carry)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            carry = step(carry)
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        carry = step(carry)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def _randint(lo, hi, shape, dtype, gen, device):
    return torch.randint(lo, hi, shape, generator=gen, device=device).to(dtype)


def bench_pairwise(m: int, n: int, d: int, metric: Metric, dtype, iters: int, *,
                   device=None):
    device = default_device(device)
    gen = generator(0, device=device)
    x = torch.randn((m, d), generator=gen, device=device).to(dtype)
    y = torch.randn((n, d), generator=gen, device=device).to(dtype)

    def step(xq):
        dmat = pairwise_distance(xq.float(), y.float(), metric)
        # fold a scalar of the output back in to chain the iterations
        return xq + (dmat[0, 0] * 1e-30).to(xq.dtype)

    s = _timed(step, x, iters, device)
    flops = 2.0 * m * n * d
    return {"ms_per_op": s * 1e3, "gflops": flops / s / 1e9}


def bench_expand_score(b: int, r: int, dp: int, n_rows: int, iters: int, *,
                       device=None):
    device = default_device(device)
    gen = generator(0, device=device)
    codes = _randint(-127, 128, (n_rows, r * dp), torch.int8, gen, device)
    aux = torch.rand((n_rows, r), generator=gen, device=device) * 100.0
    qi = _randint(-127, 128, (b, dp), torch.int8, gen, device)
    beam = _randint(0, n_rows, (b,), torch.int64, gen, device)

    def step(carry):
        beam, acc = carry
        rows = codes[beam].reshape(b, r, dp)
        # int8 products summed in float32: exact while |dot| < 2^24
        # (127 * 127 * dp), and torch has no int8 product on the card
        dots = torch.bmm(rows.float(), qi.float()[:, :, None]).squeeze(-1)
        d = aux[beam] - 2.0 * dots
        nxt = (beam + d.argmin(1)) % n_rows
        return nxt, acc + d[:, 0] * 1e-30

    s = _timed(step, (beam, torch.zeros(b, device=device)), iters, device)
    gb = b * r * dp / 1e9
    return {"ms_per_op": s * 1e3, "gather_gbps": gb / s}


def bench_sort_merge(b: int, l: int, c: int, iters: int, *, device=None):
    device = default_device(device)
    gen = generator(0, device=device)
    d0 = torch.rand((b, l + c), generator=gen, device=device)
    i0 = _randint(0, 1 << 20, (b, l + c), torch.int32, gen, device)

    def step(carry):
        d, ids = carry
        sd, perm = torch.sort(d, dim=-1, stable=True)
        si = ids.gather(1, perm)
        torch.zeros_like(ids).gather(1, perm)  # the reference's third operand
        return torch.roll(sd, 1, dims=1), si

    s = _timed(step, (d0, i0), iters, device)
    return {"ms_per_op": s * 1e3}


def bench_lut_score(b: int, c: int, m: int, k: int, n_rows: int, iters: int, *,
                    device=None):
    device = default_device(device)
    gen = generator(0, device=device)
    codes = _randint(0, k, (n_rows, m), torch.uint8, gen, device)
    lut = torch.rand((b, m * k), generator=gen, device=device)
    ids = _randint(0, n_rows, (b, c), torch.int64, gen, device)
    offs = torch.arange(m, device=device) * k

    def step(carry):
        ids, acc = carry
        flat = codes[ids].long() + offs                     # [B, C, m]
        d = lut.gather(1, flat.reshape(b, c * m)).reshape(b, c, m).sum(-1)
        nxt = (ids + d.argmin(1)[:, None]) % n_rows
        return nxt, acc + d[:, 0] * 1e-30

    s = _timed(step, (ids, torch.zeros(b, device=device)), iters, device)
    return {"ms_per_op": s * 1e3}


def _device_ms(fn, iters: int, device: torch.device, tries: int = 3) -> dict:
    """Milliseconds per call of ``fn`` over ``iters`` calls, after 3
    warm-up calls: {"ms", "host_ms": the host's ms a call (the enqueue
    alone, timed on its own first), "covered"}.  On a CUDA card "ms" is
    the device's alone: the timed calls queue behind a `torch.cuda._sleep`
    twice as long as their enqueue (plus 1 ms), so the events bracket
    back-to-back device work only; a window whose enqueue outlasted its
    sleep ("covered" false: the host was held up) is taken again with a
    sleep twice as long, up to ``tries`` windows.  A call that waits on
    the card (a plain version's boolean index) is never covered, and its
    "ms" then holds host time too.  On the CPU "ms" is the host's."""
    for _ in range(3):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / iters
        return {"ms": ms, "host_ms": ms, "covered": None}
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        # the sleep's cycles a device millisecond (the SM clock)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        cycles_per_ms = 20_000_000 / start.elapsed_time(end)
        sleep_ms = 2.0 * host_ms * iters + 1.0
        for _ in range(tries):
            torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
            t0 = time.perf_counter()
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            covered = (time.perf_counter() - t0) * 1e3 < sleep_ms
            end.synchronize()
            if covered:
                break
            sleep_ms *= 2
        return {"ms": start.elapsed_time(end) / iters, "host_ms": host_ms, "covered": covered}


def _kernel_row(kernel, plain, bound: tuple, iters: int, device: torch.device) -> dict:
    """Time a kernel's wrapper and its plain version (`_device_ms`) and
    set them beside ``bound`` (ms, what bounds it)."""
    t = _device_ms(kernel, iters, device)
    p = _device_ms(plain, iters, device, tries=1)
    return {"kernel_ms": t["ms"], "plain_ms": p["ms"], "bound_ms": bound[0],
            "bound_by": bound[1], "share": bound[0] / t["ms"], "host_ms": t["host_ms"],
            "covered": t["covered"],
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}


def fatrow_expand_bound(beam, rp: int, dp: int, n_rows: int) -> tuple:
    """K1's least time for ``beam`` over a table of ``n_rows`` fat rows:
    the id, aux and code sections of the distinct beam nodes read once
    (ids clamped to the table, as the wrapper clamps them), the beam ids
    and int8 queries read once, the three outputs written once."""
    idw, _, codr, cpr = _geometry(rp, dp)
    bw = beam.shape[0]
    nodes = int(beam.long().clamp(0, n_rows - 1).unique().numel())
    moved = (nodes * (2 * idw + codr) * 512 + bw * (4 + dp)
             + bw * (2 * idw * 128 + codr * cpr) * 4)
    return moved / HBM_BYTES_PER_MS, "bytes"


def block_patch_bound(blocks: int) -> tuple:
    """K2's least time for ``blocks`` int32 blocks: each block's 8 x 128
    words read from the values and written into the table once, and its
    index read once."""
    return (2 * blocks * 8 * 128 * 4 + blocks * 4) / HBM_BYTES_PER_MS, "bytes"


def hop_merge_bound(b: int, w: int, rp: int, l: int) -> tuple:
    """K3's least time for one hop of ``b`` rows: K1's ids, aux and dots
    of the rp slots of each beam entry read, the lists (distance, id,
    expanded bit) read and written, the beam read and the next one
    written, qscale and qsq read, cmps and hops read and written."""
    moved = b * (w * rp * 12 + 2 * l * 12 + 2 * w * 4 + 2 * 4 + 2 * 2 * 4)
    return moved / HBM_BYTES_PER_MS, "bytes"


def router_topk_bound(b: int, s: int, dp: int, n_start: int) -> tuple:
    """K4's least time: the larger of its product's FLOP at the dense bf16
    peak and its bytes (the codes, raux, queries and norms read once, the
    ids it returns and maps)."""
    by_flop = 2 * b * s * dp / BF16_FLOPS_PER_MS
    by_bytes = (s * dp + 4 * s + b * (4 * dp + 4) + 8 * b * n_start) / HBM_BYTES_PER_MS
    return (by_flop, "FLOP") if by_flop >= by_bytes else (by_bytes, "bytes")


def _word_table(rp: int, dp: int, n_rows: int, gen, device):
    """A random packed word table of ``n_rows`` fat rows plus the dump row."""
    rows = torch.empty(((n_rows + 1) * n_wrows(rp, dp), 128), dtype=torch.int32, device=device)
    return rows.random_(generator=gen)


def bench_fatrow_expand(rp: int, dp: int, n_rows: int, slots: int, iters: int, *,
                        device=None) -> dict:
    device = default_device(device)
    gen = generator(0, device=device)
    rows = _word_table(rp, dp, n_rows, gen, device)
    beam = torch.randint(0, n_rows, (slots,), generator=gen, device=device, dtype=torch.int32)
    qiw = torch.randint(-127, 128, (slots, dp), generator=gen, device=device, dtype=torch.int8)
    return _kernel_row(lambda: fatrow_expand(rows, beam, qiw, rp=rp, dp=dp),
                       lambda: fatrow_expand_plain(rows, beam, qiw, rp=rp, dp=dp),
                       fatrow_expand_bound(beam, rp, dp, n_rows + 1), iters, device)


def bench_block_patch(rp: int, dp: int, n_rows: int, blocks: int, iters: int, *,
                      device=None) -> dict:
    device = default_device(device)
    gen = generator(0, device=device)
    rows = _word_table(rp, dp, n_rows, gen, device)
    idx = torch.randperm(rows.shape[0] // 8 - 1, generator=gen, device=device)[:blocks]
    idx = idx.to(torch.int32)
    vals = torch.empty((idx.shape[0] * 8, 128), dtype=torch.int32, device=device)
    vals.random_(generator=gen)
    return _kernel_row(lambda: block_patch(rows, idx, vals),
                       lambda: block_patch_plain(rows, idx, vals),
                       block_patch_bound(idx.shape[0]), iters, device)


def _hop_inputs(b: int, w: int, rp: int, dp: int, l: int, gen, device):
    """One packed list-walk hop's inputs to K3 for ``b`` rows: K1's
    outputs at (rp, dp) over 1M node ids (a tenth -1, beam slot 1 of each
    row repeating half of slot 0's ids, a few list ids among them), each
    query's scale and squared norm, sorted lists (+inf tails in a quarter
    of the rows, ties in another quarter), a beam with invalid slots, and
    a sixteenth of the rows converged.  Returns (K1's outputs, qscale,
    qsq, HopState)."""
    idw, _, codr, cpr = _geometry(rp, dp)
    nodes = 1_000_000

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int32)

    def rand(shape):
        return torch.rand(shape, generator=gen, device=device)

    ids = ints(0, nodes, (b * w, idw * 128))
    ids[rand(ids.shape) < 0.1] = -1
    ids.view(b, w, -1)[:, 1, : rp // 2] = ids.view(b, w, -1)[:, 0, : rp // 2]
    aux = rand(ids.shape) * 40
    dots = ints(-127 * 127 * 4, 127 * 127 * 4, (b * w, codr * cpr))
    qscale, qsq = rand(b) * 1e-2 + 1e-4, rand(b) * 40 + 20
    ld = torch.sort(rand((b, l)) * 80, dim=1).values
    ld[b // 4: b // 2] = torch.floor(ld[b // 4: b // 2] / 8) * 8      # ties
    li = (torch.argsort(rand((b, nodes // 64)), dim=1)[:, :l] * 64).to(torch.int32)
    li[:, :2] = ids.view(b, w, -1)[:, 0, :2]                           # in the hop too
    le = ints(0, 2, (b, l))
    tail = torch.arange(l, device=device)[None, :] >= ints(1, l + 1, (b, 1))
    tail[b // 4:] = False
    ld[tail], li[tail], le[tail] = float("inf"), -1, 1
    beam = ints(0, nodes, (b, w))
    beam[rand(beam.shape) < 0.1] = -1
    beam[::16] = -1
    le[::16] = 1
    st = k3.HopState(ld, li, le, ints(0, 100, (b,)), ints(0, 20, (b,)), beam,
                     torch.tensor([False, True], device=device))
    return (ids, aux.view(torch.int32), dots, qscale, qsq), st


def bench_hop_merge(b: int, w: int, rp: int, dp: int, l: int, iters: int, *,
                    device=None) -> dict:
    device = default_device(device)
    args, st = _hop_inputs(b, w, rp, dp, l, generator(0, device=device), device)
    # a fresh state for every call the kernel's and the plain version's
    # timings make (`_device_ms`: 3 + iters * (1 + tries) calls a side)
    fresh = iter([st.clone() for _ in range(2 * 3 + iters * (2 + 3 + 1))])
    return _kernel_row(lambda: k3.hop_merge(*args, next(fresh), 0, rp=rp, inner_product=False),
                       lambda: k3.hop_merge_plain(*args, next(fresh), 0, rp=rp,
                                                  inner_product=False),
                       hop_merge_bound(b, w, rp, l), iters, device)


def bench_router_topk(b: int, s: int, dp: int, n_start: int, iters: int, *,
                      device=None) -> dict:
    device = default_device(device)
    gen = generator(0, device=device)
    qs = torch.randn((b, dp), generator=gen, device=device) * 8
    rc = torch.randint(-127, 128, (s, dp), generator=gen, device=device, dtype=torch.int8)
    ids = torch.randperm(1_000_000, generator=gen, device=device)[:s].to(torch.int32)
    args = (qs, (qs * qs).sum(1), rc, (rc.float() ** 2).sum(1), ids, n_start)
    return _kernel_row(lambda: router_topk(*args, inner_product=False),
                       lambda: router_topk_plain(*args, inner_product=False),
                       router_topk_bound(b, s, dp, n_start), iters, device)


_KERNEL_BENCHES = {"fatrow_expand": bench_fatrow_expand, "block_patch": bench_block_patch,
                   "hop_merge": bench_hop_merge, "router_topk": bench_router_topk}


def kernels_job(job: dict) -> dict:
    """Registry entry point: {"benchmark": "kernels", "op": ..., ...}; the
    ops run on ``job["device"]``, the CUDA card by default."""
    op = job.get("op", "pairwise")
    iters = job.get("iters", 16)
    dev = job.get("device")
    if op == "pairwise":
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[job.get("dtype", "f32")]
        return bench_pairwise(
            job.get("m", 1024), job.get("n", 4096), job.get("dim", 128),
            Metric(job.get("metric", "l2")), dtype, iters, device=dev,
        )
    if op == "expand_score":
        return bench_expand_score(
            job.get("b", 1024), job.get("r", 64), job.get("dp", 64),
            job.get("n_rows", 1 << 16), iters, device=dev,
        )
    if op == "sort_merge":
        return bench_sort_merge(
            job.get("b", 1024), job.get("l", 40), job.get("c", 256), iters,
            device=dev,
        )
    if op == "lut_score":
        return bench_lut_score(
            job.get("b", 1024), job.get("c", 256), job.get("m", 32),
            job.get("k", 256), job.get("n_rows", 1 << 16), iters, device=dev,
        )
    if op in KERNEL_SHAPES:
        shape = {k: job.get(k, v) for k, v in KERNEL_SHAPES[op].items()}
        return _KERNEL_BENCHES[op](**shape, iters=iters, device=dev)
    raise ValueError(f"unknown kernels op {op!r}")
