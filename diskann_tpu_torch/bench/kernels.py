"""Device op microbenchmarks (PyTorch port of `diskann_tpu/bench/kernels.py`;
the reference's `diskann-benchmark-simd` analogue).

Each op times what the reference's times, as plain torch:

- ``pairwise``: [M, d] x [N, d] distance matrix (the flat-scan / k-means /
  prune core), with GFLOP/s;
- ``expand_score``: a gather of int8 neighbour-code rows and their dot with
  int8 queries (the hop core as plain ops), with the gather's GB/s;
- ``sort_merge``: the [B, L+C] multi-operand sort of the search loop;
- ``lut_score``: PQ ADC table-gather scoring.

The two CUDA kernels of the port (K1 `fatrow_expand`, K2 `block_patch`)
are not timed here: `chip_smoke.py`'s `time_kernels` holds them against
their plain versions and their bounds.

Method: the iterations are chained (each one's input depends on the last
one's output) and run eagerly; on a CUDA card the loop is timed with CUDA
events around all of it and one synchronize at its end, on the CPU with
the host clock.  So the launch cost of each op counts here: the
reference chained its iterations inside one jitted `fori_loop`, where it
did not.  Regression gating reuses the registry's `check_tolerances`.
"""

from __future__ import annotations

import time

import torch

from diskann_tpu_torch.devices import default_device, generator
from diskann_tpu_torch.ops.distance import Metric, pairwise_distance


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
    raise ValueError(f"unknown kernels op {op!r}")
