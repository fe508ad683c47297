"""The port's kernels K1 (`fatrow_expand`) and K2 (`block_patch`).

On the CPU the wrappers run their plain PyTorch versions, which must be
bitwise equal to the JAX Pallas kernels (run as `tests/test_kernels.py`
runs them: `interpret=True`) and to their `*_ref` oracles.  The CUDA kernel
against its plain version is checked on a CUDA card only (marker `cuda`).
A CUDA host need not have JAX (the port does not use it), so the JAX
package is imported inside the CPU tests only, and the `cuda` cases run
without `tests/conftest.py` (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from diskann_tpu_torch.graph.packed import n_wrows
from diskann_tpu_torch.ops.kernels import block_patch as k2
from diskann_tpu_torch.ops.kernels import fatrow_expand as k1
from torch_port_helpers import cuda_device, n, rand_word_rows, t  # noqa: F401

PATCH_BLOCK = 4096  # the JAX block_patch takes patch counts in multiples of this

# (rp, dp, table nodes, beam slots): the three geometries of
# tests/test_kernels.py, then the build (dp=64) and search (dp=128)
# geometries of the 1M main path, then the other packed widths the
# reference takes (dp/4 divides 128): 4 and 8 (whole codes per 16-byte
# vector), 256 and 512 (a code spans 16 or 32 lanes)
GEOMETRIES = [
    (16, 64, 1024, 512),
    (16, 64, 512, 1024),
    (32, 32, 256, 512),
    (88, 64, 256, 512),
    (84, 128, 256, 512),
    (16, 4, 256, 512),
    (16, 8, 256, 512),
    (16, 16, 256, 512),
    (84, 256, 128, 512),
    (40, 512, 128, 512),
]


def _expand_inputs(seed, nodes, bw, rp, dp):
    rng = np.random.default_rng(seed)
    rows = rand_word_rows(rng, nodes, n_wrows(rp, dp))
    beam = rng.integers(0, nodes, size=(bw,)).astype(np.int32)
    qiw = rng.integers(-127, 128, size=(bw, dp)).astype(np.int8)
    return rows, beam, qiw


@pytest.mark.parametrize("rp,dp,nodes,bw", GEOMETRIES)
def test_fatrow_expand_plain_matches_pallas(rp, dp, nodes, bw):
    import jax.numpy as jnp
    from diskann_tpu.ops.kernels.fatrow_expand import (
        fatrow_expand as j_fatrow_expand, fatrow_expand_ref,
    )

    rows, beam, qiw = _expand_inputs(rp * dp + nodes, nodes, bw, rp, dp)
    got = k1.fatrow_expand(t(rows), t(beam), t(qiw), rp=rp, dp=dp)
    want_k = j_fatrow_expand(jnp.asarray(rows), jnp.asarray(beam),
                             jnp.asarray(qiw), rp=rp, dp=dp, interpret=True)
    want_r = fatrow_expand_ref(jnp.asarray(rows), jnp.asarray(beam),
                               jnp.asarray(qiw), rp=rp, dp=dp)
    for g, wk, wr in zip(got, want_k, want_r):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(n(g), np.asarray(wk))
        np.testing.assert_array_equal(n(g), np.asarray(wr))


def test_fatrow_expand_plain_clamps_like_ref():
    # ids outside the table clamp to its first / last row, as in the oracle
    import jax.numpy as jnp
    from diskann_tpu.ops.kernels.fatrow_expand import fatrow_expand_ref

    rp, dp, nodes = 16, 64, 64
    rows, beam, qiw = _expand_inputs(1, nodes, 40, rp, dp)
    beam[::3] = -5
    beam[1::3] = nodes + 9
    got = k1.fatrow_expand_plain(t(rows), t(beam), t(qiw), rp=rp, dp=dp)
    want = fatrow_expand_ref(jnp.asarray(rows), jnp.asarray(beam),
                             jnp.asarray(qiw), rp=rp, dp=dp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), np.asarray(w))


@pytest.mark.parametrize("dtype", [np.int8, np.int32])
def test_block_patch_plain_matches_pallas(dtype):
    import jax.numpy as jnp
    from diskann_tpu.ops.kernels.block_patch import (
        PATCH_BLOCK as J_PATCH_BLOCK, block_patch as j_block_patch, block_patch_ref,
    )

    assert J_PATCH_BLOCK == PATCH_BLOCK
    rng = np.random.default_rng(23)
    n_rows = 8 * PATCH_BLOCK
    table = rng.integers(-100, 100, size=(n_rows, 128)).astype(dtype)
    idx = rng.choice(n_rows // 8, size=PATCH_BLOCK, replace=False).astype(np.int32)
    vals = rng.integers(-100, 100, size=(PATCH_BLOCK * 8, 128)).astype(dtype)
    got = k2.block_patch(t(table), t(idx), t(vals))
    want_k = j_block_patch(jnp.asarray(table), jnp.asarray(idx),
                           jnp.asarray(vals), interpret=True)
    want_r = block_patch_ref(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(vals))
    np.testing.assert_array_equal(n(got), np.asarray(want_k))
    np.testing.assert_array_equal(n(got), np.asarray(want_r))


def test_block_patch_plain_skips_blocks_outside_the_table():
    import jax.numpy as jnp
    from diskann_tpu.ops.kernels.block_patch import block_patch_ref

    rng = np.random.default_rng(29)
    table = rng.integers(-100, 100, size=(64, 128)).astype(np.int32)
    idx = np.array([2, 8, 1, 99], np.int32)           # 8 and 99 are outside
    vals = rng.integers(-100, 100, size=(32, 128)).astype(np.int32)
    got = k2.block_patch(t(table), t(idx), t(vals))
    want = block_patch_ref(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(vals))
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_cpu_calls_leave_launch_counters_at_zero(monkeypatch):
    monkeypatch.setattr(k1, "launches", 0)
    monkeypatch.setattr(k2, "launches", 0)
    rows, beam, qiw = _expand_inputs(3, 32, 16, 16, 64)
    k1.fatrow_expand(t(rows), t(beam), t(qiw), rp=16, dp=64)
    k2.block_patch(t(rows[:64]), t(np.array([0, 3], np.int32)), t(rows[:16]))
    assert (k1.launches, k2.launches) == (0, 0)


def test_wrappers_reject_other_devices():
    meta = torch.empty((8, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        k1.fatrow_expand(meta, meta[0], meta[:1], rp=16, dp=64)
    with pytest.raises(ValueError):
        k2.block_patch(meta, meta[0, :1], meta)


@pytest.mark.cuda
@pytest.mark.parametrize("rp,dp,nodes,bw", GEOMETRIES + [(84, 128, 4096, 1000)])
def test_fatrow_expand_kernel_matches_plain(cuda_device, rp, dp, nodes, bw):
    rows, beam, qiw = _expand_inputs(5, nodes, bw, rp, dp)
    beam[::11] = -1
    beam[1::13] = nodes + 3
    args = [t(a).to(cuda_device) for a in (rows, beam, qiw)]
    before = k1.launches
    got = k1.fatrow_expand(*args, rp=rp, dp=dp)
    assert k1.launches == before + 1
    want = k1.fatrow_expand_plain(*args, rp=rp, dp=dp)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# every dp the reference takes (dp/4 divides 128)
PACKED_DPS = (4, 8, 16, 32, 64, 128, 256, 512)


def _round16(x):
    return -(-x // 16) * 16


@pytest.mark.parametrize("dp", PACKED_DPS)
def test_fatrow_expand_plan_fits_and_aligns(dp):
    # for every r_pack up to 256 and a few slot counts: the ring fits 227
    # KB, its stages start on 128-byte boundaries and hold whole prefixes
    # plus the slots' queries and dots, two stages or more wherever two fit
    # (every rp <= 220 even at dp=512), and the grid has a group per block
    for rp in range(1, 257):
        idw, _, codr, cpr = k1._geometry(rp, dp)
        prefix = (2 * idw + codr) * 512
        for bw in (1, 7, 1003, 32768, 1 << 18):
            p = k1.plan(rp, dp, bw)
            sps = p.slots_per_stage
            assert p.prefix_bytes == prefix
            assert 1 <= sps <= min(k1.MAX_SLOTS_PER_STAGE, bw)
            assert p.stage_bytes == prefix * sps and p.stage_bytes % 16 == 0
            assert p.stage_stride % 128 == 0
            assert p.stage_stride >= (p.stage_bytes + _round16(sps * dp)
                                      + _round16(sps * codr * cpr * 4))
            assert p.stages * (p.stage_stride + 8) <= p.smem_bytes <= 227 * 1024
            fit = 227 * 1024 // (p.stage_stride + 8)
            assert p.stages >= min(2, fit) and p.stages >= 1
            if rp <= 220:
                assert p.stages >= 2, (rp, dp, p)
            # each warp owns stages / warps of the ring
            assert 1 <= p.warps <= k1.WARPS
            assert p.stages % p.warps == 0
            # each SM keeps >= 64 KB in flight where the ring can hold it
            assert (p.stages * p.stage_bytes >= 65536
                    or p.stages + p.warps > fit)
            assert 1 <= p.grid <= min(-(-bw // sps), k1.H100_SMS)
            if prefix < k1.STAGE_TARGET // 2 and bw >= 32:
                assert sps >= 2                   # small prefixes share a stage


def test_fatrow_expand_plan_follows_the_card_and_rejects_bad_widths():
    assert k1.plan(84, 128, 32768, n_sms=114).grid == 114
    assert k1.plan(88, 64, 50).grid == 50               # fewer slots than SMs
    assert k1.plan(16, 4, 50).grid == 10                # 5 slots a stage
    for dp in (0, 2, 12, 24, 1024):                     # dp/4 must divide 128
        with pytest.raises(ValueError):
            k1.plan(16, dp, 100)
    with pytest.raises(ValueError):                     # no stage holds one prefix
        k1.plan(1024, 512, 100)


# (rp, dp): both lane maps, a stage of several slots (dp <= 32) and of one
K1_EDGE_WIDTHS = [(16, 4), (16, 8), (64, 32), (88, 64), (84, 128), (40, 512)]
# beam shapes at the edges of the plan: one slot, fewer slots than blocks,
# a ragged last group, every slot on one node, ids clamped at both ends
K1_EDGE_CASES = ["one_slot", "below_grid", "ragged", "one_node", "clamped"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K1_EDGE_CASES)
@pytest.mark.parametrize("rp,dp", K1_EDGE_WIDTHS)
def test_fatrow_expand_kernel_edges_match_plain(cuda_device, rp, dp, case):
    nodes = 300
    sps = k1.plan(rp, dp, 1 << 16).slots_per_stage
    bw = {"one_slot": 1, "below_grid": 50, "ragged": 40 * sps + sps // 2 + 1,
          "one_node": 2048, "clamped": 2048}[case]
    rows, beam, qiw = _expand_inputs(rp + dp + bw, nodes, bw, rp, dp)
    if case == "one_node":
        beam[:] = nodes // 2
    elif case == "clamped":
        beam[::2] = -(2**31)
        beam[1::2] = 2**31 - 1
        beam[2::5] = nodes
        beam[3::5] = -1
    args = [t(a).to(cuda_device) for a in (rows, beam, qiw)]
    before = k1.launches
    got = k1.fatrow_expand(*args, rp=rp, dp=dp)
    assert k1.launches == before + 1
    want = k1.fatrow_expand_plain(*args, rp=rp, dp=dp)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("field,value", [("smem_bytes", 240_000), ("stages", 7),
                                         ("stage_stride", 64)])
def test_fatrow_expand_raises_on_a_refused_plan(cuda_device, monkeypatch, field, value):
    # more shared memory than a block may have, stages the warps do not
    # divide, a stride that does not hold a stage: the launch returns an
    # error and the wrapper raises instead of running the plain version
    import dataclasses

    rows, beam, qiw = _expand_inputs(9, 64, 100, 84, 128)
    plan = k1.plan
    monkeypatch.setattr(k1, "plan", lambda *a, **kw: dataclasses.replace(
        plan(*a, **kw), **{field: value}))
    before = k1.launches
    with pytest.raises(RuntimeError, match="fatrow_expand"):
        k1.fatrow_expand(*[t(x).to(cuda_device) for x in (rows, beam, qiw)], rp=84, dp=128)
    assert k1.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_block_patch_kernel_matches_plain(cuda_device, dtype):
    gen = torch.Generator().manual_seed(3)
    table = torch.randint(-100, 100, (8 * 512, 128), generator=gen).to(dtype)
    idx = torch.randperm(511, generator=gen)[:300].to(torch.int32)
    idx[::4] = 511                                   # the dump block
    vals = torch.randint(-100, 100, (300 * 8, 128), generator=gen).to(dtype)
    a = [x.to(cuda_device) for x in (table, idx, vals)]
    got = k2.block_patch(a[0].clone(), a[1], a[2])
    want = k2.block_patch_plain(a[0].clone(), a[1], a[2])
    assert torch.equal(got[: 511 * 8], want[: 511 * 8])
