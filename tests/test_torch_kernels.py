"""The port's kernels K1 (`fatrow_expand`), K2 (`block_patch`) and K3
(`hop_merge`).

On the CPU the wrappers run their plain PyTorch versions, which must be
bitwise equal to the JAX Pallas kernels (run as `tests/test_kernels.py`
runs them: `interpret=True`) and to their `*_ref` oracles; K3 replaces no
Pallas kernel, and its plain version is the walk's own code (held against
the JAX walk in `tests/test_torch_search.py`).  Each CUDA kernel against
its plain version is checked on a CUDA card only (marker `cuda`); K1 and
K2 also on the main path's full-size tables of 1M nodes, whose word
offsets pass 2^31.
A CUDA host need not have JAX (the port does not use it), so the JAX
package is imported inside the CPU tests only, and the `cuda` cases run
without `tests/conftest.py` (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

from collections import Counter

import numpy as np
import pytest
import torch

from diskann_tpu_torch.graph.packed import n_wrows
from diskann_tpu_torch.ops.kernels import block_patch as k2
from diskann_tpu_torch.ops.kernels import fatrow_expand as k1
from diskann_tpu_torch.ops.kernels import hop_merge as k3
from diskann_tpu_torch.ops.kernels import native
from torch_port_helpers import cuda_device, launches, n, rand_word_rows, t  # noqa: F401

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
    monkeypatch.setattr(native, "launches", Counter())
    rows, beam, qiw = _expand_inputs(3, 32, 16, 16, 64)
    k1.fatrow_expand(t(rows), t(beam), t(qiw), rp=16, dp=64)
    k2.block_patch(t(rows[:64]), t(np.array([0, 3], np.int32)), t(rows[:16]))
    (*args, hop), st = _hop_inputs(3, 16, 8, 10, 1, "random", "cpu")
    k3.hop_merge(*args, st, hop, rp=16, inner_product=False)
    assert not native.launches


def test_wrappers_reject_other_devices():
    meta = torch.empty((8, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        k1.fatrow_expand(meta, meta[0], meta[:1], rp=16, dp=64)
    with pytest.raises(ValueError):
        k2.block_patch(meta, meta[0, :1], meta)
    (*args, hop), st = _hop_inputs(3, 16, 8, 10, 1, "random", "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k3.hop_merge(*args, st, hop, rp=16, inner_product=False)


# K3: (rp, dp, L, W) of the batch and online cells' walk, of the churn
# checkpoint's, and of the smallest packed row at W = 1
K3_GEOMETRIES = [(84, 128, 24, 4), (88, 64, 90, 4), (16, 8, 10, 1)]
# the rows' shapes: ids repeated within a hop, across beam slots and from
# the list (few distinct ids); every row converged (no valid beam slot, the
# list expanded); distances that tie, at the L-th place too; lists with
# +inf tails; a batch of one row; the inner-product distance
K3_CASES = ["random", "repeats", "converged", "ties", "inf_tail", "one_row",
            "inner_product"]


def _hop_inputs(seed, rp, dp, l, w, case, device):
    """One hop's inputs to `hop_merge` for B rows on ``device``: K1's
    outputs at (rp, dp) (-1 neighbours, ids repeated as ``case`` asks;
    beyond rp the sections hold garbage the kernel must not read), each
    query's scale and squared norm, and a `HopState` of sorted lists, a
    beam with invalid slots and the flag this hop sets cleared."""
    rng = np.random.default_rng(seed)
    b = 1 if case == "one_row" else 48
    idw, _, codr, cpr = k1._geometry(rp, dp)
    nid = rp // 2 + 3 if case == "repeats" else 50 * rp * w
    ids = rng.integers(0, nid, (b * w, idw * 128)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.1] = -1
    ids[:, rp:] = rng.integers(-5, 5, (b * w, idw * 128 - rp))
    if case == "ties":
        # qsq + aux - 2 * dot * qscale exact and small: many equal distances
        aux = rng.integers(0, 2, ids.shape).astype(np.float32)
        dots = rng.integers(0, 2, (b * w, codr * cpr)).astype(np.int32)
        qscale = np.full(b, 0.5, np.float32)
        qsq = np.full(b, 1.0, np.float32)
        ld = rng.integers(0, 3, (b, l)).astype(np.float32)
    else:
        aux = rng.uniform(0, 40, ids.shape).astype(np.float32)
        dots = rng.integers(-127 * 127 * 4, 127 * 127 * 4, (b * w, codr * cpr)).astype(np.int32)
        qscale = rng.uniform(1e-4, 1e-2, b).astype(np.float32)
        qsq = rng.uniform(20, 60, b).astype(np.float32)
        ld = rng.uniform(0, 80, (b, l)).astype(np.float32)
    if case == "inner_product":
        ld = -ld
    ld = np.sort(ld, axis=1)
    li = rng.choice(nid, size=(b, l)).astype(np.int32)
    for r in range(b):                                # a list holds an id once
        li[r] = rng.permutation(max(nid, l))[:l]
    le = rng.integers(0, 2, (b, l)).astype(np.int32)
    beam = rng.integers(0, nid, (b, w)).astype(np.int32)
    beam[rng.random(beam.shape) < 0.2] = -1
    if case == "inf_tail":
        cut = rng.integers(0, l, b)
        for r in range(b):
            ld[r, cut[r]:], li[r, cut[r]:], le[r, cut[r]:] = np.inf, -1, 1
    if case == "converged":
        le[:] = 1
        beam[:] = -1
    hop = int(rng.integers(0, 4))
    flags = np.ones(2, bool)
    flags[hop % 2] = False               # the previous hop cleared this one

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    args = (dev(ids), dev(aux.view(np.int32)), dev(dots), dev(qscale), dev(qsq))
    st = k3.HopState(dev(ld), dev(li), dev(le), dev(rng.integers(0, 99, b).astype(np.int32)),
                     dev(rng.integers(0, 9, b).astype(np.int32)), dev(beam), dev(flags))
    return args + (hop,), st


def _run_k3(fn, args, st, rp, case):
    *inputs, hop = args
    st = st.clone()
    fn(*inputs, st, hop, rp=rp, inner_product=case == "inner_product")
    return st


def _same_state(got, want):
    for f in ("best_d", "best_i", "best_e", "cmps", "hops", "beam", "flags"):
        a, b = getattr(got, f), getattr(want, f)
        if a.dtype == torch.float32:                  # bitwise, -0.0 and inf too
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f


@pytest.mark.parametrize("case", K3_CASES)
@pytest.mark.parametrize("rp,dp,l,w", K3_GEOMETRIES)
def test_hop_merge_plain_keeps_the_lists_sorted_and_counts(rp, dp, l, w, case):
    # the plain version on the CPU: lists stay sorted with distinct ids,
    # cmps rises by the fresh candidates, hops by the valid beam slots, the
    # next beam holds the first unexpanded entries (now expanded), and the
    # flag says whether any entry was left unexpanded
    (*args, hop), st = _hop_inputs(rp + l + w, rp, dp, l, w, case, "cpu")
    got = _run_k3(k3.hop_merge, (*args, hop), st, rp, case)
    d = got.best_d.numpy()
    assert (d[:, 1:] >= d[:, :-1]).all()
    for r in range(d.shape[0]):
        ids = got.best_i[r].numpy()
        live = ids[ids >= 0]
        assert len(set(live.tolist())) == len(live)
    assert torch.equal(got.hops - st.hops, (st.beam >= 0).sum(1, dtype=torch.int32))
    assert (got.cmps >= st.cmps).all()
    for r in range(d.shape[0]):
        nb = got.beam[r][got.beam[r] >= 0]
        pos = [int(np.flatnonzero(got.best_i[r].numpy() == i)[0]) for i in nb.tolist()]
        assert all(got.best_e[r, p] == 1 for p in pos) and pos == sorted(pos)
    left = bool(((got.best_e == 0) & (got.best_i >= 0)).any()) or bool((got.beam >= 0).any())
    assert bool(got.flags[hop % 2]) == left and not bool(got.flags[(hop + 1) % 2])
    if case == "converged":
        assert torch.equal(got.best_i, st.best_i) and torch.equal(got.cmps, st.cmps)
        assert (got.beam == -1).all() and not bool(got.flags.any())


@pytest.mark.parametrize("rp,dp,l,w", K3_GEOMETRIES + [(84, 256, 200, 8)])
def test_hop_merge_geometry_fits_the_walks(rp, dp, l, w):
    threads, hbits, smem = k3.geometry(w * rp, l, w)
    p = 1 << (w * rp - 1).bit_length()
    assert threads % 32 == 0 and 32 <= threads <= k3.MAX_THREADS
    assert threads == min(k3.MAX_THREADS, max(32, p // 4))
    assert 2 * (w * rp + l) <= 1 << hbits < 4 * (w * rp + l)   # at most half full
    assert smem % 16 == 0
    assert smem >= 8 * p + 8 * (1 << hbits) + 8 * w * rp + 28 * l + 4 * w + 16
    assert k3.fits(w * rp, l, w)
    assert not k3.fits(64 * 256, l, 64)          # 16,384 candidates: the generic body


@pytest.mark.cuda
@pytest.mark.parametrize("case", K3_CASES)
@pytest.mark.parametrize("rp,dp,l,w", K3_GEOMETRIES)
def test_hop_merge_kernel_matches_plain(cuda_device, rp, dp, l, w, case):
    args, st = _hop_inputs(rp + l + w, rp, dp, l, w, case, cuda_device)
    before = launches("hop_merge")
    got = _run_k3(k3.hop_merge, args, st, rp, case)
    assert launches("hop_merge") == before + 1
    want = _run_k3(k3.hop_merge_plain, args, st, rp, case)
    torch.cuda.synchronize(cuda_device)
    _same_state(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["device", "dtype", "shape", "stride", "too_wide"])
def test_hop_merge_raises_on_inputs_it_does_not_take(cuda_device, fault):
    # a CPU tensor among CUDA ones, int64 dots, one row too many of K1's
    # ids, a non-contiguous list, more candidates than a block holds: a
    # ValueError and no launch, never the plain version
    (ids, aux, dots, qscale, qsq, hop), st = _hop_inputs(1, 84, 128, 24, 4, "random",
                                                         cuda_device)
    rp = 84
    if fault == "device":
        qscale = qscale.cpu()
    elif fault == "dtype":
        dots = dots.long()
    elif fault == "shape":
        ids = torch.cat([ids, ids[:1]])
    elif fault == "stride":
        st.best_d = torch.cat([st.best_d, st.best_d], 1)[:, ::2]
    else:
        rp = 4096
        ids = ids.repeat(1, 32)
        aux, dots = aux.repeat(1, 32), dots.repeat(1, 64)
    before = launches("hop_merge")
    with pytest.raises(ValueError, match="hop_merge"):
        k3.hop_merge(ids, aux, dots, qscale, qsq, st, hop, rp=rp, inner_product=False)
    assert launches("hop_merge") == before


def _card_words(shape, dtype, gen):
    """A random tensor of ``dtype`` drawn on ``gen``'s card as random bytes
    (a full-size table would not fit a draw on the host)."""
    n_bytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    return torch.randint(-128, 128, (n_bytes,), generator=gen, device=gen.device,
                         dtype=torch.int8).view(dtype).view(shape)


def _past_int32(ids, row_words: int) -> int:
    """How many of the valid block or node ``ids`` start at a word offset
    that an int32 cannot hold."""
    return int((ids.long() * row_words >= 2**31).sum())


# the main path's tables at full size (1M nodes), searched by its beam of
# 8192 x 4 slots: the search table (rp=84, dp=128: 3.07e9 words, so slots
# past word offset 2^31) and the build table (rp=88, dp=64: 2.05e9 words)
FULL_NODES = 1_000_000
FULL_GEOMETRIES = [(84, 128, FULL_NODES, 8192 * 4), (88, 64, FULL_NODES, 8192 * 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("rp,dp,nodes,bw",
                         GEOMETRIES + [(84, 128, 4096, 1000)] + FULL_GEOMETRIES)
def test_fatrow_expand_kernel_matches_plain(cuda_device, rp, dp, nodes, bw):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    rows = _card_words((nodes * n_wrows(rp, dp), 128), torch.int32, gen)
    beam = torch.randint(0, nodes, (bw,), generator=gen, device=cuda_device, dtype=torch.int32)
    qiw = _card_words((bw, dp), torch.int8, gen)
    beam[::11] = -1
    beam[1::13] = nodes + 3
    if rows.numel() > 2**31:
        valid = beam[(beam >= 0) & (beam < nodes)]
        assert _past_int32(valid, n_wrows(rp, dp) * 128) > 0
    before = launches("fatrow_expand")
    got = k1.fatrow_expand(rows, beam, qiw, rp=rp, dp=dp)
    assert launches("fatrow_expand") == before + 1
    want = k1.fatrow_expand_plain(rows, beam, qiw, rp=rp, dp=dp)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    del rows, got, want
    torch.cuda.empty_cache()


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
    before = launches("fatrow_expand")
    got = k1.fatrow_expand(*args, rp=rp, dp=dp)
    assert launches("fatrow_expand") == before + 1
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
    before = launches("fatrow_expand")
    with pytest.raises(RuntimeError, match="fatrow_expand"):
        k1.fatrow_expand(*[t(x).to(cuda_device) for x in (rows, beam, qiw)], rp=84, dp=128)
    assert launches("fatrow_expand") == before


# blocks of the full-size search table (rp=84, dp=128, 1M nodes)
FULL_BLOCKS = FULL_NODES * n_wrows(84, 128) // 8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n_blocks,g", [(torch.int8, 512, 300), (torch.int32, 512, 300),
                                              (torch.int32, FULL_BLOCKS, 3 * 8192)])
def test_block_patch_kernel_matches_plain(cuda_device, dtype, n_blocks, g):
    # the last block is the dump block, whose contents are garbage by design
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    dump = n_blocks - 1
    table = _card_words((8 * n_blocks, 128), dtype, gen)
    idx = torch.randperm(dump, generator=gen, device=cuda_device)[:g].to(torch.int32)
    idx[::5] = dump                                  # a fifth on the dump block
    idx[1::101] = n_blocks + 2                       # outside the table: skipped
    vals = _card_words((g * 8, 128), dtype, gen)
    if table.numel() > 2**31:
        assert _past_int32(idx[idx < dump], 8 * 128) > 0
    # the plain version on the host's copy: a second full table may not fit
    # beside whatever else holds the card
    want = k2.block_patch_plain(table.cpu(), idx.cpu(), vals.cpu())
    got = k2.block_patch(table, idx, vals)
    for lo in range(0, dump * 8, 1 << 22):
        hi = min(lo + (1 << 22), dump * 8)
        assert torch.equal(got[lo:hi].cpu(), want[lo:hi]), lo
    del table, got, want
    torch.cuda.empty_cache()
