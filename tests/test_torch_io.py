"""The port's persistence and host IO against the JAX package's.

- The copies: `io_/fbin.py`, `io_/record.py`, `tiered/stores.py` and
  `native/hostio.cpp` are byte-identical to the JAX package's, and the
  readers give equal arrays (fbin, fvecs / ivecs, both groundtruth files).
- One JAX index (n=1500 x 24 clustered, R=16, L=32, W=4, a non-default
  `max_hops` and `router_size`) is saved straight after its build, then
  again with every attachment (packed, PQ, SQ, spherical 4-bit, MinMax,
  labels) after a delete.  A JAX record loads in the port and returns what
  the JAX package's own load returns, in every mode: ids bitwise,
  distances within 1e-5 relative; the port writes that record back byte
  for byte, and the JAX package loads the port's record alike.
- The port's own round trip is identical (ids, distances, cmps, hops, the
  start point and every config field), where the JAX package's loses its
  start point and all but eight config fields (reference faults, ROADMAP
  §C).
- The port's native reader gathers what the JAX package's does: at once,
  submitted and waited for, through its LRU cache, and with io_uring asked
  for; without a compiler `HostVectorStore` falls back to numpy.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

from diskann_tpu import GraphConfig as JConfig
from diskann_tpu import GraphIndex as JIndex
from diskann_tpu.io_ import fbin as jfbin
from diskann_tpu.io_ import record as jrecord
from diskann_tpu.native import NativeVectorFile as JNativeFile
from diskann_tpu_torch import GraphConfig, GraphIndex
from diskann_tpu_torch import native
from diskann_tpu_torch.bench.harness import make_clustered
from diskann_tpu_torch.io_ import fbin, record
from diskann_tpu_torch.native import NativeVectorFile
from diskann_tpu_torch.tiered import HostVectorStore
from torch_port_helpers import CPU, n

ROOT = Path(__file__).resolve().parents[1]
N, D, NQ = 1500, 24, 48
CFG = dict(max_degree=16, l_build=32, beam_width=4, max_hops=64, router_size=256)
MODES = ("full", "packed", "pq", "sq", "spherical", "minmax", "filtered")
DEAD = np.array([3, 100, 555])


def _labels():
    return [["even" if i % 2 == 0 else "odd", f"g{i % 5}"] for i in range(N)]


def _attach_all(idx):
    idx.attach_packed(dp=16)
    idx.attach_pq(n_chunks=8)
    idx.attach_sq()
    idx.attach_spherical(n_bits=4)
    idx.attach_minmax()
    idx.attach_labels(_labels())


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    """The JAX index saved straight after its build ("fresh") and with every
    attachment after a delete ("full"), with the start it searched from."""
    tmp = tmp_path_factory.mktemp("jax_records")
    x, q = make_clustered(31, N, NQ, D, n_clusters=24, sigma=0.35)
    j = JIndex.build(x, JConfig(**CFG), insert_batch_size=512)
    fresh_start = np.asarray(j._start())
    j.save(str(tmp / "fresh"))
    _attach_all(j)
    j.delete(DEAD)
    j.save(str(tmp / "full"))
    return {"x": x, "q": q, "j": j, "fresh_start": fresh_start, "tmp": tmp,
            "fresh": str(tmp / "fresh"), "full": str(tmp / "full"),
            "jl": JIndex.load(str(tmp / "full"))}


def _run(idx, q, mode):
    """(dists, ids, stats) of one mode on either package's index."""
    if mode == "filtered":
        return idx.search_filtered(q, "even", k=5, l_search=40)
    return idx.search(q, 10, l_search=40, mode=mode)


def _same(got, want, what, stats=False):
    np.testing.assert_array_equal(got[1], want[1], err_msg=f"ids differ: {what}")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, err_msg=what)
    if stats:
        np.testing.assert_array_equal(got[2].cmps, want[2].cmps, err_msg=what)
        np.testing.assert_array_equal(got[2].hops, want[2].hops, err_msg=what)


# ------------------------------------------------------------------- copies
@pytest.mark.parametrize("port, ref", [
    ("io_/fbin.py", "io_/fbin.py"),
    ("io_/record.py", "io_/record.py"),
    ("tiered/stores.py", "tiered/stores.py"),
    ("native/hostio.cpp", "native/hostio.cpp"),
])
def test_copies_are_identical(port, ref):
    got = (ROOT / "diskann_tpu_torch" / port).read_text()
    want = (ROOT / "diskann_tpu" / ref).read_text()
    for old, new in _PORT_EDITS.get(port, ()):
        assert want.count(old) == 1, old
        want = want.replace(old, new)
    assert got == want, port


# record.py's one edit: bfloat16 artifacts cross as their raw uint16 bits,
# since the card's host has no ml_dtypes
_PORT_EDITS = {"io_/record.py": [
    ("""def save_record(path: str, kind: str, meta: dict, arrays: dict[str, np.ndarray]):
""", """def save_record(path: str, kind: str, meta: dict, arrays: dict[str, np.ndarray],
                *, bfloat16=()):
    \"\"\"``bfloat16``: names of arrays that hold bfloat16 values as their raw
    uint16 bits; the manifest names their dtype "bfloat16", as numpy with
    ml_dtypes does.\"\"\"
"""),
    ('"dtype": str(arr.dtype),', '"dtype": "bfloat16" if name in bfloat16 else str(arr.dtype),'),
    ("""        dtype = np.dtype(info["dtype"])
""", """        # bfloat16 comes back as its raw uint16 bits: numpy knows the type
        # only through ml_dtypes
        dtype = np.uint16 if info["dtype"] == "bfloat16" else np.dtype(info["dtype"])
"""),
]}


def test_fbin_and_groundtruth_readers_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((37, 12)).astype(np.float32)
    fbin.write_fbin(str(tmp_path / "x.fbin"), x)
    for mmap in (False, True):
        got = fbin.read_fbin(str(tmp_path / "x.fbin"), mmap=mmap)
        np.testing.assert_array_equal(got, jfbin.read_fbin(str(tmp_path / "x.fbin"), mmap=mmap))
        np.testing.assert_array_equal(got, x)
    ids = rng.integers(0, 37, (5, 10)).astype(np.uint32)
    dists = rng.random((5, 10)).astype(np.float32)
    fbin.write_knn_groundtruth(str(tmp_path / "gt.bin"), ids, dists)
    for a, b in zip(fbin.read_knn_groundtruth(str(tmp_path / "gt.bin")),
                    jfbin.read_knn_groundtruth(str(tmp_path / "gt.bin"))):
        np.testing.assert_array_equal(a, b)
    per_query = [np.array([1, 5, 9]), np.array([], np.int64), np.array([4])]
    fbin.write_range_groundtruth(str(tmp_path / "rg.bin"), per_query)
    for a, b in zip(fbin.read_range_groundtruth(str(tmp_path / "rg.bin")),
                    jfbin.read_range_groundtruth(str(tmp_path / "rg.bin"))):
        np.testing.assert_array_equal(a, b)
    # TexMex .fvecs / .ivecs: [dim:i32][row] per row
    for name, arr, reader, jreader in (
            ("x.fvecs", x, fbin.read_fvecs, jfbin.read_fvecs),
            ("i.ivecs", ids.astype(np.int32), fbin.read_ivecs, jfbin.read_ivecs)):
        rows = np.concatenate([np.full((arr.shape[0], 1), arr.shape[1], np.int32),
                               arr.view(np.int32)], 1)
        rows.tofile(str(tmp_path / name))
        np.testing.assert_array_equal(reader(str(tmp_path / name)),
                                      jreader(str(tmp_path / name)))
    (tmp_path / "lfs.fbin").write_text("version https://git-lfs.github.com/spec/v1\n")
    for p in ("lfs.fbin", "x.fbin"):
        assert fbin.is_lfs_pointer(str(tmp_path / p)) == jfbin.is_lfs_pointer(str(tmp_path / p))


def test_record_bytes_match_jax(tmp_path):
    arrays = {"a": np.arange(12, dtype=np.int32).reshape(3, 4),
              "b": np.array([True, False]), "w": np.array([2**32 - 1], np.uint32)}
    meta = {"n": 3, "nested": {"x": [1, 2]}}
    record.save_record(str(tmp_path / "p"), "graph_index", meta, arrays)
    jrecord.save_record(str(tmp_path / "j"), "graph_index", meta, arrays)
    for f in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "p" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f
    man, got = record.load_record(str(tmp_path / "j"), mmap=True)
    assert man["format_version"] == record.FORMAT_VERSION == 1
    for k in arrays:
        assert got[k].dtype == arrays[k].dtype
        np.testing.assert_array_equal(got[k], arrays[k])


# --------------------------------------------------- records across packages
@pytest.mark.parametrize("mode", MODES)
def test_jax_record_loads_in_the_port(jax_records, mode):
    r = jax_records
    p = GraphIndex.load(r["full"], device=CPU)
    _same(_run(p, r["q"], mode), _run(r["jl"], r["q"], mode), mode)


@pytest.mark.parametrize("mode", MODES)
def test_port_record_loads_in_jax(jax_records, mode, tmp_path):
    r = jax_records
    p = GraphIndex.load(r["full"], device=CPU)
    p.save(str(tmp_path / "port"))
    jl = JIndex.load(str(tmp_path / "port"))
    want = _run(p, r["q"], mode)
    _same(_run(jl, r["q"], mode), want, mode)
    _same(_run(GraphIndex.load(str(tmp_path / "port"), device=CPU), r["q"], mode), want,
          mode, stats=True)


def test_port_writes_the_jax_record_byte_for_byte(jax_records, tmp_path):
    """A JAX record loaded by the port and saved again: every artifact the
    JAX package wrote comes back with its bytes, dtype and shape; the port
    adds only the start point it searched from, and the config fields the
    reference leaves out."""
    r = jax_records
    GraphIndex.load(r["full"], device=CPU).save(str(tmp_path / "again"))
    jm = json.loads(Path(r["full"], "manifest.json").read_text())
    pm = json.loads((tmp_path / "again" / "manifest.json").read_text())
    assert set(pm["artifacts"]) - set(jm["artifacts"]) == {"auto_start"}
    for name, info in jm["artifacts"].items():
        assert pm["artifacts"][name] == info, name
        assert ((tmp_path / "again" / info["file"]).read_bytes()
                == Path(r["full"], info["file"]).read_bytes()), name
    assert pm["kind"] == jm["kind"] == "graph_index"
    assert pm["format_version"] == jm["format_version"] == 1
    for key, val in jm["meta"].items():
        if key != "config":
            assert pm["meta"][key] == val, key
    assert {k: pm["meta"]["config"][k] for k in jm["meta"]["config"]} == jm["meta"]["config"]


def test_state_fields_across_packages(jax_records, tmp_path):
    r = jax_records
    jl = r["jl"]
    p = GraphIndex.load(r["full"], device=CPU)
    p.save(str(tmp_path / "port"))
    jp = JIndex.load(str(tmp_path / "port"))
    cap = p.state.capacity
    for a, b in ((p, jl), (p, jp)):
        assert b.n == a.n == N and b.n_deleted == a.n_deleted == len(DEAD)
        assert b.free_slots == a.free_slots == DEAD.tolist()
        assert b.labels.vocab == a.labels.vocab
        assert b.state.capacity == cap and a.packed.r_pack == b.packed.r_pack
        for f in ("adjacency", "degrees", "valid", "vectors", "sq_norms"):
            np.testing.assert_array_equal(n(getattr(a.state, f)),
                                          np.asarray(getattr(b.state, f)), err_msg=f)
        np.testing.assert_array_equal(n(a.packed.rows), np.asarray(b.packed.rows))
        np.testing.assert_array_equal(n(a.labels.bits).view(np.uint32),
                                      np.asarray(b.labels.bits))
        np.testing.assert_array_equal(n(a.sph_words).view(np.uint32),
                                      np.asarray(b.sph_words))
        np.testing.assert_allclose(n(a.state.vec_sum), np.asarray(b.state.vec_sum),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(n(a._start()), np.asarray(b._start()))


def test_load_grows_like_jax(jax_records):
    """Capacity max(n, 1024) rounded to the insert batch; an insert after
    the load grows every table as JAX's does."""
    r = jax_records
    p = GraphIndex.load(r["full"], device=CPU, insert_batch_size=512)
    jl = JIndex.load(r["full"], insert_batch_size=512)
    assert p.state.capacity == jl.state.capacity == 1536
    assert p.packed.rows.shape == tuple(jl.packed.rows.shape)
    new = r["x"][:600] + 0.01
    np.testing.assert_array_equal(p.insert(new), jl.insert(new))
    assert p.state.capacity == jl.state.capacity
    for t, a in ((p.packed.rows, jl.packed.rows), (p.pq_codes, jl.pq_codes),
                 (p.labels.bits, jl.labels.bits), (p.mm_step, jl.mm_step)):
        assert tuple(t.shape) == tuple(a.shape)


# ------------------------------------------------ round trips and faults
@pytest.fixture(scope="module")
def port_round_trip(jax_records):
    """A port index built on the CPU, saved straight after its build with
    every attachment, and loaded again."""
    r = jax_records
    p = GraphIndex.build(r["x"], GraphConfig(**CFG), insert_batch_size=512, device=CPU)
    _attach_all(p)
    path = str(r["tmp"] / "port_fresh")
    start = n(p._start()).copy()
    p.save(path)
    return p, GraphIndex.load(path, device=CPU), start


@pytest.mark.parametrize("mode", MODES)
def test_port_round_trip_is_identical(port_round_trip, jax_records, mode):
    p, re, _ = port_round_trip
    q = jax_records["q"]
    _same(_run(re, q, mode), _run(p, q, mode), mode, stats=True)


def test_port_round_trip_keeps_start_and_config(port_round_trip):
    p, re, start = port_round_trip
    assert re.config == p.config
    assert re.config.max_hops == CFG["max_hops"] and re.config.router_size == CFG["router_size"]
    np.testing.assert_array_equal(n(re._start()), start)
    # after a mutation the start is derived again, as before the save
    assert re._start_strategy == p._start_strategy


def test_reference_fault_start_point_after_load(jax_records, tmp_path):
    """The JAX package saves no start point: its load derives the medoid
    from all rows, not the one the build took at its second batch, so a
    record saved straight after a build walks from elsewhere (other cmps).
    The port loads a JAX record to the same start as JAX's own load."""
    r = jax_records
    jl = JIndex.load(r["fresh"])
    assert not np.array_equal(np.asarray(jl._start()), r["fresh_start"])
    p = GraphIndex.load(r["fresh"], device=CPU)
    np.testing.assert_array_equal(n(p._start()), np.asarray(jl._start()))
    assert "auto_start" not in json.loads(Path(r["fresh"], "manifest.json").read_text())[
        "artifacts"]


def test_reference_fault_config_fields(jax_records, tmp_path):
    """The JAX package writes eight `GraphConfig` fields: `max_hops`,
    `router_size` and the rest fall back to their defaults after its load.
    The port writes them all; the JAX loader still reads the port's record
    (its eight fields), and the port restores every field present."""
    r = jax_records
    jl = JIndex.load(r["fresh"])
    assert (jl.config.max_hops, jl.config.router_size) == (512, 65536)
    p = GraphIndex.load(r["fresh"], device=CPU)
    assert (p.config.max_hops, p.config.router_size) == (512, 65536)
    p.config = GraphConfig(**CFG)
    p.save(str(tmp_path / "port"))
    assert GraphIndex.load(str(tmp_path / "port"), device=CPU).config == GraphConfig(**CFG)
    jp = JIndex.load(str(tmp_path / "port"))
    assert (jp.config.max_degree, jp.config.beam_width, jp.config.max_hops) == (16, 4, 512)


def test_other_vector_dtypes_raise(jax_records, tmp_path):
    """The reference's vector dtypes load (float32, float16, bfloat16, int8,
    uint8: `test_torch_dtypes.py` crosses them); any other raises."""
    r = jax_records
    p = GraphIndex.load(r["fresh"], device=CPU)
    p.save(str(tmp_path / "rec"))
    man = json.loads((tmp_path / "rec" / "manifest.json").read_text())
    man["meta"]["dtype"] = "float64"
    (tmp_path / "rec" / "manifest.json").write_text(json.dumps(man))
    with pytest.raises(ValueError, match="vector dtype"):
        GraphIndex.load(str(tmp_path / "rec"), device=CPU)


# ------------------------------------------------------------ native store
@pytest.fixture(scope="module")
def vec_file(tmp_path_factory):
    x = np.random.default_rng(2).standard_normal((300, 24)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("vecs") / "v.fbin")
    fbin.write_fbin(path, x)
    return x, path


@pytest.mark.parametrize("how", ["sync", "async", "cached", "uring"])
def test_native_reader_matches_jax(vec_file, how):
    x, path = vec_file
    ids = np.random.default_rng(3).integers(-5, 310, size=5000)   # clamped at both ends
    kw = {"cached": dict(cache_rows=64), "uring": dict(uring=True, uring_depth=64)}.get(how, {})
    ours, ref = NativeVectorFile(path, 4, **kw), JNativeFile(path, 4, **kw)
    assert (ours.n, ours.dim) == (ref.n, ref.dim) == x.shape
    if how == "async":
        got = ours.wait(ours.gather_async(ids))
        want = ref.wait(ref.gather_async(ids))
    else:
        got, want = ours.gather(ids), ref.gather(ids)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x[np.clip(ids, 0, len(x) - 1)])
    assert ours.cache_stats == ref.cache_stats
    if how == "cached":
        assert ours.cache_stats["hits"] + ours.cache_stats["misses"] == ids.size
    assert ours.uring_active == ref.uring_active
    ours.close()
    ref.close()


def test_store_falls_back_to_numpy_without_a_compiler(vec_file, monkeypatch):
    x, path = vec_file
    native_store = HostVectorStore.from_fbin(path, cache_rows=32)
    assert native_store.is_native
    monkeypatch.setattr(native, "get_lib", lambda: None)
    store = HostVectorStore.from_fbin(path)
    assert not store.is_native and store.source_path == path
    ids = np.array([[1, 2], [299, 400]])
    for s in (native_store, store):
        got = s.fetch(ids)
        assert got.shape == (2, 2, 24)
        np.testing.assert_array_equal(got, x[np.clip(ids, 0, 299)])
        np.testing.assert_array_equal(s.fetch_wait(s.fetch_async(ids)), got)


def test_native_library_builds_into_the_ignored_build_dir():
    lib = native.library_path()
    assert lib.parent.parent == ROOT / "diskann_tpu_torch" / "_build"
    assert native.get_lib() is not None and lib.exists()
    assert "diskann_tpu_torch/_build/" in (ROOT / ".gitignore").read_text().split()
