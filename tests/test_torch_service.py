"""The port's vector-set service against the JAX package's: the five cases
of `tests/test_service.py`, each one op sequence run against both
packages on the same seeded vectors.  Results on the flat route (auto
below the crossover) and on the filtered scan carry equal names; the graph
walks (paged, quantized) >= 99% equal names, as the two packages' float32
sums may swap a near-tie; the backfilled code tables equal JAX's.  A flush
whose insert fails keeps the buffered VADDs in the port (the JAX
package's drops them), and a VREM whose delete fails keeps the element
for the next VREM (the JAX package's unbinds it and leaks the node)."""

import numpy as np
import pytest
import torch

from diskann_tpu_torch.graph import build as tbuild
from diskann_tpu_torch.graph import delete as tdel
from diskann_tpu_torch.service import VectorService
from test_torch_rollback import _fail_call
from torch_port_helpers import n


def _services():
    from diskann_tpu.service import VectorService as JService

    return {"jax": JService(), "port": VectorService(device="cpu")}


def _run_both(case):
    rng_seed = 0xD15CA
    out = {}
    for name, svc in _services().items():
        out[name] = case(svc, np.random.default_rng(rng_seed))
    return out["jax"], out["port"]


def _names(res):
    return [n for n, _ in res]


def _share(a, b):
    """Share of equal names, position by position, over lists of results."""
    pairs = [(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)]
    assert len(pairs) == sum(len(r) for r in a) == sum(len(r) for r in b)
    return np.mean([x == y for x, y in pairs])


def _codes(vs, *fields):
    return [n(getattr(vs.index, f)[: vs.index.n]) for f in fields]


def _lifecycle(svc, rng):
    vs = svc.create_index("products", 16, max_degree=8, l_build=16, insert_batch_size=64)
    assert svc.names() == ["products"]
    vecs = {f"item{i}": rng.standard_normal(16).astype(np.float32) for i in range(50)}
    for name, v in vecs.items():
        assert vs.add(name, v, attribute={"i": name})
    assert not vs.add("item0", vecs["item0"])
    assert vs.card() == 50
    r1 = vs.search_vector(vecs["item7"] + 0.001, k=5, l_search=16)
    assert r1[0][0] == "item7"
    r2 = vs.search_element("item7", k=5, l_search=16)
    assert all(n != "item7" for n, _ in r2) and len(r2) == 5
    assert vs.get_attribute("item7") == {"i": "item7"}
    assert vs.set_attribute("item7", {"x": 1})
    assert vs.get_attribute("item7") == {"x": 1}
    assert vs.remove("item7")
    assert vs.card() == 49
    r3 = vs.search_vector(vecs["item7"], k=5, l_search=16)
    assert all(n != "item7" for n, _ in r3)
    assert svc.drop_index("products") and not svc.drop_index("products")
    return {"flat": [r1, r2, r3]}


def _continue_search(svc, rng):
    vs = svc.create_index("pg", 12, max_degree=8, l_build=16, insert_batch_size=64)
    names = [f"e{i}" for i in range(120)]
    vecs = rng.standard_normal((120, 12)).astype(np.float32)
    assert vs.add_batch(names, vecs) == 120
    cursor, page1 = vs.start_search(vecs[5] + 0.001, page_size=6, l_search=16)
    assert page1[0][0] == "e5" and len(page1) == 6
    page2 = vs.continue_search(cursor, 6)
    assert len(page2) == 6
    assert not {n for n, _ in page1} & {n for n, _ in page2}
    assert vs.end_search(cursor)
    assert vs.continue_search(cursor, 6) == []
    return {"graph": [page1, page2]}


def _quant_backfill(svc, rng):
    vs = svc.create_index("qz", 16, max_degree=8, l_build=16, insert_batch_size=64)
    vecs = rng.standard_normal((150, 16)).astype(np.float32)
    vs.add_batch([f"a{i}" for i in range(150)], vecs)
    vs.build_quant_table("sq")
    assert vs.backfill_quant_vectors() == 150
    more = rng.standard_normal((30, 16)).astype(np.float32)
    vs.add_batch([f"b{i}" for i in range(30)], more)
    hit = vs.search_vector(more[3] + 0.0005, k=3, l_search=24)
    assert hit[0][0] == "b3"
    hit_full = vs.search_vector(more[3] + 0.0005, k=3, l_search=24, mode="full")
    assert hit_full[0][0] == "b3"
    return {"graph": [hit, hit_full], "codes": _codes(vs, "sq_codes", "sq_aux")}


def _minmax_streaming(svc, rng):
    vs = svc.create_index("mm", 12, max_degree=8, l_build=16, insert_batch_size=64)
    vecs = rng.standard_normal((100, 12)).astype(np.float32)
    vs.add_batch([f"x{i}" for i in range(100)], vecs)
    vs.build_quant_table("minmax")
    vs.add("fresh", vecs[0] * 0.5 + 0.1)
    got = vs.search_vector(vecs[0] * 0.5 + 0.1, k=1, l_search=20)
    assert got[0][0] == "fresh"
    return {"graph": [got],
            "codes": _codes(vs, "mm_codes", "mm_lo", "mm_step", "mm_aux")}


def _filtered(svc, rng):
    vs = svc.create_index("f", 12, max_degree=8, l_build=16, insert_batch_size=64)
    vecs = rng.standard_normal((120, 12)).astype(np.float32)
    attrs = [["red"] if i % 3 == 0 else ["blue", "big"] for i in range(120)]
    vs.add_batch([f"e{i}" for i in range(120)], vecs, attrs)
    q = vecs[9] + 0.001
    got = vs.search_vector_filtered(q, "red", k=5, l_search=24)
    assert got and got[0][0] == "e9" and all(int(n[1:]) % 3 == 0 for n, _ in got)
    got_b = vs.search_vector_filtered(q, "blue & big", k=5, l_search=24)
    assert got_b and all(int(n[1:]) % 3 != 0 for n, _ in got_b)
    vs.set_attribute("e9", ["blue", "big"])
    got2 = vs.search_vector_filtered(q, "red", k=5, l_search=24)
    assert all(n != "e9" for n, _ in got2)
    vs.remove("e0")
    got3 = vs.search_vector_filtered(vecs[0] + 0.001, "red", k=5, l_search=24)
    assert all(n != "e0" for n, _ in got3)
    return {"flat": [got, got_b, got2, got3]}


CASES = {"lifecycle": _lifecycle, "continue_search": _continue_search,
         "quant_backfill": _quant_backfill, "minmax_streaming": _minmax_streaming,
         "filtered": _filtered}


@pytest.mark.parametrize("case", sorted(CASES))
def test_service_case_matches_jax(case):
    j, p = _run_both(CASES[case])
    if "flat" in j:
        assert [_names(r) for r in p["flat"]] == [_names(r) for r in j["flat"]]
        for rp, rj in zip(p["flat"], j["flat"]):
            np.testing.assert_allclose([d for _, d in rp], [d for _, d in rj],
                                       rtol=1e-4, atol=1e-4)
    if "graph" in j:
        assert _share([_names(r) for r in p["graph"]],
                      [_names(r) for r in j["graph"]]) >= 0.99
    # integer codes equal; their float32 side values (norms, offsets) up
    # to the two packages' summation order
    for got, want in zip(p.get("codes", []), j.get("codes", [])):
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_service_device():
    svc = VectorService(device="cpu")
    vs = svc.create_index("a", 4)
    assert vs.index.device.type == "cpu"
    with pytest.raises(KeyError):
        svc.create_index("a", 4)
    assert svc.create_index("b", 4, device="cpu").index.state.vectors.device.type == "cpu"


def _fail_next_prune(monkeypatch):
    """The next insert batch raises out of device memory in its first
    prune; later ones run."""
    orig = tbuild.chunked_robust_prune_steps
    left = [1]

    def failing(*a, **k):
        if left[0]:
            left[0] -= 1
            raise torch.cuda.OutOfMemoryError("injected")
        return (yield from orig(*a, **k))

    monkeypatch.setattr(tbuild, "chunked_robust_prune_steps", failing)


def test_failed_flush_keeps_the_buffered_writes(monkeypatch):
    rng = np.random.default_rng(7)
    names = [f"v{i}" for i in range(104)]
    vecs = rng.standard_normal((104, 8)).astype(np.float32)
    sets = {}
    for key, svc in (_services() | {"twin": VectorService(device="cpu")}).items():
        vs = sets[key] = svc.create_index("f", 8, max_degree=8, l_build=16,
                                          insert_batch_size=64)
        vs.add_batch(names[:24], vecs[:24])
        for name, v in zip(names[24:40], vecs[24:40]):
            assert vs.add(name, v)                  # 16 buffered
    vs, twin, jvs = sets["port"], sets["twin"], sets["jax"]
    q = vecs[30] + 0.001
    assert vs.card() == 40

    # a read's flush fails: VCARD and VSIM answer as before, and the next
    # flush commits every buffered element (the twin never failed)
    with monkeypatch.context() as mp:
        _fail_next_prune(mp)
        with pytest.raises(torch.cuda.OutOfMemoryError):
            vs.search_vector(q, k=5, l_search=16)
    assert vs.card() == 40 and [e[0] for e in vs._pending] == names[24:40]
    assert vs.search_vector(q, k=5, l_search=16) == twin.search_vector(q, k=5, l_search=16)
    assert set(names[:40]) <= vs.name_to_id.keys()

    # an add whose flush fails is answered with the error and not kept;
    # the adds buffered before it stay
    for name, v in zip(names[40:103], vecs[40:103]):
        assert vs.add(name, v) and twin.add(name, v)    # 63 buffered
    with monkeypatch.context() as mp:
        _fail_next_prune(mp)
        with pytest.raises(torch.cuda.OutOfMemoryError):
            vs.add(names[103], vecs[103])               # the 64th: a flush
    assert vs.card() == 103 and len(vs._pending) == 63
    assert vs.add(names[103], vecs[103]) and twin.add(names[103], vecs[103])
    assert vs.card() == 104 and not vs._pending
    assert vs.search_vector(q, k=5, l_search=16) == twin.search_vector(q, k=5, l_search=16)
    np.testing.assert_array_equal(n(vs.index.state.adjacency), n(twin.index.state.adjacency))

    # the reference fault: the JAX package's flush empties its buffer first
    def fail(*a, **k):
        raise MemoryError("injected")

    monkeypatch.setattr(jvs.index, "insert", fail)
    with pytest.raises(MemoryError):
        jvs.search_vector(q, k=5, l_search=16)
    assert jvs.card() == 24


def test_failed_vrem_keeps_the_element(monkeypatch):
    # a VREM whose delete raises keeps the name, its id, its attribute and
    # its VCARD; the next VREM deletes it as one clean VREM does (the twin)
    rng = np.random.default_rng(9)
    names = [f"v{i}" for i in range(96)]
    vecs = rng.standard_normal((96, 8)).astype(np.float32)
    sets = {}
    for key, svc in (_services() | {"twin": VectorService(device="cpu")}).items():
        vs = sets[key] = svc.create_index("r", 8, max_degree=8, l_build=16,
                                          insert_batch_size=64)
        vs.add_batch(names, vecs, [{"i": i} for i in range(96)])
    vs, twin, jvs = sets["port"], sets["twin"], sets["jax"]
    iid = vs.name_to_id["v5"]
    assert twin.remove("v5")

    with monkeypatch.context() as mp:
        _fail_call(mp, tdel, "drop_deleted_rows", 1)
        with pytest.raises(torch.cuda.OutOfMemoryError):
            vs.remove("v5")
    assert vs.card() == 96 and vs.name_to_id["v5"] == iid and vs.id_to_name[iid] == "v5"
    assert vs.get_attribute("v5") == {"i": 5}
    assert vs.search_element("v5", k=3, l_search=16)
    assert vs.remove("v5") and not vs.remove("v5")
    assert vs.card() == twin.card() == 95
    for f in ("adjacency", "degrees", "valid"):
        np.testing.assert_array_equal(n(getattr(vs.index.state, f)),
                                      n(getattr(twin.index.state, f)), err_msg=f)
    assert vs.index.free_slots == twin.index.free_slots == [iid]

    # the reference fault: the JAX package's VREM unbinds the name first, so
    # after a failed delete the second VREM answers 0 and deletes nothing
    def fail(*a, **k):
        raise MemoryError("injected")

    monkeypatch.setattr(jvs.index, "delete", fail)
    with pytest.raises(MemoryError):
        jvs.remove("v5")
    monkeypatch.undo()
    assert not jvs.remove("v5") and jvs.card() == 95
    assert "v5" not in jvs.name_to_id and jvs.index.n_live == 96
