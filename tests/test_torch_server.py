"""The port's RESP2 server (`diskann_tpu_torch/server.py`): the protocol
source held equal to the JAX package's apart from the service it imports
and the `--device` option of `main`, reply bytes equal for a table of
values, the wire test of `tests/test_server.py` over a real socket, the
JAX package's client driving the port's server, and a VREM whose delete
fails answered with -ERR while the element stays."""

import json
import re
from pathlib import Path

import numpy as np
import pytest

from diskann_tpu_torch import server as pserver
from diskann_tpu_torch.server import ResponseError, VectorSetClient, VectorSetServer
from diskann_tpu_torch.service import VectorService

ROOT = Path(__file__).resolve().parents[1]

VALUES = [None, True, False, 0, -7, 2**40, 1.5, -0.0, 1e-30, "", "abc", "é",
          b"\x00\r\n", pserver.SimpleString("OK"), pserver.Error("bad"),
          [], [1, "a", None, [b"x", 2.25]], ("t", 3)]


def test_source_is_the_jax_protocol():
    jax_src = (ROOT / "diskann_tpu/server.py").read_text()
    port_src = (ROOT / "diskann_tpu_torch/server.py").read_text()
    want = jax_src.replace("diskann_tpu.service", "diskann_tpu_torch.service")
    cut = want.index("def main(argv=None):")
    assert port_src[:cut] == want[:cut]
    main = port_src[cut:]
    assert '"--device"' in main and "VectorService(device=a.device)" in main
    # the rest of main is the reference's
    stripped = re.sub(r'    p\.add_argument\("--device".*?\)\n', "", main, flags=re.S)
    stripped = stripped.replace("VectorSetServer(a.host, a.port, VectorService(device=a.device))",
                                "VectorSetServer(a.host, a.port)")
    assert stripped == want[cut:].replace('"diskann_tpu vector-set server"',
                                          '"diskann_tpu_torch vector-set server"')


def test_encode_bytes_match_jax():
    from diskann_tpu import server as jserver

    for v in VALUES:
        jv = v
        if isinstance(v, pserver.SimpleString):
            jv = jserver.SimpleString(v)
        elif isinstance(v, pserver.Error):
            jv = jserver.Error(v)
        assert pserver._encode(v) == jserver._encode(jv), v
    with pytest.raises(TypeError):
        pserver._encode({1: 2})


@pytest.fixture(scope="module")
def server():
    srv = VectorSetServer(port=0, service=VectorService(device="cpu"))
    host, port = srv.serve_background()
    yield host, port
    srv.shutdown()
    srv.server_close()


def _drive(client, key):
    """The command sequence of `tests/test_server.py` on index ``key``."""
    rng = np.random.default_rng(11)
    assert client.execute("PING") == "PONG"
    assert client.create(key, 8, m=16, ef=32) == "OK"
    with pytest.raises(Exception, match="exists"):
        client.create(key, 8)
    centers = rng.standard_normal((4, 8)).astype(np.float32) * 2
    vecs = {}
    for i in range(96):
        v = centers[i % 4] + 0.1 * rng.standard_normal(8).astype(np.float32)
        vecs[f"e{i}"] = v
        assert client.add(key, f"e{i}", v, attribute=f"cat{i % 4}") == 1
    assert client.add(key, "e0", vecs["e0"]) == 0
    assert client.card(key) == 96
    out = client.sim(key, vecs["e7"], k=5, withscores=True)
    assert out[0][0] == "e7" and out[0][1] <= 1e-5 and len(out) == 5
    out = client.sim_element(key, "e7", k=5)
    assert "e7" not in out and len(out) == 5
    out = client.sim(key, vecs["e2"], k=5, filter="cat2")
    assert out and all(int(n[1:]) % 4 == 2 for n in out)
    assert client.execute("VSETATTR", key, "e3", '{"k": [1, 2]}') == 1
    assert json.loads(client.execute("VGETATTR", key, "e3")) == {"k": [1, 2]}
    assert client.execute("VGETATTR", key, "nope") is None
    out = client.execute("VSCAN", key, "VALUES", 8,
                         *[repr(float(x)) for x in vecs["e1"]], "COUNT", 6)
    cursor, page1 = int(out[0]), [x.decode() for x in out[1:]]
    assert len(page1) == 6
    page2 = [x.decode() for x in client.execute("VSCAN", key, "CONT", cursor, "COUNT", 6)]
    assert page2 and not (set(page1) & set(page2))
    assert client.execute("VSCAN", key, "END", cursor) == 1
    assert client.remove(key, "e7") == 1
    assert client.remove(key, "e7") == 0
    assert "e7" not in client.sim(key, vecs["e7"], k=5)
    assert client.card(key) == 95
    assert client.execute("VQUANT", key, "spherical") == "OK"
    assert client.sim(key, vecs["e6"], k=5)[0] == "e6"
    assert key.encode() in client.execute("VLIST")
    assert client.execute("VDROP", key) == 1
    assert client.execute("VDROP", key) == 0
    # an unknown command is an -ERR (each client raises its own class)
    with pytest.raises(Exception, match="ERR"):
        client.execute("BOGUS")


def test_wire_protocol_end_to_end(server):
    client = VectorSetClient(*server, timeout=600.0)
    try:
        _drive(client, "idx")
        with pytest.raises(ResponseError):
            client.execute("VCARD", "missing")
    finally:
        client.close()


def test_jax_client_drives_the_port_server(server):
    from diskann_tpu.server import VectorSetClient as JClient

    client = JClient(*server, timeout=600.0)
    try:
        _drive(client, "jidx")
    finally:
        client.close()


def test_failed_vrem_answers_err_and_keeps_the_element(monkeypatch):
    # the delete behind a VREM raises: the server answers -ERR and keeps
    # serving, the element stays, and the next VREM deletes it
    from diskann_tpu_torch.graph import delete as tdel
    from test_torch_rollback import _fail_call

    srv = VectorSetServer(port=0, service=VectorService(device="cpu"))
    host, port = srv.serve_background()
    client = VectorSetClient(host, port, timeout=600.0)
    try:
        rng = np.random.default_rng(5)
        assert client.create("r", 8, m=16, ef=32) == "OK"
        vecs = rng.standard_normal((40, 8)).astype(np.float32)
        for i, v in enumerate(vecs):
            assert client.add("r", f"e{i}", v, attribute=f"cat{i % 2}") == 1
        assert client.card("r") == 40
        assert client.sim("r", vecs[3], k=1) == ["e3"]      # commits the adds
        with monkeypatch.context() as mp:
            _fail_call(mp, tdel, "drop_deleted_rows", 1)
            with pytest.raises(ResponseError, match="ERR.*injected"):
                client.remove("r", "e3")
        assert client.card("r") == 40
        assert json.loads(client.execute("VGETATTR", "r", "e3")) == "cat1"
        assert client.sim("r", vecs[3], k=1) == ["e3"]
        assert client.remove("r", "e3") == 1 and client.remove("r", "e3") == 0
        assert client.card("r") == 39 and "e3" not in client.sim("r", vecs[3], k=5)
    finally:
        client.close()
        srv.shutdown()
        srv.server_close()
