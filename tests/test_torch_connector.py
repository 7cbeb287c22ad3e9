"""The port's Connector (`connector/`) against the JAX package's.

One session — node ops, every `SIM_MODELS` model, `SIM_SUBMIT` on an
external-arrival backlog, and the error frames — runs against the JAX
server and against the port's server (on the CPU) on both engine
backends, driven by both packages' clients: every reply must be equal.
The port's `protocol.py` is a copy, so its frames must be byte-equal to
the JAX package's on the Go fixtures' argument set; and the C++ harness
drives the port's server as it drives the JAX one.
"""

from __future__ import annotations

import os
import socket
import struct
import subprocess

import pytest

from go_avalanche_tpu.connector import client as jclient
from go_avalanche_tpu.connector import go_fixtures
from go_avalanche_tpu.connector import protocol as jproto
from go_avalanche_tpu.connector import server as jserver
from go_avalanche_tpu_torch.connector import client as tclient
from go_avalanche_tpu_torch.connector import protocol as tproto
from go_avalanche_tpu_torch.connector import server as tserver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")
BACKENDS = ["python"] + (["native"] if tserver.have_native() else [])
CLIENTS = {"jax_client": jclient.ConnectorClient,
           "port_client": tclient.ConnectorClient}

# Raw frames the session sends past the client: an unknown message
# type, a truncated payload, bad SIM_INIT tail bytes.
_BASE = struct.pack("<IIIIIBdd", 16, 16, 1, 4, 8, 1, 0.0, 0.0)
RAW = [
    (99, b""),
    (jproto.MsgType.CREATE_NODE, b"\x01\x02"),
    (jproto.MsgType.SIM_INIT, _BASE + struct.pack("<Bdd", 9, 1.0, 0.0)),
    (jproto.MsgType.SIM_INIT, _BASE + struct.pack("<Bdd", 0, 1.0, 0.0)
     + struct.pack("<BII", 7, 2, 0)),
    (jproto.MsgType.SIM_INIT, _BASE + struct.pack("<Bdd", 0, 1.0, 0.0)
     + struct.pack("<BII", 0, 2, 0) + struct.pack("<BdIdd", 9, 0, 0, 0, 0)),
]


def _call(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 — error frames compared as text
        return f"{type(e).__name__}: {e}"


def _raw(addr, msg_type, payload):
    with socket.create_connection(addr, timeout=60) as s:
        jproto.send_frame(s, msg_type, payload)
        return jproto.recv_frame(s)


def session(client_cls, srv) -> list:
    out = []
    with client_cls(*srv.address) as c:
        out.append(c.ping())
        out.append(_call(c.get_invs, 123))
        out.append(_call(c.sim_run, 1))
        out.append(_call(c.sim_submit, 1))
        for n in (1, 2, 3, 1):
            out.append(c.create_node(n))
        for h, acc, score in ((5, True, 3), (6, False, 9), (7, True, 1)):
            out.append(c.add_target(1, h, acc, True, score))
        out.append(c.add_target(2, 8, True, False, 4))
        for _ in range(40):
            invs = c.get_invs(1)
            votes = c.query(2, invs)
            out += [invs, votes]
            ok, ups = c.register_votes(1, 2, c.get_round(1), votes)
            out.append((ok, [(u.hash, int(u.status)) for u in ups]))
        for h in (5, 6, 7, 8, 9):
            out += [c.is_accepted(1, h), c.get_confidence(1, h),
                    c.is_accepted(2, h)]
        out.append(c.get_round(1))
        for model in tproto.SIM_MODELS:
            out.append(c.sim_init(16, 16, seed=3, k=4, finalization_score=8,
                                  byzantine_fraction=0.125,
                                  adversary_strategy="oppose_majority",
                                  model=model, window_sets=2))
            out += [tuple(c.sim_run(5)), tuple(c.sim_run(5))]
        out.append(_call(c.sim_submit, 2))
        out.append(c.sim_init(8, 32, seed=1, finalization_score=8,
                              model="backlog", window_sets=4,
                              arrival_mode="external"))
        out += [tuple(c.sim_submit(5)), tuple(c.sim_run(12)),
                tuple(c.sim_submit(3)), tuple(c.sim_run(12)),
                tuple(c.sim_submit(0))]
        out.append(c.sim_init(8, 16, model="streaming_dag",
                              finalization_score=8, arrival_mode="poisson",
                              arrival_rate=1.0,
                              arrival_backpressure=(0.5, 0.9)))
        out += [tuple(c.sim_run(6)), tuple(c.sim_submit(2))]
        out.append(_call(c.sim_init, 8, 7, model="dag"))
        out.append(_call(c.sim_init, 8, 8, model="avalanche",
                         arrival_mode="poisson", arrival_rate=1.0))
    out += [_raw(srv.address, t, p) for t, p in RAW]
    return out


@pytest.fixture(scope="module")
def reference():
    """The JAX server's replies, per engine backend."""
    replies = {}
    for backend in BACKENDS:
        with jserver.ConnectorServer(backend=backend) as srv:
            replies[backend] = session(jclient.ConnectorClient, srv)
    return replies


@pytest.mark.parametrize("client", list(CLIENTS))
@pytest.mark.parametrize("backend", BACKENDS)
def test_port_server_replies_equal_the_jax_server(reference, backend,
                                                  client):
    with tserver.ConnectorServer(backend=backend, device="cpu") as srv:
        assert srv.backend == backend
        got = session(CLIENTS[client], srv)
    want = reference[backend]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)


def test_each_sim_reply_takes_one_read():
    from go_avalanche_tpu_torch import sync

    with tserver.ConnectorServer(backend="python", device="cpu") as srv:
        with tclient.ConnectorClient(*srv.address) as c:
            for model in ("avalanche", "dag"):
                c.sim_init(16, 16, k=4, finalization_score=8, model=model)
                reads = sync.reads
                c.sim_run(3)
                assert sync.reads - reads == 1
            c.sim_init(8, 32, model="backlog", window_sets=4,
                       arrival_mode="external")
            reads = sync.reads
            c.sim_submit(4)
            assert sync.reads - reads == 1


def test_pack_frame_matches_on_the_go_fixtures(monkeypatch):
    want = go_fixtures.build_fixtures()
    monkeypatch.setattr(go_fixtures, "proto", tproto)
    got = go_fixtures.build_fixtures()
    assert got == want
    assert [int(m) for m in tproto.MsgType] == [int(m) for m in
                                                jproto.MsgType]
    assert tproto.SIM_MODELS == jproto.SIM_MODELS
    assert tproto.ARRIVAL_MODES == jproto.ARRIVAL_MODES
    votes = [(65, 0), (66, -1), (2**40, 1)]
    assert tproto.unpack_votes(tproto.pack_votes(votes)) == (votes, 40)
    assert tproto.unpack_updates(tproto.pack_updates(True, [(1, 3)])) == (
        True, [(1, 3)])


def test_shutdown_request_and_backend_choice():
    with tserver.ConnectorServer(backend="python", device="cpu") as srv:
        with tclient.ConnectorClient(*srv.address) as c:
            c.shutdown_server()
        assert srv.wait_for_shutdown_request(5.0)
    if not tserver.have_native():
        with pytest.raises(RuntimeError, match="unavailable"):
            tserver.ConnectorServer(backend="native", device="cpu")


@pytest.fixture(scope="module")
def harness_bin(tmp_path_factory) -> str:
    # Built privately with the Makefile's flags, so it never races the
    # JAX package's tests writing `native/build/avalanche_harness`.
    out = str(tmp_path_factory.mktemp("harness") / "avalanche_harness")
    src = os.path.join(NATIVE, "connector")
    try:
        subprocess.run(["g++", "-O2", "-std=c++17", "-o", out,
                        os.path.join(src, "harness_main.cc"),
                        os.path.join(src, "client.cc"), "-pthread"],
                       check=True, capture_output=True, text=True)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"cannot build C++ harness: {e}")
    return out


def test_cpp_harness_drives_the_port_server(harness_bin):
    with tserver.ConnectorServer(device="cpu") as srv:
        host, port = srv.address
        out = subprocess.run([harness_bin, host, str(port), "6", "3",
                              "--sim"],
                             capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "nodes_fully_finalized=6/6" in out.stdout
    assert "finalized_fraction=1.000" in out.stdout
