"""Python Connector client — the port's copy of
`go_avalanche_tpu/connector/client.py`.

Method-per-message mirror of the seam the reference example drives in
process (`examples/basic-preconcensus/main.go`); the C++ twin is
`native/connector/client.h`.
"""

from __future__ import annotations

import socket
import struct
from typing import List, NamedTuple, Sequence, Tuple

from go_avalanche_tpu_torch.connector import protocol as proto
from go_avalanche_tpu_torch.config import AdversaryStrategy
from go_avalanche_tpu_torch.types import Status, StatusUpdate


class SimStats(NamedTuple):
    round: int
    finalized_fraction: float
    polls: int
    votes_applied: int
    flips: int
    finalizations: int


class TrafficStats(NamedTuple):
    """SIM_TRAFFIC_STATS: the live-traffic SLO view — cumulative
    arrivals/admissions/settlements plus the in-graph finality-latency
    percentiles (-1 while nothing has settled)."""

    arrived: int
    admitted: int
    settled: int
    lat_count: int
    lat_p50: int
    lat_p99: int
    lat_p999: int


class ConnectorClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeout_s: float = 60.0) -> None:
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "ConnectorClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ transport
    def _call(self, msg_type: int, payload: bytes,
              expect: Sequence[int]) -> Tuple[int, bytes]:
        proto.send_frame(self._sock, msg_type, payload)
        frame = proto.recv_frame(self._sock)
        if frame is None:
            raise proto.ProtocolError("server closed connection")
        reply_type, reply = frame
        if reply_type == proto.MsgType.ERROR:
            raise proto.ProtocolError(proto.unpack_error(reply))
        if reply_type not in expect:
            raise proto.ProtocolError(
                f"unexpected reply {reply_type} to {msg_type}")
        return reply_type, reply

    # ------------------------------------------------------------- messages
    def ping(self) -> bool:
        t, _ = self._call(proto.MsgType.PING, b"", [proto.MsgType.PONG])
        return t == proto.MsgType.PONG

    def create_node(self, node_id: int) -> bool:
        _, r = self._call(proto.MsgType.CREATE_NODE,
                          struct.pack("<q", node_id), [proto.MsgType.OK])
        return bool(r[0])

    def add_target(self, node_id: int, target_hash: int, accepted: bool,
                   valid: bool = True, score: int = 1) -> bool:
        _, r = self._call(
            proto.MsgType.ADD_TARGET,
            struct.pack("<qqBBq", node_id, target_hash,
                        1 if accepted else 0, 1 if valid else 0, score),
            [proto.MsgType.OK])
        return bool(r[0])

    def get_invs(self, node_id: int) -> List[int]:
        _, r = self._call(proto.MsgType.GET_INVS, struct.pack("<q", node_id),
                          [proto.MsgType.INVS])
        invs, _ = proto.unpack_i64s(r)
        return invs

    def query(self, node_id: int,
              hashes: Sequence[int]) -> List[Tuple[int, int]]:
        """Poll a peer: it gossip-admits unseen targets and answers one vote
        per inv from its own acceptance state (`main.go:168-193`)."""
        _, r = self._call(proto.MsgType.QUERY,
                          struct.pack("<q", node_id) + proto.pack_i64s(hashes),
                          [proto.MsgType.VOTES])
        votes, _ = proto.unpack_votes(r)
        return votes

    def register_votes(self, node_id: int, from_node: int, round_: int,
                       votes: Sequence[Tuple[int, int]],
                       ) -> Tuple[bool, List[StatusUpdate]]:
        _, r = self._call(
            proto.MsgType.REGISTER_VOTES,
            struct.pack("<qqq", node_id, from_node, round_)
            + proto.pack_votes(votes),
            [proto.MsgType.UPDATES])
        ok, raw = proto.unpack_updates(r)
        return ok, [StatusUpdate(h, Status(s)) for h, s in raw]

    def is_accepted(self, node_id: int, target_hash: int) -> bool:
        _, r = self._call(proto.MsgType.IS_ACCEPTED,
                          struct.pack("<qq", node_id, target_hash),
                          [proto.MsgType.OK])
        return bool(r[0])

    def get_confidence(self, node_id: int, target_hash: int) -> int:
        """-1 for unknown targets (the wire has no exceptions)."""
        _, r = self._call(proto.MsgType.GET_CONFIDENCE,
                          struct.pack("<qq", node_id, target_hash),
                          [proto.MsgType.I64])
        return struct.unpack("<q", r)[0]

    def get_round(self, node_id: int) -> int:
        _, r = self._call(proto.MsgType.GET_ROUND,
                          struct.pack("<q", node_id), [proto.MsgType.I64])
        return struct.unpack("<q", r)[0]

    def sim_init(self, n_nodes: int, n_txs: int, seed: int = 0, k: int = 8,
                 finalization_score: int = 128, gossip: bool = True,
                 byzantine_fraction: float = 0.0,
                 drop_probability: float = 0.0,
                 adversary_strategy: str = "flip",
                 flip_probability: float = 1.0,
                 churn_probability: float = 0.0,
                 model: str = "avalanche",
                 conflict_size: int = 2,
                 window_sets: int = 0,
                 arrival_mode: str = "off",
                 arrival_rate: float = 0.0,
                 arrival_period: int = 0,
                 arrival_backpressure=None) -> bool:
        """(Re)initialize the server-side batched simulator.

        `model` selects the family (v3 tail): "avalanche" (default),
        "dag" (conflict sets of `conflict_size`), "streaming_dag"
        (`window_sets` set-slots; 0 = auto-size to sets/8), or
        "backlog" (`window_sets` tx slots; 0 = auto-size to txs/8).

        The arrival args (v4 tail; streaming models only) turn on the
        live-traffic plane (go_avalanche_tpu/traffic.py): a schedule
        mode with `arrival_rate` offered units/round and optional
        `(lo, hi)` occupancy backpressure, or "external" to feed the
        stream exclusively through `sim_submit` — this client acting
        as the live load generator.
        """
        strategies = [s.value for s in AdversaryStrategy]
        bp = arrival_backpressure or (0.0, 0.0)
        _, r = self._call(
            proto.MsgType.SIM_INIT,
            struct.pack("<IIIIIBdd", n_nodes, n_txs, seed, k,
                        finalization_score, 1 if gossip else 0,
                        byzantine_fraction, drop_probability)
            + struct.pack("<Bdd", strategies.index(adversary_strategy),
                          flip_probability, churn_probability)
            + struct.pack("<BII", proto.SIM_MODELS.index(model), conflict_size,
                          window_sets)
            + struct.pack("<BdIdd",
                          proto.ARRIVAL_MODES.index(arrival_mode),
                          arrival_rate, arrival_period, bp[0], bp[1]),
            [proto.MsgType.OK])
        return bool(r[0])

    def sim_run(self, n_rounds: int) -> SimStats:
        _, r = self._call(proto.MsgType.SIM_RUN,
                          struct.pack("<I", n_rounds),
                          [proto.MsgType.SIM_STATS])
        return SimStats(*struct.unpack("<Id4q", r))

    def sim_submit(self, count: int = 0) -> TrafficStats:
        """Push `count` fresh admission units into the running streaming
        sim (they arrive at the CURRENT round) and read the traffic
        stats; `count=0` just reads.  The live-load-generator seam —
        interleave with `sim_run` to drive a closed loop from outside
        the graph."""
        _, r = self._call(proto.MsgType.SIM_SUBMIT,
                          struct.pack("<I", count),
                          [proto.MsgType.SIM_TRAFFIC_STATS])
        return TrafficStats(*struct.unpack("<7q", r))

    def shutdown_server(self) -> None:
        self._call(proto.MsgType.SHUTDOWN, b"", [proto.MsgType.OK])
