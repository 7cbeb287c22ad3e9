"""Connector wire protocol — the port's copy of
`go_avalanche_tpu/connector/protocol.py`, byte for byte the same format.

Frame layout (everything little-endian except the length prefix):

    u32be  frame_length            # bytes that follow (type + payload)
    u8     message_type            # MsgType
    ...    payload                 # fixed-width fields, then repeated groups

Scalar field encodings: i64 = '<q', i32 = '<i', u32 count = '<I',
bool/flag = 'B', probability = '<d'.  Repeated groups are a u32 count
followed by count fixed-width records.  Strings (ERROR only) are u32 length +
UTF-8 bytes.

The asymmetry with the reference is deliberate: the reference's seam is Go
interfaces crossed by direct method calls (`main.go:168-193`); ours is a
wire boundary, so `Target` crosses as its scalar attributes (hash /
preference / validity / score) and `StatusUpdate` as (hash, status) pairs —
the same reduction the batched simulator applies (SURVEY.md §7).

This module is the single source of truth for the format; the C++ client
(`native/connector/protocol.h`) mirrors it and the integration test drives
both ends against each other.
"""

from __future__ import annotations

import enum
import socket
import struct
from typing import List, Optional, Sequence, Tuple

MAX_FRAME = 64 * 1024 * 1024  # sanity bound, not a protocol limit

# SIM_INIT v3 model bytes, in wire order (mirrored by the Go client's
# Model* constants and native/connector/protocol.h).  "backlog" (byte 3,
# PR 8) is the streaming working-set scheduler — the live-traffic
# service-mode model; older clients never send it.
SIM_MODELS = ("avalanche", "dag", "streaming_dag", "backlog")

# SIM_INIT v4 arrival-mode bytes, in wire order (go_avalanche_tpu/
# traffic.py; "external" = arrivals pushed via SIM_SUBMIT only).
ARRIVAL_MODES = ("off", "poisson", "bursty", "diurnal", "external")


class MsgType(enum.IntEnum):
    # requests
    PING = 1
    CREATE_NODE = 3        # {node q}
    ADD_TARGET = 4         # {node q, hash q, accepted B, valid B, score q}
    GET_INVS = 5           # {node q}
    QUERY = 6              # {node q, count I, hash q ...}
    REGISTER_VOTES = 7     # {node q, from q, round q, count I, (hash q, err i)..}
    IS_ACCEPTED = 8        # {node q, hash q}
    GET_CONFIDENCE = 9     # {node q, hash q}
    GET_ROUND = 10         # {node q}
    SIM_INIT = 11          # {nodes I, txs I, seed I, k I, fin I, gossip B,
                           #  byz d, drop d}
                           #  + optional v2 tail {strategy B, flip d, churn d}
                           #  (strategy: 0=flip 1=equivocate 2=oppose_majority;
                           #   older clients omit the tail)
                           #  + optional v3 tail {model B, conflict_size I,
                           #  window_sets I} (model: 0=avalanche 1=dag
                           #  2=streaming_dag 3=backlog; window_sets 0 =
                           #  auto — set-slots for streaming_dag, tx
                           #  slots for backlog)
                           #  + optional v4 tail {arrival_mode B,
                           #  arrival_rate d, arrival_period I,
                           #  backpressure_lo d, backpressure_hi d}
                           #  (mode: 0=off 1=poisson 2=bursty 3=diurnal
                           #  4=external; lo == hi == 0 means no
                           #  backpressure; streaming models only)
    SIM_RUN = 12           # {rounds I}
    SIM_SUBMIT = 13        # {count I} — live load generator: `count`
                           #  fresh admission units arrive NOW
                           #  (traffic.push_arrivals); count 0 just
                           #  reads the traffic stats.  Needs a
                           #  streaming model with an arrival mode.
    SHUTDOWN = 16
    # replies
    PONG = 2
    OK = 14                # {flag B}
    I64 = 15               # {value q}
    INVS = 17              # {count I, hash q ...}
    VOTES = 18             # {count I, (hash q, err i) ...}
    UPDATES = 19           # {ok B, count I, (hash q, status b) ...}
    SIM_STATS = 20         # {round I, finalized_frac d, polls q, votes q,
                           #  flips q, finalizations q}
    ERROR = 21             # {len I, utf8 ...}
    SIM_TRAFFIC_STATS = 22  # {arrived q, admitted q, settled q,
                           #  lat_count q, lat_p50 q, lat_p99 q,
                           #  lat_p999 q} — the finality-latency SLO
                           #  view (percentiles -1 while nothing
                           #  settled)


# ------------------------------------------------------------------- framing


def pack_frame(msg_type: int, payload: bytes = b"") -> bytes:
    body = bytes([msg_type]) + payload
    return struct.pack(">I", len(body)) + body


def send_frame(sock: socket.socket, msg_type: int,
               payload: bytes = b"") -> None:
    sock.sendall(pack_frame(msg_type, payload))


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def recv_frame(sock: socket.socket) -> Optional[Tuple[int, bytes]]:
    """Read one frame; None on clean EOF."""
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (length,) = struct.unpack(">I", header)
    if not (1 <= length <= MAX_FRAME):
        raise ProtocolError(f"bad frame length {length}")
    body = _recv_exact(sock, length)
    if body is None:
        raise ProtocolError("connection closed mid-frame")
    return body[0], body[1:]


class ProtocolError(RuntimeError):
    pass


# ------------------------------------------------------- payload (de)coding


def pack_i64s(values: Sequence[int]) -> bytes:
    return struct.pack(f"<I{len(values)}q", len(values), *values)


def unpack_i64s(payload: bytes, offset: int = 0) -> Tuple[List[int], int]:
    (count,) = struct.unpack_from("<I", payload, offset)
    offset += 4
    values = list(struct.unpack_from(f"<{count}q", payload, offset))
    return values, offset + 8 * count


def pack_votes(votes: Sequence[Tuple[int, int]]) -> bytes:
    out = [struct.pack("<I", len(votes))]
    for h, err in votes:
        out.append(struct.pack("<qi", h, err))
    return b"".join(out)


def unpack_votes(payload: bytes,
                 offset: int = 0) -> Tuple[List[Tuple[int, int]], int]:
    (count,) = struct.unpack_from("<I", payload, offset)
    offset += 4
    votes = []
    for _ in range(count):
        h, err = struct.unpack_from("<qi", payload, offset)
        votes.append((h, err))
        offset += 12
    return votes, offset


def pack_updates(ok: bool, updates: Sequence[Tuple[int, int]]) -> bytes:
    out = [struct.pack("<BI", 1 if ok else 0, len(updates))]
    for h, status in updates:
        out.append(struct.pack("<qb", h, status))
    return b"".join(out)


def unpack_updates(payload: bytes) -> Tuple[bool, List[Tuple[int, int]]]:
    ok, count = struct.unpack_from("<BI", payload, 0)
    offset = 5
    updates = []
    for _ in range(count):
        h, status = struct.unpack_from("<qb", payload, offset)
        updates.append((h, status))
        offset += 9
    return bool(ok), updates


def pack_error(msg: str) -> bytes:
    raw = msg.encode("utf-8")
    return struct.pack("<I", len(raw)) + raw


def unpack_error(payload: bytes) -> str:
    (n,) = struct.unpack_from("<I", payload, 0)
    return payload[4:4 + n].decode("utf-8", "replace")
