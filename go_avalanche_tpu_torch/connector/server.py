"""Connector server: hosts consensus engines behind the wire boundary — the
port's `go_avalanche_tpu/connector/server.py`, on torch.

One server process owns a registry of per-node engines (the native C++
Processor when the library builds and loads, else the port's Python
`Processor`; `ConnectorServer.backend` says which) plus the batched
simulator on the server's `device`.  External harnesses — e.g. the C++
example in `native/connector/harness_main.cc` — connect and reproduce the reference
example's drive loop (`examples/basic-preconcensus/main.go`) over TCP:

    CREATE_NODE x N                (the per-node Processors, main.go:73-87)
    ADD_TARGET                     (feed txs, main.go:49-53)
    loop: GET_INVS -> QUERY peer -> REGISTER_VOTES     (main.go:110-161)

`QUERY` implements the polled peer's seam (`main.go:168-193`): gossip-on-poll
admission of unseen targets (`main.go:177`, attributes from the shared target
registry, the wire stand-in for the example's global tx list) and a vote per
inv from the peer's own acceptance state (`main.go:179-183`).

Thread model: one thread per connection (ThreadingTCPServer); engines are
internally locked, the registries by `_mu`.  The native library is built
and loaded at the first server construction, not at import.  Frames,
replies and error texts are the reference's byte for byte, so either
package's client drives either server.
"""

from __future__ import annotations

import socketserver
import struct
import threading
from typing import Dict, List, Optional, Tuple

import torch

from go_avalanche_tpu_torch import native as _native
from go_avalanche_tpu_torch import sync
from go_avalanche_tpu_torch.config import AdversaryStrategy, AvalancheConfig
from go_avalanche_tpu_torch.connector import protocol as proto
from go_avalanche_tpu_torch.connector.protocol import SIM_MODELS
from go_avalanche_tpu_torch.models.avalanche import _device
from go_avalanche_tpu_torch.types import Response, Vote

_have_native: Optional[bool] = None


def have_native() -> bool:
    """Whether the native host runtime builds and loads here (checked
    once; the reference's engine choice)."""
    global _have_native
    if _have_native is None:
        try:
            _native.load_library()
            _have_native = True
        except (_native.NativeBuildError, OSError):  # no toolchain / .so
            _have_native = False
    return _have_native


class _ScalarTarget:
    """Target adapter for the Python engine (wire targets are scalar)."""

    def __init__(self, hash_: int, accepted: bool, valid: bool,
                 score: int) -> None:
        self._hash, self._accepted = hash_, accepted
        self.valid, self._score = valid, score

    def hash(self) -> int:
        return self._hash

    def type(self) -> str:
        return "wire"

    def is_accepted(self) -> bool:
        return self._accepted

    def is_valid(self) -> bool:
        return self.valid

    def score(self) -> int:
        return self._score


class _PyEngine:
    """Python Processor behind the same scalar API as NativeProcessor."""

    def __init__(self, cfg: AvalancheConfig) -> None:
        from go_avalanche_tpu_torch.net import Connman
        from go_avalanche_tpu_torch.processor import Processor

        self._targets: Dict[int, _ScalarTarget] = {}
        self._p = Processor(Connman(), cfg)

    def add_target_to_reconcile(self, h: int, accepted: bool, valid: bool,
                                score: int) -> bool:
        t = self._targets.setdefault(h, _ScalarTarget(h, accepted, valid,
                                                      score))
        return self._p.add_target_to_reconcile(t)

    def get_invs_for_next_poll(self) -> List[int]:
        return [inv.target_hash for inv in self._p.get_invs_for_next_poll()]

    def register_votes(self, node_id, resp, updates) -> bool:
        return self._p.register_votes(node_id, resp, updates)

    def is_accepted(self, h: int) -> bool:
        t = self._targets.get(h)
        return self._p.is_accepted(t) if t is not None else False

    def get_confidence(self, h: int) -> int:
        t = self._targets.get(h)
        if t is None:
            raise KeyError(h)
        return self._p.get_confidence(t)

    def get_round(self) -> int:
        return self._p.get_round()

    def close(self) -> None:
        pass


class _SimBackend:
    """The batched simulators on the server's device.

    The v3 SIM_INIT tail selects the model family: plain multi-target
    (`models/avalanche`, the default), conflict DAG (`models/dag`), the
    streaming conflict-DAG (`models/streaming_dag`) or the backlog
    scheduler (`models/backlog`).  SIM_STATS' `finalized_fraction`
    generalizes per model: record-finalized fraction, (node, set)-resolved
    fraction, or backlog-settled fraction.  Each reply's numbers come to
    the host in one counted read (`sync.to_host`).
    """

    def __init__(self, device) -> None:
        # One lock for the whole backend: SIM_INIT/SIM_RUN from different
        # connections must serialize (state/cfg/totals are read-modify-write
        # triples; handler threads are per-connection).
        self._lock = threading.Lock()
        self._device = device
        self._state = None
        self._cfg: Optional[AvalancheConfig] = None
        self._model = "avalanche"
        self._totals = [0, 0, 0, 0]  # polls, votes, flips, finalizations

    def init(self, n_nodes: int, n_txs: int, seed: int,
             cfg: AvalancheConfig, model: str = "avalanche",
             conflict_size: int = 2, window_sets: int = 0) -> None:
        from go_avalanche_tpu_torch import prng

        if cfg.arrivals_enabled() and model not in ("backlog",
                                                    "streaming_dag"):
            raise proto.ProtocolError(
                f"SIM_INIT: the arrival tail (live traffic) needs a "
                f"streaming model (backlog/streaming_dag), got {model}")
        dev = self._device
        with self._lock:
            self._cfg = cfg
            self._model = model
            key = prng.key(seed, dev)
            if model == "avalanche":
                from go_avalanche_tpu_torch.models import avalanche as av
                self._state = av.init(key, n_nodes, n_txs, cfg, device=dev)
            elif model == "dag":
                from go_avalanche_tpu_torch.models import dag
                if n_txs % conflict_size:
                    raise proto.ProtocolError(
                        f"SIM_INIT: txs ({n_txs}) must divide by "
                        f"conflict_size ({conflict_size})")
                cs = torch.div(torch.arange(n_txs, dtype=torch.int32),
                               conflict_size, rounding_mode="floor")
                self._state = dag.init(key, n_nodes, cs, cfg, device=dev)
            elif model == "streaming_dag":
                from go_avalanche_tpu_torch.models import streaming_dag as sdg
                if n_txs % conflict_size:
                    raise proto.ProtocolError(
                        f"SIM_INIT: txs ({n_txs}) must divide by "
                        f"conflict_size ({conflict_size})")
                n_sets = n_txs // conflict_size
                w_sets = window_sets or max(1, n_sets // 8)
                backlog = sdg.make_set_backlog(torch.arange(
                    n_txs, dtype=torch.int32).reshape(n_sets, conflict_size))
                self._state = sdg.init(key, n_nodes, w_sets, backlog, cfg,
                                       device=dev)
            elif model == "backlog":
                from go_avalanche_tpu_torch.models import backlog as bl
                slots = window_sets or max(1, n_txs // 8)
                b = bl.make_backlog(torch.arange(n_txs, dtype=torch.int32))
                self._state = bl.init(key, n_nodes, slots, b, cfg,
                                      device=dev)
            else:
                raise proto.ProtocolError(f"SIM_INIT: unknown model {model}")
            self._totals = [0, 0, 0, 0]

    def run(self, n_rounds: int) -> Tuple[int, float, List[int]]:
        from go_avalanche_tpu_torch.ops import voterecord as vr

        with self._lock:
            if self._state is None or self._cfg is None:
                raise proto.ProtocolError("SIM_INIT required before SIM_RUN")
            cfg, dev = self._cfg, self._device
            if self._model == "avalanche":
                from go_avalanche_tpu_torch.models import avalanche as av
                state, tel = av.run_scan(self._state, cfg, n_rounds,
                                         device=dev)
                rnd = state.round
                fin = vr.has_finalized(state.records.confidence, cfg)
            elif self._model == "dag":
                from go_avalanche_tpu_torch.models import dag
                state, tel = dag.run_scan(self._state, cfg, n_rounds,
                                          device=dev)
                rnd = state.base.round
                conf = state.base.records.confidence
                fin_acc = vr.has_finalized(conf, cfg) & vr.is_accepted(conf)
                c = fin_acc.shape[1] // state.n_sets
                fin = dag.winners_per_set(fin_acc.to(torch.int32), c) == 1
            elif self._model == "streaming_dag":
                from go_avalanche_tpu_torch.models import streaming_dag as sdg
                state, stel = sdg.run_scan(self._state, cfg, n_rounds,
                                           device=dev)
                tel = stel.round
                rnd = state.dag.base.round
                fin = state.outputs.settled
            else:  # backlog
                from go_avalanche_tpu_torch.models import backlog as bl
                state, btel = bl.run_scan(self._state, cfg, n_rounds,
                                          device=dev)
                tel = btel.round
                rnd = state.sim.round
                fin = state.outputs.settled
            self._state = state
            # One read: the round, the finalized count, the four sums.
            host = sync.to_host(torch.stack(
                [rnd.to(torch.int64), fin.sum(dtype=torch.int64)]
                + [x.sum(dtype=torch.int64) for x in (
                    tel.polls, tel.votes_applied, tel.flips,
                    tel.finalizations)]))
            fin_frac = float(host[1]) / fin.numel()
            self._totals = [a + int(b) for a, b in zip(self._totals,
                                                       host[2:])]
            return int(host[0]), fin_frac, list(self._totals)

    def submit(self, count: int) -> Tuple[int, ...]:
        """SIM_SUBMIT: the live-load-generator seam — `count` fresh
        admission units arrive NOW (`traffic.push_arrivals`); count 0
        just reads.  Returns the SIM_TRAFFIC_STATS tuple (arrived,
        admitted, settled, lat_count, p50, p99, p999)."""
        from go_avalanche_tpu_torch import traffic as tf

        with self._lock:
            state = self._state
            if state is None or self._cfg is None:
                raise proto.ProtocolError(
                    "SIM_INIT required before SIM_SUBMIT")
            traffic = getattr(state, "traffic", None)
            if traffic is None:
                raise proto.ProtocolError(
                    "SIM_SUBMIT needs a streaming model with the "
                    "arrival tail (SIM_INIT v4; arrival_mode "
                    "'external' for a pure push-driven stream)")
            round_ = (state.sim.round if self._model == "backlog"
                      else state.dag.base.round)
            if count > 0:
                state = state._replace(
                    traffic=tf.push_arrivals(traffic, count, round_))
                self._state = state
            tel = tf.traffic_telemetry(state.traffic, torch.zeros(
                (), dtype=torch.int32, device=round_.device))
            # Same units as arrived/admitted: txs for backlog, SETS for
            # streaming_dag (whose outputs.settled is a per-member
            # plane, invalid padding lanes included; lat_count already
            # counts valid members only).
            settled_plane = state.outputs.settled
            settled = (settled_plane.sum(dtype=torch.int64)
                       if self._model == "backlog"
                       else settled_plane.any(dim=1).sum(dtype=torch.int64))
            host = sync.to_host(torch.stack([
                x.to(torch.int64) for x in (
                    tel.arrived_total, state.next_idx, settled,
                    tel.lat_count, tel.lat_p50, tel.lat_p99,
                    tel.lat_p999)]))
            return tuple(int(x) for x in host)


class ConnectorServer:
    """Threaded TCP server exposing the Connector protocol.

    `backend` chooses the per-node engine: "native" (default if the
    library builds and loads), "python"; the `backend` attribute reports
    the one in use.  The batched simulator runs on `device` (the card
    unless the caller asks for the CPU).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 cfg: Optional[AvalancheConfig] = None,
                 backend: Optional[str] = None, device="cuda") -> None:
        dev = _device(device)
        self._cfg = cfg if cfg is not None else AvalancheConfig()
        if backend is None:
            backend = "native" if have_native() else "python"
        if backend == "native" and not have_native():
            raise RuntimeError("native backend requested but unavailable")
        self._backend = backend
        self._mu = threading.Lock()
        self._engines: Dict[int, object] = {}
        self._target_attrs: Dict[int, Tuple[bool, bool, int]] = {}
        self._sim = _SimBackend(dev)
        self._shutdown_requested = threading.Event()

        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                while True:
                    try:
                        frame = proto.recv_frame(self.request)
                    except (proto.ProtocolError, OSError):
                        return
                    if frame is None:
                        return
                    msg_type, payload = frame
                    try:
                        reply = outer._dispatch(msg_type, payload)
                    except Exception as e:  # engine errors -> ERROR frame
                        reply = (proto.MsgType.ERROR, proto.pack_error(str(e)))
                    if reply is not None:
                        proto.send_frame(self.request, *reply)
                    if msg_type == proto.MsgType.SHUTDOWN:
                        outer._shutdown_requested.set()
                        return

        class _Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = _Server((host, port), _Handler)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- lifecycle
    @property
    def backend(self) -> str:
        """The per-node engine in use: "native" or "python"."""
        return self._backend

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address  # type: ignore[return-value]

    def start(self) -> "ConnectorServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join()
        with self._mu:
            # Do NOT close() engines here: daemon handler threads may still
            # be mid-dispatch (shutdown() stops only the accept loop), and
            # freeing a native engine under a live call is a use-after-free.
            # Dropping the references instead lets refcounting destroy each
            # engine once the last in-flight handler releases it.
            self._engines.clear()

    def wait_for_shutdown_request(self, timeout: Optional[float] = None
                                  ) -> bool:
        """Block until a client sent SHUTDOWN (the harness-driven exit)."""
        return self._shutdown_requested.wait(timeout)

    def __enter__(self) -> "ConnectorServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------------- engines
    def _new_engine(self):
        if self._backend == "native":
            return _native.NativeProcessor(self._cfg)
        return _PyEngine(self._cfg)

    def _engine(self, node_id: int):
        with self._mu:
            engine = self._engines.get(node_id)
            if engine is None:
                raise proto.ProtocolError(f"unknown node {node_id}")
            return engine

    # ------------------------------------------------------------- dispatch
    def _dispatch(self, msg_type: int,
                  payload: bytes) -> Optional[Tuple[int, bytes]]:
        M = proto.MsgType
        if msg_type == M.PING:
            return M.PONG, b""

        if msg_type == M.CREATE_NODE:
            (node_id,) = struct.unpack_from("<q", payload, 0)
            with self._mu:
                created = node_id not in self._engines
                if created:
                    self._engines[node_id] = self._new_engine()
            return M.OK, struct.pack("<B", 1 if created else 0)

        if msg_type == M.ADD_TARGET:
            node_id, h, accepted, valid, score = struct.unpack_from(
                "<qqBBq", payload, 0)
            with self._mu:
                self._target_attrs[h] = (bool(accepted), bool(valid), score)
            ok = self._engine(node_id).add_target_to_reconcile(
                h, bool(accepted), bool(valid), score)
            return M.OK, struct.pack("<B", 1 if ok else 0)

        if msg_type == M.GET_INVS:
            (node_id,) = struct.unpack_from("<q", payload, 0)
            invs = self._engine(node_id).get_invs_for_next_poll()
            return M.INVS, proto.pack_i64s(invs)

        if msg_type == M.QUERY:
            (node_id,) = struct.unpack_from("<q", payload, 0)
            hashes, _ = proto.unpack_i64s(payload, 8)
            engine = self._engine(node_id)
            votes = []
            for h in hashes:
                with self._mu:
                    accepted, valid, score = self._target_attrs.get(
                        h, (True, True, 1))
                engine.add_target_to_reconcile(h, accepted, valid, score)
                votes.append((h, 0 if engine.is_accepted(h) else 1))
            return M.VOTES, proto.pack_votes(votes)

        if msg_type == M.REGISTER_VOTES:
            node_id, from_node, round_ = struct.unpack_from("<qqq", payload, 0)
            votes, _ = proto.unpack_votes(payload, 24)
            resp = Response(round_, 0, [Vote(err, h) for h, err in votes])
            updates: List = []
            ok = self._engine(node_id).register_votes(from_node, resp, updates)
            return M.UPDATES, proto.pack_updates(
                ok, [(u.hash, int(u.status)) for u in updates])

        if msg_type == M.IS_ACCEPTED:
            node_id, h = struct.unpack_from("<qq", payload, 0)
            return M.OK, struct.pack(
                "<B", 1 if self._engine(node_id).is_accepted(h) else 0)

        if msg_type == M.GET_CONFIDENCE:
            node_id, h = struct.unpack_from("<qq", payload, 0)
            try:
                conf = self._engine(node_id).get_confidence(h)
            except KeyError:
                conf = -1
            return M.I64, struct.pack("<q", conf)

        if msg_type == M.GET_ROUND:
            (node_id,) = struct.unpack_from("<q", payload, 0)
            return M.I64, struct.pack("<q", self._engine(node_id).get_round())

        if msg_type == M.SIM_INIT:
            base_len = struct.calcsize("<IIIIIBdd")
            n_nodes, n_txs, seed, k, fin, gossip, byz, drop = \
                struct.unpack_from("<IIIIIBdd", payload, 0)
            extra = {}
            # v2 optional extension (older clients omit it): adversary
            # strategy byte + flip/churn probabilities.
            v2_len = struct.calcsize("<Bdd")
            if len(payload) >= base_len + v2_len:
                strat, flip_p, churn = struct.unpack_from("<Bdd", payload,
                                                          base_len)
                strategies = list(AdversaryStrategy)
                if strat >= len(strategies):
                    raise proto.ProtocolError(
                        f"SIM_INIT adversary strategy byte {strat} out of "
                        f"range (valid: 0..{len(strategies) - 1}: "
                        + ", ".join(f"{i}={s.value}"
                                    for i, s in enumerate(strategies)) + ")")
                extra = dict(
                    adversary_strategy=strategies[strat],
                    flip_probability=flip_p,
                    churn_probability=churn)
            # v3 optional extension: model byte + conflict_size + window
            # set-slots (streaming only; 0 = auto).
            model, conflict_size, window_sets = "avalanche", 2, 0
            v3_len = struct.calcsize("<BII")
            if len(payload) >= base_len + v2_len + v3_len:
                model_b, conflict_size, window_sets = struct.unpack_from(
                    "<BII", payload, base_len + v2_len)
                if model_b >= len(SIM_MODELS):
                    raise proto.ProtocolError(
                        f"SIM_INIT model byte {model_b} out of range "
                        f"(valid: 0..{len(SIM_MODELS) - 1}: "
                        + ", ".join(f"{i}={m}"
                                    for i, m in enumerate(SIM_MODELS)) + ")")
                model = SIM_MODELS[model_b]
            # v4 optional extension: live-traffic arrival tail
            # (streaming models; lo == hi == 0 means no backpressure).
            arrival = {}
            v4_off = base_len + v2_len + v3_len
            if len(payload) >= v4_off + struct.calcsize("<BdIdd"):
                mode_b, rate, period, bp_lo, bp_hi = struct.unpack_from(
                    "<BdIdd", payload, v4_off)
                if mode_b >= len(proto.ARRIVAL_MODES):
                    raise proto.ProtocolError(
                        f"SIM_INIT arrival mode byte {mode_b} out of "
                        f"range (valid: 0.."
                        f"{len(proto.ARRIVAL_MODES) - 1}: "
                        + ", ".join(f"{i}={m}" for i, m in
                                    enumerate(proto.ARRIVAL_MODES))
                        + ")")
                mode = proto.ARRIVAL_MODES[mode_b]
                if mode != "off":
                    arrival = dict(
                        arrival_mode=mode, arrival_rate=rate,
                        arrival_period=period,
                        arrival_backpressure=((bp_lo, bp_hi)
                                              if bp_lo or bp_hi
                                              else None))
            cfg = AvalancheConfig(
                k=k, finalization_score=fin, gossip=bool(gossip),
                byzantine_fraction=byz, drop_probability=drop, **extra,
                **arrival)
            self._sim.init(n_nodes, n_txs, seed, cfg, model=model,
                           conflict_size=conflict_size,
                           window_sets=window_sets)
            return M.OK, struct.pack("<B", 1)

        if msg_type == M.SIM_RUN:
            (rounds,) = struct.unpack_from("<I", payload, 0)
            rnd, fin_frac, totals = self._sim.run(rounds)
            return M.SIM_STATS, struct.pack("<Id4q", rnd, fin_frac, *totals)

        if msg_type == M.SIM_SUBMIT:
            (count,) = struct.unpack_from("<I", payload, 0)
            return (M.SIM_TRAFFIC_STATS,
                    struct.pack("<7q", *self._sim.submit(count)))

        if msg_type == M.SHUTDOWN:
            return M.OK, struct.pack("<B", 1)

        raise proto.ProtocolError(f"unknown message type {msg_type}")
