"""Protocol and simulation configuration of the PyTorch port.

The port's own copy of `go_avalanche_tpu.config`: the same field names,
the same defaults and the same validation, so one kwargs dict builds
both configs.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple


class VoteMode(enum.Enum):
    """How one round turns k sampled peer preferences into votes.

    SEQUENTIAL — each peer's vote goes through the 8-vote sliding window
    one at a time, in sample order (`processor.go:94-117`).
    MAJORITY — the k preferences reduce to one conclusive yes/no chit per
    round when >= alpha*k agree, else a neutral vote.
    """

    SEQUENTIAL = "sequential"
    MAJORITY = "majority"


class AdversaryStrategy(enum.Enum):
    """What a byzantine peer answers when it lies (`ops/adversary.py`).

    FLIP — the opposite of its true preference.  EQUIVOCATE — a fresh
    coin per (querier, draw, target).  OPPOSE_MAJORITY — the current
    global minority color.
    """

    FLIP = "flip"
    EQUIVOCATE = "equivocate"
    OPPOSE_MAJORITY = "oppose_majority"


ADVERSARY_POLICIES = ("off", "split_vote", "withhold_near_quorum",
                      "stake_eclipse", "timing")


# Fault-script event schema: kind -> positional field names after the
# kind tag, the one source for both spellings (tuple arity in
# `_validate_fault_script`, JSON object keys in `fault_script_from_json`).
# Every event is a plain tuple, so the config stays hashable, and every
# window is END-EXCLUSIVE ([start, end), like `partition_spec`).  The
# stochastic kinds carry a [lo, hi] range (inclusive) in every field; the
# realized values are drawn once per simulation from its init key
# (`ops/inflight.draw_fault_params`), and their windows are
# [start, start + length).
_FAULT_EVENT_FIELDS = {
    "partition": ("start", "end", "frac"),
    "regional_outage": ("start", "end", "cluster"),
    "latency_spike": ("start", "end", "extra_rounds"),
    "churn_burst": ("round", "frac"),
    "stochastic_partition": ("start", "length", "frac"),
    "stochastic_spike": ("start", "length", "extra_rounds"),
    "stochastic_regional_outage": ("start", "length", "cluster"),
}

# The event kinds whose parameters are drawn at init rather than fixed in
# the script; they are exempt from the static overlap check (realized cut
# masks OR and spike extras add, so overlaps compose deterministically).
_STOCHASTIC_KINDS = ("stochastic_partition", "stochastic_spike",
                     "stochastic_regional_outage")


def fault_script_from_json(data) -> Tuple[Tuple, ...]:
    """Parse a JSON-decoded fault script into the `cfg.fault_script`
    tuple spelling; structural errors only (ranges, overlaps and topology
    are `AvalancheConfig`'s to check).  Events are ``[kind, ...]`` lists
    or ``{"kind": ..., <fields>}`` objects, freely mixed.  Raises
    `ValueError` naming the offending index."""
    if not isinstance(data, (list, tuple)):
        raise ValueError(
            f"a fault script is a JSON LIST of events, got "
            f"{type(data).__name__}")
    events = []
    for i, ev in enumerate(data):
        if isinstance(ev, dict):
            kind = ev.get("kind")
            if kind not in _FAULT_EVENT_FIELDS:
                raise ValueError(
                    f"event[{i}]: unknown event kind {kind!r}; known "
                    f"kinds: {', '.join(sorted(_FAULT_EVENT_FIELDS))}")
            fields = _FAULT_EVENT_FIELDS[kind]
            extra = set(ev) - {"kind", *fields}
            missing = [f for f in fields if f not in ev]
            if missing or extra:
                raise ValueError(
                    f"event[{i}]: {kind} events carry fields "
                    f"{', '.join(fields)}"
                    + (f" — missing {', '.join(missing)}" if missing
                       else "")
                    + (f" — unknown {', '.join(sorted(extra))}" if extra
                       else ""))
            events.append((kind,) + tuple(ev[f] for f in fields))
        elif isinstance(ev, (list, tuple)):
            events.append(tuple(ev))
        else:
            raise ValueError(
                f"event[{i}]: an event is a [kind, ...] list or a "
                f"{{'kind': ...}} object, got {type(ev).__name__}")
    return tuple(events)


@dataclasses.dataclass(frozen=True)
class AvalancheConfig:
    """All protocol constants of the reference plus simulator knobs.

    Field meanings, defaults and validation rules are those of
    `go_avalanche_tpu.config.AvalancheConfig`.
    """

    # --- protocol constants (reference parity) ---
    finalization_score: int = 128
    time_step_s: float = 0.010
    max_element_poll: int = 4096
    request_timeout_s: float = 60.0
    window: int = 8
    quorum: int = 7

    # --- simulator knobs ---
    k: int = 8
    alpha: float = 0.8
    vote_mode: VoteMode = VoteMode.SEQUENTIAL
    sample_with_replacement: bool = True
    exclude_self: bool = True
    weighted_sampling: bool = False
    n_clusters: int = 1
    cluster_locality: float = 0.8
    gossip: bool = True
    fused_exchange: bool = True
    # "u8" and "swar32" give the same bits; "u8" is kept as the
    # counterpart of the reference's `_vote_kernel` (ROADMAP.md Queue 2).
    ingest_engine: str = "u8"
    round_engine: str = "phased"
    fused_sharded_gossip: bool = False
    # The Processor's request/response validation contract
    # (`processor.py`; the reference compiled it out, `processor.go:62-90`).
    strict_validation: bool = False
    latency_mode: str = "none"
    latency_rounds: int = 0
    partition_spec: Optional[Tuple[int, int, float]] = None
    fault_script: Optional[Tuple[Tuple, ...]] = None
    rtt_matrix: Optional[Tuple[Tuple[int, ...], ...]] = None
    inflight_engine: str = "walk"
    metrics_every: int = 0
    trace_every: int = 0
    stream_retire_cap: Optional[int] = None

    # --- live-traffic service mode ---
    arrival_mode: str = "off"
    arrival_rate: float = 0.0
    arrival_period: int = 0
    arrival_burst_factor: float = 1.0
    arrival_duty: float = 0.5
    arrival_depth: float = 0.0
    arrival_backpressure: Optional[Tuple[float, float]] = None
    arrival_cluster_weights: Optional[Tuple[float, ...]] = None
    arrival_latency_buckets: int = 512

    # --- stake subsystem ---
    stake_mode: str = "off"
    stake_zipf_s: float = 1.0
    stake_weights: Optional[Tuple[float, ...]] = None
    registry_nodes: int = 0
    active_nodes: int = 0
    node_churn_rate: float = 0.0

    # --- fault / adversary model ---
    byzantine_fraction: float = 0.0
    flip_probability: float = 1.0
    adversary_strategy: AdversaryStrategy = AdversaryStrategy.FLIP
    adversary_policy: str = "off"
    adversary_margin: int = 1
    drop_probability: float = 0.0
    churn_probability: float = 0.0
    skip_absent_votes: bool = False

    def arrivals_enabled(self) -> bool:
        """True when the live-traffic arrival plane (`traffic.py`) is on:
        the streaming schedulers carry a `TrafficState` and admission is
        gated on arrived work."""
        return self.arrival_mode != "off"

    def fault_events(self) -> Tuple[Tuple, ...]:
        """The merged fault script: `partition_spec` (the one-event
        spelling) first, then `fault_script` in order.  Every consumer of
        the fault model reads this."""
        events = tuple(self.fault_script or ())
        if self.partition_spec is not None:
            events = (("partition",) + tuple(self.partition_spec),) + events
        return events

    def cut_events(self) -> Tuple[Tuple, ...]:
        """Static events that sever (querier, responder) pairs:
        partitions and regional outages (`ops/inflight.partition_cut`)."""
        return tuple(e for e in self.fault_events()
                     if e[0] in ("partition", "regional_outage"))

    def spike_events(self) -> Tuple[Tuple, ...]:
        """Static latency_spike events: extra latency on queries sent
        during the window (`ops/inflight.apply_latency_spikes`)."""
        return tuple(e for e in self.fault_events()
                     if e[0] == "latency_spike")

    def stochastic_cut_events(self) -> Tuple[Tuple, ...]:
        """stochastic_partition events, realized per simulation."""
        return tuple(e for e in self.fault_events()
                     if e[0] == "stochastic_partition")

    def stochastic_spike_events(self) -> Tuple[Tuple, ...]:
        """stochastic_spike events, realized per simulation."""
        return tuple(e for e in self.fault_events()
                     if e[0] == "stochastic_spike")

    def stochastic_region_events(self) -> Tuple[Tuple, ...]:
        """stochastic_regional_outage events, realized per simulation."""
        return tuple(e for e in self.fault_events()
                     if e[0] == "stochastic_regional_outage")

    def stochastic_events(self) -> Tuple[Tuple, ...]:
        """All stochastic events in script order, the order in which
        `ops/inflight.draw_fault_params` folds their index into its
        stream."""
        return tuple(e for e in self.fault_events()
                     if e[0] in _STOCHASTIC_KINDS)

    def churn_burst_events(self) -> Tuple[Tuple, ...]:
        """churn_burst events: one-shot alive-toggle impulses
        (`ops/inflight.apply_churn_bursts`), the one kind that needs no
        in-flight ring."""
        return tuple(e for e in self.fault_events()
                     if e[0] == "churn_burst")

    def async_queries(self) -> bool:
        """True when the in-flight query ring (`ops/inflight.py`) is on:
        a latency distribution, or any cut, spike or stochastic fault
        event (churn bursts alone need no ring)."""
        return (self.latency_mode != "none" or bool(self.cut_events())
                or bool(self.spike_events())
                or bool(self.stochastic_events()))

    def timeout_rounds(self) -> int:
        """First round-age at which an outstanding query expires (the
        reference's floor + 1 spelling)."""
        return int(math.floor(self.request_timeout_s / self.time_step_s
                              + 1e-9)) + 1

    def __post_init__(self) -> None:
        if not (0 < self.window <= 8):
            raise ValueError("window must be in (0, 8]: packed into uint8")
        if not (0 < self.quorum <= self.window):
            raise ValueError("quorum must be in (0, window]")
        if self.finalization_score <= 0 or self.finalization_score > 0x7FFF:
            raise ValueError("finalization_score must fit in 15 bits "
                             "(confidence counter is uint16 >> 1)")
        if self.k <= 0:
            raise ValueError("k must be positive")
        if self.weighted_sampling and not self.sample_with_replacement:
            raise ValueError(
                "weighted_sampling requires sample_with_replacement: exact "
                "weighted draws without replacement need per-row Gumbel "
                "top-k over all N peers (O(N^2) state)")
        if self.n_clusters < 1:
            raise ValueError("n_clusters must be >= 1 (1 = no clustering)")
        if self.skip_absent_votes and self.vote_mode is not VoteMode.SEQUENTIAL:
            raise ValueError(
                "skip_absent_votes applies to the SEQUENTIAL vote mode only")
        if self.n_clusters > 1 and not self.sample_with_replacement:
            raise ValueError(
                "clustered topology requires sample_with_replacement "
                "(same O(N^2) argument as weighted_sampling)")
        if not (0.0 <= self.cluster_locality <= 1.0):
            raise ValueError("cluster_locality must be in [0, 1]")
        if not (0.5 < self.alpha <= 1.0):
            raise ValueError("alpha must be in (0.5, 1.0]")
        if self.ingest_engine not in ("u8", "swar32"):
            raise ValueError(
                f"ingest_engine must be 'u8' or 'swar32', "
                f"got {self.ingest_engine!r}")
        if self.metrics_every < 0:
            raise ValueError("metrics_every must be >= 0 (0 disables the "
                             "in-graph metrics tap)")
        if self.trace_every < 0:
            raise ValueError("trace_every must be >= 0 (0 disables the "
                             "on-device trace plane)")
        if self.stream_retire_cap is not None and self.stream_retire_cap < 1:
            raise ValueError("stream_retire_cap must be >= 1 (None "
                             "disables the cap)")
        if self.inflight_engine not in ("walk", "walk_earlyout",
                                        "coalesced"):
            raise ValueError(
                f"inflight_engine must be 'walk', 'walk_earlyout' or "
                f"'coalesced', got {self.inflight_engine!r}")
        if self.latency_mode not in ("none", "fixed", "geometric",
                                     "weighted", "rtt"):
            raise ValueError(
                f"latency_mode must be 'none', 'fixed', 'geometric', "
                f"'weighted' or 'rtt', got {self.latency_mode!r}")
        if self.latency_rounds < 0:
            raise ValueError("latency_rounds must be >= 0")
        if self.partition_spec is not None:
            if len(self.partition_spec) != 3:
                raise ValueError("partition_spec is (round_start, "
                                 "round_end, split_frac)")
            object.__setattr__(self, "partition_spec",
                               tuple(self.partition_spec))
            start, end, frac = self.partition_spec
            if start == end:
                raise ValueError(
                    f"partition_spec window [{start}, {end}) is "
                    f"zero-length: windows are END-EXCLUSIVE, so a "
                    f"start == end cut never fires — rounds must "
                    f"satisfy 0 <= start < end")
            if not (0 <= start < end):
                raise ValueError("partition_spec rounds must satisfy "
                                 "0 <= start < end (end-exclusive "
                                 "window)")
            if not (0.0 < frac < 1.0):
                raise ValueError("partition_spec split_frac must be in "
                                 "(0, 1)")
        self._validate_fault_script()
        self._validate_rtt_matrix()
        self._validate_arrival()
        self._validate_stake()
        self._validate_adversary()
        self._validate_round_engine()
        self._validate_async()

    def _validate_async(self) -> None:
        """The reference's rules for the latency mode, the RTT matrix and
        the in-flight ring's depth."""
        if self.latency_mode == "rtt":
            if self.rtt_matrix is None:
                raise ValueError(
                    "latency_mode 'rtt' needs an rtt_matrix (a "
                    "C x C tuple of per-cluster-pair latencies in "
                    "rounds, C == n_clusters)")
        elif self.rtt_matrix is not None:
            raise ValueError(
                f"rtt_matrix is only read by latency_mode 'rtt', got "
                f"latency_mode {self.latency_mode!r} — a silently "
                f"ignored matrix would mislabel the run")
        if not self.async_queries():
            return
        if self.vote_mode is not VoteMode.SEQUENTIAL:
            raise ValueError(
                "the async query engine applies to the SEQUENTIAL "
                "vote mode only (MAJORITY reduces all k draws at "
                "once, which has no per-draw delivery time)")
        if self.timeout_rounds() < 1:
            raise ValueError(
                f"async queries need timeout_rounds() >= 1, got "
                f"{self.timeout_rounds()} from request_timeout_s="
                f"{self.request_timeout_s} / time_step_s="
                f"{self.time_step_s}: a non-positive timeout makes "
                f"EVERY query expire before any response can "
                f"deliver, so a run-until-settled loop spins "
                f"forever")
        if self.timeout_rounds() > 64:
            raise ValueError(
                f"async queries need timeout_rounds() <= 64 (the "
                f"in-flight ring depth), got "
                f"{self.timeout_rounds()} from request_timeout_s="
                f"{self.request_timeout_s} / time_step_s="
                f"{self.time_step_s}; lower request_timeout_s or "
                f"raise time_step_s (e.g. time_step_s=1.0, "
                f"request_timeout_s=7.0 for an 8-round timeout)")

    def _validate_fault_script(self) -> None:
        """Reject malformed, out-of-range or overlapping fault events at
        construction, with the reference's messages."""
        if self.fault_script is None:
            return

        def _canon(ev):
            # Stochastic range fields may arrive as lists; the script
            # must stay hashable.
            ev = tuple(ev)
            if ev and ev[0] in _STOCHASTIC_KINDS:
                return (ev[0],) + tuple(
                    tuple(f) if isinstance(f, (list, tuple)) else f
                    for f in ev[1:])
            return ev

        script = tuple(_canon(e) for e in self.fault_script)
        object.__setattr__(self, "fault_script", script)
        for i, ev in enumerate(script):
            if not ev or ev[0] not in _FAULT_EVENT_FIELDS:
                raise ValueError(
                    f"fault_script[{i}]: unknown event kind "
                    f"{ev[0] if ev else ev!r}; known kinds: "
                    f"{', '.join(sorted(_FAULT_EVENT_FIELDS))}")
            kind = ev[0]
            fields = _FAULT_EVENT_FIELDS[kind]
            if len(ev) != 1 + len(fields):
                raise ValueError(
                    f"fault_script[{i}]: {kind} events are "
                    f"(kind, {', '.join(fields)}), got {len(ev)} fields")
            if kind == "churn_burst":
                _, round_, frac = ev
                if int(round_) != round_ or round_ < 0:
                    raise ValueError(
                        f"fault_script[{i}]: churn_burst round must be "
                        f"a non-negative integer, got {round_!r}")
                if not (0.0 < frac <= 1.0):
                    raise ValueError(
                        f"fault_script[{i}]: churn_burst frac must be "
                        f"in (0, 1], got {frac!r}")
                continue
            if kind in _STOCHASTIC_KINDS:
                self._validate_stochastic_event(i, ev)
                continue
            _, start, end, param = ev
            if int(start) != start or int(end) != end:
                raise ValueError(
                    f"fault_script[{i}]: {kind} start/end must be "
                    f"integer rounds, got ({start!r}, {end!r})")
            if start == end:
                raise ValueError(
                    f"fault_script[{i}]: {kind} window [{start}, {end}) "
                    f"is zero-length: windows are END-EXCLUSIVE, so a "
                    f"start == end event never fires — use "
                    f"0 <= start < end")
            if not (0 <= start < end):
                raise ValueError(
                    f"fault_script[{i}]: {kind} rounds must satisfy "
                    f"0 <= start < end (end-exclusive window), got "
                    f"[{start}, {end})")
            if kind == "partition" and not (0.0 < param < 1.0):
                raise ValueError(
                    f"fault_script[{i}]: partition split_frac must be "
                    f"in (0, 1), got {param!r}")
            if kind == "regional_outage":
                if self.n_clusters < 2:
                    raise ValueError(
                        f"fault_script[{i}]: regional_outage needs a "
                        f"clustered topology (n_clusters > 1), got "
                        f"n_clusters={self.n_clusters}")
                if int(param) != param or not (0 <= param
                                               < self.n_clusters):
                    raise ValueError(
                        f"fault_script[{i}]: regional_outage cluster "
                        f"must be an integer in [0, "
                        f"{self.n_clusters}), got {param!r}")
            if kind == "latency_spike" and (int(param) != param
                                            or param < 1):
                raise ValueError(
                    f"fault_script[{i}]: latency_spike extra_rounds "
                    f"must be an integer >= 1, got {param!r}")
        # Two same-kind static events (same cluster for outages) active
        # in one round are ambiguous, so the merged script rejects them;
        # different clusters or kinds compose freely.
        windows: dict = {}
        for ev in self.fault_events():
            kind = ev[0]
            if kind in _STOCHASTIC_KINDS:
                continue
            if kind == "churn_burst":
                key, span = (kind,), (ev[1], ev[1] + 1)
            elif kind == "regional_outage":
                key, span = (kind, ev[3]), (ev[1], ev[2])
            else:
                key, span = (kind,), (ev[1], ev[2])
            for other in windows.setdefault(key, []):
                if span[0] < other[1] and other[0] < span[1]:
                    raise ValueError(
                        f"fault_script: overlapping {kind} events"
                        f"{' for cluster ' + str(ev[3]) if kind == 'regional_outage' else ''}"
                        f" — [{other[0]}, {other[1]}) and [{span[0]}, "
                        f"{span[1]}) are both active in round "
                        f"{max(other[0], span[0])} (partition_spec "
                        f"counts as a partition event)")
            windows[key].append(span)

    def _validate_stochastic_event(self, i: int, ev: Tuple) -> None:
        """One stochastic event: every field a (lo, hi) range with
        lo <= hi; start, length and extra rounds integers, frac a float
        range inside (0, 1)."""
        kind = ev[0]
        fields = _FAULT_EVENT_FIELDS[kind]

        def _range(name, value, *, integer, lo_min):
            if (not isinstance(value, tuple) or len(value) != 2):
                raise ValueError(
                    f"fault_script[{i}]: {kind} {name} must be a "
                    f"[lo, hi] range, got {value!r}")
            lo, hi = value
            for v in (lo, hi):
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    raise ValueError(
                        f"fault_script[{i}]: {kind} {name} bounds must "
                        f"be numbers, got {value!r}")
                if integer and int(v) != v:
                    raise ValueError(
                        f"fault_script[{i}]: {kind} {name} bounds must "
                        f"be integers, got {value!r}")
            if not (lo_min <= lo <= hi):
                raise ValueError(
                    f"fault_script[{i}]: {kind} {name} range must "
                    f"satisfy {lo_min} <= lo <= hi, got {value!r}")

        _range(fields[0], ev[1], integer=True, lo_min=0)       # start
        _range(fields[1], ev[2], integer=True, lo_min=1)       # length
        if kind == "stochastic_regional_outage":
            if self.n_clusters < 2:
                raise ValueError(
                    f"fault_script[{i}]: stochastic_regional_outage "
                    f"needs a clustered topology (n_clusters > 1), got "
                    f"n_clusters={self.n_clusters}")
            _range(fields[2], ev[3], integer=True, lo_min=0)   # cluster
            if ev[3][1] >= self.n_clusters:
                raise ValueError(
                    f"fault_script[{i}]: stochastic_regional_outage "
                    f"cluster range must stay inside [0, "
                    f"{self.n_clusters}), got {ev[3]!r}")
            return
        if kind == "stochastic_partition":
            lo, hi = (ev[3] if isinstance(ev[3], tuple) and len(ev[3]) == 2
                      else (None, None))
            for v in (lo, hi):
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    lo = None
                    break
            if lo is None or not (0.0 < lo <= hi < 1.0):
                raise ValueError(
                    f"fault_script[{i}]: stochastic_partition frac must "
                    f"be a [lo, hi] range inside (0, 1), got {ev[3]!r}")
        else:                                                  # spike
            _range(fields[2], ev[3], integer=True, lo_min=1)

    def _validate_rtt_matrix(self) -> None:
        """The cluster-pair RTT matrix must be square, match the
        clustered topology, and carry non-negative integer rounds."""
        if self.rtt_matrix is None:
            return
        matrix = tuple(tuple(row) for row in self.rtt_matrix)
        object.__setattr__(self, "rtt_matrix", matrix)
        c = self.n_clusters
        if len(matrix) != c or any(len(row) != c for row in matrix):
            raise ValueError(
                f"rtt_matrix must be n_clusters x n_clusters = "
                f"{c} x {c} (one row per querier cluster), got "
                f"{len(matrix)} row(s) of lengths "
                f"{[len(r) for r in matrix]}")
        for i, row in enumerate(matrix):
            for j, entry in enumerate(row):
                if int(entry) != entry or entry < 0:
                    raise ValueError(
                        f"rtt_matrix[{i}][{j}] must be a non-negative "
                        f"integer latency in rounds, got {entry!r}")

    def _validate_arrival(self) -> None:
        """The reference's rules for the live-traffic knobs: inert or
        out-of-range arrival configs are rejected at construction."""
        modes = ("off", "poisson", "bursty", "diurnal", "external")
        if self.arrival_mode not in modes:
            raise ValueError(
                f"arrival_mode must be one of {', '.join(modes)}, got "
                f"{self.arrival_mode!r}")
        if self.arrival_mode == "off":
            if self.arrival_rate != 0.0:
                raise ValueError(
                    f"arrival_rate is only read when arrival_mode is on, "
                    f"got rate {self.arrival_rate!r} with mode 'off' — a "
                    f"silently ignored rate would mislabel the run")
            if self.arrival_backpressure is not None:
                raise ValueError(
                    "arrival_backpressure is only read when arrival_mode "
                    "is on (occupancy throttles the arrival draw); with "
                    "mode 'off' it would be silently ignored")
            if self.arrival_cluster_weights is not None:
                raise ValueError(
                    "arrival_cluster_weights is only read when "
                    "arrival_mode is on (it scales the in-graph arrival "
                    "draw per region); with mode 'off' it would be "
                    "silently ignored")
            return
        if self.arrival_mode == "external":
            if self.arrival_rate != 0.0:
                raise ValueError(
                    f"arrival_mode 'external' draws nothing in-graph "
                    f"(arrivals are pushed via traffic.push_arrivals); "
                    f"got arrival_rate {self.arrival_rate!r} — use a "
                    f"schedule mode for in-graph offered load")
            if self.arrival_backpressure is not None:
                raise ValueError(
                    "arrival_backpressure throttles the in-graph "
                    "arrival DRAW, which arrival_mode 'external' never "
                    "performs (pushed arrivals are admitted as-is) — "
                    "a silently inert backpressure band would mislabel "
                    "the run as closed-loop")
        elif not (self.arrival_rate > 0.0):
            raise ValueError(
                f"arrival_mode {self.arrival_mode!r} needs "
                f"arrival_rate > 0 (mean admission units per round), "
                f"got {self.arrival_rate!r}")
        if self.arrival_mode in ("bursty", "diurnal"):
            if self.arrival_period < 2:
                raise ValueError(
                    f"arrival_mode {self.arrival_mode!r} needs "
                    f"arrival_period >= 2 rounds (the modulation cycle), "
                    f"got {self.arrival_period}")
        if self.arrival_mode == "bursty":
            if not (self.arrival_burst_factor > 1.0):
                raise ValueError(
                    f"bursty arrivals need arrival_burst_factor > 1 "
                    f"(otherwise the schedule is plain poisson), got "
                    f"{self.arrival_burst_factor!r}")
            if not (0.0 < self.arrival_duty < 1.0):
                raise ValueError(
                    f"arrival_duty must be in (0, 1) (the burst fraction "
                    f"of each cycle), got {self.arrival_duty!r}")
        if self.arrival_mode == "diurnal" and not (
                0.0 <= self.arrival_depth <= 1.0):
            raise ValueError(
                f"arrival_depth must be in [0, 1] (sinusoid modulation "
                f"depth), got {self.arrival_depth!r}")
        if self.arrival_backpressure is not None:
            bp = tuple(self.arrival_backpressure)
            object.__setattr__(self, "arrival_backpressure", bp)
            if len(bp) != 2:
                raise ValueError(
                    f"arrival_backpressure is (lo, hi) occupancy "
                    f"fractions, got {bp!r}")
            lo, hi = bp
            for v in bp:
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    raise ValueError(
                        f"arrival_backpressure bounds must be numbers, "
                        f"got {bp!r}")
            if not (0.0 <= lo < hi <= 1.0):
                raise ValueError(
                    f"arrival_backpressure needs 0 <= lo < hi <= 1 "
                    f"(full rate below lo, fully throttled above hi), "
                    f"got {bp!r}")
        if self.arrival_cluster_weights is not None:
            if self.arrival_mode == "external":
                raise ValueError(
                    "arrival_cluster_weights scales the in-graph arrival "
                    "DRAW, which arrival_mode 'external' never performs "
                    "(pushed arrivals are admitted as-is) — a silently "
                    "inert skew would mislabel the run as hot-region "
                    "traffic")
            if self.n_clusters < 2:
                raise ValueError(
                    "arrival_cluster_weights needs a clustered topology "
                    "(n_clusters > 1): the per-region admission blocks "
                    "derive from the same cluster partition as the node "
                    "clusters — with one cluster the skew is inert")
            wts = tuple(self.arrival_cluster_weights)
            object.__setattr__(self, "arrival_cluster_weights", wts)
            if len(wts) != self.n_clusters:
                raise ValueError(
                    f"arrival_cluster_weights is one rate multiplier per "
                    f"cluster (n_clusters = {self.n_clusters}), got "
                    f"{len(wts)} entries")
            for i, w in enumerate(wts):
                if isinstance(w, bool) or not isinstance(w, (int, float)) \
                        or not (w > 0.0) or not math.isfinite(w):
                    raise ValueError(
                        f"arrival_cluster_weights[{i}] must be a "
                        f"positive finite rate multiplier, got {w!r}")
        if self.arrival_latency_buckets < 2:
            raise ValueError(
                f"arrival_latency_buckets must be >= 2 (latencies clamp "
                f"into [0, buckets)), got {self.arrival_latency_buckets}")

    def _validate_stake(self) -> None:
        """The reference's rules for the stake and node-registry
        knobs."""
        modes = ("off", "uniform", "zipf", "explicit")
        if self.stake_mode not in modes:
            raise ValueError(
                f"stake_mode must be one of {', '.join(modes)}, got "
                f"{self.stake_mode!r}")
        if self.stake_mode == "zipf":
            if not (isinstance(self.stake_zipf_s, (int, float))
                    and not isinstance(self.stake_zipf_s, bool)
                    and self.stake_zipf_s > 0.0
                    and math.isfinite(self.stake_zipf_s)):
                raise ValueError(
                    f"stake_zipf_s must be a positive finite zipf "
                    f"exponent, got {self.stake_zipf_s!r}")
        elif self.stake_zipf_s != 1.0:
            raise ValueError(
                f"stake_zipf_s is only read by stake_mode 'zipf', got "
                f"exponent {self.stake_zipf_s!r} with mode "
                f"{self.stake_mode!r} — a silently ignored exponent "
                f"would mislabel the run")
        if self.stake_mode == "explicit":
            if self.stake_weights is None:
                raise ValueError(
                    "stake_mode 'explicit' needs a stake_weights vector "
                    "(one positive stake per node)")
            wts = tuple(self.stake_weights)
            object.__setattr__(self, "stake_weights", wts)
            if not wts:
                raise ValueError("stake_weights must be non-empty")
            for i, w in enumerate(wts):
                if isinstance(w, bool) or not isinstance(w, (int, float)) \
                        or not (w > 0.0) or not math.isfinite(w):
                    raise ValueError(
                        f"stake_weights[{i}] must be a positive finite "
                        f"stake, got {w!r}")
        elif self.stake_weights is not None:
            raise ValueError(
                f"stake_weights is only read by stake_mode 'explicit', "
                f"got a vector with mode {self.stake_mode!r} — a "
                f"silently ignored vector would mislabel the run")
        if self.stake_mode != "off":
            if not self.sample_with_replacement:
                raise ValueError(
                    "stake-weighted sampling requires "
                    "sample_with_replacement (same O(N^2) Gumbel-top-k "
                    "argument as weighted_sampling)")
            if self.latency_mode == "weighted":
                raise ValueError(
                    "stake_mode folds the stake vector into the "
                    "latency_weight sampling-propensity plane at init; "
                    "latency_mode 'weighted' reads that same plane to "
                    "derive response latency, which would silently "
                    "couple delay to stake — use fixed/geometric/rtt "
                    "latency with stake")
        # --- node registry (models/node_stream.py) ---
        if (self.registry_nodes > 0) != (self.active_nodes > 0):
            raise ValueError(
                f"registry_nodes and active_nodes come together (the "
                f"node-stream scheduler streams active_nodes resident "
                f"rows out of a registry_nodes population), got "
                f"registry_nodes={self.registry_nodes}, "
                f"active_nodes={self.active_nodes}")
        if self.registry_nodes < 0 or self.active_nodes < 0:
            raise ValueError("registry_nodes/active_nodes must be >= 0 "
                             "(0 disables the node registry)")
        if self.registry_nodes > 0:
            if self.stake_mode == "off":
                raise ValueError(
                    "the node registry draws its working set "
                    "STAKE-proportionally — registry_nodes > 0 needs a "
                    "stake_mode ('uniform' for uniform residency)")
            if not (self.active_nodes < self.registry_nodes):
                raise ValueError(
                    f"active_nodes ({self.active_nodes}) must be "
                    f"smaller than registry_nodes "
                    f"({self.registry_nodes}): churn rotates the window "
                    f"through a non-resident pool, which an "
                    f"active == registry config leaves empty")
            if (self.stake_mode == "explicit"
                    and len(self.stake_weights) != self.registry_nodes):
                raise ValueError(
                    f"with the node registry on, stake_weights is the "
                    f"REGISTRY's stake vector: expected "
                    f"{self.registry_nodes} entries, got "
                    f"{len(self.stake_weights)}")
        if not (0.0 <= self.node_churn_rate <= 1.0):
            raise ValueError(
                f"node_churn_rate must be in [0, 1], got "
                f"{self.node_churn_rate!r}")
        if self.node_churn_rate > 0.0 and self.registry_nodes == 0:
            raise ValueError(
                "node_churn_rate is only read by the node-stream "
                "scheduler (registry_nodes > 0) — without the registry "
                "the knob is inert and would mislabel the run")

    def _validate_adversary(self) -> None:
        """The reference's rules for the adversary fields: inert knobs
        with no byzantine nodes, the margin under withhold_near_quorum
        only, split_vote with FLIP only, timing with the async engine
        only, stake_eclipse with a stake mode only."""
        if not (0.0 <= self.byzantine_fraction <= 1.0):
            raise ValueError(
                f"byzantine_fraction must be in [0, 1], got "
                f"{self.byzantine_fraction!r}")
        if not (0.0 <= self.flip_probability <= 1.0):
            raise ValueError(
                f"flip_probability must be in [0, 1], got "
                f"{self.flip_probability!r}")
        if self.adversary_policy not in ADVERSARY_POLICIES:
            raise ValueError(
                f"adversary_policy must be one of "
                f"{', '.join(ADVERSARY_POLICIES)}, got "
                f"{self.adversary_policy!r}")
        if (isinstance(self.adversary_margin, bool)
                or not isinstance(self.adversary_margin, int)
                or self.adversary_margin < 0):
            raise ValueError(
                f"adversary_margin must be a non-negative integer "
                f"(window votes short of the quorum), got "
                f"{self.adversary_margin!r}")
        if self.byzantine_fraction == 0.0:
            inert = []
            if self.adversary_strategy is not AdversaryStrategy.FLIP:
                inert.append(
                    f"adversary_strategy={self.adversary_strategy.value}")
            if self.flip_probability != 1.0:
                inert.append(f"flip_probability={self.flip_probability!r}")
            if self.adversary_policy != "off":
                inert.append(f"adversary_policy={self.adversary_policy}")
            if self.adversary_margin != 1:
                inert.append(f"adversary_margin={self.adversary_margin}")
            if inert:
                raise ValueError(
                    f"{', '.join(inert)} set while byzantine_fraction "
                    f"== 0: with no byzantine nodes every adversary "
                    f"knob is inert and would mislabel the run as "
                    f"attacked — set byzantine_fraction > 0 (the "
                    f"byzantine mask is drawn at init from it)")
            return
        if (self.adversary_margin != 1
                and self.adversary_policy != "withhold_near_quorum"):
            raise ValueError(
                f"adversary_margin is only read by adversary_policy "
                f"'withhold_near_quorum', got margin "
                f"{self.adversary_margin} with policy "
                f"{self.adversary_policy!r} — a silently ignored margin "
                f"would mislabel the run")
        if (self.adversary_policy == "split_vote"
                and self.adversary_strategy is not AdversaryStrategy.FLIP):
            raise ValueError(
                f"adversary_policy 'split_vote' OVERRIDES the lie "
                f"content (lies vote the honest-minority color), so "
                f"adversary_strategy {self.adversary_strategy.value!r} "
                f"would be silently ignored and mislabel the run — "
                f"leave the strategy at its default under split_vote")
        if self.adversary_policy == "timing" and not self.async_queries():
            raise ValueError(
                "adversary_policy 'timing' delays lying responses "
                "through the in-flight latency plane (ops/inflight.py), "
                "which the synchronous ideal never builds — select a "
                "latency_mode (or schedule a cut/spike fault) to turn "
                "the async engine on")
        if (self.adversary_policy == "stake_eclipse"
                and self.stake_mode == "off"):
            raise ValueError(
                "adversary_policy 'stake_eclipse' concentrates lies on "
                "the top-STAKE queriers; with stake_mode 'off' every "
                "node is weightless and the eclipse set is arbitrary — "
                "select a stake_mode ('zipf' puts the adversary on top "
                "stake, the worst case)")

    def _validate_round_engine(self) -> None:
        """The whole-round megakernel covers the sync SEQUENTIAL round
        only; the same rejections, with the same exception types, as the
        reference's `_validate_round_engine`."""
        if self.round_engine not in ("phased", "megakernel"):
            raise ValueError(
                f"round_engine must be 'phased' or 'megakernel', "
                f"got {self.round_engine!r}")
        if self.round_engine == "phased":
            return
        if self.vote_mode is not VoteMode.SEQUENTIAL:
            raise ValueError(
                "round_engine 'megakernel' fuses the SEQUENTIAL "
                "window-ingest round; the MAJORITY reduction has no "
                "windowed ingest to fuse")
        if self.async_queries():
            raise ValueError(
                "round_engine 'megakernel' covers the synchronous "
                "round only: the in-flight ring (latency_mode / "
                "partition_spec / fault_script events) delivers votes "
                "ACROSS rounds, outside the one fused program — run "
                "the async lanes on round_engine 'phased'")
        if self.inflight_engine != "walk":
            raise ValueError(
                f"inflight_engine {self.inflight_engine!r} set with "
                f"round_engine 'megakernel': the kernel covers the "
                f"sync round, so the delivery-engine knob is inert "
                f"and would mislabel the A/B lane — leave it at "
                f"'walk' (the default)")
        if self.skip_absent_votes:
            raise ValueError(
                "round_engine 'megakernel' does not implement the "
                "skip_absent_votes lane gating — use round_engine "
                "'phased'")
        if (self.byzantine_fraction > 0.0 and self.adversary_strategy
                is AdversaryStrategy.EQUIVOCATE):
            raise ValueError(
                "round_engine 'megakernel' cannot reproduce the "
                "EQUIVOCATE strategy's per-draw keyed coin stream inside "
                "the kernel — run equivocation on round_engine 'phased'")
        if self.adversary_policy != "off":
            raise ValueError(
                f"adversary_policy {self.adversary_policy!r} set with "
                f"round_engine 'megakernel': the adaptive-adversary "
                f"context transforms run between the phases the "
                f"kernel fuses — run policy studies on round_engine "
                f"'phased'")


def inner_round_config(cfg: AvalancheConfig) -> AvalancheConfig:
    """The inner-round config a streaming scheduler passes to its wrapped
    consensus round: both telemetry taps (the metrics tap and the trace
    plane) zeroed, so the scheduler emits and writes exactly one record
    per round itself.  Returns `cfg` itself when no tap is on.  The
    reference's `suppress_taps`: its static analysis
    (`go_avalanche_tpu/analysis/lint.py`, canonical-spelling) reserves
    that name to its own module, which the port may not import, so the
    copy takes this name."""
    if cfg.metrics_every == 0 and cfg.trace_every == 0:
        return cfg
    return dataclasses.replace(cfg, metrics_every=0, trace_every=0)


DEFAULT_CONFIG = AvalancheConfig()
