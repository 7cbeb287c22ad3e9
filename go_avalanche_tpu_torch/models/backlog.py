"""Streaming backlog scheduler — `go_avalanche_tpu/models/backlog.py`.

A bounded window of W slots holds dense ``[nodes, W]`` consensus state
while the whole backlog waits as ``[B]`` metadata.  Each step retires the
slots whose tx the network has settled (their outcome is written to
per-tx outputs) and refills the freed slots from the backlog in
score-descending admission order, then runs one `models/avalanche`
round on the window.  Retire and refill are masks, one cumsum and
scatters on the device; `run` reads one scalar back per round to decide
whether to go on, as the reference's `lax.while_loop` checks `drained`
before every step.

With `cfg.arrivals_enabled()` the state carries the live-traffic plane
(`traffic.py`): admission is gated on the arrived watermark and retiring
slots record their arrival -> settle latency.  Under async queries the
freed columns leave every pending ring entry's poll mask
(`ops/inflight.clear_columns`).  The scheduler owns the flight recorder:
each step emits and writes one full `BacklogTelemetry` record (the
traffic fields only with arrivals on) into `sim.trace`, and silences the
inner round's taps through `config.inner_round_config`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from go_avalanche_tpu_torch import sync
from go_avalanche_tpu_torch import traffic as tf
from go_avalanche_tpu_torch.config import (AvalancheConfig, DEFAULT_CONFIG,
                                           inner_round_config)
from go_avalanche_tpu_torch.models import avalanche as av
from go_avalanche_tpu_torch.obs import sink as obs_sink
from go_avalanche_tpu_torch.obs import trace as obs_trace
from go_avalanche_tpu_torch.ops import inflight
from go_avalanche_tpu_torch.ops import voterecord as vr
from go_avalanche_tpu_torch.utils.tracing import annotate

NO_TX = -1   # empty-slot sentinel
# The score of an empty slot: below every real score, so it polls last.
EMPTY_SCORE = -2**31 + 1


class Backlog(NamedTuple):
    """Per-tx metadata of the whole pending set, in admission order."""

    score: torch.Tensor      # int32 [B]
    init_pref: torch.Tensor  # bool  [B]
    valid: torch.Tensor      # bool  [B]


class BacklogOutputs(NamedTuple):
    """Per-tx settlement results, written as slots retire; ``[B]``."""

    settled: torch.Tensor       # bool
    accepted: torch.Tensor      # bool — network-majority final preference
    accept_votes: torch.Tensor  # int32 — nodes finalized-accepted
    settle_round: torch.Tensor  # int32 — global round at retirement
    admit_round: torch.Tensor   # int32 — global round at admission


class BacklogSimState(NamedTuple):
    """Active window + backlog + outputs (+ the traffic plane)."""

    sim: av.AvalancheSimState        # dense [N, W] window state
    slot_tx: torch.Tensor            # int32 [W] — backlog index, NO_TX empty
    slot_admit_round: torch.Tensor   # int32 [W]
    backlog: Backlog                 # [B]
    outputs: BacklogOutputs          # [B]
    next_idx: torch.Tensor           # int32 — next unadmitted position
    traffic: Optional[tf.TrafficState] = None


class BacklogTelemetry(NamedTuple):
    """Per-step scalars: the inner round's telemetry plus scheduler
    stats."""

    round: av.SimTelemetry
    retired: torch.Tensor       # int32 — slots retired this step
    occupied: torch.Tensor      # int32 — occupied slots after refill
    backlog_left: torch.Tensor  # int32 — txs not yet admitted
    traffic: Optional[tf.TrafficTelemetry] = None


def trace_columns(cfg: AvalancheConfig) -> tuple:
    """The scheduler's trace-plane column manifest: the inner round's
    `SimTelemetry` fields, the scheduler stats, then the traffic fields
    when the arrival plane is on — the JSONL flattening order of
    `BacklogTelemetry`."""
    groups = [av.SimTelemetry._fields,
              ("retired", "occupied", "backlog_left")]
    if cfg.arrivals_enabled():
        groups.append(tf.TrafficTelemetry._fields)
    return obs_trace.columns_from_fields(*groups)


def with_trace(state: "BacklogSimState", cfg: AvalancheConfig,
               n_rounds: int) -> "BacklogSimState":
    """Attach the trace plane, owned by the scheduler (full
    `BacklogTelemetry` rows; the inner round's write is silenced).
    No-op when `cfg.trace_every == 0`."""
    return state._replace(sim=state.sim._replace(
        trace=obs_trace.alloc(cfg, n_rounds, trace_columns(cfg),
                              state.slot_tx.device)))


def stack_tree(rows: list):
    """Per-step telemetry rows (nested NamedTuples of scalars, or None)
    stacked leaf by leaf along a new leading axis."""
    first = rows[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return type(first)(*(stack_tree(list(col)) for col in zip(*rows)))
    return torch.stack(rows)


def set_drop(plane: torch.Tensor, idx: torch.Tensor,
             values) -> torch.Tensor:
    """``plane.at[idx].set(values, mode="drop")`` along the first axis:
    rows ``idx == len(plane)`` are dropped (written to a spare row that
    is cut off), the others must be distinct.  A new tensor."""
    n = plane.shape[0]
    out = torch.cat([plane, plane[:1]])
    if not isinstance(values, torch.Tensor):   # filled on the device
        values = torch.full((), values, dtype=plane.dtype,
                            device=plane.device)
    out[idx.long()] = values.to(device=plane.device, dtype=plane.dtype)
    return out[:n]


def make_backlog(scores: torch.Tensor,
                 init_pref: Optional[torch.Tensor] = None,
                 valid: Optional[torch.Tensor] = None) -> Backlog:
    """Sort txs into score-descending admission order (stable on ties),
    on the scores' device."""
    scores = torch.as_tensor(scores).to(torch.int32)
    b, dev = scores.shape[0], scores.device
    if init_pref is None:
        init_pref = torch.ones(b, dtype=torch.bool, device=dev)
    if valid is None:
        valid = torch.ones(b, dtype=torch.bool, device=dev)
    order = torch.argsort(-scores, stable=True)
    return Backlog(score=scores[order],
                   init_pref=init_pref.to(dev, torch.bool)[order],
                   valid=valid.to(dev, torch.bool)[order])


def init(key: torch.Tensor, n_nodes: int, window: int, backlog: Backlog,
         cfg: AvalancheConfig = DEFAULT_CONFIG, track_finality: bool = True,
         device="cuda") -> BacklogSimState:
    """Empty window over a fresh backlog on `device` (the card unless the
    caller asks for the CPU); the first refill happens in step 0."""
    dev = av._device(device)
    key = key.to(dev)
    backlog = av.move_leaves(backlog, dev)
    b = backlog.score.shape[0]
    sim = av.init(key, n_nodes, window, cfg,
                  added=torch.zeros((n_nodes, window), dtype=torch.bool),
                  valid=torch.zeros(window, dtype=torch.bool),
                  track_finality=track_finality, device=dev)

    def full(value, dtype):
        return torch.full((b,), value, dtype=dtype, device=dev)

    return BacklogSimState(
        sim=sim,
        slot_tx=torch.full((window,), NO_TX, dtype=torch.int32, device=dev),
        slot_admit_round=torch.zeros(window, dtype=torch.int32, device=dev),
        backlog=backlog,
        outputs=BacklogOutputs(
            settled=full(False, torch.bool),
            accepted=full(False, torch.bool),
            accept_votes=full(0, torch.int32),
            settle_round=full(-1, torch.int32),
            admit_round=full(-1, torch.int32)),
        next_idx=torch.zeros((), dtype=torch.int32, device=dev),
        traffic=tf.init_traffic(cfg, key, b),
    )


def _settled_slots(state: BacklogSimState,
                   cfg: AvalancheConfig) -> torch.Tensor:
    """bool [W]: occupied slots the network is done with — every live
    node that holds the tx finalized it, or the tx is invalid."""
    sim = state.sim
    occupied = state.slot_tx != NO_TX
    fin = vr.has_finalized(sim.records.confidence, cfg)
    pending = sim.added & sim.alive[:, None] & ~fin
    return occupied & (~pending.any(dim=0) | ~sim.valid)


def refill_slots(sim: av.AvalancheSimState, queue: Backlog,
                 settled: torch.Tensor, take: torch.Tensor,
                 cand: torch.Tensor, new_tx: torch.Tensor
                 ) -> av.AvalancheSimState:
    """The window after a retire and refill pass: `take` slots seed fresh
    records from their backlog entries `cand` on every node, the other
    slots keep theirs (cleared where `new_tx` is empty), and the scores,
    poll-order ranks, finality stamps and in-flight columns follow."""
    b = queue.score.shape[0]
    cand_safe = cand.clamp(0, b - 1).long()
    fresh = vr.init_state(queue.init_pref[cand_safe][None, :])
    records = vr.VoteRecordState(*(torch.where(take[None, :], f, p)
                                   for p, f in zip(sim.records, fresh)))
    occupied_after = new_tx != NO_TX
    # Admission seeds every node; retired slots clear.
    added = take[None, :] | (sim.added & occupied_after[None, :])
    valid = torch.where(take, queue.valid[cand_safe],
                        sim.valid & occupied_after)
    score = torch.where(occupied_after,
                        queue.score[new_tx.clamp(0, b - 1).long()],
                        EMPTY_SCORE)
    score_rank, poll_order, poll_order_inv = av.score_rank_with_orders(score)
    return sim._replace(
        records=records, added=added, valid=valid, score_rank=score_rank,
        poll_order=poll_order, poll_order_inv=poll_order_inv,
        finalized_at=av.reset_finality(sim.finalized_at, take),
        # Responses still in flight for a retired slot must not land on
        # its new occupant.
        inflight=inflight.clear_columns(sim.inflight, settled | take))


def _retire_and_refill(state: BacklogSimState, cfg: AvalancheConfig,
                       refill: bool = True
                       ) -> Tuple[BacklogSimState, torch.Tensor]:
    """Write settled slots' outcomes to the [B] outputs and refill the
    free slots from the backlog.  Returns (new_state, slots retired).
    With `refill=False` (the end-of-run harvest) settled slots empty
    instead of taking new txs."""
    sim = state.sim
    settled = _settled_slots(state, cfg)
    b = state.backlog.score.shape[0]
    conf = sim.records.confidence
    fin = vr.has_finalized(conf, cfg)
    accept_votes = (fin & vr.is_accepted(conf) & sim.added).sum(
        dim=0, dtype=torch.int32)
    n_live = sim.alive.sum(dtype=torch.int32).clamp_min(1)
    accepted = accept_votes * 2 > n_live

    # --- retire: outcomes at the retiring slots' tx indices (b = drop).
    idx = torch.where(settled, state.slot_tx, b)
    out = state.outputs
    out = BacklogOutputs(
        settled=set_drop(out.settled, idx, True),
        accepted=set_drop(out.accepted, idx, accepted),
        accept_votes=set_drop(out.accept_votes, idx, accept_votes),
        settle_round=set_drop(out.settle_round, idx,
                              sim.round.expand(idx.shape)),
        admit_round=set_drop(out.admit_round, idx, state.slot_admit_round))

    # --- live traffic: retiring slots record arrival -> settle latency.
    traffic = state.traffic
    if traffic is not None:
        arr = traffic.arrival_round[state.slot_tx.clamp(0, b - 1).long()]
        traffic = traffic._replace(lat_hist=traffic.lat_hist + tf.latency_delta(
            cfg, sim.round - arr, settled.to(torch.int32)))

    # --- refill: free slots take the next backlog txs in admission order.
    free = settled | (state.slot_tx == NO_TX)
    rank = torch.cumsum(free.to(torch.int32), dim=0, dtype=torch.int32) - 1
    cand = state.next_idx + rank
    avail = (b if traffic is None
             else torch.clamp_max(traffic.arrived_idx, b))
    take = free & (cand < avail)
    if not refill:
        take = torch.zeros_like(take)
    new_tx = torch.where(take, cand,
                         torch.where(settled, NO_TX, state.slot_tx))
    n_taken = take.sum(dtype=torch.int32)

    new_sim = refill_slots(sim, state.backlog, settled, take, cand, new_tx)
    return BacklogSimState(
        sim=new_sim,
        slot_tx=new_tx,
        slot_admit_round=torch.where(take, sim.round, state.slot_admit_round),
        backlog=state.backlog,
        outputs=out,
        next_idx=state.next_idx + n_taken,
        traffic=traffic,
    ), settled.sum(dtype=torch.int32)


def step(state: BacklogSimState, cfg: AvalancheConfig = DEFAULT_CONFIG
         ) -> Tuple[BacklogSimState, BacklogTelemetry]:
    """Arrive (traffic mode), retire/refill, then one consensus round on
    the window."""
    if cfg.round_engine != "phased":
        raise ValueError(
            "round_engine 'megakernel' is wired for the dense avalanche "
            "round only; the backlog window scheduler keeps the phased "
            "inner round (the window width need not satisfy the "
            "kernel's tiling contract) — the knob would be inert here")
    round_val = state.sim.round
    arrivals = torch.zeros((), dtype=torch.int32,
                           device=state.slot_tx.device)
    if state.traffic is not None:
        new_traffic, arrivals = tf.arrive(
            state.traffic, cfg, round_val,
            (state.slot_tx != NO_TX).sum(dtype=torch.int32),
            state.slot_tx.shape[0])
        state = state._replace(traffic=new_traffic)
    with annotate("retire_refill"):
        state, retired = _retire_and_refill(state, cfg)
    new_sim, round_tel = av.round_step(state.sim, inner_round_config(cfg))
    tel = BacklogTelemetry(
        round=round_tel,
        retired=retired,
        occupied=(state.slot_tx != NO_TX).sum(dtype=torch.int32),
        backlog_left=state.backlog.score.shape[0] - state.next_idx,
        traffic=(None if state.traffic is None
                 else tf.traffic_telemetry(state.traffic, arrivals)),
    )
    obs_sink.emit_round(cfg, round_val, tel)
    new_sim = new_sim._replace(
        trace=obs_trace.write_round(new_sim.trace, cfg, round_val, tel))
    return state._replace(sim=new_sim), tel


def drained(state: BacklogSimState,
            cfg: AvalancheConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """True when the backlog is exhausted and every occupied slot
    settled (one device bool)."""
    exhausted = state.next_idx >= state.backlog.score.shape[0]
    occupied = state.slot_tx != NO_TX
    return exhausted & ~(occupied & ~_settled_slots(state, cfg)).any()


def run(state: BacklogSimState, cfg: AvalancheConfig = DEFAULT_CONFIG,
        max_rounds: int = 100_000, device="cuda") -> BacklogSimState:
    """Stream the whole backlog through the window on `device`, reading
    `drained` back once per round; a final retire pass harvests the last
    settled slots' outputs."""
    state = av.move_leaves(state, av._device(device))
    rounds = sync.read(state.sim.round)
    while rounds < max_rounds and not sync.read(drained(state, cfg)):
        state = step(state, cfg)[0]
        rounds += 1
    return _retire_and_refill(state, cfg, refill=False)[0]


def run_scan(state: BacklogSimState, cfg: AvalancheConfig = DEFAULT_CONFIG,
             n_rounds: int = 1000, device="cuda"
             ) -> Tuple[BacklogSimState, BacklogTelemetry]:
    """`n_rounds` steps on `device` with stacked per-step telemetry."""
    state = av.move_leaves(state, av._device(device))
    rows = []
    for _ in range(n_rounds):
        state, tel = step(state, cfg)
        rows.append(tel)
    return state, stack_tree(rows)
