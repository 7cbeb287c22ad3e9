"""Streaming conflict-set DAG — `go_avalanche_tpu/models/streaming_dag.py`.

The admission unit of `models/backlog` becomes the whole conflict set:
the window is ``S_w`` set-slots of ``c`` contiguous tx slots, so its
conflict partition is the constant ``arange(W) // c`` whatever sets
occupy it, and the inner round is exactly `models/dag.round_step`.  The
pending conflict graph waits as ``[S_b, c]`` metadata (short sets pad
with invalid lanes).  A set-slot retires when no (live node, member)
pair is pollable any more; its members' outcomes are written to
``[S_b, c]`` outputs and free set-slots refill in score-descending
order (a set scores as its best valid member).

`cfg.stream_retire_cap` caps how many set-slots retire and refill a
round and rewrites only their columns; when a round's free slots fit
the cap the trajectory equals the dense path.  `run_chunked` is `run`
dispatched in `chunk`-round pieces with a `progress` hook, saving an npz
checkpoint (`utils/checkpoint.py`) every few pieces on a background
thread when asked.
Under async queries the freed columns leave every pending ring entry's
poll mask (`ops/inflight.clear_columns`).  The scheduler owns the flight
recorder, as `models/backlog` does: one full `StreamingDagTelemetry`
record a step, into `dag.base.trace`, with the inner round's taps
silenced.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from go_avalanche_tpu_torch import sync
from go_avalanche_tpu_torch import traffic as tf
from go_avalanche_tpu_torch.config import (AvalancheConfig, DEFAULT_CONFIG,
                                           inner_round_config)
from go_avalanche_tpu_torch.models import avalanche as av
from go_avalanche_tpu_torch.models import dag as dag_model
from go_avalanche_tpu_torch.models.backlog import (EMPTY_SCORE, NO_TX,
                                                   set_drop, stack_tree)
from go_avalanche_tpu_torch.obs import sink as obs_sink
from go_avalanche_tpu_torch.obs import trace as obs_trace
from go_avalanche_tpu_torch.ops import inflight
from go_avalanche_tpu_torch.ops import voterecord as vr
from go_avalanche_tpu_torch.utils.tracing import annotate

NO_SET = NO_TX   # empty set-slot sentinel (-1)


class SetBacklog(NamedTuple):
    """The pending conflict graph, ``[S_b, c]`` member planes in
    admission order."""

    score: torch.Tensor      # int32 [S_b, c]
    init_pref: torch.Tensor  # bool  [S_b, c]
    valid: torch.Tensor      # bool  [S_b, c]


class SetOutputs(NamedTuple):
    """Per-member settlement results, written as sets retire;
    ``[S_b, c]``."""

    settled: torch.Tensor       # bool
    accepted: torch.Tensor      # bool — network-majority winner lane
    accept_votes: torch.Tensor  # int32 — nodes finalized-accepted
    settle_round: torch.Tensor  # int32
    admit_round: torch.Tensor   # int32


class StreamingDagState(NamedTuple):
    """Active conflict window + set backlog + outputs (+ traffic)."""

    dag: dag_model.DagSimState       # [N, W] window, arange(W) // c
    slot_set: torch.Tensor           # int32 [S_w] — backlog set per slot
    slot_admit_round: torch.Tensor   # int32 [S_w]
    backlog: SetBacklog              # [S_b, c]
    outputs: SetOutputs              # [S_b, c]
    next_idx: torch.Tensor           # int32 — next unadmitted set
    traffic: Optional[tf.TrafficState] = None


class StreamingDagTelemetry(NamedTuple):
    """Per-step scalars: the inner DAG round's telemetry plus scheduler
    stats."""

    round: av.SimTelemetry
    retired_sets: torch.Tensor   # int32 — set-slots retired this step
    occupied_sets: torch.Tensor  # int32 — occupied set-slots after refill
    backlog_left: torch.Tensor   # int32 — sets not yet admitted
    traffic: Optional[tf.TrafficTelemetry] = None


def trace_columns(cfg: AvalancheConfig) -> tuple:
    """The set scheduler's trace-plane column manifest: the JSONL
    flattening order of `StreamingDagTelemetry`."""
    groups = [av.SimTelemetry._fields,
              ("retired_sets", "occupied_sets", "backlog_left")]
    if cfg.arrivals_enabled():
        groups.append(tf.TrafficTelemetry._fields)
    return obs_trace.columns_from_fields(*groups)


def with_trace(state: StreamingDagState, cfg: AvalancheConfig,
               n_rounds: int) -> StreamingDagState:
    """Attach the trace plane, owned by the scheduler (the inner conflict
    round's write is silenced).  No-op when `cfg.trace_every == 0`."""
    base = state.dag.base
    return state._replace(dag=state.dag._replace(base=base._replace(
        trace=obs_trace.alloc(cfg, n_rounds, trace_columns(cfg),
                              base.round.device))))


def set_capacity(state: StreamingDagState) -> int:
    return state.backlog.score.shape[1]


def make_set_backlog(scores: torch.Tensor,
                     init_pref: Optional[torch.Tensor] = None,
                     valid: Optional[torch.Tensor] = None) -> SetBacklog:
    """Sort ``[S_b, c]`` sets into score-descending admission order
    (stable on ties) by their best valid member's score; `init_pref`
    defaults to "first valid member preferred"."""
    scores = torch.as_tensor(scores).to(torch.int32)
    s_b, c = scores.shape
    dev = scores.device
    if valid is None:
        valid = torch.ones((s_b, c), dtype=torch.bool, device=dev)
    valid = valid.to(dev, torch.bool)
    if init_pref is None:
        first_valid = torch.argmax(valid.to(torch.uint8), dim=1)
        init_pref = ((torch.arange(c, device=dev)[None, :]
                      == first_valid[:, None]) & valid)
    init_pref = init_pref.to(dev, torch.bool)
    set_score = torch.where(valid, scores, EMPTY_SCORE).amax(dim=1)
    order = torch.argsort(-set_score, stable=True)
    return SetBacklog(score=scores[order], init_pref=init_pref[order],
                      valid=valid[order])


def init(key: torch.Tensor, n_nodes: int, window_sets: int,
         backlog: SetBacklog, cfg: AvalancheConfig = DEFAULT_CONFIG,
         track_finality: bool = True, device="cuda") -> StreamingDagState:
    """Empty window over a fresh set backlog on `device` (the card
    unless the caller asks for the CPU); the first refill is in step 0."""
    dev = av._device(device)
    key = key.to(dev)
    backlog = av.move_leaves(backlog, dev)
    s_b, c = backlog.score.shape
    w = window_sets * c
    base = av.init(key, n_nodes, w, cfg,
                   added=torch.zeros((n_nodes, w), dtype=torch.bool),
                   valid=torch.zeros(w, dtype=torch.bool),
                   track_finality=track_finality, device=dev)
    window = dag_model.DagSimState(
        base=base,
        conflict_set=torch.arange(w, dtype=torch.int32, device=dev) // c,
        n_sets=window_sets,
        set_size=c)
    zeros = torch.zeros((s_b, c), dtype=torch.int32, device=dev)
    return StreamingDagState(
        dag=window,
        slot_set=torch.full((window_sets,), NO_SET, dtype=torch.int32,
                            device=dev),
        slot_admit_round=torch.zeros(window_sets, dtype=torch.int32,
                                     device=dev),
        backlog=backlog,
        outputs=SetOutputs(
            settled=torch.zeros((s_b, c), dtype=torch.bool, device=dev),
            accepted=torch.zeros((s_b, c), dtype=torch.bool, device=dev),
            accept_votes=zeros,
            settle_round=zeros - 1,
            admit_round=zeros - 1),
        next_idx=torch.zeros((), dtype=torch.int32, device=dev),
        traffic=tf.init_traffic(cfg, key, s_b),
    )


def _settled_set_slots(state: StreamingDagState,
                       cfg: AvalancheConfig) -> torch.Tensor:
    """bool [S_w]: occupied set-slots with no (live node, member) pair
    still pollable — the round's pollable mask, per set."""
    base = state.dag.base
    n, w = base.records.votes.shape
    c = set_capacity(state)
    s_w = w // c
    fin = vr.has_finalized(base.records.confidence, cfg)
    fin_acc = fin & vr.is_accepted(base.records.confidence)
    node_set_done = fin_acc.reshape(n, s_w, c).any(dim=2)        # [N, S_w]
    rival_settled = node_set_done.repeat_interleave(c, dim=1) & ~fin_acc
    pending = (base.added & base.alive[:, None] & base.valid[None, :]
               & ~fin & ~rival_settled)
    pending_set = pending.reshape(n, s_w, c).any(dim=2).any(dim=0)
    return (state.slot_set != NO_SET) & ~pending_set


def _first_true(mask: torch.Tensor, size: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=len(mask))[0]`` with no
    host read: the first `size` True positions ascending, then fill."""
    n = mask.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=mask.device)
    return torch.sort(torch.where(mask, pos, n)).values[:size]


def refill_planes(base, settled: torch.Tensor, take: torch.Tensor,
                  occupied_after_w: torch.Tensor, pref_rows: torch.Tensor,
                  k_slots: Optional[int] = None) -> tuple:
    """``(records, added, finalized_at)`` of the window after a retire
    and refill pass: `take` (bool ``[S_w]``) set-slots seed fresh records
    from `pref_rows` (``[S_w, c]``) on every node and `settled` ones
    clear.  With `k_slots` (the retire cap) only the columns of the at
    most `k_slots` slots that change are rewritten."""
    w = base.records.votes.shape[1]
    s_w, c = pref_rows.shape
    take_w = take.repeat_interleave(c)                           # [W]
    if k_slots is not None:
        # Columns of the slots that change (retire or admit).  The
        # reference pads the slot list with s_w, whose columns its
        # scatter drops; here a pad entry repeats the first listed slot
        # (the same columns, the same values), so the writes are the
        # reference's without a host read.
        changed = settled | take
        slot_ids = _first_true(changed, k_slots)                 # [K]
        first = slot_ids[:1].clamp_max(s_w - 1)
        sid = torch.where(slot_ids < s_w, slot_ids, first).long()
        lanes = torch.arange(c, device=sid.device)
        cols = (sid[:, None] * c + lanes[None, :]).reshape(-1)   # [K*c]
        take_cols = take[sid].repeat_interleave(c)[None, :]
        real_cols = changed[sid].repeat_interleave(c)[None, :]
        fresh = vr.init_state(pref_rows[sid].reshape(-1)[None, :])

        def fill_cols(plane, fresh_plane):
            # Admitted columns seed fresh; retiring-only columns keep
            # their values (added and valid mask them out of every poll).
            new = plane.clone()
            new[:, cols] = torch.where(take_cols, fresh_plane,
                                       plane[:, cols])
            return new

        records = vr.VoteRecordState(*(fill_cols(p, f) for p, f in
                                       zip(base.records, fresh)))
        # A retiring column clears and an admitted one seeds every node;
        # a pad entry of an unchanged slot writes its values back.
        added = base.added.clone()
        added[:, cols] = torch.where(real_cols, take_cols,
                                     base.added[:, cols])
        finalized_at = base.finalized_at
        if finalized_at is not None:   # stamps reset at admitted columns
            finalized_at = fill_cols(finalized_at, -1)
        return records, added, finalized_at
    fresh = vr.init_state(pref_rows.reshape(w)[None, :])

    def fill(plane, fresh_plane):
        return torch.where(take_w[None, :], fresh_plane, plane)

    records = vr.VoteRecordState(*(fill(p, f) for p, f in
                                   zip(base.records, fresh)))
    # Admission seeds every node; retired slots clear.
    added = take_w[None, :] | (base.added & occupied_after_w[None, :])
    return records, added, av.reset_finality(base.finalized_at, take_w)


def _retire_and_refill(state: StreamingDagState, cfg: AvalancheConfig,
                       refill: bool = True
                       ) -> Tuple[StreamingDagState, torch.Tensor]:
    """Write retiring sets' member outcomes and refill free set-slots.
    Returns (new_state, sets retired).  With `cfg.stream_retire_cap`
    (and `refill`) at most that many set-slots retire or admit, and only
    their columns are rewritten; the end-of-run harvest always runs
    dense."""
    base = state.dag.base
    n, w = base.records.votes.shape
    c = set_capacity(state)
    s_w = w // c
    s_b = state.backlog.score.shape[0]
    settled = _settled_set_slots(state, cfg)
    empty = state.slot_set == NO_SET
    cap = cfg.stream_retire_cap
    sparse = refill and cap is not None
    if sparse:
        k_slots = min(cap, s_w)
        pool = settled | empty
        participate = pool & (torch.cumsum(pool.to(torch.int32), dim=0)
                              - 1 < k_slots)
        settled = settled & participate
        free = participate
    else:
        free = settled | empty

    # --- live traffic: one latency sample per valid member of a
    # retiring set.
    traffic = state.traffic
    if traffic is not None:
        rows_safe = state.slot_set.clamp(0, s_b - 1).long()
        lat = base.round - traffic.arrival_round[rows_safe]
        members = state.backlog.valid[rows_safe].sum(dim=1,
                                                     dtype=torch.int32)
        traffic = traffic._replace(lat_hist=traffic.lat_hist + tf.latency_delta(
            cfg, lat, torch.where(settled, members, 0)))

    # --- retire: member outcomes at the retiring sets' rows (s_b = drop).
    conf = base.records.confidence
    fin_acc = vr.has_finalized(conf, cfg) & vr.is_accepted(conf)
    accept_votes = (fin_acc & base.added).sum(dim=0, dtype=torch.int32)
    n_live = base.alive.sum(dtype=torch.int32).clamp_min(1)
    accepted = accept_votes * 2 > n_live
    row_idx = torch.where(settled, state.slot_set, s_b)
    out = state.outputs

    def scatter(plane, rows):
        if not isinstance(rows, torch.Tensor):   # filled on the device
            rows = torch.full((), rows, dtype=plane.dtype,
                              device=plane.device)
        return set_drop(plane, row_idx, rows.to(plane).expand(s_w, c))

    out = SetOutputs(
        settled=scatter(out.settled, True),
        accepted=scatter(out.accepted, accepted.reshape(s_w, c)),
        accept_votes=scatter(out.accept_votes, accept_votes.reshape(s_w, c)),
        settle_round=scatter(out.settle_round, base.round),
        admit_round=scatter(out.admit_round,
                            state.slot_admit_round[:, None]))

    # --- refill: free set-slots take the next backlog sets in order.
    rank = torch.cumsum(free.to(torch.int32), dim=0, dtype=torch.int32) - 1
    cand = state.next_idx + rank
    avail = (s_b if traffic is None
             else torch.clamp_max(traffic.arrived_idx, s_b))
    take = free & (cand < avail)
    if not refill:   # end-of-run harvest: record outcomes, admit nothing
        take = torch.zeros_like(take)
    new_set = torch.where(take, cand,
                          torch.where(settled, NO_SET, state.slot_set))
    n_taken = take.sum(dtype=torch.int32)

    cand_safe = cand.clamp(0, s_b - 1).long()
    pref_rows = state.backlog.init_pref[cand_safe]               # [S_w, c]
    take_w = take.repeat_interleave(c)                           # [W]
    occupied_after_w = (new_set != NO_SET).repeat_interleave(c)

    records, added, finalized_at = refill_planes(
        base, settled, take, occupied_after_w, pref_rows,
        k_slots if sparse else None)
    valid = torch.where(take_w, state.backlog.valid[cand_safe].reshape(w),
                        base.valid & occupied_after_w)
    score = torch.where(
        occupied_after_w,
        state.backlog.score[new_set.clamp(0, s_b - 1).long()].reshape(w),
        EMPTY_SCORE)
    score_rank, poll_order, poll_order_inv = av.score_rank_with_orders(score)
    new_base = base._replace(
        records=records, added=added, valid=valid, score_rank=score_rank,
        poll_order=poll_order, poll_order_inv=poll_order_inv,
        finalized_at=finalized_at,
        # Responses still in flight for a retired set-slot must not land
        # on its new occupant.
        inflight=inflight.clear_columns(base.inflight,
                                        (settled | take).repeat_interleave(c)))
    return StreamingDagState(
        dag=state.dag._replace(base=new_base),
        slot_set=new_set,
        slot_admit_round=torch.where(take, base.round,
                                     state.slot_admit_round),
        backlog=state.backlog,
        outputs=out,
        next_idx=state.next_idx + n_taken,
        traffic=traffic,
    ), settled.sum(dtype=torch.int32)


def step(state: StreamingDagState, cfg: AvalancheConfig = DEFAULT_CONFIG
         ) -> Tuple[StreamingDagState, StreamingDagTelemetry]:
    """Arrive (traffic mode), retire/refill at set granularity, then one
    conflict round."""
    round_val = state.dag.base.round
    arrivals = torch.zeros((), dtype=torch.int32,
                           device=state.slot_set.device)
    if state.traffic is not None:
        new_traffic, arrivals = tf.arrive(
            state.traffic, cfg, round_val,
            (state.slot_set != NO_SET).sum(dtype=torch.int32),
            state.slot_set.shape[0])
        state = state._replace(traffic=new_traffic)
    with annotate("retire_refill"):
        state, retired = _retire_and_refill(state, cfg)
    new_dag, round_tel = dag_model.round_step(state.dag, inner_round_config(cfg))
    tel = StreamingDagTelemetry(
        round=round_tel,
        retired_sets=retired,
        occupied_sets=(state.slot_set != NO_SET).sum(dtype=torch.int32),
        backlog_left=state.backlog.score.shape[0] - state.next_idx,
        traffic=(None if state.traffic is None
                 else tf.traffic_telemetry(state.traffic, arrivals)),
    )
    obs_sink.emit_round(cfg, round_val, tel)
    new_dag = new_dag._replace(base=new_dag.base._replace(
        trace=obs_trace.write_round(new_dag.base.trace, cfg, round_val,
                                    tel)))
    return state._replace(dag=new_dag), tel


def drained(state: StreamingDagState,
            cfg: AvalancheConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """True when the backlog is exhausted and every occupied slot
    settled (one device bool)."""
    exhausted = state.next_idx >= state.backlog.score.shape[0]
    occupied = state.slot_set != NO_SET
    return exhausted & ~(occupied & ~_settled_set_slots(state, cfg)).any()


def run(state: StreamingDagState, cfg: AvalancheConfig = DEFAULT_CONFIG,
        max_rounds: int = 100_000, device="cuda") -> StreamingDagState:
    """Stream the whole conflict graph through the window on `device`,
    reading `drained` back once per round, then harvest."""
    state = av.move_leaves(state, av._device(device))
    rounds = sync.read(state.dag.base.round)
    while rounds < max_rounds and not sync.read(drained(state, cfg)):
        state = step(state, cfg)[0]
        rounds += 1
    return _retire_and_refill(state, cfg, refill=False)[0]


def run_chunked(state: StreamingDagState,
                cfg: AvalancheConfig = DEFAULT_CONFIG,
                max_rounds: int = 100_000, chunk: int = 256,
                checkpoint_path: Optional[str] = None,
                checkpoint_every_chunks: int = 8,
                checkpoint_fetch_bytes: Optional[int] = 64 << 20,
                checkpoint_fetch_timeout_s: Optional[float] = 120.0,
                progress=None, device="cuda") -> StreamingDagState:
    """`run` in pieces of at most `chunk` rounds: the same final state,
    round for round (each piece checks `drained` before every step, as
    `run` does), with `progress(rounds_done, state)` called after every
    piece and one more read of `drained` there.

    `checkpoint_path` saves the state every `checkpoint_every_chunks`
    pieces (`utils/checkpoint.save_checkpoint`, atomic replace), so a
    killed run resumes from the last checkpoint.  Saves run on a
    background thread while later pieces compute, one at a time (a
    boundary is skipped while a save is in flight), and the last one is
    joined before returning.  No step writes into the tensors of the
    state it was given (every plane a step changes is a new tensor), so
    a boundary state stays as it was while the saver copies it; the
    saver's device→host copies run on a side stream that waits for an
    event recorded at the boundary, not for the pieces queued after it.
    Each save moves `checkpoint_fetch_bytes`-sized transfers with a
    `checkpoint_fetch_timeout_s` deadline each.  A failed save is
    dropped with a warning and the run goes on; only when no save
    succeeded at all is one synchronous retry made at the end, and its
    failure raised."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if checkpoint_path and checkpoint_every_chunks < 1:
        raise ValueError("checkpoint_every_chunks must be >= 1, got "
                         f"{checkpoint_every_chunks}")
    import threading
    import warnings

    from go_avalanche_tpu_torch.utils.checkpoint import save_checkpoint

    state = av.move_leaves(state, av._device(device))
    saver: Optional[threading.Thread] = None
    save_errors: list = []
    saves_ok = [0]

    def _do_save(snapshot, ready=None):
        save_checkpoint(checkpoint_path, snapshot,
                        max_fetch_bytes=checkpoint_fetch_bytes,
                        fetch_timeout_s=checkpoint_fetch_timeout_s,
                        ready=ready)
        saves_ok[0] += 1

    def _save(snapshot, ready):
        # A failed save costs a checkpoint, not the run: the next
        # boundary tries again with a fresher state.
        try:
            _do_save(snapshot, ready)
        except Exception as e:  # noqa: BLE001 — surfaced at completion
            save_errors.append(e)
            if len(save_errors) == 1:
                warnings.warn(f"checkpoint save failed (run continues, "
                              f"will retry next boundary): {e!r}",
                              RuntimeWarning, stacklevel=2)

    try:
        rounds = sync.read(state.dag.base.round)
        chunks_done = 0
        while True:
            start = rounds
            while (rounds - start < chunk and rounds < max_rounds
                   and not sync.read(drained(state, cfg))):
                state = step(state, cfg)[0]
                rounds += 1
            done = sync.read(drained(state, cfg))
            chunks_done += 1
            if progress is not None:
                progress(rounds, state)
            if (checkpoint_path
                    and chunks_done % checkpoint_every_chunks == 0
                    and (saver is None or not saver.is_alive())):
                ready = None
                if state.dag.base.round.is_cuda:
                    ready = torch.cuda.Event()
                    ready.record()
                saver = threading.Thread(target=_save, args=(state, ready),
                                         daemon=True)
                saver.start()
            if done or rounds >= max_rounds:
                break
    finally:
        # Always join: an orphaned save would race a later one to the
        # same tmp path.
        if saver is not None:
            saver.join()
    if checkpoint_path and save_errors:
        if saves_ok[0] == 0:
            try:
                _do_save(state)
            except Exception as e:  # noqa: BLE001
                raise e from save_errors[0]
        if saves_ok[0] > 0 and save_errors:
            warnings.warn(
                f"run completed; {len(save_errors)} checkpoint save(s) "
                f"failed and were dropped (last: {save_errors[-1]!r}); "
                f"latest successful checkpoint kept at {checkpoint_path}",
                RuntimeWarning, stacklevel=2)
    return _retire_and_refill(state, cfg, refill=False)[0]


def run_scan(state: StreamingDagState,
             cfg: AvalancheConfig = DEFAULT_CONFIG, n_rounds: int = 1000,
             device="cuda") -> Tuple[StreamingDagState,
                                     StreamingDagTelemetry]:
    """`n_rounds` steps on `device` with stacked per-step telemetry."""
    state = av.move_leaves(state, av._device(device))
    rows = []
    for _ in range(n_rounds):
        state, tel = step(state, cfg)
        rows.append(tel)
    return state, stack_tree(rows)


def resolution_summary(state: StreamingDagState) -> dict:
    """Host digest of the outcomes: how many sets settled, how many got
    exactly one winner, and the admit -> settle latency."""
    out = SetOutputs(*(x.cpu().numpy() for x in state.outputs))
    valid = state.backlog.valid.cpu().numpy()
    settled_sets = out.settled.any(axis=1)
    winners = (out.accepted & valid).sum(axis=1)
    latency = (out.settle_round - out.admit_round)[out.settled]
    return {
        "sets_settled_fraction": float(settled_sets.mean()),
        "sets_one_winner_fraction": float(
            (winners[settled_sets] == 1).mean()) if settled_sets.any()
        else 0.0,
        "txs_settled": int(out.settled[valid].sum()),
        "settle_latency_median": float(np.median(latency))
        if latency.size else None,
        "settle_latency_p90": float(np.percentile(latency, 90))
        if latency.size else None,
    }
