"""The mesh-sharded streaming conflict DAG — `go_avalanche_tpu/parallel/sharded_streaming_dag.py`.

The north-star workload over the ``(nodes, txs)`` mesh: the composition
of `parallel/sharded_dag` (the conflict round, `sharded_dag._local_round`
unchanged) and `parallel/sharded_backlog` (the streaming scheduler's
collectives, lifted from tx to set granularity):

  * settle test: a psum over the nodes axis of the per-set "some (node,
    member) still pollable" bit;
  * admission rank: an exclusive prefix over tx shards, from an
    all-gather of one int32 count a shard, so free set-slots across
    shards take backlog sets in the global score order; under
    `cfg.stream_retire_cap` the participation rank is built the same
    way, which reproduces the unsharded scheduler's cumsum order;
  * output merge: each shard row-scatters its retiring sets' member
    outcomes into zero ``[S_b, c]`` planes and a psum over the txs axis
    merges them (a set occupies one set-slot, so rows never collide).

Layout: the ``[N, W]`` window is cut on both axes, and ``W`` must split
into tx shards at whole-set granularity (``W / n_tx_shards`` a multiple
of the set capacity ``c``), so the window partition ``arange(W) // c``
stays locally contiguous: the non-straddling contract of
`sharded_dag.shard_dag_state`, here checked at placement.  The per-slot
metadata is cut along the txs axis; the ``[S_b, c]`` backlog and output
planes are replicated.

Divergence from the unsharded scheduler (the reference's, kept): the
poll-order score ranks are computed per tx shard; with
``W <= max_element_poll`` nothing is truncated and ranks never matter.
"""

from __future__ import annotations

from typing import Tuple

import torch

from go_avalanche_tpu_torch import sync
from go_avalanche_tpu_torch import traffic as tf
from go_avalanche_tpu_torch.config import (AvalancheConfig, DEFAULT_CONFIG,
                                           inner_round_config)
from go_avalanche_tpu_torch.models import avalanche as av
from go_avalanche_tpu_torch.models.backlog import stack_tree
from go_avalanche_tpu_torch.models.streaming_dag import (
    EMPTY_SCORE, NO_SET, SetBacklog, SetOutputs, StreamingDagState,
    StreamingDagTelemetry, refill_planes)
from go_avalanche_tpu_torch.obs import trace as obs_trace
from go_avalanche_tpu_torch.ops import inflight
from go_avalanche_tpu_torch.ops import voterecord as vr
from go_avalanche_tpu_torch.parallel import collectives as C
from go_avalanche_tpu_torch.parallel import sharded, sharded_dag
from go_avalanche_tpu_torch.parallel.mesh import NODES_AXIS, TXS_AXIS
from go_avalanche_tpu_torch.parallel.sharded import REPLICATED
from go_avalanche_tpu_torch.parallel.sharded_backlog import (
    _alive_local, _exclusive_prefix, _occupied, merge_planes,
    traffic_specs)
from go_avalanche_tpu_torch.utils.tracing import annotate


def streaming_dag_state_specs(n_sets: int, set_size=None,
                              track_finality: bool = True,
                              with_inflight: bool = False,
                              with_fault_params: bool = False,
                              with_traffic: bool = False,
                              traced: bool = False) -> StreamingDagState:
    """The spec of every leaf of `StreamingDagState` (the window's
    `sharded_dag.dag_state_specs`; the scheduler's trace plane is
    replicated)."""
    return StreamingDagState(
        dag=sharded_dag.dag_state_specs(n_sets, set_size, track_finality,
                                        with_inflight, with_fault_params,
                                        traced),
        slot_set=(TXS_AXIS,),
        slot_admit_round=(TXS_AXIS,),
        backlog=SetBacklog(*([REPLICATED] * len(SetBacklog._fields))),
        outputs=SetOutputs(*([REPLICATED] * len(SetOutputs._fields))),
        next_idx=REPLICATED,
        traffic=traffic_specs(with_traffic),
    )


def specs_of(state: StreamingDagState) -> StreamingDagState:
    base = state.dag.base
    return streaming_dag_state_specs(
        state.dag.n_sets, state.dag.set_size, base.finalized_at is not None,
        base.inflight is not None, base.fault_params is not None,
        state.traffic is not None, base.trace is not None)


def shard_streaming_dag_state(state: StreamingDagState,
                              mesh) -> StreamingDagState:
    """This rank's block of the global streaming-DAG `state`, on its
    device.  Checks whole-set tx sharding: the per-shard window width
    must be a multiple of the set capacity, so no window set straddles
    a shard."""
    n_tx_shards = mesh.shape[TXS_AXIS]
    c = state.backlog.score.shape[1]
    w = state.dag.base.records.votes.shape[1]
    if w % n_tx_shards:
        raise ValueError(f"window ({w}) must divide by tx shards "
                         f"({n_tx_shards})")
    if (w // n_tx_shards) % c:
        raise ValueError(
            f"per-shard window ({w // n_tx_shards}) must be a multiple of "
            f"the set capacity ({c}) so sets do not straddle tx shards")
    base = state.dag.base
    state = state._replace(dag=state.dag._replace(base=base._replace(
        inflight=inflight.repack_polled_for_shards(base.inflight, w,
                                                   n_tx_shards))))
    return sharded.map_specs(lambda x, s: sharded.block_of(x, s, mesh),
                             state, specs_of(state))


def gather_streaming_dag_state(state: StreamingDagState,
                               mesh) -> StreamingDagState:
    """The global streaming-DAG state assembled from every rank's block,
    on every rank."""
    with C.bind(mesh):
        return sharded.map_specs(sharded.assemble, state, specs_of(state))


def _local_settled_sets(state: StreamingDagState, cfg: AvalancheConfig,
                        c: int) -> torch.Tensor:
    """Bool ``[s_w_local]``: occupied set-slots with no (live node,
    member) pair pollable on any node shard — the dense
    `_settled_set_slots` with its node-axis `any` a psum."""
    base = state.dag.base
    n_local, w_local = base.records.votes.shape
    s_w_local = w_local // c
    fin = vr.has_finalized(base.records.confidence, cfg)
    fin_acc = fin & vr.is_accepted(base.records.confidence)
    node_set_done = fin_acc.reshape(n_local, s_w_local, c).any(dim=2)
    rival_settled = node_set_done.repeat_interleave(c, dim=1) & ~fin_acc
    pending = (base.added & _alive_local(base)[:, None]
               & base.valid[None, :] & ~fin & ~rival_settled)
    pending_local = pending.reshape(n_local, s_w_local, c).any(
        dim=2).any(dim=0).to(torch.int32)
    pending_any = C.psum(pending_local, NODES_AXIS) > 0
    return (state.slot_set != NO_SET) & ~pending_any


def _local_retire_and_refill(state: StreamingDagState, cfg: AvalancheConfig,
                             c: int, refill: bool = True
                             ) -> Tuple[StreamingDagState, torch.Tensor]:
    """The set-granular scheduler pass on this rank's block
    (`models/streaming_dag`).  Returns (new state, sets retired over the
    whole mesh)."""
    base = state.dag.base
    w_local = base.records.votes.shape[1]
    s_w_local = w_local // c
    s_b = state.backlog.score.shape[0]
    settled = _local_settled_sets(state, cfg, c)
    empty = state.slot_set == NO_SET
    cap = cfg.stream_retire_cap
    sparse = refill and cap is not None
    if sparse:
        # The unsharded capped scheduler with its participation rank made
        # global: shards hold contiguous slot ranges, so an exclusive
        # prefix of the pool counts gives the unsharded cumsum order.
        pool = settled | empty
        grank = (_exclusive_prefix(pool.sum(dtype=torch.int32))
                 + torch.cumsum(pool.to(torch.int32), dim=0,
                                dtype=torch.int32) - 1)
        participate = pool & (grank < cap)
        settled = settled & participate
        free = participate
    else:
        free = settled | empty

    # --- live traffic: member-weighted latency deltas psum'd over the
    # txs axis (integer adds: the replicated histogram is the dense one).
    traffic = state.traffic
    if traffic is not None:
        rows_safe = state.slot_set.clamp(0, s_b - 1).long()
        lat = base.round - traffic.arrival_round[rows_safe]
        members = state.backlog.valid[rows_safe].sum(dim=1,
                                                     dtype=torch.int32)
        delta = tf.latency_delta(cfg, lat, torch.where(settled, members, 0))
        traffic = traffic._replace(
            lat_hist=traffic.lat_hist + C.psum(delta, TXS_AXIS))

    # --- retire: member outcomes, the node-axis sums psum'd.
    conf = base.records.confidence
    fin_acc = vr.has_finalized(conf, cfg) & vr.is_accepted(conf)
    accept_votes = C.psum((fin_acc & base.added).sum(dim=0,
                                                     dtype=torch.int32),
                          NODES_AXIS)
    n_live = base.alive.sum(dtype=torch.int32).clamp_min(1)
    accepted = accept_votes * 2 > n_live
    row_idx = torch.where(settled, state.slot_set, s_b)
    out = SetOutputs(*merge_planes(
        list(state.outputs), row_idx,
        [torch.ones((s_w_local, c), dtype=torch.bool,
                    device=settled.device),
         accepted.reshape(s_w_local, c),
         accept_votes.reshape(s_w_local, c), base.round,
         state.slot_admit_round[:, None]]))

    # --- refill: the global admission rank, an exclusive prefix over
    # the tx shards.
    rank = (_exclusive_prefix(free.sum(dtype=torch.int32))
            + torch.cumsum(free.to(torch.int32), dim=0, dtype=torch.int32)
            - 1)
    cand = state.next_idx + rank
    avail = (s_b if traffic is None
             else torch.clamp_max(traffic.arrived_idx, s_b))
    take = free & (cand < avail)
    if not refill:   # end-of-run harvest: record outcomes, admit nothing
        take = torch.zeros_like(take)
    new_set = torch.where(take, cand,
                          torch.where(settled, NO_SET, state.slot_set))
    n_taken = C.psum(take.sum(dtype=torch.int32), TXS_AXIS)

    cand_safe = cand.clamp(0, s_b - 1).long()
    pref_rows = state.backlog.init_pref[cand_safe]      # [s_w_local, c]
    take_w = take.repeat_interleave(c)
    occupied_after_w = (new_set != NO_SET).repeat_interleave(c)
    records, added, finalized_at = refill_planes(
        base, settled, take, occupied_after_w, pref_rows,
        min(cap, s_w_local) if sparse else None)
    valid = torch.where(take_w,
                        state.backlog.valid[cand_safe].reshape(w_local),
                        base.valid & occupied_after_w)
    score = torch.where(
        occupied_after_w,
        state.backlog.score[new_set.clamp(0, s_b - 1).long()].reshape(
            w_local),
        EMPTY_SCORE)
    # Per-shard ranks (module docstring).
    score_rank, poll_order, poll_order_inv = av.score_rank_with_orders(score)
    new_base = base._replace(
        records=records, added=added, valid=valid, score_rank=score_rank,
        poll_order=poll_order, poll_order_inv=poll_order_inv,
        finalized_at=finalized_at,
        # Responses in flight for a retired set-slot must not land on its
        # new occupant; the columns are this shard's.
        inflight=inflight.clear_columns(
            base.inflight, (settled | take).repeat_interleave(c)))
    retired = C.psum(settled.sum(dtype=torch.int32), TXS_AXIS)
    return StreamingDagState(
        dag=state.dag._replace(base=new_base),
        slot_set=new_set,
        slot_admit_round=torch.where(take, base.round,
                                     state.slot_admit_round),
        backlog=state.backlog,
        outputs=out,
        next_idx=state.next_idx + n_taken,
        traffic=traffic,
    ), retired


def _local_step(state: StreamingDagState, cfg: AvalancheConfig, c: int,
                n_global: int, n_tx_shards: int
                ) -> Tuple[StreamingDagState, StreamingDagTelemetry]:
    """Arrive, retire and refill by sets, then one sharded conflict round
    (inside ``collectives.bind``)."""
    round_val = state.dag.base.round
    arrivals = torch.zeros((), dtype=torch.int32,
                           device=state.slot_set.device)
    if state.traffic is not None:
        # A replicated draw with the global set-slot occupancy: every
        # shard realizes the dense arrival sequence.
        new_traffic, arrivals = tf.arrive(
            state.traffic, cfg, round_val, _occupied(state.slot_set),
            state.slot_set.shape[0] * n_tx_shards)
        state = state._replace(traffic=new_traffic)
    with annotate("retire_refill"):
        state, retired = _local_retire_and_refill(state, cfg, c)
    # The scheduler owns the trace plane: the inner round's taps are
    # silenced and the full record is written below from psum'd counters.
    new_dag, round_tel = sharded_dag._local_round(
        state.dag, inner_round_config(cfg), n_global, n_tx_shards)
    tel = StreamingDagTelemetry(
        round=round_tel,
        retired_sets=retired,
        occupied_sets=_occupied(state.slot_set),
        backlog_left=state.backlog.score.shape[0] - state.next_idx,
        traffic=(None if state.traffic is None
                 else tf.traffic_telemetry(state.traffic, arrivals)),
    )
    new_dag = new_dag._replace(base=new_dag.base._replace(
        trace=obs_trace.write_round(new_dag.base.trace, cfg, round_val,
                                    tel)))
    return state._replace(dag=new_dag), tel


# The reference's manifest: the set scheduler's txs-axis merges (the
# row-block retire/refill psums, the pool counts' all-gather — one int32
# a shard, never a plane) on top of the conflict round's.
DECLARED_COLLECTIVES = frozenset({
    ("all_gather", (NODES_AXIS,)),
    ("all_gather", (TXS_AXIS,)),      # per-shard admission-pool counts
    ("all_reduce", (NODES_AXIS,)),    # settle test over the nodes axis
    ("all_reduce", (TXS_AXIS,)),      # retire/refill merges, occupancy,
                                      #   traffic deltas, the poll cap
    ("all_reduce", (NODES_AXIS, TXS_AXIS)),
})


def _n_global(state: StreamingDagState, mesh) -> int:
    return state.dag.base.records.votes.shape[0] * mesh.shape[NODES_AXIS]


def make_sharded_streaming_dag_step(mesh,
                                    cfg: AvalancheConfig = DEFAULT_CONFIG,
                                    donate: bool = False):
    """A one-step set scheduler and conflict round over the mesh:
    ``step(block) -> (block, telemetry)`` on this rank's block
    (`shard_streaming_dag_state`); `donate` as in
    `sharded.make_sharded_round_step`.  The local round is phased
    whatever `cfg.round_engine` says, as the reference's."""
    n_tx = mesh.shape[TXS_AXIS]

    def step(state: StreamingDagState):
        with C.bind(mesh):
            return _local_step(state, cfg, state.backlog.score.shape[1],
                               _n_global(state, mesh), n_tx)

    return step


def run_scan_sharded_streaming_dag(
        mesh, state: StreamingDagState,
        cfg: AvalancheConfig = DEFAULT_CONFIG, n_rounds: int = 100,
        donate: bool = False
) -> Tuple[StreamingDagState, StreamingDagTelemetry]:
    """`n_rounds` steps on this rank's block with the stacked
    telemetry."""
    step = make_sharded_streaming_dag_step(mesh, cfg, donate)
    rows = []
    for _ in range(n_rounds):
        state, tel = step(state)
        rows.append(tel)
    return state, stack_tree(rows)


def _undrained(state: StreamingDagState, cfg: AvalancheConfig,
               mesh) -> torch.Tensor:
    """Device bool: sets left in the backlog, or an occupied set-slot
    unsettled anywhere (a psum over the txs axis)."""
    c = state.backlog.score.shape[1]
    with C.bind(mesh):
        unsettled = ((state.slot_set != NO_SET)
                     & ~_local_settled_sets(state, cfg, c))
        any_left = C.psum(unsettled.any().to(torch.int32), TXS_AXIS) > 0
    return (state.next_idx < state.backlog.score.shape[0]) | any_left


def run_sharded_streaming_dag(mesh, state: StreamingDagState,
                              cfg: AvalancheConfig = DEFAULT_CONFIG,
                              max_rounds: int = 100_000,
                              donate: bool = False) -> StreamingDagState:
    """Stream the whole conflict graph to settlement over the mesh,
    reading the drained flag once a round, then a harvest pass records
    the last window's outcomes."""
    step = make_sharded_streaming_dag_step(mesh, cfg, donate)
    round_ = int(sync.read(state.dag.base.round))
    live = bool(sync.read(_undrained(state, cfg, mesh)))
    while live and round_ < max_rounds:
        state = step(state)[0]
        round_ += 1
        live = bool(sync.read(_undrained(state, cfg, mesh)))
    with C.bind(mesh):
        return _local_retire_and_refill(state, cfg,
                                        state.backlog.score.shape[1],
                                        refill=False)[0]
