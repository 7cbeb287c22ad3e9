"""The mesh-sharded streaming backlog — `go_avalanche_tpu/parallel/sharded_backlog.py`.

`models/backlog` run on this rank's block: the dense ``[N, W]`` window
is cut like the plain round's state (`parallel/sharded.py`), the
per-slot metadata along the txs axis, and the ``[B]`` backlog, output
and traffic planes stay replicated (1M txs of metadata is MBs, little
beside the window).  The scheduler's collectives a step:

  * settle test: a psum over the nodes axis of the per-slot "some node
    still pending" bit;
  * admission rank: an exclusive prefix over tx shards, built from an
    all-gather of one int32 count per shard, so free slots across shards
    take backlog entries in the global score order without a sort;
  * output merge: each shard writes its retiring txs' outcomes into
    zero planes, and a psum over the txs axis merges them (a tx occupies
    one slot, so writes never collide).  The written mask is summed
    once and the five value planes in one ``[5, B]`` int32 psum: the
    reference sums the same mask five times and each plane alone, with
    the same result.

The inner round is `parallel/sharded._local_round`, unchanged, so a rank
on the card launches the ingest kernel of `cfg.ingest_engine` on its
block.

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
from go_avalanche_tpu_torch.models.backlog import (NO_TX, Backlog,
                                                   BacklogOutputs,
                                                   BacklogSimState,
                                                   BacklogTelemetry,
                                                   refill_slots, set_drop,
                                                   stack_tree)
from go_avalanche_tpu_torch.obs import trace as obs_trace
from go_avalanche_tpu_torch.ops import inflight
from go_avalanche_tpu_torch.ops import voterecord as vr
from go_avalanche_tpu_torch.parallel import collectives as C
from go_avalanche_tpu_torch.parallel import sharded
from go_avalanche_tpu_torch.parallel.mesh import NODES_AXIS, TXS_AXIS
from go_avalanche_tpu_torch.parallel.sharded import REPLICATED
from go_avalanche_tpu_torch.utils.tracing import annotate


def traffic_specs(with_traffic: bool):
    """The live-traffic plane replicated: the draw is the same on every
    shard, like the backlog metadata it gates."""
    if not with_traffic:
        return None
    return tf.TrafficState(*([REPLICATED] * len(tf.TrafficState._fields)))


def backlog_state_specs(track_finality: bool = True,
                        with_inflight: bool = False,
                        with_fault_params: bool = False,
                        with_traffic: bool = False,
                        traced: bool = False) -> BacklogSimState:
    """The spec of every leaf of `BacklogSimState` (`sharded.state_specs`
    for the window; the trace plane, owned by the scheduler, is
    replicated)."""
    return BacklogSimState(
        sim=sharded.state_specs(track_finality, with_inflight,
                                with_fault_params, traced),
        slot_tx=(TXS_AXIS,),
        slot_admit_round=(TXS_AXIS,),
        backlog=Backlog(*([REPLICATED] * len(Backlog._fields))),
        outputs=BacklogOutputs(*([REPLICATED]
                                 * len(BacklogOutputs._fields))),
        next_idx=REPLICATED,
        traffic=traffic_specs(with_traffic),
    )


def specs_of(state: BacklogSimState) -> BacklogSimState:
    sim = state.sim
    return backlog_state_specs(sim.finalized_at is not None,
                               sim.inflight is not None,
                               sim.fault_params is not None,
                               state.traffic is not None,
                               sim.trace is not None)


def shard_backlog_state(state: BacklogSimState, mesh) -> BacklogSimState:
    """This rank's block of the global backlog `state`, on its device."""
    state = state._replace(sim=state.sim._replace(
        inflight=inflight.repack_polled_for_shards(
            state.sim.inflight, state.sim.records.votes.shape[1],
            mesh.shape[TXS_AXIS])))
    return sharded.map_specs(lambda x, s: sharded.block_of(x, s, mesh),
                             state, specs_of(state))


def gather_backlog_state(state: BacklogSimState, mesh) -> BacklogSimState:
    """The global backlog state assembled from every rank's block, on
    every rank."""
    with C.bind(mesh):
        return sharded.map_specs(sharded.assemble, state, specs_of(state))


def merge_planes(olds, idx: torch.Tensor, values) -> list:
    """Replicated planes updated from every shard's scatters: each
    shard's `values` (one per plane, rows of `idx`; `idx` == len(plane)
    drops) go into zero int32 planes, one stacked psum over the txs axis
    merges them, and rows some shard wrote take the merged value cast
    back to the plane's dtype (bool planes travel as int32)."""
    n = olds[0].shape[0]
    zero = torch.zeros((len(olds),) + tuple(olds[0].shape),
                       dtype=torch.int32, device=idx.device)
    vals = torch.stack([
        set_drop(zero[i], idx, v.to(torch.int32).expand(
            (idx.shape[0],) + tuple(olds[0].shape[1:])))
        for i, v in enumerate(values)])
    vals = C.psum(vals, TXS_AXIS)
    ones = torch.ones(idx.shape, dtype=torch.int32, device=idx.device)
    written = C.psum(set_drop(torch.zeros(n, dtype=torch.int32,
                                          device=idx.device), idx, ones),
                     TXS_AXIS) > 0
    mask = written.reshape((n,) + (1,) * (olds[0].dim() - 1))
    return [torch.where(mask, vals[i].to(old.dtype), old)
            for i, old in enumerate(olds)]


def _exclusive_prefix(count_local: torch.Tensor) -> torch.Tensor:
    """The sum of the counts of the tx shards before this one: one int32
    a shard, all-gathered over the txs axis."""
    counts = C.all_gather(count_local[None], TXS_AXIS)
    before = torch.arange(counts.shape[0], device=counts.device) < (
        C.axis_index(TXS_AXIS))
    return torch.where(before, counts, 0).sum(dtype=torch.int32)


def _alive_local(sim) -> torch.Tensor:
    n_local = sim.records.votes.shape[0]
    offset = C.axis_index(NODES_AXIS) * n_local
    return sim.alive[offset:offset + n_local]


def _local_settled(state: BacklogSimState,
                   cfg: AvalancheConfig) -> torch.Tensor:
    """Bool ``[w_local]``: occupied slots settled on every node shard
    (the pending bit psum'd over the nodes axis)."""
    sim = state.sim
    occupied = state.slot_tx != NO_TX
    fin = vr.has_finalized(sim.records.confidence, cfg)
    pending = sim.added & _alive_local(sim)[:, None] & ~fin
    pending_any = C.psum(pending.any(dim=0).to(torch.int32),
                         NODES_AXIS) > 0
    return occupied & (~pending_any | ~sim.valid)


def _local_retire_and_refill(state: BacklogSimState, cfg: AvalancheConfig,
                             refill: bool = True
                             ) -> Tuple[BacklogSimState, torch.Tensor]:
    """The scheduler pass on this rank's block (`models/backlog`).
    Returns (new state, slots retired over the whole mesh)."""
    sim = state.sim
    b = state.backlog.score.shape[0]
    settled = _local_settled(state, cfg)

    # --- retire: the node-axis sums psum'd, so every node shard holds
    # the same [w_local] planes.
    conf = sim.records.confidence
    fin = vr.has_finalized(conf, cfg)
    accept_votes = C.psum((fin & vr.is_accepted(conf) & sim.added).sum(
        dim=0, dtype=torch.int32), NODES_AXIS)
    n_live = sim.alive.sum(dtype=torch.int32).clamp_min(1)
    accepted = accept_votes * 2 > n_live

    idx = torch.where(settled, state.slot_tx, b)
    out = state.outputs
    out = BacklogOutputs(*merge_planes(
        list(out), idx,
        [torch.ones_like(settled), accepted, accept_votes,
         sim.round.expand(idx.shape), state.slot_admit_round]))

    # --- live traffic: the per-shard latency deltas psum'd over the txs
    # axis (integer adds: the replicated histogram is the dense one).
    traffic = state.traffic
    if traffic is not None:
        arr = traffic.arrival_round[state.slot_tx.clamp(0, b - 1).long()]
        delta = tf.latency_delta(cfg, sim.round - arr,
                                 settled.to(torch.int32))
        traffic = traffic._replace(
            lat_hist=traffic.lat_hist + C.psum(delta, TXS_AXIS))

    # --- refill: the global admission rank, an exclusive prefix over
    # the tx shards.
    free = settled | (state.slot_tx == NO_TX)
    rank = (_exclusive_prefix(free.sum(dtype=torch.int32))
            + torch.cumsum(free.to(torch.int32), dim=0, dtype=torch.int32)
            - 1)
    cand = state.next_idx + rank
    avail = (b if traffic is None
             else torch.clamp_max(traffic.arrived_idx, b))
    take = free & (cand < avail)
    if not refill:   # end-of-run harvest: record outcomes, admit nothing
        take = torch.zeros_like(take)
    new_tx = torch.where(take, cand,
                         torch.where(settled, NO_TX, state.slot_tx))
    n_taken = C.psum(take.sum(dtype=torch.int32), TXS_AXIS)

    # The poll-order ranks are this shard's (module docstring); the
    # in-flight columns cleared are this shard's.
    new_sim = refill_slots(sim, state.backlog, settled, take, cand, new_tx)
    retired = C.psum(settled.sum(dtype=torch.int32), TXS_AXIS)
    return BacklogSimState(
        sim=new_sim,
        slot_tx=new_tx,
        slot_admit_round=torch.where(take, sim.round, state.slot_admit_round),
        backlog=state.backlog,
        outputs=out,
        next_idx=state.next_idx + n_taken,
        traffic=traffic,
    ), retired


def _occupied(slots: torch.Tensor) -> torch.Tensor:
    """Occupied slots over the whole window (a psum over the txs axis)."""
    return C.psum((slots != NO_TX).sum(dtype=torch.int32), TXS_AXIS)


def _local_step(state: BacklogSimState, cfg: AvalancheConfig,
                n_global: int, n_tx_shards: int
                ) -> Tuple[BacklogSimState, BacklogTelemetry]:
    """Arrive, retire and refill, then one sharded round (inside
    ``collectives.bind``)."""
    round_val = state.sim.round
    arrivals = torch.zeros((), dtype=torch.int32,
                           device=state.slot_tx.device)
    if state.traffic is not None:
        # The draw runs on replicated state with the global occupancy, so
        # every shard realizes the dense arrival sequence.
        new_traffic, arrivals = tf.arrive(
            state.traffic, cfg, round_val, _occupied(state.slot_tx),
            state.slot_tx.shape[0] * n_tx_shards)
        state = state._replace(traffic=new_traffic)
    with annotate("retire_refill"):
        state, retired = _local_retire_and_refill(state, cfg)
    # The scheduler owns the trace plane: the inner round's taps are
    # silenced and the full record is written below from psum'd counters.
    new_sim, round_tel = sharded._local_round(
        state.sim, inner_round_config(cfg), n_global, n_tx_shards)
    tel = BacklogTelemetry(
        round=round_tel,
        retired=retired,
        occupied=_occupied(state.slot_tx),
        backlog_left=state.backlog.score.shape[0] - state.next_idx,
        traffic=(None if state.traffic is None
                 else tf.traffic_telemetry(state.traffic, arrivals)),
    )
    new_sim = new_sim._replace(
        trace=obs_trace.write_round(new_sim.trace, cfg, round_val, tel))
    return state._replace(sim=new_sim), tel


# The reference's manifest: the scheduler's txs-axis merges (the one-hot
# retire/refill psums, the admission counts' all-gather — one int32 a
# shard, never a plane) on top of the inner round's.
DECLARED_COLLECTIVES = frozenset({
    ("all_gather", (NODES_AXIS,)),
    ("all_gather", (TXS_AXIS,)),      # per-shard admission counts
    ("all_to_all", (NODES_AXIS,)),
    ("all_reduce", (NODES_AXIS,)),
    ("all_reduce", (TXS_AXIS,)),      # retire/refill merges, occupancy,
                                      #   traffic deltas, the poll cap
    ("all_reduce", (NODES_AXIS, TXS_AXIS)),
})


def _n_global(state: BacklogSimState, mesh) -> int:
    return state.sim.records.votes.shape[0] * mesh.shape[NODES_AXIS]


def make_sharded_backlog_step(mesh, cfg: AvalancheConfig = DEFAULT_CONFIG,
                              donate: bool = False):
    """A one-step scheduler and round over the mesh: ``step(block) ->
    (block, telemetry)`` on this rank's block (`shard_backlog_state`),
    the telemetry the same on every rank.  `donate` is accepted and
    changes nothing (`sharded.make_sharded_round_step`).  The local
    round is the phased `sharded._local_round` whatever
    `cfg.round_engine` says, as the reference's (its driver never reads
    the knob)."""
    n_tx = mesh.shape[TXS_AXIS]

    def step(state: BacklogSimState):
        with C.bind(mesh):
            return _local_step(state, cfg, _n_global(state, mesh), n_tx)

    return step


def run_scan_sharded_backlog(mesh, state: BacklogSimState,
                             cfg: AvalancheConfig = DEFAULT_CONFIG,
                             n_rounds: int = 100, donate: bool = False
                             ) -> Tuple[BacklogSimState, BacklogTelemetry]:
    """`n_rounds` steps on this rank's block with the stacked
    telemetry."""
    step = make_sharded_backlog_step(mesh, cfg, donate)
    rows = []
    for _ in range(n_rounds):
        state, tel = step(state)
        rows.append(tel)
    return state, stack_tree(rows)


def _undrained(state: BacklogSimState, cfg: AvalancheConfig,
               mesh) -> torch.Tensor:
    """Device bool: backlog left, or an occupied slot unsettled anywhere
    (a psum over the txs axis)."""
    with C.bind(mesh):
        unsettled = (state.slot_tx != NO_TX) & ~_local_settled(state, cfg)
        any_left = C.psum(unsettled.any().to(torch.int32), TXS_AXIS) > 0
    return (state.next_idx < state.backlog.score.shape[0]) | any_left


def run_sharded_backlog(mesh, state: BacklogSimState,
                        cfg: AvalancheConfig = DEFAULT_CONFIG,
                        max_rounds: int = 100_000, donate: bool = False
                        ) -> BacklogSimState:
    """Stream the whole backlog to settlement over the mesh, reading the
    drained flag once a round, then a harvest pass records the last
    window's outcomes."""
    step = make_sharded_backlog_step(mesh, cfg, donate)
    round_ = int(sync.read(state.sim.round))
    live = bool(sync.read(_undrained(state, cfg, mesh)))
    while live and round_ < max_rounds:
        state = step(state)[0]
        round_ += 1
        live = bool(sync.read(_undrained(state, cfg, mesh)))
    with C.bind(mesh):
        return _local_retire_and_refill(state, cfg, refill=False)[0]
