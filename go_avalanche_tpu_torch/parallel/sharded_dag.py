"""The mesh-sharded conflict-set DAG — `go_avalanche_tpu/parallel/sharded_dag.py`.

BASELINE's "byzantine mix, sharded DAG": `models/dag.round_step` run on
this rank's ``[N/A, T/B]`` block (`parallel/sharded.py` has the plain
round).  Both of the DAG's additions stay free of collectives on the
txs axis, because no conflict set may straddle a tx shard
(`shard_dag_state` checks):

  * the response plane is preferred-in-set, computed on the local
    columns with local set ids, then packed and all-gathered over the
    nodes axis like the plain preference plane;
  * the rival-settled freeze (a set settles for a node once any member
    finalized accepted) is a local set pass too.

The ingest goes through `ops/pallas_vote.register_packed_votes_fused`,
as in `parallel/sharded.py`.  Randomness follows that module: the draws
fold in the nodes-shard index, the equivocation and split_vote coins
also the txs index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from go_avalanche_tpu_torch import prng, sync
from go_avalanche_tpu_torch.config import (AdversaryStrategy,
                                           AvalancheConfig, DEFAULT_CONFIG)
from go_avalanche_tpu_torch.models import avalanche as av
from go_avalanche_tpu_torch.models import dag as dag_model
from go_avalanche_tpu_torch.models.dag import DagSimState
from go_avalanche_tpu_torch.obs import trace as obs_trace
from go_avalanche_tpu_torch.ops import (adversary, exchange, inflight,
                                        pallas_vote)
from go_avalanche_tpu_torch.ops import voterecord as vr
from go_avalanche_tpu_torch.ops.bitops import pack_bool_plane
from go_avalanche_tpu_torch.ops.sampling import draw_peers
from go_avalanche_tpu_torch.parallel import collectives as C
from go_avalanche_tpu_torch.parallel import sharded
from go_avalanche_tpu_torch.parallel.mesh import NODES_AXIS, TXS_AXIS
from go_avalanche_tpu_torch.utils.tracing import annotate


def dag_state_specs(n_sets: int, set_size: Optional[int] = None,
                    track_finality: bool = True,
                    with_inflight: bool = False,
                    with_fault_params: bool = False,
                    traced: bool = False) -> DagSimState:
    """The spec of every leaf of `DagSimState`: the base state's
    (`sharded.state_specs`), `conflict_set` cut along txs, and the
    `n_sets` / `set_size` statics carried as they are."""
    return DagSimState(base=sharded.state_specs(track_finality,
                                                with_inflight,
                                                with_fault_params, traced),
                       conflict_set=(TXS_AXIS,), n_sets=n_sets,
                       set_size=set_size)


def specs_of(state: DagSimState) -> DagSimState:
    base = state.base
    return dag_state_specs(state.n_sets, state.set_size,
                           base.finalized_at is not None,
                           base.inflight is not None,
                           base.fault_params is not None,
                           base.trace is not None)


def shard_dag_state(state: DagSimState, mesh) -> DagSimState:
    """This rank's block of the global DAG `state`, on its device.

    Checks the contract that keeps set passes local: no conflict set
    may straddle a tx-shard boundary, and set ids must be sorted so
    each shard's ids form one contiguous range (the ``idx // set_size``
    partition satisfies both)."""
    n_tx_shards = mesh.shape[TXS_AXIS]
    cs = state.conflict_set.cpu().numpy()
    t = cs.shape[0]
    if t % n_tx_shards:
        raise ValueError(f"txs ({t}) must divide by tx shards "
                         f"({n_tx_shards})")
    if (np.diff(cs) < 0).any():
        raise ValueError("conflict_set ids must be sorted non-decreasing "
                         "for tx sharding")
    blocks = cs.reshape(n_tx_shards, t // n_tx_shards)
    for i in range(n_tx_shards - 1):
        if blocks[i, -1] == blocks[i + 1, 0]:
            raise ValueError(
                f"conflict set {int(blocks[i, -1])} straddles the boundary "
                f"between tx shards {i} and {i + 1}")
    state = state._replace(base=state.base._replace(
        inflight=inflight.repack_polled_for_shards(state.base.inflight, t,
                                                   n_tx_shards)))
    return sharded.map_specs(lambda x, s: sharded.block_of(x, s, mesh),
                             state, specs_of(state))


def gather_dag_state(state: DagSimState, mesh) -> DagSimState:
    """The global DAG state assembled from every rank's block, on every
    rank."""
    with C.bind(mesh):
        return sharded.map_specs(sharded.assemble, state, specs_of(state))


def _local_sets(conflict_set_local: torch.Tensor) -> torch.Tensor:
    """This shard's set ids re-based to 0..(local sets - 1): sorted,
    non-straddling sets make them one contiguous range.  The global
    `n_sets` bounds the local segment count."""
    return conflict_set_local - conflict_set_local[0]


def _set_done(fin_acc: torch.Tensor, state: DagSimState,
              cs_local: torch.Tensor) -> torch.Tensor:
    """Bool ``[n_local, t_local]``: has tx t's set a finalized-accepted
    member on this node?  (local columns, local set ids)"""
    if state.set_size is not None:
        return dag_model.set_any_fixed(fin_acc, state.set_size)
    done = dag_model._segment(fin_acc.to(torch.uint8), cs_local,
                              state.n_sets, "amax")
    return done[:, cs_local.long()] > 0


def _local_round(state: DagSimState, cfg: AvalancheConfig, n_global: int,
                 n_tx_shards: int) -> Tuple[DagSimState, av.SimTelemetry]:
    """One DAG round on this rank's block (inside ``collectives.bind``)."""
    base = state.base
    n_local, t_local = base.records.votes.shape
    nshard = C.axis_index(NODES_AXIS)
    offset = nshard * n_local
    cs_local = _local_sets(state.conflict_set)

    k_sample, k_byz, k_drop, k_churn, k_next = prng.split(base.key, 5)
    k_sample = prng.fold_in(k_sample, nshard)
    k_byz = prng.fold_in(k_byz, nshard)
    k_drop = prng.fold_in(k_drop, nshard)
    k_churn = prng.fold_in(k_churn, nshard)

    confidence = base.records.confidence
    fin = vr.has_finalized(confidence, cfg)
    fin_acc = fin & vr.is_accepted(confidence)
    alive_local = base.alive[offset:offset + n_local]

    with annotate("poll_mask"):
        if state.set_size is not None and t_local % state.set_size:
            raise ValueError(
                f"set_size={state.set_size} must divide the per-shard tx "
                f"width ({t_local}) for the fixed-partition fast path")
        rival_settled = _set_done(fin_acc, state, cs_local) & ~fin_acc
        pollable = (base.added & alive_local[:, None] & base.valid[None, :]
                    & ~fin & ~rival_settled)
        polled = sharded.global_capped_poll_mask(
            pollable, base.score_rank, cfg.max_element_poll, n_tx_shards,
            base.poll_order, base.poll_order_inv)

    with annotate("sample_peers"):
        peers, self_draw = draw_peers(k_sample, cfg, base.latency_weight,
                                      base.alive, n_global,
                                      n_local=n_local, id_offset=offset)
    lie = adversary.lie_mask(k_byz, peers, base.byzantine, cfg)
    responded = base.alive[peers.long()]
    if self_draw is not None:
        responded &= ~self_draw
    if cfg.drop_probability > 0.0:
        responded &= ~prng.bernoulli(k_drop, cfg.drop_probability,
                                     tuple(peers.shape))

    # --- response plane: preferred-in-set, packed and all-gathered.
    with annotate("gather_prefs"):
        if state.set_size is not None:
            prefs_local = dag_model.preferred_in_set_fixed(confidence,
                                                           state.set_size)
        else:
            prefs_local = dag_model.preferred_in_set(confidence, cs_local,
                                                     state.n_sets)
        packed_global = C.all_gather(pack_bool_plane(prefs_local),
                                     NODES_AXIS)
        if cfg.adversary_strategy is AdversaryStrategy.OPPOSE_MAJORITY:
            minority_t = sharded._global_minority_plane(prefs_local,
                                                        n_global)
        else:
            minority_t = torch.zeros(t_local, dtype=torch.bool,
                                     device=peers.device)   # unused
        k_vote = k_byz
        if (cfg.adversary_strategy is AdversaryStrategy.EQUIVOCATE
                or cfg.adversary_policy == "split_vote"):
            k_vote = prng.fold_in(k_byz, C.axis_index(TXS_AXIS))
        pol = sharded._policy_ctx_sharded(cfg, base.records, prefs_local,
                                          base.byzantine,
                                          base.latency_weight, offset,
                                          n_local)
        lie, responded, withheld = adversary.apply_policy_issue(
            cfg, pol, lie, responded)
        async_round = inflight.enabled(cfg)
        if not async_round:
            yes_pack, consider_pack = exchange.gather_vote_packs(
                packed_global, peers, responded, lie, k_vote, cfg,
                minority_t, t_local, pol)

    ring = base.inflight
    with annotate("ingest_votes"):
        if async_round:
            lat = inflight.draw_latency(k_sample, cfg, peers,
                                        base.latency_weight, n_global,
                                        row_offset=offset)
            lat = adversary.apply_policy_latency(cfg, lat, lie, withheld)
            lat = inflight.apply_faults(lat, cfg, base.round, offset,
                                        peers, n_global, base.fault_params)
            ring = inflight.enqueue(base.inflight, base.round, peers, lat,
                                    responded, lie, polled)
            records, changed, votes_applied = inflight.deliver_multi_engine(
                ring, base.records, cfg, packed_global, minority_t, k_vote,
                base.round, t_local, live_rows=alive_local, ctx=pol)
        else:
            records, changed = pallas_vote.register_packed_votes_fused(
                base.records, yes_pack, consider_pack, cfg.k, cfg,
                update_mask=polled)
            votes_applied = (av.popcnt_plane(consider_pack) * polled).sum()

    fin_after = vr.has_finalized(records.confidence, cfg)
    newly_final = fin_after & ~fin
    finalized_at = av.stamp_finality(base.finalized_at, newly_final,
                                     base.round)

    # Each node shard toggles its own rows, then the replicated [N]
    # plane is gathered again.
    alive = base.alive
    alive_local_new = alive_local
    if cfg.churn_probability > 0.0:
        alive_local_new = alive_local ^ prng.bernoulli(
            k_churn, cfg.churn_probability, (n_local,))
    alive_local_new = inflight.apply_churn_bursts(alive_local_new, cfg,
                                                  base.round, k_churn)
    if cfg.churn_probability > 0.0 or cfg.churn_burst_events():
        alive = C.all_gather(alive_local_new, NODES_AXIS)

    # The DAG round has no gossip: admissions and gossip_writes stay 0.
    zero = torch.zeros((), dtype=torch.int32, device=peers.device)
    totals = C.psum(torch.stack([
        sharded._sum(polled), votes_applied.to(torch.int32),
        sharded._sum(changed & ~newly_final), sharded._sum(newly_final)]),
        (NODES_AXIS, TXS_AXIS))
    ring_tel = (zero, zero, zero, zero)
    if async_round:
        rt = inflight.ring_telemetry(ring, cfg, base.round)
        cut = inflight.partition_cut(cfg, base.round, offset, peers,
                                     n_global, base.fault_params)
        ring_tel = tuple(C.psum(torch.stack([
            rt.deliveries, rt.expiries, rt.occupancy,
            zero if cut is None else sharded._sum(cut)]), NODES_AXIS))
    telemetry = av.SimTelemetry(
        polls=totals[0], votes_applied=totals[1], flips=totals[2],
        finalizations=totals[3], admissions=zero, deliveries=ring_tel[0],
        expiries=ring_tel[1], ring_occupancy=ring_tel[2],
        partition_blocked=ring_tel[3], gossip_writes=zero)
    new_base = base._replace(
        records=records, alive=alive, finalized_at=finalized_at,
        round=base.round + 1, key=k_next, inflight=ring,
        trace=obs_trace.write_round(base.trace, cfg, base.round, telemetry))
    return state._replace(base=new_base), telemetry


# The reference's manifest: the response plane's all-gather over nodes,
# the telemetry and settled flag over both axes, and the ring counters
# over nodes (async configs); plus the poll cap's psum over txs, which
# it omits (see `sharded.DECLARED_COLLECTIVES`).  Set passes stay local
# and the DAG round has no gossip, so there is no all-to-all.
DECLARED_COLLECTIVES = frozenset({
    ("all_gather", (NODES_AXIS,)),
    ("all_reduce", (NODES_AXIS,)),      # ring counters (async configs)
    ("all_reduce", (TXS_AXIS,)),        # poll-cap counts
    ("all_reduce", (NODES_AXIS, TXS_AXIS)),
})


def make_sharded_dag_round_step(mesh,
                                cfg: AvalancheConfig = DEFAULT_CONFIG,
                                donate: bool = False):
    """A one-round DAG step over the mesh on this rank's block
    (`shard_dag_state`); `donate` as in `sharded.make_sharded_round_step`."""
    sharded._reject_round_engine(cfg)
    n_tx = mesh.shape[TXS_AXIS]

    def step(state: DagSimState):
        n_global = state.base.records.votes.shape[0] * mesh.shape[NODES_AXIS]
        with C.bind(mesh):
            return _local_round(state, cfg, n_global, n_tx)

    return step


def _unresolved(state: DagSimState, cfg: AvalancheConfig, mesh) -> bool:
    """Is any (live node, set) anywhere still without a
    finalized-accepted member?  The psum'd flag, read once."""
    base = state.base
    n_local = base.records.votes.shape[0]
    offset = mesh.coords[NODES_AXIS] * n_local
    alive_local = base.alive[offset:offset + n_local]
    conf = base.records.confidence
    fin_acc = vr.has_finalized(conf, cfg) & vr.is_accepted(conf)
    open_sets = (~_set_done(fin_acc, state, _local_sets(state.conflict_set))
                 & alive_local[:, None] & base.valid[None, :])
    with C.bind(mesh):
        live = C.psum(open_sets.any().to(torch.int32)[None],
                      (NODES_AXIS, TXS_AXIS))
    return bool(sync.read(live[0] > 0))


def run_sharded_dag(mesh, state: DagSimState,
                    cfg: AvalancheConfig = DEFAULT_CONFIG,
                    max_rounds: int = 2000, donate: bool = False
                    ) -> DagSimState:
    """Run until every (live node, set) resolved everywhere, or
    `max_rounds`; one read of the psum'd flag a round."""
    step = make_sharded_dag_round_step(mesh, cfg, donate)
    round_ = int(sync.read(state.base.round))
    live = _unresolved(state, cfg, mesh)
    while live and round_ < max_rounds:
        state = step(state)[0]
        round_ += 1
        live = _unresolved(state, cfg, mesh)
    return state

