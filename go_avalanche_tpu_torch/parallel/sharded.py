"""The mesh-sharded multi-target round — `go_avalanche_tpu/parallel/sharded.py`.

The reference runs `models/avalanche.round_step` under `shard_map` over
the ``(nodes, txs)`` mesh; here each rank runs the body for its own
``[N/A, T/B]`` block and the cross-rank steps are explicit collectives
(`parallel/collectives.py`), all but the poll cap's and the telemetry's
on the nodes axis:

  * preference exchange: each rank packs its preference plane to bits
    and all-gathers it over the nodes axis, so peer gathers index a
    replicated packed plane;
  * gossip admission: a bit-packed or-scatter into a global-height
    plane, then an all-to-all and an OR back to the owner rows
    (`_gossip_heard_packed`);
  * poll cap: the 4096-inv cap holds across tx shards through a per-node
    rank-threshold search, one int32 per node per step psum'd over the
    txs axis (`global_capped_poll_mask`);
  * telemetry and the settled flag: psums.

The window ingest goes through `ops/pallas_vote.register_packed_votes_fused`
as the dense round's does, so a rank on the card launches kernel 1
(`csrc/vote_u8.cu`) or kernel 2 (`csrc/vote_swar.cu`) on its block.  The
reference's sharded round calls its jnp engine there, which computes the
same function.

Randomness: the round's keys fold in the nodes-shard index only, so all
tx shards of the same rows draw the same peers, flips and drops; the
equivocation and split_vote coins, per target by definition, also fold
in the txs index.  A mesh with only tx shards therefore walks the
trajectory of the 1x1 mesh, leaf for leaf.

State placement: `shard_state` cuts this rank's block out of a global
state (the reference's `device_put` onto the mesh) and `gather_state`
assembles the global state again on every rank (reading a sharded
`jax.Array` whole).  `state_specs` says, per leaf, which dimension is
cut along which axis.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from go_avalanche_tpu_torch import prng, sync
from go_avalanche_tpu_torch.config import (AdversaryStrategy,
                                           AvalancheConfig, DEFAULT_CONFIG,
                                           VoteMode)
from go_avalanche_tpu_torch.models.avalanche import (AvalancheSimState,
                                                     SimTelemetry,
                                                     capped_poll_mask,
                                                     popcnt_plane,
                                                     stamp_finality)
from go_avalanche_tpu_torch.obs import trace as obs_trace
from go_avalanche_tpu_torch.ops import adversary, exchange, inflight
from go_avalanche_tpu_torch.ops import pallas_vote
from go_avalanche_tpu_torch.ops import voterecord as vr
from go_avalanche_tpu_torch.ops.bitops import (pack_bool_plane, popcount8,
                                               unpack_bool_plane)
from go_avalanche_tpu_torch.ops.sampling import draw_peers
from go_avalanche_tpu_torch.parallel import collectives as C
from go_avalanche_tpu_torch.parallel.mesh import NODES_AXIS, TXS_AXIS
from go_avalanche_tpu_torch.utils.tracing import annotate

# A leaf's spec is a tuple with one entry per dimension: the mesh axis
# that dimension is cut along, or None.  () is a replicated leaf.
REPLICATED = ()


def state_specs(track_finality: bool = True, with_inflight: bool = False,
                with_fault_params: bool = False,
                traced: bool = False) -> AvalancheSimState:
    """The spec of every leaf of `AvalancheSimState`.

    `track_finality=False` mirrors a state whose `finalized_at` is None;
    `with_inflight` adds the async ring (per-draw planes cut along their
    node rows, the poll-mask plane along both axes); `with_fault_params`
    the realized fault parameters and `traced` the trace plane, both
    replicated (the trace row is written from psum'd counters)."""
    ring = None
    if with_inflight:
        rows = (None, NODES_AXIS, None)
        ring = inflight.InflightState(peers=rows, lat=rows, responded=rows,
                                      lie=rows,
                                      polled=(None, NODES_AXIS, TXS_AXIS))
    fault = None
    if with_fault_params:
        fault = inflight.FaultParams(
            *([REPLICATED] * len(inflight.FaultParams._fields)))
    block = (NODES_AXIS, TXS_AXIS)
    return AvalancheSimState(
        records=vr.VoteRecordState(votes=block, consider=block,
                                   confidence=block),
        added=block,
        valid=(TXS_AXIS,),
        score_rank=(TXS_AXIS,),
        poll_order=(TXS_AXIS,),      # read only with one tx shard
        poll_order_inv=(TXS_AXIS,),
        byzantine=REPLICATED,        # [N]: peer lookups need every row
        alive=REPLICATED,
        latency_weight=REPLICATED,   # [N]: the global sampling CDF
        finalized_at=block if track_finality else None,
        round=REPLICATED,
        key=REPLICATED,
        inflight=ring,
        fault_params=fault,
        trace=REPLICATED if traced else None,
    )


def specs_of(state: AvalancheSimState) -> AvalancheSimState:
    """`state_specs` mirrored from the optional leaves `state` holds."""
    return state_specs(state.finalized_at is not None,
                       state.inflight is not None,
                       state.fault_params is not None,
                       state.trace is not None)


def _is_spec(spec) -> bool:
    return isinstance(spec, tuple) and not hasattr(spec, "_fields")


def map_specs(fn, tree, specs):
    """`fn(leaf, spec)` over every leaf of a state tree (nested
    NamedTuples); None slots and plain-int statics pass, and a trace
    buffer is one leaf."""
    if _is_spec(specs):
        return fn(tree, specs)
    if not isinstance(tree, tuple):
        return tree
    return type(tree)(*(map_specs(fn, getattr(tree, f), getattr(specs, f))
                        for f in tree._fields))


def block_of(x, spec, mesh):
    """This rank's block of the global leaf `x`, contiguous."""
    if spec == REPLICATED:
        return x
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} ({x.shape[dim]}) does not "
                             f"divide over the {axis} axis ({n} shards)")
        w = x.shape[dim] // n
        x = x.narrow(dim, mesh.coords[axis] * w, w)
    return x.contiguous()


def assemble(x, spec):
    """The global leaf from this rank's block `x`: all-gathers along
    each cut dimension (inside ``collectives.bind``)."""
    if spec == REPLICATED:
        return x
    for dim, axis in reversed(list(enumerate(spec))):
        if axis is not None:
            x = C.all_gather(x, axis, dim=dim)
    return x


def shard_state(state: AvalancheSimState, mesh) -> AvalancheSimState:
    """This rank's block of the global `state`, on the state's device.

    A coalesced-engine ring is repacked to the mesh's per-shard padded
    byte layout first (`inflight.repack_polled_for_shards`)."""
    state = state._replace(inflight=inflight.repack_polled_for_shards(
        state.inflight, state.added.shape[1], mesh.shape[TXS_AXIS]))
    return map_specs(lambda x, s: block_of(x, s, mesh), state,
                     specs_of(state))


def gather_state(state: AvalancheSimState, mesh) -> AvalancheSimState:
    """The global state assembled from every rank's block, on every
    rank (a coalesced ring keeps the per-shard padded layout)."""
    with C.bind(mesh):
        return map_specs(assemble, state, specs_of(state))


def _global_minority_plane(prefs_local: torch.Tensor,
                           n_global: int) -> torch.Tensor:
    """Bool ``[t_local]``: the minority color of each target over every
    node row — local column sums psum'd over the nodes axis (an even
    split counts "no" as the minority)."""
    yes = C.psum(prefs_local.sum(dim=0, dtype=torch.int32), NODES_AXIS)
    return yes * 2 < n_global


def _policy_ctx_sharded(cfg: AvalancheConfig, records, prefs_local,
                        byzantine, latency_weight, offset: int,
                        n_local: int) -> Optional[adversary.PolicyCtx]:
    """The sharded twin of `ops/adversary.policy_ctx`, the same bits
    from psum'd tallies; None with the policy off.

      split_vote            the honest yes tally of this rank's rows,
                            psum'd over the nodes axis; the honest count
                            from the replicated byzantine plane;
      withhold_near_quorum  the near-quorum gate of this rank's columns,
                            ORed across tx shards (a querier's row spans
                            them);
      stake_eclipse         the eclipse set from the replicated planes,
                            this rank's rows kept.
    """
    if cfg.adversary_policy == "off":
        return None
    if cfg.adversary_policy == "split_vote":
        honest = ~byzantine
        honest_local = honest[offset:offset + n_local]
        yes = C.psum((prefs_local & honest_local[:, None])
                     .sum(dim=0, dtype=torch.int32), NODES_AXIS)
        n_honest = honest.sum(dtype=torch.int32)
        even = yes * 2 == n_honest
        return adversary.PolicyCtx(split_t=yes * 2 < n_honest,
                                   split_even=even,
                                   split_tied=sync.read(even.any()))
    if cfg.adversary_policy == "withhold_near_quorum":
        near_local = adversary.near_quorum_rows(records, cfg)
        near = C.psum(near_local.to(torch.int32), TXS_AXIS) > 0
        return adversary.PolicyCtx(withhold_q=near)
    if cfg.adversary_policy == "stake_eclipse":
        eclipse = adversary.eclipse_rows(latency_weight, byzantine, cfg)
        return adversary.PolicyCtx(
            eclipse_q=eclipse[offset:offset + n_local])
    return adversary.PolicyCtx()      # timing: latency plane only


def global_capped_poll_mask(pollable: torch.Tensor,
                            score_rank: torch.Tensor, cap: int,
                            n_tx_shards: int,
                            poll_order: Optional[torch.Tensor] = None,
                            poll_order_inv: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """`capped_poll_mask` with the cap held across tx shards: per node,
    the `cap` best-ranked pollable targets of the whole row.

    Per node, a binary search for the largest rank threshold R with
    ``|{t : pollable[i, t] and rank[t] < R}| <= cap``; the global ranks
    are a permutation, so the counts step by 1 and the threshold gives
    the flat top-cap exactly.  Each of the ~log2(T) steps psums one
    int32 per node row over the txs axis."""
    t_local = pollable.shape[1]
    total_t = t_local * n_tx_shards
    if total_t <= cap:
        return pollable
    if n_tx_shards == 1:
        return capped_poll_mask(pollable, cap, poll_order, poll_order_inv)
    n_local = pollable.shape[0]
    rank_row = score_rank[None, :]
    lo = torch.zeros(n_local, dtype=torch.int32, device=pollable.device)
    hi = torch.full((n_local,), total_t, dtype=torch.int32,
                    device=pollable.device)
    for _ in range(total_t.bit_length() + 1):
        mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
        keep = pollable & (rank_row < mid[:, None])
        ok = C.psum(keep.sum(dim=1, dtype=torch.int32), TXS_AXIS) <= cap
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid - 1)
    return pollable & (rank_row < lo[:, None])


def _gossip_heard_packed(peers: torch.Tensor, polled: torch.Tensor,
                         n_global: int, fused: bool = False) -> torch.Tensor:
    """uint8 ``[n_local, ceil(t_local/8)]``: the heard bits of this
    rank's rows (gossip-on-poll, `main.go:177`), packed along txs.

    An or-scatter is a max-scatter of single-bit bytes, one per bit
    position; `fused` (`cfg.fused_sharded_gossip`) does the 8 in one
    scatter over an ``[8, n_local*k, t8]`` stack, whose bit planes are
    disjoint, so their byte sum is their OR.  The global-height plane
    then goes back to its owner rows with an all-to-all over the nodes
    axis and an OR of the blocks."""
    n_local = polled.shape[0]
    k = peers.shape[1]
    n_shards = n_global // n_local
    polled_packed = pack_bool_plane(polled)               # [n_local, t8]
    t8 = polled_packed.shape[1]
    idx = peers.reshape(-1).long()                        # [n_local*k]
    upd = torch.repeat_interleave(polled_packed, k, dim=0)
    if fused:
        bit = (torch.ones(8, dtype=torch.uint8, device=peers.device)
               << torch.arange(8, dtype=torch.uint8, device=peers.device))
        upd8 = upd[None, :, :] & bit[:, None, None]       # [8, N*k, t8]
        planes = torch.zeros((8, n_global, t8), dtype=torch.uint8,
                             device=peers.device)
        planes = planes.scatter_reduce(
            1, idx[None, :, None].expand(8, -1, t8), upd8, "amax")
        heard = planes.sum(dim=0, dtype=torch.uint8)
    else:
        heard = torch.zeros((n_global, t8), dtype=torch.uint8,
                            device=peers.device)
        index = idx[:, None].expand(-1, t8)
        for b in range(8):
            src = upd & (1 << b)
            heard |= torch.zeros_like(heard).scatter_reduce(
                0, index, src, "amax")
    if n_shards == 1:
        return heard
    parts = C.all_to_all(heard, NODES_AXIS).reshape(n_shards, n_local, t8)
    out = parts[0]
    for s in range(1, n_shards):
        out = out | parts[s]
    return out


def _sum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dtype=torch.int32)


def _local_round(state: AvalancheSimState, cfg: AvalancheConfig,
                 n_global: int, n_tx_shards: int
                 ) -> Tuple[AvalancheSimState, SimTelemetry]:
    """One round on this rank's block (inside ``collectives.bind``)."""
    n_local, t_local = state.records.votes.shape
    nshard = C.axis_index(NODES_AXIS)
    offset = nshard * n_local

    # The base split is replicated; the draws fold in the nodes-shard
    # index (not the txs index: see the module docstring).
    k_sample, k_byz, k_drop, k_churn, k_next = prng.split(state.key, 5)
    k_sample = prng.fold_in(k_sample, nshard)
    k_byz = prng.fold_in(k_byz, nshard)
    k_drop = prng.fold_in(k_drop, nshard)
    k_churn = prng.fold_in(k_churn, nshard)

    fin = vr.has_finalized(state.records.confidence, cfg)
    alive_local = state.alive[offset:offset + n_local]

    # --- GetInvsForNextPoll on the block, the cap held across tx shards.
    with annotate("poll_mask"):
        pollable = (state.added & alive_local[:, None]
                    & state.valid[None, :] & ~fin)
        polled = global_capped_poll_mask(pollable, state.score_rank,
                                         cfg.max_element_poll, n_tx_shards,
                                         state.poll_order,
                                         state.poll_order_inv)

    # --- k global peer ids for the local rows.
    with annotate("sample_peers"):
        peers, self_draw = draw_peers(k_sample, cfg, state.latency_weight,
                                      state.alive, n_global,
                                      n_local=n_local, id_offset=offset)
    lie = adversary.lie_mask(k_byz, peers, state.byzantine, cfg)
    responded = state.alive[peers.long()]
    if self_draw is not None:
        responded &= ~self_draw
    if cfg.drop_probability > 0.0:
        responded &= ~prng.bernoulli(k_drop, cfg.drop_probability,
                                     tuple(peers.shape))

    # --- gossip-on-poll across shards.
    added = state.added
    zero = torch.zeros((), dtype=torch.int32, device=peers.device)
    admissions = gossip_writes = zero
    if cfg.gossip:
        with annotate("gossip_admission"):
            heard = unpack_bool_plane(
                _gossip_heard_packed(peers, polled, n_global,
                                     fused=cfg.fused_sharded_gossip),
                t_local)
            new_adds = (heard & ~added & alive_local[:, None]
                        & state.valid[None, :])
            admissions = _sum(new_adds)
            gossip_writes = _sum(heard)
            added = added | new_adds

    # --- preference exchange: pack, all-gather over nodes, gather rows.
    with annotate("gather_prefs"):
        prefs_local = vr.is_accepted(state.records.confidence)
        packed_global = C.all_gather(pack_bool_plane(prefs_local),
                                     NODES_AXIS)
        if cfg.adversary_strategy is AdversaryStrategy.OPPOSE_MAJORITY:
            minority_t = _global_minority_plane(prefs_local, n_global)
        else:
            minority_t = torch.zeros(t_local, dtype=torch.bool,
                                     device=peers.device)   # unused
        # The equivocation and split_vote coins are per target: they
        # must differ across tx shards, so they fold in the txs index.
        k_vote = k_byz
        if (cfg.adversary_strategy is AdversaryStrategy.EQUIVOCATE
                or cfg.adversary_policy == "split_vote"):
            k_vote = prng.fold_in(k_byz, C.axis_index(TXS_AXIS))
        pol = _policy_ctx_sharded(cfg, state.records, prefs_local,
                                  state.byzantine, state.latency_weight,
                                  offset, n_local)
        lie, responded, withheld = adversary.apply_policy_issue(
            cfg, pol, lie, responded)
        async_round = inflight.enabled(cfg)
        if not async_round:
            yes_pack, consider_pack = exchange.gather_vote_packs(
                packed_global, peers, responded, lie, k_vote, cfg,
                minority_t, t_local, pol)

    # --- ingest.
    ring = state.inflight
    with annotate("ingest_votes"):
        if async_round:
            lat = inflight.draw_latency(k_sample, cfg, peers,
                                        state.latency_weight, n_global,
                                        row_offset=offset)
            lat = adversary.apply_policy_latency(cfg, lat, lie, withheld)
            lat = inflight.apply_faults(lat, cfg, state.round, offset,
                                        peers, n_global, state.fault_params)
            ring = inflight.enqueue(state.inflight, state.round, peers, lat,
                                    responded, lie, polled)
            records, changed, votes_applied = inflight.deliver_multi_engine(
                ring, state.records, cfg, packed_global, minority_t, k_vote,
                state.round, t_local, live_rows=alive_local, ctx=pol)
        elif cfg.vote_mode is VoteMode.SEQUENTIAL:
            records, changed = pallas_vote.register_packed_votes_fused(
                state.records, yes_pack, consider_pack, cfg.k, cfg,
                update_mask=polled)
            votes_applied = (popcnt_plane(consider_pack) * polled).sum()
        else:
            thresh = math.ceil(cfg.alpha * cfg.k)
            yes_cnt = popcount8(yes_pack & consider_pack)
            no_cnt = popcount8(~yes_pack & consider_pack)
            err = torch.where(yes_cnt >= thresh, 0,
                              (no_cnt >= thresh).to(torch.int32) * 2 - 1)
            records, changed = vr.register_vote(state.records, err, cfg,
                                                update_mask=polled)
            votes_applied = ((err >= 0) & polled).sum()

    # --- lifecycle.
    fin_after = vr.has_finalized(records.confidence, cfg)
    newly_final = fin_after & ~fin
    finalized_at = stamp_finality(state.finalized_at, newly_final,
                                  state.round)

    alive = state.alive
    alive_local_new = alive_local
    if cfg.churn_probability > 0.0:
        alive_local_new = alive_local ^ prng.bernoulli(
            k_churn, cfg.churn_probability, (n_local,))
    # Churn bursts toggle this rank's rows (k_churn is shard-folded),
    # then the replicated [N] plane is gathered again.
    alive_local_new = inflight.apply_churn_bursts(alive_local_new, cfg,
                                                  state.round, k_churn)
    if cfg.churn_probability > 0.0 or cfg.churn_burst_events():
        alive = C.all_gather(alive_local_new, NODES_AXIS)

    # --- telemetry: one psum over both axes for the plane counters, one
    # over the nodes axis for the ring's (their planes are cut along
    # node rows only, replicated across tx shards).
    totals = C.psum(torch.stack([
        _sum(polled), votes_applied.to(torch.int32),
        _sum(changed & ~newly_final), _sum(newly_final), admissions,
        gossip_writes]), (NODES_AXIS, TXS_AXIS))
    ring_tel = (zero, zero, zero, zero)
    if async_round:
        rt = inflight.ring_telemetry(ring, cfg, state.round)
        cut = inflight.partition_cut(cfg, state.round, offset, peers,
                                     n_global, state.fault_params)
        ring_tel = tuple(C.psum(torch.stack([
            rt.deliveries, rt.expiries, rt.occupancy,
            zero if cut is None else _sum(cut)]), NODES_AXIS))
    telemetry = SimTelemetry(
        polls=totals[0], votes_applied=totals[1], flips=totals[2],
        finalizations=totals[3], admissions=totals[4],
        deliveries=ring_tel[0], expiries=ring_tel[1],
        ring_occupancy=ring_tel[2], partition_blocked=ring_tel[3],
        gossip_writes=totals[5] if cfg.gossip else zero)
    new_state = state._replace(
        records=records, added=added, alive=alive,
        finalized_at=finalized_at, round=state.round + 1, key=k_next,
        inflight=ring,
        # The row comes from the psum'd counters, the same on every
        # rank, so the replicated buffer stays replicated.
        trace=obs_trace.write_round(state.trace, cfg, state.round,
                                    telemetry))
    return new_state, telemetry


# The (collective kind, mesh axes) pairs a round may record: the
# reference's manifest for its driver, plus the psum over txs of the
# poll cap's search and the withhold gate, which that manifest omits
# (its audit lowers the round at a width under the cap, where the
# search is statically absent).
DECLARED_COLLECTIVES = frozenset({
    ("all_gather", (NODES_AXIS,)),    # packed preference plane [N, T/8]
                                      #   + the alive vector [N]
    ("all_to_all", (NODES_AXIS,)),    # gossip heard-plane owner exchange
    ("all_reduce", (NODES_AXIS,)),    # minority plane, ring counters
    ("all_reduce", (TXS_AXIS,)),      # poll-cap counts, withhold gate
    ("all_reduce", (NODES_AXIS, TXS_AXIS)),  # telemetry + settled flag
})


def _reject_round_engine(cfg: AvalancheConfig) -> None:
    """The sharded drivers run the phased round: the megakernel's
    in-kernel gather needs the whole node axis on one device, which is
    the axis these drivers cut."""
    if cfg.round_engine != "phased":
        raise ValueError(
            "round_engine 'megakernel' is wired for the single-device "
            "dense avalanche round only; the sharded drivers keep the "
            "phased path (the fused gather needs the full node axis "
            "resident per device) — the knob would be inert here")


def _n_global(state: AvalancheSimState, mesh) -> int:
    return state.records.votes.shape[0] * mesh.shape[NODES_AXIS]


def make_sharded_round_step(mesh, cfg: AvalancheConfig = DEFAULT_CONFIG,
                            donate: bool = False):
    """A one-round step over the mesh: ``step(block) -> (block,
    telemetry)`` on this rank's block (`shard_state`), the telemetry
    psum'd and the same on every rank.  `donate` is accepted and
    changes nothing: the round never updates its input in place, and
    the input's memory returns to the allocator when the caller drops
    it."""
    _reject_round_engine(cfg)
    n_tx = mesh.shape[TXS_AXIS]

    def step(state: AvalancheSimState):
        with C.bind(mesh):
            return _local_round(state, cfg, _n_global(state, mesh), n_tx)

    return step


def stack_telemetry(rows) -> SimTelemetry:
    """Per-round telemetry stacked field by field to ``[R]``."""
    return SimTelemetry(*(torch.stack(col) for col in zip(*rows)))


def run_scan_sharded(mesh, state: AvalancheSimState,
                     cfg: AvalancheConfig = DEFAULT_CONFIG,
                     n_rounds: int = 100, donate: bool = False
                     ) -> Tuple[AvalancheSimState, SimTelemetry]:
    """`n_rounds` rounds on this rank's block with the stacked
    telemetry."""
    step = make_sharded_round_step(mesh, cfg, donate)
    rows = []
    for _ in range(n_rounds):
        state, tel = step(state)
        rows.append(tel)
    return state, stack_telemetry(rows)


def _unsettled(state: AvalancheSimState, cfg: AvalancheConfig,
               mesh) -> bool:
    """Does any (live node, valid target) pair anywhere still need
    polling?  The psum'd flag, read once (`sync.read`)."""
    n_local = state.records.votes.shape[0]
    offset = mesh.coords[NODES_AXIS] * n_local
    alive_local = state.alive[offset:offset + n_local]
    fin = vr.has_finalized(state.records.confidence, cfg)
    pollable = (state.added & alive_local[:, None] & state.valid[None, :]
                & ~fin)
    with C.bind(mesh):
        live = C.psum(pollable.any().to(torch.int32)[None],
                      (NODES_AXIS, TXS_AXIS))
    return bool(sync.read(live[0] > 0))


def run_sharded(mesh, state: AvalancheSimState,
                cfg: AvalancheConfig = DEFAULT_CONFIG,
                max_rounds: int = 2000, donate: bool = False
                ) -> AvalancheSimState:
    """Run until settled everywhere (the psum'd flag) or `max_rounds`;
    one read of the flag a round, and one of the start round."""
    step = make_sharded_round_step(mesh, cfg, donate)
    round_ = int(sync.read(state.round))
    live = _unsettled(state, cfg, mesh)
    while live and round_ < max_rounds:
        state = step(state)[0]
        round_ += 1
        live = _unsettled(state, cfg, mesh)
    return state
