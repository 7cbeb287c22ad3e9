"""Single-decree Snowball: N nodes deciding one binary question —
`go_avalanche_tpu/models/snowball.py`, synchronous round only.

The whole network is one ``[N]`` vote-record state; a round is

    sample k random peers per node  ->  gather their preferences  ->
    adversary / drop transforms     ->  window update

In the SEQUENTIAL vote mode the k votes go through the 8-vote window one
at a time: the round packs them into uint8 bit planes and ingests them
through `ops/pallas_vote.register_packed_votes_fused` on an ``[N, 1]``
view of the records, which launches the ingest kernel of
`cfg.ingest_engine` on the card.  The MAJORITY mode reduces the k votes
to one chit per round (`voterecord.register_vote`).  Randomness is the
reference's: the state's threefry key split five ways per round.  Under
`cfg.async_queries()` the round enqueues its polls into the in-flight
ring (a bool ``[D, N]`` poll mask) and the response gather and adversary
transform move to delivery time (`ops/inflight.deliver_1d_engine`).  A
node whose record finalized keeps answering with its final preference,
as in the reference.  The round feeds the flight recorder: the metrics
tap (`obs/sink.emit_round`) and the `trace` leaf (`with_trace`,
`obs/trace.write_round`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from go_avalanche_tpu_torch import prng, sync
from go_avalanche_tpu_torch.config import (AvalancheConfig, DEFAULT_CONFIG,
                                           VoteMode)
from go_avalanche_tpu_torch.models.avalanche import _device, move_leaves
from go_avalanche_tpu_torch.obs import sink as obs_sink
from go_avalanche_tpu_torch.obs import trace as obs_trace
from go_avalanche_tpu_torch.ops import adversary, inflight, pallas_vote
from go_avalanche_tpu_torch.ops import voterecord as vr
from go_avalanche_tpu_torch.ops.bitops import pack_draws
from go_avalanche_tpu_torch.ops.sampling import sample_peers_uniform


class SnowballState(NamedTuple):
    """Whole-network state: ``[N]`` records and masks plus scalars."""

    records: vr.VoteRecordState   # [N] uint8 / uint8 / int16 (u16 bits)
    byzantine: torch.Tensor       # bool [N]
    alive: torch.Tensor           # bool [N]
    finalized_at: torch.Tensor    # int32 [N]; -1 until finalized
    round: torch.Tensor           # int32 scalar
    key: torch.Tensor             # int64 [2] threefry key words
    inflight: Optional[inflight.InflightState] = None  # the async ring
    fault_params: Optional[inflight.FaultParams] = None
    trace: Optional[obs_trace.TraceBuffer] = None  # None = off


class RoundTelemetry(NamedTuple):
    """Per-round int32 scalars, the reference's fields; the ring
    counters are zero in the synchronous round."""

    flips: torch.Tensor
    finalizations: torch.Tensor
    yes_preferences: torch.Tensor
    deliveries: torch.Tensor
    expiries: torch.Tensor
    ring_occupancy: torch.Tensor
    partition_blocked: torch.Tensor


# The snowball round's trace-plane column manifest (all int32).
TRACE_COLUMNS = obs_trace.columns_from_fields(RoundTelemetry._fields)


def with_trace(state: SnowballState, cfg: AvalancheConfig,
               n_rounds: int) -> SnowballState:
    """Attach the trace plane for an `n_rounds`-horizon run, on the
    state's device; no-op when `cfg.trace_every == 0`."""
    return state._replace(trace=obs_trace.alloc(cfg, n_rounds,
                                                TRACE_COLUMNS,
                                                state.round.device))


def to_device(state: SnowballState, device) -> SnowballState:
    """Move every state leaf to `device`."""
    return move_leaves(state, _device(device))


def init(key: torch.Tensor, n_nodes: int,
         cfg: AvalancheConfig = DEFAULT_CONFIG, yes_fraction: float = 0.5,
         device="cuda") -> SnowballState:
    """Fresh network on `device` (the card unless the caller asks for
    the CPU): each node starts yes with probability `yes_fraction`, the
    first ``round(byzantine_fraction * N)`` nodes are byzantine."""
    dev = _device(device)
    key = key.to(dev, torch.int64)
    k_pref, k_next = prng.split(key)
    n_byz = int(round(cfg.byzantine_fraction * n_nodes))
    return SnowballState(
        records=vr.init_state(prng.bernoulli(k_pref, yes_fraction,
                                             (n_nodes,))),
        byzantine=torch.arange(n_nodes, device=dev) < n_byz,
        alive=torch.ones(n_nodes, dtype=torch.bool, device=dev),
        finalized_at=torch.full((n_nodes,), -1, dtype=torch.int32,
                                device=dev),
        round=torch.zeros((), dtype=torch.int32, device=dev),
        key=k_next,
        inflight=(inflight.init_ring(cfg, n_nodes, device=dev)
                  if inflight.enabled(cfg) else None),
        fault_params=inflight.draw_fault_params(cfg, key, n_nodes),
    )


def _ingest_sequential(records: vr.VoteRecordState, yes_pack, consider_pack,
                       cfg: AvalancheConfig, update_mask) -> Tuple:
    """The k-vote window ingest of ``[N]`` records through the ingest
    kernel's wrapper, which takes ``[N, T]`` planes: an ``[N, 1]`` view
    in, squeezed back out."""
    col = vr.VoteRecordState(*(x[:, None] for x in records))
    new, changed = pallas_vote.register_packed_votes_fused(
        col, yes_pack[:, None], consider_pack[:, None], cfg.k, cfg,
        update_mask=update_mask[:, None])
    return vr.VoteRecordState(*(x[:, 0] for x in new)), changed[:, 0]


def _count(x: torch.Tensor) -> torch.Tensor:
    return x.sum().to(torch.int32)


def round_step(state: SnowballState, cfg: AvalancheConfig = DEFAULT_CONFIG
               ) -> Tuple[SnowballState, RoundTelemetry]:
    """One simulated network round."""
    if cfg.round_engine != "phased":
        raise ValueError(
            "round_engine 'megakernel' is wired for the dense avalanche "
            "round only; the snowball/snowflake/slush family keeps the "
            "phased path — the knob would be inert here")
    n = state.records.votes.shape[0]
    k_sample, k_byz, k_drop, k_churn, k_next = prng.split(state.key, 5)

    peers = sample_peers_uniform(k_sample, n, cfg.k, cfg.exclude_self,
                                 cfg.sample_with_replacement)
    peers_l = peers.long()
    prefs = vr.is_accepted(state.records.confidence)
    lie = adversary.lie_mask(k_byz, peers, state.byzantine, cfg)
    responded = state.alive[peers_l]
    if cfg.drop_probability > 0.0:
        responded &= ~prng.bernoulli(k_drop, cfg.drop_probability,
                                     tuple(peers.shape))
    # The adaptive adversary's context: a scalar honest split for
    # split_vote, the per-querier near-quorum gate for withholding;
    # Snowball carries no stake plane (uniform weights).
    pol = adversary.policy_ctx(cfg, state.records, state.byzantine, None,
                               prefs=prefs)
    lie, responded, withheld = adversary.apply_policy_issue(cfg, pol, lie,
                                                            responded)

    fin_before = vr.has_finalized(state.records.confidence, cfg)
    update_mask = ~fin_before & state.alive
    ring = state.inflight
    if inflight.enabled(cfg):
        # The gather and adversary transform run at delivery time.
        # Snowball has no latency_weight plane: "weighted" latency reads
        # uniform weights (all 0).
        lat = inflight.draw_latency(
            k_sample, cfg, peers,
            torch.ones(n, dtype=torch.float32, device=peers.device), n)
        lat = adversary.apply_policy_latency(cfg, lat, lie, withheld)
        lat = inflight.apply_faults(lat, cfg, state.round, 0, peers, n,
                                    state.fault_params)
        ring = inflight.enqueue(state.inflight, state.round, peers, lat,
                                responded, lie, update_mask)
        records, changed = inflight.deliver_1d_engine(
            ring, state.records, cfg, prefs, k_byz, state.round,
            live_rows=state.alive, ctx=pol)
    else:
        peer_votes = adversary.apply_1d(k_byz, prefs[peers_l], lie, cfg,
                                        prefs, pol)
        if cfg.vote_mode is VoteMode.SEQUENTIAL:
            records, changed = _ingest_sequential(
                state.records, pack_draws(peer_votes), pack_draws(responded),
                cfg, update_mask)
        else:
            thresh = math.ceil(cfg.alpha * cfg.k)
            yes_cnt = (peer_votes & responded).sum(dim=1, dtype=torch.int32)
            no_cnt = (~peer_votes & responded).sum(dim=1,
                                                 dtype=torch.int32)
            err = torch.where(yes_cnt >= thresh, 0,
                              (no_cnt >= thresh).to(torch.int32) * 2 - 1)
            records, changed = vr.register_vote(state.records, err, cfg,
                                                update_mask)

    fin_after = vr.has_finalized(records.confidence, cfg)
    newly_final = fin_after & ~fin_before
    finalized_at = torch.where(newly_final & (state.finalized_at < 0),
                               state.round, state.finalized_at)

    alive = state.alive
    if cfg.churn_probability > 0.0:
        alive = alive ^ prng.bernoulli(k_churn, cfg.churn_probability, (n,))
    alive = inflight.apply_churn_bursts(alive, cfg, state.round, k_churn)

    rt = inflight.ring_telemetry(ring, cfg, state.round)
    cut = (inflight.partition_cut(cfg, state.round, 0, peers, n,
                                  state.fault_params)
           if inflight.enabled(cfg) else None)
    telemetry = RoundTelemetry(
        flips=_count(changed & ~newly_final),
        finalizations=_count(newly_final),
        yes_preferences=_count(vr.is_accepted(records.confidence)),
        deliveries=rt.deliveries, expiries=rt.expiries,
        ring_occupancy=rt.occupancy,
        partition_blocked=(torch.zeros((), dtype=torch.int32,
                                       device=peers.device)
                           if cut is None else _count(cut)))
    obs_sink.emit_round(cfg, state.round, telemetry)
    return SnowballState(
        records=records, byzantine=state.byzantine, alive=alive,
        finalized_at=finalized_at, round=state.round + 1, key=k_next,
        inflight=ring, fault_params=state.fault_params,
        trace=obs_trace.write_round(state.trace, cfg, state.round,
                                    telemetry)), telemetry


def live_unfinished(state: SnowballState,
                    cfg: AvalancheConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """True while some live node has not finalized."""
    return (~vr.has_finalized(state.records.confidence, cfg)
            & state.alive).any()


def run(state: SnowballState, cfg: AvalancheConfig = DEFAULT_CONFIG,
        max_rounds: int = 1000, device="cuda") -> SnowballState:
    """Run on `device` until every live node finalized or `max_rounds`;
    reads the round and the pending flag back before each round to
    decide whether to go on (`sync.read`)."""
    state = to_device(state, device)
    while (sync.read(state.round) < max_rounds
           and sync.read(live_unfinished(state, cfg))):
        state = round_step(state, cfg)[0]
    return state


def run_scan(state: SnowballState, cfg: AvalancheConfig = DEFAULT_CONFIG,
             n_rounds: int = 200, device="cuda"
             ) -> Tuple[SnowballState, RoundTelemetry]:
    """`n_rounds` rounds on `device` with stacked per-round telemetry."""
    state = to_device(state, device)
    rows = []
    for _ in range(n_rounds):
        state, tel = round_step(state, cfg)
        rows.append(tel)
    return state, RoundTelemetry(*(torch.stack(col) for col in zip(*rows)))
