"""Multi-target Avalanche network simulator: N nodes x T targets —
`go_avalanche_tpu/models/avalanche.py`, synchronous round only.

One `round_step` is the whole network doing one poll / response /
ingest cycle on dense ``[nodes, txs]`` tensors:

    poll-cap top-score targets  (GetInvsForNextPoll)
    sample k peers per node
    gossip-on-poll admission
    gather peer preferences + adversary / drop transforms
    k-vote window ingest        (RegisterVotes)

With `cfg.async_queries()` the round stamps each poll with a latency
(and the fault script's spikes and cuts), enqueues it into the in-flight
ring carried in the state, and delivers whatever the ring holds for this
round through `ops/inflight.deliver_multi_engine` (plain PyTorch, as in
the reference); otherwise `cfg.round_engine` selects the phased path (exchange as plain PyTorch,
then the window ingest of `cfg.ingest_engine` through
`ops/pallas_vote.register_packed_votes_fused`, a hand-written CUDA
kernel on the card) or the megakernel (`ops/megakernel.py`, one
hand-written CUDA kernel for the whole round).  Randomness comes from the
threefry key carried in the state (`prng.py`), split exactly as the
reference splits it, so both packages walk the same trajectory from the
same state.  Peers are drawn by `ops/sampling.draw_peers` (uniform,
distinct, weighted, clustered or stake-weighted, the stake folded into
`latency_weight` at `init`).  The adaptive adversary's context
(`ops/adversary.policy_ctx`) is read from the pre-round records after the
drop draw and threaded through the exchange and the delivery engines.
After the telemetry is assembled the round feeds the flight recorder on
every engine: `obs/sink.emit_round` (under `cfg.metrics_every`) and
`obs/trace.write_round` into the state's `trace` leaf (attached by
`with_trace` under `cfg.trace_every`); both are plain PyTorch with no
read back to the host.

The round's phases run under `utils/tracing.annotate` spans with the
reference's names (poll_mask, sample_peers, gossip_admission,
gather_prefs, fused_round / ingest_votes), and the rest of it under the
port's own (key_split, responses, finality, telemetry), all inside
`round`, as in `models/dag.round_step`; `all_settled` runs under
`settled`.  So every line of the round that launches device work runs
in a named child of `round`, and a profiler trace reads device time per
phase (`round_profile.py`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from go_avalanche_tpu_torch import prng, stake, sync
from go_avalanche_tpu_torch.config import (AvalancheConfig, DEFAULT_CONFIG,
                                           VoteMode)
from go_avalanche_tpu_torch.obs import sink as obs_sink
from go_avalanche_tpu_torch.obs import trace as obs_trace
from go_avalanche_tpu_torch.ops import (adversary, exchange, inflight,
                                        megakernel, pallas_vote)
from go_avalanche_tpu_torch.ops import voterecord as vr
from go_avalanche_tpu_torch.ops.bitops import pack_bool_plane, popcount8
from go_avalanche_tpu_torch.ops.sampling import draw_peers
from go_avalanche_tpu_torch.utils.tracing import annotate


def popcnt_plane(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of a uint8 plane, as int32."""
    return popcount8(x).to(torch.int32)


class AvalancheSimState(NamedTuple):
    """Whole-network state; the reference's leaves."""

    records: vr.VoteRecordState   # [N, T] uint8 / uint8 / int16 (u16 bits)
    added: torch.Tensor           # bool [N, T] — node reconciles target
    valid: torch.Tensor           # bool [T]
    score_rank: torch.Tensor      # int32 [T] — 0 = highest score
    poll_order: torch.Tensor      # int32 [T] — target ids best-score-first
    poll_order_inv: torch.Tensor  # int32 [T] — inverse of poll_order
    byzantine: torch.Tensor       # bool [N]
    alive: torch.Tensor           # bool [N]
    latency_weight: torch.Tensor  # float32 [N]
    finalized_at: Optional[torch.Tensor]  # int32 [N, T]; -1 until final
    round: torch.Tensor           # int32 scalar
    key: torch.Tensor             # int64 [2] threefry key words
    inflight: Optional[inflight.InflightState] = None  # the async ring,
                                  # present iff cfg.async_queries()
    fault_params: Optional[inflight.FaultParams] = None  # realized
                                  # stochastic fault events, or None
    trace: Optional[obs_trace.TraceBuffer] = None  # the trace plane
                                  # (`with_trace`); None = off


class SimTelemetry(NamedTuple):
    """Per-round int32 scalars, the reference's fields; the ring
    counters are zero in the synchronous round."""

    polls: torch.Tensor
    votes_applied: torch.Tensor
    flips: torch.Tensor
    finalizations: torch.Tensor
    admissions: torch.Tensor
    deliveries: torch.Tensor
    expiries: torch.Tensor
    ring_occupancy: torch.Tensor
    partition_blocked: torch.Tensor
    gossip_writes: torch.Tensor


# The round's trace-plane column manifest: the SimTelemetry fields in
# JSONL flattening order, all int32 counters.
TRACE_COLUMNS = obs_trace.columns_from_fields(SimTelemetry._fields)


def with_trace(state: AvalancheSimState, cfg: AvalancheConfig,
               n_rounds: int) -> AvalancheSimState:
    """Attach the trace plane for an `n_rounds`-horizon run, on the
    state's device (no-op when `cfg.trace_every == 0`); also the DAG
    round's buffer, which emits the same `SimTelemetry` columns."""
    return state._replace(trace=obs_trace.alloc(cfg, n_rounds,
                                                TRACE_COLUMNS,
                                                state.round.device))


def _device(device) -> torch.device:
    """Resolve an entry point's device, refusing CUDA where there is none
    (no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           f"torch.cuda.is_available() is False; pass "
                           f"device='cpu' to run on the CPU")
    return dev


def move_leaves(tree, device):
    """Every tensor leaf of a (nested) tuple or NamedTuple, or of a trace
    buffer, on `device`; None and plain ints pass."""
    if isinstance(tree, (torch.Tensor, obs_trace.TraceBuffer)):
        return tree.to(device)
    if isinstance(tree, tuple):
        leaves = (move_leaves(x, device) for x in tree)
        return type(tree)(*leaves) if hasattr(tree, "_fields") else tuple(
            leaves)
    return tree


def to_device(state: AvalancheSimState, device) -> AvalancheSimState:
    """Move every state leaf to `device`."""
    return move_leaves(state, _device(device))


def contested_init_pref(seed: int, n_nodes: int, n_txs: int,
                        device="cuda") -> torch.Tensor:
    """Per-node 50/50 initial preferences, bool ``[N, T]`` — the
    reference's ``bernoulli(key(seed + 1), 0.5, (N, T))``."""
    return prng.bernoulli(prng.key(seed + 1, _device(device)), 0.5,
                          (n_nodes, n_txs))


def contested_init_pref_from_key(key: torch.Tensor, n_nodes: int,
                                 n_txs: int) -> torch.Tensor:
    """`contested_init_pref` from a key instead of a seed — the fleet's
    per-trial priors, ``bernoulli(fold_in(key, 0xC0), 0.5, (N, T))`` on
    the key's device."""
    return prng.bernoulli(prng.fold_in(key, 0xC0), 0.5, (n_nodes, n_txs))


def stamp_finality(finalized_at, newly_final, round_):
    """Record first-finalization rounds; None (tracking off) passes."""
    if finalized_at is None:
        return None
    return torch.where(newly_final & (finalized_at < 0), round_, finalized_at)


def reset_finality(finalized_at, take_cols):
    """Clear stamps for window columns being re-admitted (streaming
    schedulers); None (tracking off) passes."""
    if finalized_at is None:
        return None
    return torch.where(take_cols[None, :], -1, finalized_at)


def score_rank_with_orders(scores: torch.Tensor) -> Tuple:
    """``(score_rank, poll_order, poll_order_inv)`` from raw scores with
    one stable argsort (descending score, ties by index)."""
    t = scores.shape[0]
    order = torch.argsort(-scores, stable=True).to(torch.int32)
    ar = torch.arange(t, dtype=torch.int32, device=scores.device)
    rank = torch.zeros(t, dtype=torch.int32, device=scores.device)
    rank[order.long()] = ar
    return rank, order, rank.clone()


def score_ranks(scores: torch.Tensor) -> torch.Tensor:
    """Rank targets by descending score; int32 [T], 0 = best, ties by
    index — the reference's `score_ranks`, the first of
    `score_rank_with_orders`."""
    return score_rank_with_orders(scores)[0]


def init(
    key: torch.Tensor,
    n_nodes: int,
    n_txs: int,
    cfg: AvalancheConfig = DEFAULT_CONFIG,
    init_pref: Optional[torch.Tensor] = None,
    scores: Optional[torch.Tensor] = None,
    added: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    latency_weights: Optional[torch.Tensor] = None,
    track_finality: bool = True,
    device="cuda",
) -> AvalancheSimState:
    """Fresh network on `device` (the card unless the caller asks for the
    CPU).  Defaults mirror the reference: every node holds every tx,
    every tx starts accepted with score 1."""
    dev = _device(device)
    if init_pref is None:
        init_pref = torch.ones(n_txs, dtype=torch.bool, device=dev)
    init_pref = init_pref.to(dev, torch.bool)
    if init_pref.ndim == 1:
        init_pref = init_pref[None, :].expand(n_nodes, n_txs).contiguous()
    if scores is None:
        scores = torch.ones(n_txs, dtype=torch.int32, device=dev)
    if added is None:
        added = torch.ones((n_nodes, n_txs), dtype=torch.bool, device=dev)
    if valid is None:
        valid = torch.ones(n_txs, dtype=torch.bool, device=dev)
    if latency_weights is None:
        latency_weights = torch.ones(n_nodes, dtype=torch.float32,
                                     device=dev)
    latency_weights = latency_weights.to(dev, torch.float32)
    if stake.stake_enabled(cfg) and not stake.registry_enabled(cfg):
        # The stake vector folds into the sampling-propensity plane, so
        # every peer draw is a stake-weighted committee draw.  With the
        # node registry on, row index is not node id: the node-stream
        # scheduler owns the plane (`models/node_stream.init`).
        latency_weights = latency_weights * stake.node_stake(cfg, n_nodes,
                                                             dev)
    n_byz = int(round(cfg.byzantine_fraction * n_nodes))
    score_rank, poll_order, poll_order_inv = score_rank_with_orders(
        scores.to(dev))
    return AvalancheSimState(
        records=vr.init_state(init_pref),
        added=added.to(dev, torch.bool),
        valid=valid.to(dev, torch.bool),
        score_rank=score_rank,
        poll_order=poll_order,
        poll_order_inv=poll_order_inv,
        byzantine=torch.arange(n_nodes, device=dev) < n_byz,
        alive=torch.ones(n_nodes, dtype=torch.bool, device=dev),
        latency_weight=latency_weights,
        finalized_at=(torch.full((n_nodes, n_txs), -1, dtype=torch.int32,
                                 device=dev) if track_finality else None),
        round=torch.zeros((), dtype=torch.int32, device=dev),
        key=key.to(dev, torch.int64),
        inflight=(inflight.init_ring(cfg, n_nodes, n_txs, device=dev)
                  if inflight.enabled(cfg) else None),
        fault_params=inflight.draw_fault_params(
            cfg, key.to(dev, torch.int64), n_nodes),
    )


def capped_poll_mask(pollable: torch.Tensor, cap: int,
                     poll_order: torch.Tensor,
                     poll_order_inv: torch.Tensor) -> torch.Tensor:
    """Keep at most `cap` pollable targets per node, best score first;
    a no-op when T <= cap."""
    t = pollable.shape[-1]
    if t <= cap:
        return pollable
    in_order = pollable[:, poll_order.long()]
    keep = (torch.cumsum(in_order.to(torch.int32), dim=1,
                         dtype=torch.int32) <= cap) & in_order
    return keep[:, poll_order_inv.long()]


def _count(x: torch.Tensor) -> torch.Tensor:
    return x.sum().to(torch.int32)


def round_step(
    state: AvalancheSimState,
    cfg: AvalancheConfig = DEFAULT_CONFIG,
) -> Tuple[AvalancheSimState, SimTelemetry]:
    """One network-wide poll / response / ingest round."""
    with annotate("round"):
        return _round(state, cfg)


def _round(state: AvalancheSimState, cfg: AvalancheConfig
           ) -> Tuple[AvalancheSimState, SimTelemetry]:
    n, t = state.records.votes.shape
    with annotate("key_split"):
        k_sample, k_byz, k_drop, k_churn, k_next = prng.split(state.key, 5)

    with annotate("finality"):
        fin = vr.has_finalized(state.records.confidence, cfg)

    # --- GetInvsForNextPoll: live, valid, non-finalized, score-capped.
    with annotate("poll_mask"):
        pollable = (state.added & state.alive[:, None] & state.valid[None, :]
                    & ~fin)
        polled = capped_poll_mask(pollable, cfg.max_element_poll,
                                  state.poll_order, state.poll_order_inv)

    # --- peer sampling, lies, non-responses.
    with annotate("sample_peers"):
        peers, self_draw = draw_peers(k_sample, cfg, state.latency_weight,
                                      state.alive, n)
    with annotate("responses"):
        lie = adversary.lie_mask(k_byz, peers, state.byzantine, cfg)
        responded = state.alive[peers.long()]
        if self_draw is not None:
            responded &= ~self_draw
        if cfg.drop_probability > 0.0:
            responded &= ~prng.bernoulli(k_drop, cfg.drop_probability,
                                         tuple(peers.shape))

        # --- adaptive adversary: one context from the pre-round records
        # (None with the policy off) decides who lies, and whether a lie
        # is silence instead.
        pol = adversary.policy_ctx(cfg, state.records, state.byzantine,
                                   state.latency_weight)
        lie, responded, withheld = adversary.apply_policy_issue(
            cfg, pol, lie, responded)

    # --- gossip-on-poll admission.
    added = state.added
    admissions = gossip_writes = None
    if cfg.gossip:
        with annotate("gossip_admission"):
            heard = exchange.gossip_heard(peers, polled.to(torch.uint8),
                                          cfg) > 0
            new_adds = (heard & ~added & state.alive[:, None]
                        & state.valid[None, :])
            admissions = _count(new_adds)
            gossip_writes = _count(heard)
            added = added | new_adds

    # --- gather peer preferences (at delivery time under async queries).
    megakernel_round = cfg.round_engine == "megakernel"
    async_round = inflight.enabled(cfg)
    with annotate("gather_prefs"):
        prefs = vr.is_accepted(state.records.confidence)
        packed_prefs = pack_bool_plane(prefs)
        minority_t = adversary.minority_plane(prefs)
        if not (megakernel_round or async_round):
            yes_pack, consider_pack = exchange.gather_vote_packs(
                packed_prefs, peers, responded, lie, k_byz, cfg, minority_t,
                t, pol)

    # --- ingest: the async ring, the megakernel, or the phased ingest.
    ring = state.inflight
    with annotate("fused_round" if megakernel_round else "ingest_votes"):
        if async_round:
            # Stamp this round's polls with latencies, the policy's
            # stamps, then the fault script's spikes and cuts, enqueue
            # them, and deliver what the ring holds for this round.
            lat = inflight.draw_latency(k_sample, cfg, peers,
                                        state.latency_weight, n)
            lat = adversary.apply_policy_latency(cfg, lat, lie, withheld)
            lat = inflight.apply_faults(lat, cfg, state.round, 0, peers, n,
                                        state.fault_params)
            ring = inflight.enqueue(state.inflight, state.round, peers, lat,
                                    responded, lie, polled)
            records, changed, votes_applied = inflight.deliver_multi_engine(
                ring, state.records, cfg, packed_prefs, minority_t, k_byz,
                state.round, t, live_rows=state.alive, ctx=pol)
        elif megakernel_round:
            records, changed = megakernel.fused_round(
                state.records, packed_prefs, peers, responded, lie,
                minority_t, polled, cfg)
            # consider_pack is the per-row responded count broadcast over
            # txs, so the phased count folds to this closed form.
            votes_applied = (responded.sum(dim=1, dtype=torch.int32)[:, None]
                             * polled).sum()
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

    # --- lifecycle + telemetry.
    with annotate("finality"):
        fin_after = vr.has_finalized(records.confidence, cfg)
        newly_final = fin_after & ~fin
        finalized_at = stamp_finality(state.finalized_at, newly_final,
                                      state.round)

    with annotate("telemetry"):
        alive = state.alive
        if cfg.churn_probability > 0.0:
            alive = alive ^ prng.bernoulli(k_churn, cfg.churn_probability,
                                           (n,))
        alive = inflight.apply_churn_bursts(alive, cfg, state.round, k_churn)

        zero = torch.zeros((), dtype=torch.int32, device=peers.device)
        rt = inflight.ring_telemetry(ring, cfg, state.round)
        cut = (inflight.partition_cut(cfg, state.round, 0, peers, n,
                                      state.fault_params)
               if async_round else None)
        telemetry = SimTelemetry(
            polls=_count(polled),
            votes_applied=votes_applied.to(torch.int32),
            flips=_count(changed & ~newly_final),
            finalizations=_count(newly_final),
            admissions=zero if admissions is None else admissions,
            deliveries=rt.deliveries,
            expiries=rt.expiries,
            ring_occupancy=rt.occupancy,
            partition_blocked=zero if cut is None else _count(cut),
            gossip_writes=zero if gossip_writes is None else gossip_writes,
        )
        obs_sink.emit_round(cfg, state.round, telemetry)
        new_state = state._replace(
            records=records, added=added, alive=alive,
            finalized_at=finalized_at, round=state.round + 1, key=k_next,
            inflight=ring,
            trace=obs_trace.write_round(state.trace, cfg, state.round,
                                        telemetry))
    return new_state, telemetry


def all_settled(state: AvalancheSimState,
                cfg: AvalancheConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """True when no (live node, valid target) pair still needs polling."""
    with annotate("settled"):
        with annotate("finality"):
            fin = vr.has_finalized(state.records.confidence, cfg)
        pollable = (state.added & state.alive[:, None]
                    & state.valid[None, :] & ~fin)
        return ~pollable.any()


def run(state: AvalancheSimState, cfg: AvalancheConfig = DEFAULT_CONFIG,
        max_rounds: int = 2000, device="cuda") -> AvalancheSimState:
    """Run on `device` until the network settles or `max_rounds`; reads
    the round and the settled flag back before each round to decide
    whether to go on (`sync.read`)."""
    state = to_device(state, device)
    while (sync.read(state.round) < max_rounds
           and not sync.read(all_settled(state, cfg))):
        state = round_step(state, cfg)[0]
    return state


def run_scan(state: AvalancheSimState,
             cfg: AvalancheConfig = DEFAULT_CONFIG, n_rounds: int = 200,
             device="cuda") -> Tuple[AvalancheSimState, SimTelemetry]:
    """`n_rounds` rounds on `device` with stacked per-round telemetry."""
    state = to_device(state, device)
    rows = []
    for _ in range(n_rounds):
        state, tel = round_step(state, cfg)
        rows.append(tel)
    return state, SimTelemetry(*(torch.stack(col) for col in zip(*rows)))
