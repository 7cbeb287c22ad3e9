"""Conflict-set Avalanche: double-spend resolution over ``[nodes, txs]``
— `go_avalanche_tpu/models/dag.py`, synchronous round only.

Transactions partition into conflict sets (`conflict_set[t]` is tx t's
set id).  Per node and set, the preferred tx is the one with the highest
confidence word (counter, then accepted bit, then lowest tx index); a
node answers a poll about tx t with yes iff t is preferred in its set,
so set winners gather chits and losers flip to rejected.  A set settles
for a node once any member finalized accepted, and its rivals stop
being polled.

Set reductions are `scatter_reduce` ("amax" / "amin") over the tx axis,
or, for the contiguous ``arange(T) // c`` partition that `init`
detects, reshapes to ``[N, S, c]``.  The preference order is the u16
confidence word, which the int16 storage reads negative from 0x8000 on,
so every max, min and argmax runs on the widened int32 word.  The round
ingests through `ops/pallas_vote.register_packed_votes_fused`, as the
avalanche round does; under `cfg.async_queries()` the round enqueues its
polls into the in-flight ring and delivers through
`ops/inflight.deliver_multi_engine` instead, responses voting the
responder's preferred-in-set plane as of the delivery round's start.  The
adaptive adversary's context is built from that plane and the pre-round
windows before the exchange.  The round feeds the flight recorder as the
avalanche round does: `obs/sink.emit_round` and `obs/trace.write_round`
into `base.trace` (attached by `with_trace`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from go_avalanche_tpu_torch import prng, sync
from go_avalanche_tpu_torch.config import AvalancheConfig, DEFAULT_CONFIG
from go_avalanche_tpu_torch.models import avalanche as av
from go_avalanche_tpu_torch.obs import sink as obs_sink
from go_avalanche_tpu_torch.obs import trace as obs_trace
from go_avalanche_tpu_torch.ops import (adversary, exchange, inflight,
                                        pallas_vote)
from go_avalanche_tpu_torch.ops import voterecord as vr
from go_avalanche_tpu_torch.ops.bitops import pack_bool_plane, popcount8
from go_avalanche_tpu_torch.ops.sampling import draw_peers
from go_avalanche_tpu_torch.utils.tracing import annotate


class DagSimState(NamedTuple):
    """Avalanche sim state plus the conflict partition.  `n_sets` and
    `set_size` are plain ints: `set_size` is c when the partition is
    ``arange(T) // c`` (the reshape fast path), else None."""

    base: av.AvalancheSimState
    conflict_set: torch.Tensor    # int32 [T] — set id per tx
    n_sets: int
    set_size: Optional[int] = None


def to_device(state: DagSimState, device) -> DagSimState:
    """Move every state leaf to `device`."""
    base = av.to_device(state.base, device)
    return state._replace(base=base,
                          conflict_set=state.conflict_set.to(
                              base.records.votes.device))


def with_trace(state: DagSimState, cfg: AvalancheConfig,
               n_rounds: int) -> DagSimState:
    """Attach the trace plane for an `n_rounds`-horizon run: the DAG
    round emits `SimTelemetry`, so the buffer is the avalanche round's
    manifest on the base state.  No-op when `cfg.trace_every == 0`."""
    return state._replace(base=av.with_trace(state.base, cfg, n_rounds))


def _segment(values: torch.Tensor, conflict_set: torch.Tensor, n_sets: int,
             reduce: str) -> torch.Tensor:
    """Per-node segment reduction of ``[N, T]`` over the tx axis ->
    ``[N, S]``; sets with no member keep 0."""
    n = values.shape[0]
    out = torch.zeros((n, n_sets), dtype=values.dtype, device=values.device)
    index = conflict_set.long()[None, :].expand(n, -1)
    return out.scatter_reduce(1, index, values, reduce, include_self=False)


def init(
    key: torch.Tensor,
    n_nodes: int,
    conflict_set: torch.Tensor,
    cfg: AvalancheConfig = DEFAULT_CONFIG,
    init_pref: Optional[torch.Tensor] = None,
    scores: Optional[torch.Tensor] = None,
    track_finality: bool = True,
    n_sets: Optional[int] = None,
    set_size: Optional[int] = None,
    device="cuda",
) -> DagSimState:
    """Fresh conflicted network on `device` (the card unless the caller
    asks for the CPU).

    `conflict_set` is an int32 ``[T]`` partition.  `init_pref` defaults
    to "every node prefers the lowest-index tx of each set".  `n_sets` /
    `set_size` state the partition's statics instead of reading them off
    `conflict_set`; `set_size` (with `n_sets`) claims the
    ``arange(T) // set_size`` layout, and both are checked.
    """
    with annotate("init"):
        dev = av._device(device)
        conflict_set = torch.as_tensor(conflict_set).to(dev, torch.int32)
        n_txs = conflict_set.shape[0]
        layout = torch.arange(n_txs, device=dev)
        if n_sets is None:
            if set_size is not None:
                raise ValueError(
                    "set_size override requires n_sets (pass both, or "
                    "neither for host-side detection)")
            n_sets = sync.read(conflict_set.max()) + 1
            # Fast-path detection: the fixed-capacity contiguous partition.
            if n_txs % n_sets == 0:
                c = n_txs // n_sets
                if sync.read((conflict_set == layout // c).all()):
                    set_size = c
        elif set_size is not None:
            if n_txs % set_size or n_sets != n_txs // set_size:
                raise ValueError(
                    f"set_size={set_size} with n_sets={n_sets} does not "
                    f"tile {n_txs} txs")
            if not sync.read((conflict_set == layout // set_size).all()):
                raise ValueError(
                    f"set_size={set_size} claims the contiguous "
                    f"arange(T) // set_size layout, but conflict_set is "
                    f"partitioned differently — pass n_sets alone for an "
                    f"arbitrary partition")
        else:
            max_set = sync.read(conflict_set.max())
            if max_set >= n_sets:
                raise ValueError(
                    f"n_sets={n_sets} undercounts conflict_set (max set "
                    f"id {max_set}) — txs in sets >= {n_sets} would be "
                    f"silently dropped by every segment reduction")
        if init_pref is None:
            # The first member of each set, by a deterministic min (a
            # scatter of duplicate indices has no order on CUDA); an empty
            # set keeps 0, as in the reference.
            first_of_set = torch.zeros(n_sets, dtype=torch.int64, device=dev)
            first_of_set = first_of_set.scatter_reduce(
                0, conflict_set.long(), layout, "amin", include_self=False)
            init_pref = torch.zeros(n_txs, dtype=torch.bool, device=dev)
            init_pref[first_of_set] = True
        base = av.init(key, n_nodes, n_txs, cfg, init_pref=init_pref,
                       scores=scores, track_finality=track_finality,
                       device=dev)
        return DagSimState(base=base, conflict_set=conflict_set,
                           n_sets=n_sets, set_size=set_size)


def preferred_in_set(confidence: torch.Tensor, conflict_set: torch.Tensor,
                     n_sets: int) -> torch.Tensor:
    """Bool ``[N, T]``: is tx t this node's preferred member of its set?
    The order is the u16 confidence word (counter, then accepted bit),
    ties to the lowest tx index: a segment max, then a segment min of
    the indices of the maxima."""
    strength = vr.widen_confidence(confidence)           # int32 [N, T]
    cs = conflict_set.long()
    best = _segment(strength, conflict_set, n_sets, "amax")   # [N, S]
    is_best = strength == best[:, cs]
    t = confidence.shape[-1]
    idx = torch.arange(t, dtype=torch.int32, device=confidence.device)
    idx_masked = torch.where(is_best, idx, t)            # non-best -> T
    first_best = _segment(idx_masked, conflict_set, n_sets, "amin")
    return idx[None, :] == first_best[:, cs]


def preferred_in_set_fixed(confidence: torch.Tensor,
                           set_size: int) -> torch.Tensor:
    """`preferred_in_set` for the contiguous ``arange(T) // c``
    partition: one reshape and `argmax`, which returns the first maximum
    (the lowest-index tie-break)."""
    n, t = confidence.shape
    grouped = vr.widen_confidence(confidence).reshape(n, t // set_size,
                                                      set_size)
    best_lane = torch.argmax(grouped, dim=2)             # [N, S]
    lanes = torch.arange(set_size, device=confidence.device)
    return (lanes[None, None, :] == best_lane[:, :, None]).reshape(n, t)


def set_any_fixed(plane: torch.Tensor, set_size: int) -> torch.Tensor:
    """Bool ``[N, T]``: does tx t's set hold a True anywhere on this node?
    (contiguous partition)."""
    n, t = plane.shape
    done = plane.reshape(n, t // set_size, set_size).any(dim=2)   # [N, S]
    return done.repeat_interleave(set_size, dim=1)


def round_step(
    state: DagSimState,
    cfg: AvalancheConfig = DEFAULT_CONFIG,
) -> Tuple[DagSimState, av.SimTelemetry]:
    """One conflicted-network round: responses vote conflict-set
    preference, and a set that finalized on a node freezes its rivals
    there."""
    with annotate("round"):
        return _round(state, cfg)


def _round(state: DagSimState, cfg: AvalancheConfig
           ) -> Tuple[DagSimState, av.SimTelemetry]:
    if cfg.round_engine != "phased":
        raise ValueError(
            "round_engine 'megakernel' is wired for the dense avalanche "
            "round only; the dag model keeps the phased path (fusing the "
            "conflict-set preference vote is a ROADMAP follow-up) — the "
            "knob would be inert here")
    base = state.base
    n, t = base.records.votes.shape
    with annotate("key_split"):
        k_sample, k_byz, k_drop, k_churn, k_next = prng.split(base.key, 5)
    confidence = base.records.confidence

    with annotate("finality"):
        fin = vr.has_finalized(confidence, cfg)
        fin_acc = fin & vr.is_accepted(confidence)

    with annotate("poll_mask"):
        # A set is settled for a node once any member finalized accepted.
        if state.set_size is not None:
            rival_settled = set_any_fixed(fin_acc, state.set_size) & ~fin_acc
        else:
            set_done = _segment(fin_acc.to(torch.uint8), state.conflict_set,
                                state.n_sets, "amax")             # [N, S]
            rival_settled = ((set_done[:, state.conflict_set.long()] > 0)
                             & ~fin_acc)
        pollable = (base.added & base.alive[:, None] & base.valid[None, :]
                    & ~fin & ~rival_settled)
        polled = av.capped_poll_mask(pollable, cfg.max_element_poll,
                                     base.poll_order, base.poll_order_inv)

    with annotate("sample_peers"):
        peers, self_draw = draw_peers(k_sample, cfg, base.latency_weight,
                                      base.alive, n)
    with annotate("responses"):
        lie = adversary.lie_mask(k_byz, peers, base.byzantine, cfg)
        responded = base.alive[peers.long()]
        if self_draw is not None:
            responded &= ~self_draw
        if cfg.drop_probability > 0.0:
            responded &= ~prng.bernoulli(k_drop, cfg.drop_probability,
                                         tuple(peers.shape))

    # Responses: yes iff the tx is the peer's preferred member of its set.
    with annotate("gather_prefs"):
        prefs = None     # the unpacked plane, where the plain path makes it
        if (state.set_size is not None
                and exchange.prefs_pack_route(confidence.device, cfg)):
            packed_prefs, minority_t = exchange.prefs_pack(
                confidence, state.set_size, cfg)
        else:
            if confidence.device.type == "cuda":
                exchange.plain_routes["prefs_pack"] += 1
            if state.set_size is not None:
                prefs = preferred_in_set_fixed(confidence, state.set_size)
            else:
                prefs = preferred_in_set(confidence, state.conflict_set,
                                         state.n_sets)
            minority_t = adversary.minority_plane(prefs)
            packed_prefs = pack_bool_plane(prefs)
        # The adaptive adversary's context: the split tally reads the
        # preferred-in-set plane (what responders say), the near-quorum
        # gate the pre-round windows.
        pol = adversary.policy_ctx(cfg, base.records, base.byzantine,
                                   base.latency_weight, prefs=prefs)
        lie, responded, withheld = adversary.apply_policy_issue(
            cfg, pol, lie, responded)
        async_round = inflight.enabled(cfg)
        if not async_round:
            yes_pack, consider_pack = exchange.gather_vote_packs(
                packed_prefs, peers, responded, lie, k_byz, cfg, minority_t,
                t, pol)

    ring = base.inflight
    with annotate("ingest_votes"):
        if async_round:
            lat = inflight.draw_latency(k_sample, cfg, peers,
                                        base.latency_weight, n)
            lat = adversary.apply_policy_latency(cfg, lat, lie, withheld)
            lat = inflight.apply_faults(lat, cfg, base.round, 0, peers, n,
                                        base.fault_params)
            ring = inflight.enqueue(base.inflight, base.round, peers, lat,
                                    responded, lie, polled)
            records, changed, votes_applied = inflight.deliver_multi_engine(
                ring, base.records, cfg, packed_prefs, minority_t, k_byz,
                base.round, t, live_rows=base.alive, ctx=pol)
        else:
            records, changed = pallas_vote.register_packed_votes_fused(
                base.records, yes_pack, consider_pack, cfg.k, cfg,
                update_mask=polled)
            votes_applied = (popcount8(consider_pack).to(torch.int32)
                             * polled).sum()

    with annotate("finality"):
        fin_after = vr.has_finalized(records.confidence, cfg)
        newly_final = fin_after & ~fin
        finalized_at = av.stamp_finality(base.finalized_at, newly_final,
                                         base.round)

    with annotate("telemetry"):
        alive = base.alive
        if cfg.churn_probability > 0.0:
            alive = alive ^ prng.bernoulli(k_churn, cfg.churn_probability,
                                           (n,))
        alive = inflight.apply_churn_bursts(alive, cfg, base.round, k_churn)

        zero = torch.zeros((), dtype=torch.int32, device=peers.device)
        rt = inflight.ring_telemetry(ring, cfg, base.round)
        cut = (inflight.partition_cut(cfg, base.round, 0, peers, n,
                                      base.fault_params)
               if async_round else None)
        telemetry = av.SimTelemetry(
            polls=av._count(polled),
            votes_applied=votes_applied.to(torch.int32),
            flips=av._count(changed & ~newly_final),
            finalizations=av._count(newly_final),
            admissions=zero,
            deliveries=rt.deliveries,
            expiries=rt.expiries,
            ring_occupancy=rt.occupancy,
            partition_blocked=zero if cut is None else av._count(cut),
            gossip_writes=zero,
        )
        obs_sink.emit_round(cfg, base.round, telemetry)
        new_base = base._replace(
            records=records, alive=alive, finalized_at=finalized_at,
            round=base.round + 1, key=k_next, inflight=ring,
            trace=obs_trace.write_round(base.trace, cfg, base.round,
                                        telemetry))
    return state._replace(base=new_base), telemetry


def winners_per_set(fin_acc, set_size: int):
    """Finalized-accepted member count per contiguous set, ``[N, T//c]``
    (numpy or torch): a (node, set) pair is resolved iff it is 1."""
    n, t = fin_acc.shape
    return fin_acc.reshape(n, t // set_size, set_size).sum(axis=2)


def settled(state: DagSimState,
            cfg: AvalancheConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """True when a member finalized accepted for every set on every live
    node."""
    with annotate("settled"):
        confidence = state.base.records.confidence
        with annotate("finality"):
            fin_acc = (vr.has_finalized(confidence, cfg)
                       & vr.is_accepted(confidence))
        alive = state.base.alive[:, None]
        if state.set_size is not None:
            n, t = fin_acc.shape
            done = fin_acc.reshape(n, t // state.set_size,
                                   state.set_size).any(dim=2)        # [N, S]
        else:
            done = _segment(fin_acc.to(torch.uint8), state.conflict_set,
                            state.n_sets, "amax") > 0                # [N, S]
        return (done | ~alive).all()


def run(state: DagSimState, cfg: AvalancheConfig = DEFAULT_CONFIG,
        max_rounds: int = 2000, device="cuda") -> DagSimState:
    """Run on `device` until every conflict set resolved on every live
    node, or `max_rounds`; reads the round and `settled` back before
    each round, counted in `sync.reads`."""
    state = to_device(state, device)
    while (sync.read(state.base.round) < max_rounds
           and not sync.read(settled(state, cfg))):
        state = round_step(state, cfg)[0]
    return state


def run_scan(state: DagSimState, cfg: AvalancheConfig = DEFAULT_CONFIG,
             n_rounds: int = 200, device="cuda"
             ) -> Tuple[DagSimState, av.SimTelemetry]:
    """`n_rounds` rounds on `device` with stacked per-round telemetry."""
    state = to_device(state, device)
    rows = []
    for _ in range(n_rounds):
        state, tel = round_step(state, cfg)
        rows.append(tel)
    return state, av.SimTelemetry(*(torch.stack(col) for col in zip(*rows)))
