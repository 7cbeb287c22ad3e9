"""Node-axis streaming scheduler — `go_avalanche_tpu/models/node_stream.py`.

A registry of R nodes lives as ``[R]`` metadata (stake, residency) while
an active window of W rows holds the dense ``[W, T]`` consensus state;
row r hosts registry node `slot_node[r]` and the inner round is exactly
`models/avalanche.round_step` on any round engine.  The initial window
is an exact stake-proportional draw without replacement
(`stake.draw_working_set`); each step every row departs with probability
`cfg.node_churn_rate`, and departing rows' records retire while their
replacements, drawn from the non-resident registry the same way, start
from the registry prior.  The window stays full: a departure with no
drawable replacement is cancelled.

The churn stream folds its own key off the sim's init key, so the
consensus draws never move.  Under async queries the swapped rows leave
the ring as queriers and as polled peers (`ops/inflight.clear_rows`).
The scheduler owns the flight recorder: one full `NodeStreamTelemetry`
record a step into `sim.trace`, the inner round's taps silenced.  The
telemetry's resident-stake fraction sums in float64 and rounds once, so
the CPU and the card agree; XLA:CPU's float32 sum takes its own order
(ROADMAP.md Queue 3), so that float column, and a JSONL that carries it,
can differ from the reference's in its last bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch import stake as stake_mod
from go_avalanche_tpu_torch.config import (AvalancheConfig, DEFAULT_CONFIG,
                                           inner_round_config)
from go_avalanche_tpu_torch.models import avalanche as av
from go_avalanche_tpu_torch.models.backlog import stack_tree
from go_avalanche_tpu_torch.obs import sink as obs_sink
from go_avalanche_tpu_torch.obs import trace as obs_trace
from go_avalanche_tpu_torch.ops import inflight
from go_avalanche_tpu_torch.ops import voterecord as vr

# The registry-churn stream's key is fold_in(sim init key, this).
_CHURN_FOLD = 0x2E617


class NodeStreamState(NamedTuple):
    """Active window + registry."""

    sim: av.AvalancheSimState   # dense [W, T]; row r hosts slot_node[r]
    slot_node: torch.Tensor     # int32 [W] — registry id per window row
    resident: torch.Tensor      # bool [R] — exactly W True
    stake: torch.Tensor         # float32 [R] — the registry stake plane
    init_pref: torch.Tensor     # bool [T] — an arriving row's prior
    churn_key: torch.Tensor     # int64 [2] — the churn stream's key
    churned_in: torch.Tensor    # int32 — cumulative arrivals
    churned_out: torch.Tensor   # int32 — cumulative departures


class NodeStreamTelemetry(NamedTuple):
    """Per-step scalars: the inner round's telemetry plus registry
    stats."""

    round: av.SimTelemetry
    departed: torch.Tensor        # int32 — rows rotated out this step
    resident_stake: torch.Tensor  # float32 — resident share of the stake


# The node-stream scheduler's trace-plane column manifest: the inner
# round's counters plus the registry stats; `resident_stake` is the one
# float column (stored bitcast).
TRACE_COLUMNS = obs_trace.columns_from_fields(
    av.SimTelemetry._fields, ("departed", "resident_stake"),
    floats=frozenset({"resident_stake"}))


def with_trace(state: "NodeStreamState", cfg: AvalancheConfig,
               n_rounds: int) -> "NodeStreamState":
    """Attach the trace plane, owned by the scheduler (full
    `NodeStreamTelemetry` rows); no-op when `cfg.trace_every == 0`."""
    return state._replace(sim=state.sim._replace(
        trace=obs_trace.alloc(cfg, n_rounds, TRACE_COLUMNS,
                              state.slot_node.device)))


def _registry_byzantine(cfg: AvalancheConfig, r: int,
                        device) -> torch.Tensor:
    """bool [R]: the first ``round(byzantine_fraction * R)`` ids, as
    `avalanche.init` marks rows."""
    n_byz = int(round(cfg.byzantine_fraction * r))
    return torch.arange(r, device=device) < n_byz


def init(key: torch.Tensor, n_txs: int,
         cfg: AvalancheConfig = DEFAULT_CONFIG,
         init_pref: Optional[torch.Tensor] = None,
         scores: Optional[torch.Tensor] = None,
         track_finality: bool = True, device="cuda") -> NodeStreamState:
    """Fresh registry and a stake-proportionally drawn initial window on
    `device` (the card unless the caller asks for the CPU).  R and W are
    `cfg.registry_nodes` / `cfg.active_nodes`; `init_pref` (bool ``[T]``,
    default all accepted) is the window's prior and every arrival's."""
    if not stake_mod.registry_enabled(cfg):
        raise ValueError(
            "the node-stream scheduler needs cfg.registry_nodes / "
            "cfg.active_nodes set (the registry-off window sim is "
            "models/avalanche)")
    dev = av._device(device)
    key = key.to(dev)
    r, w = cfg.registry_nodes, cfg.active_nodes
    stake_r = stake_mod.node_stake(cfg, r, dev)
    churn_key, k_draw = prng.split(prng.fold_in(key, _CHURN_FOLD))
    ids, _ = stake_mod.draw_working_set(k_draw, stake_r, w, device=dev)
    if init_pref is None:
        init_pref = torch.ones(n_txs, dtype=torch.bool, device=dev)
    init_pref = init_pref.to(dev, torch.bool)
    # Ascending row order for the initial window (rows are an arbitrary
    # hosting assignment).
    slot_node = torch.sort(ids).values
    resident = torch.zeros(r, dtype=torch.bool, device=dev)
    resident[slot_node.long()] = True
    sim = av.init(key, w, n_txs, cfg, init_pref=init_pref, scores=scores,
                  track_finality=track_finality, device=dev)
    # Row propensities are the residents' registry stakes.
    sim = sim._replace(
        latency_weight=stake_r[slot_node.long()],
        byzantine=_registry_byzantine(cfg, r, dev)[slot_node.long()])
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return NodeStreamState(sim=sim, slot_node=slot_node, resident=resident,
                           stake=stake_r, init_pref=init_pref,
                           churn_key=churn_key, churned_in=zero,
                           churned_out=zero)


def churn_swaps(state: NodeStreamState, cfg: AvalancheConfig):
    """The churn pass's draw: which rows rotate, to whom, and the new
    residency, from the registry planes and the churn key alone.
    Returns ``(swap [W], new_slot [W], resident [R], n_swapped, next
    key)``.  At most min(W, R - W) swaps are honoured a step; excess
    departures are cancelled.  The reference's `draw_churn_swaps`, under
    another name for the reason `config.inner_round_config` gives."""
    w = state.slot_node.shape[0]
    r = state.resident.shape[0]
    k_dep, k_arr, k_next = prng.split(state.churn_key, 3)
    depart = prng.bernoulli(k_dep, cfg.node_churn_rate, (w,))
    cap = min(w, r - w)
    cand_ids, cand_valid = stake_mod.draw_working_set(
        k_arr, state.stake, cap, mask=~state.resident,
        device=state.stake.device)
    rank = torch.cumsum(depart.to(torch.int32), dim=0, dtype=torch.int32) - 1
    rank_safe = rank.clamp(0, cap - 1).long()
    swap = depart & (rank < cap) & cand_valid[rank_safe]
    new_slot = torch.where(swap, cand_ids[rank_safe], state.slot_node)
    # Residency flip: departing ids out, arriving ids in; index r is a
    # spare entry that takes the writes of rows that do not swap.
    resident = torch.cat([state.resident, state.resident[:1]])
    dev = resident.device      # the flags filled there, not copied over
    resident[torch.where(swap, state.slot_node, r).long()] = torch.zeros(
        (), dtype=torch.bool, device=dev)
    resident[torch.where(swap, new_slot, r).long()] = torch.ones(
        (), dtype=torch.bool, device=dev)
    return (swap, new_slot, resident[:r], swap.sum(dtype=torch.int32),
            k_next)


def churn(state: NodeStreamState, cfg: AvalancheConfig
          ) -> Tuple[NodeStreamState, torch.Tensor]:
    """One churn pass: departing rows' records retire and their
    replacements start from the registry prior.  Returns (new_state,
    rows swapped); the state passes untouched when the churn rate is 0."""
    if cfg.node_churn_rate <= 0.0:
        return state, torch.zeros((), dtype=torch.int32,
                                  device=state.slot_node.device)
    sim = state.sim
    r = state.resident.shape[0]
    swap, new_slot, resident, n_swapped, k_next = churn_swaps(
        state, cfg)
    fresh = vr.init_state(state.init_pref[None, :])
    rows = swap[:, None]
    records = vr.VoteRecordState(*(torch.where(rows, f, p) for p, f in
                                   zip(sim.records, fresh)))
    new_sim = sim._replace(
        records=records,
        added=rows | sim.added,
        finalized_at=(None if sim.finalized_at is None
                      else torch.where(rows, -1, sim.finalized_at)),
        latency_weight=state.stake[new_slot.long()],
        byzantine=_registry_byzantine(cfg, r, swap.device)[new_slot.long()],
        alive=swap | sim.alive,
        # Responses still in flight for a departed node must not land on,
        # or be answered in the name of, its replacement.
        inflight=inflight.clear_rows(sim.inflight, swap, peer_rows=swap))
    return state._replace(
        sim=new_sim, slot_node=new_slot, resident=resident,
        churn_key=k_next, churned_in=state.churned_in + n_swapped,
        churned_out=state.churned_out + n_swapped), n_swapped


def _stake_share(resident: torch.Tensor, stake: torch.Tensor
                 ) -> torch.Tensor:
    """float32: the resident share of the registry stake, each sum in
    float64 rounded once."""
    total = stake.double().sum().float()
    held = torch.where(resident, stake, 0.0).double().sum().float()
    return held / total.clamp_min(1e-38)


def step(state: NodeStreamState, cfg: AvalancheConfig = DEFAULT_CONFIG
         ) -> Tuple[NodeStreamState, NodeStreamTelemetry]:
    """Churn the window, then one consensus round on it."""
    round_val = state.sim.round
    state, swapped = churn(state, cfg)
    new_sim, round_tel = av.round_step(state.sim, inner_round_config(cfg))
    tel = NodeStreamTelemetry(
        round=round_tel, departed=swapped,
        resident_stake=_stake_share(state.resident, state.stake))
    obs_sink.emit_round(cfg, round_val, tel)
    new_sim = new_sim._replace(
        trace=obs_trace.write_round(new_sim.trace, cfg, round_val, tel))
    return state._replace(sim=new_sim), tel


def run_scan(state: NodeStreamState, cfg: AvalancheConfig = DEFAULT_CONFIG,
             n_rounds: int = 100, device="cuda"
             ) -> Tuple[NodeStreamState, NodeStreamTelemetry]:
    """`n_rounds` steps on `device` with stacked per-step telemetry (the
    registry never drains, so there is no `run`)."""
    state = av.move_leaves(state, av._device(device))
    rows = []
    for _ in range(n_rounds):
        state, tel = step(state, cfg)
        rows.append(tel)
    return state, stack_tree(rows)


def window_summary(state: NodeStreamState,
                   cfg: AvalancheConfig = DEFAULT_CONFIG) -> dict:
    """Host digest of a final state: window finality, churn totals and
    resident stake coverage."""
    fin = vr.has_finalized(state.sim.records.confidence, cfg)
    return {"finalized_fraction": float(fin.float().mean()),
            "churned_in": int(state.churned_in),
            "churned_out": int(state.churned_out),
            "resident_stake_fraction":
                float(_stake_share(state.resident, state.stake)),
            "resident_count": int(state.resident.sum())}
