"""The streaming conflict-set DAG in plain PyTorch: the plain reference's
own copy, frozen.

A window of ``S_w`` set-slots of `c` contiguous tx slots runs the DAG
round of `reference/dag.py`; the pending sets wait in a backlog sorted
by their best member's score (stable on ties).  Before each round, a
set-slot whose members no live node still polls retires: its members'
outcomes are written to ``[S_b, c]`` output planes at the set's backlog
row.  Free slots then take the next backlog sets in order, seeding fresh
records on every node.  No retire cap, no arrivals: every free slot
refills while the backlog lasts.
"""

from __future__ import annotations

import torch

from portbench.reference import dag
from portbench.reference import records as rv

NO_SET = -1
EMPTY_SCORE = -2**31 + 1


def make_backlog(scores: torch.Tensor) -> dict:
    """The int32 ``[S_b, c]`` member scores as a backlog: sets in
    descending order of their best member's score, stable on ties; every
    member valid; the first member preferred."""
    s_b, c = scores.shape
    set_score = scores.to(torch.int64).max(dim=1).values
    order = torch.argsort(-set_score, stable=True)
    lane = torch.arange(c, device=scores.device)
    return {"backlog_score": scores[order].to(torch.int32),
            "backlog_init_pref": (lane == 0)[None, :].expand(s_b, c).clone(),
            "backlog_valid": torch.ones((s_b, c), dtype=torch.bool,
                                        device=scores.device)}


def init(key: torch.Tensor, n: int, window_sets: int, scores: torch.Tensor,
         cfg: dict) -> dict:
    """An empty window over a fresh backlog; the first refill is in the
    first step."""
    dev = key.device
    backlog = make_backlog(scores)
    s_b, c = scores.shape
    w = window_sets * c
    state = dag.init(key, n, w, c, cfg,
                     torch.ones(w, dtype=torch.bool, device=dev),
                     torch.zeros((n, w), dtype=torch.bool, device=dev),
                     torch.zeros(w, dtype=torch.bool, device=dev))
    zeros = torch.zeros((s_b, c), dtype=torch.int32, device=dev)
    state.update(backlog)
    state.update(
        slot_set=torch.full((window_sets,), NO_SET, dtype=torch.int32,
                            device=dev),
        slot_admit_round=torch.zeros(window_sets, dtype=torch.int32,
                                     device=dev),
        out_settled=torch.zeros((s_b, c), dtype=torch.bool, device=dev),
        out_accepted=torch.zeros((s_b, c), dtype=torch.bool, device=dev),
        out_accept_votes=zeros, out_settle_round=zeros - 1,
        out_admit_round=zeros - 1,
        next_idx=torch.zeros((), dtype=torch.int32, device=dev))
    return state


def settled_slots(state: dict, cfg: dict, c: int) -> torch.Tensor:
    """Bool ``[S_w]``: occupied slots with no (live node, member) pair
    left to poll."""
    n, w = state["votes"].shape
    s_w = w // c
    conf = state["confidence"]
    fin = rv.has_finalized(conf, cfg["finalization_score"])
    fin_acc = fin & rv.is_accepted(conf)
    rival = dag.set_any(fin_acc, c) & ~fin_acc
    pending = (state["added"] & state["alive"][:, None]
               & state["valid"][None, :] & ~fin & ~rival)
    pending_set = pending.reshape(n, s_w, c).any(dim=2).any(dim=0)
    return (state["slot_set"] != NO_SET) & ~pending_set


def retire_and_refill(state: dict, cfg: dict, c: int):
    """Write the retiring sets' outcomes, refill the free slots; returns
    ``(state, sets retired)``."""
    n, w = state["votes"].shape
    s_b = state["backlog_score"].shape[0]
    slot_set = state["slot_set"]
    settled = settled_slots(state, cfg, c)
    free = settled | (slot_set == NO_SET)

    conf = state["confidence"]
    fin_acc = (rv.has_finalized(conf, cfg["finalization_score"])
               & rv.is_accepted(conf))
    accept_votes = (fin_acc & state["added"]).sum(dim=0).to(torch.int32)
    n_live = state["alive"].sum().clamp_min(1)
    accepted = accept_votes.to(torch.int64) * 2 > n_live
    new = dict(state)
    rows = slot_set[settled].long()
    planes = {"out_settled": torch.ones_like(accepted),
              "out_accepted": accepted,
              "out_accept_votes": accept_votes,
              "out_settle_round": state["round"].expand(w),
              "out_admit_round": state["slot_admit_round"].repeat_interleave(c)}
    for name, value in planes.items():
        plane = state[name].clone()
        plane[rows] = value.reshape(-1, c)[settled].to(plane.dtype)
        new[name] = plane

    rank = torch.cumsum(free.to(torch.int64), dim=0) - 1
    cand = state["next_idx"].to(torch.int64) + rank
    take = free & (cand < s_b)
    new_set = torch.where(take, cand.to(torch.int32),
                          torch.where(settled, NO_SET, slot_set))
    cand_safe = cand.clamp(0, s_b - 1)
    take_w = take.repeat_interleave(c)
    occupied_w = (new_set != NO_SET).repeat_interleave(c)
    pref = state["backlog_init_pref"][cand_safe].reshape(w)
    seeded = rv.fresh(pref[None, :].expand(n, w))
    for name in ("votes", "consider", "confidence"):
        new[name] = torch.where(take_w[None, :], seeded[name], state[name])
    new["added"] = take_w[None, :] | (state["added"] & occupied_w[None, :])
    new["finalized_at"] = torch.where(take_w[None, :], -1,
                                      state["finalized_at"])
    new["valid"] = torch.where(
        take_w, state["backlog_valid"][cand_safe].reshape(w),
        state["valid"] & occupied_w)
    score = torch.where(
        occupied_w,
        state["backlog_score"][new_set.clamp(0, s_b - 1).long()].reshape(w),
        EMPTY_SCORE)
    new["score_rank"], new["poll_order"], new["poll_order_inv"] = (
        dag.orders(score))
    new["slot_set"] = new_set
    new["slot_admit_round"] = torch.where(take, state["round"],
                                          state["slot_admit_round"])
    new["next_idx"] = state["next_idx"] + take.sum().to(torch.int32)
    return new, settled.sum().to(torch.int32)


def step(state: dict, cfg: dict, c: int):
    """Retire and refill, then one DAG round; returns ``(state,
    telemetry)``."""
    state, retired = retire_and_refill(state, cfg, c)
    occupied = (state["slot_set"] != NO_SET).sum().to(torch.int32)
    backlog_left = (state["backlog_score"].shape[0]
                    - state["next_idx"]).to(torch.int32)
    state, tel = dag.round_step(state, cfg, c)
    tel.update(retired_sets=retired, occupied_sets=occupied,
               backlog_left=backlog_left)
    return state, tel
