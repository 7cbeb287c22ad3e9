"""The vote record of go-avalanche's `vote.go`, element-wise on tensors:
the plain reference's own copy.

A record is three planes of one shape: `votes` (uint8, the last
`window` votes, bit 0 newest), `consider` (uint8, which of them were
non-neutral) and `confidence`, the reference's uint16 word (bit 0 the
preference, bits 1..15 the counter) held as its bit pattern in int16.
Every shift and compare widens it to int32 first.
"""

from __future__ import annotations

import math

import torch


def popcount8(x: torch.Tensor) -> torch.Tensor:
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def widen(confidence: torch.Tensor) -> torch.Tensor:
    return confidence.to(torch.int32) & 0xFFFF


def fresh(accepted: torch.Tensor) -> dict:
    """New records with the initial preference `accepted`."""
    zeros = torch.zeros(accepted.shape, dtype=torch.uint8,
                        device=accepted.device)
    return {"votes": zeros, "consider": zeros.clone(),
            "confidence": accepted.to(torch.int16)}


def is_accepted(confidence: torch.Tensor) -> torch.Tensor:
    return (confidence & 1).to(torch.bool)


def has_finalized(confidence: torch.Tensor, score: int) -> torch.Tensor:
    return (widen(confidence) >> 1) >= score


def apply_vote(votes, consider, confidence, yes_bit, non_neutral_bit, cfg):
    """One vote (`vote.go:54-75`) on a widened int32 `confidence`:
    shift it into the window, count the window, move the counter.
    Returns ``(votes, consider, confidence, changed)``."""
    mask = (1 << cfg["window"]) - 1
    votes = ((votes << 1) | yes_bit.to(torch.uint8)) & mask
    consider = ((consider << 1) | non_neutral_bit.to(torch.uint8)) & mask
    need = cfg["quorum"] - 1
    yes = popcount8(votes & consider) > need
    no = popcount8(~votes & consider & mask) > need
    conclusive = yes | no
    agree = ((confidence & 1) == 1) == yes
    bumped = torch.where((confidence >> 1) >= 0x7FFF, confidence,
                         confidence + 2)
    confidence = torch.where(conclusive,
                             torch.where(agree, bumped, yes.to(torch.int32)),
                             confidence)
    final_now = ((bumped >> 1) == cfg["finalization_score"]) & agree
    return votes, consider, confidence, conclusive & (~agree | final_now)


def ingest(rec: dict, yes_pack: torch.Tensor, consider_pack: torch.Tensor,
           cfg: dict, update: torch.Tensor):
    """The round's k votes per record, oldest first (bit j = vote j);
    records outside `update` keep their values.  `cfg["vote_mode"]`
    "sequential" registers the k votes one by one, as `processor.go`
    does; "majority" folds them into one vote (yes or no where at least
    ceil(alpha * k) agree, else neutral), which is the control that
    breaks the configuration's sequential-vote guarantee.  Returns
    ``(records, changed)``."""
    k = cfg["k"]
    votes, consider = rec["votes"], rec["consider"]
    confidence = widen(rec["confidence"])
    shape = votes.shape
    yes_pack = torch.broadcast_to(yes_pack, shape)
    consider_pack = torch.broadcast_to(consider_pack, shape)
    if cfg["vote_mode"] == "sequential":
        changed = torch.zeros(shape, dtype=torch.bool, device=votes.device)
        for j in range(k):
            votes, consider, confidence, ch = apply_vote(
                votes, consider, confidence, (yes_pack >> j) & 1,
                (consider_pack >> j) & 1, cfg)
            changed |= ch
    elif cfg["vote_mode"] == "majority":
        need = math.ceil(cfg["alpha"] * k)
        yes_n = popcount8(yes_pack & consider_pack)
        no_n = popcount8(~yes_pack & consider_pack)
        yes_bit = yes_n >= need
        votes, consider, confidence, changed = apply_vote(
            votes, consider, confidence, yes_bit, yes_bit | (no_n >= need),
            cfg)
    else:
        raise ValueError(f"vote_mode {cfg['vote_mode']!r}")
    new = {"votes": votes, "consider": consider,
           "confidence": confidence.to(torch.int16)}
    out = {name: torch.where(update, new[name], rec[name]) for name in new}
    return out, changed & update
