"""The vote-record state machine (`vote.go:24-98`), element-wise on tensors.

The PyTorch counterpart of `go_avalanche_tpu/ops/voterecord.py`, with the
same state encoding:

  votes      : uint8  sliding window of the last `window` votes, bit0 =
               newest; bit set = that vote was a yes
  consider   : uint8  sliding window of non-neutral-ness
  confidence : the reference's uint16 word — bit 0 = current preference,
               bits 1..15 = the confidence counter

Confidence storage: torch has no arithmetic on uint16, so the state
keeps the uint16 BIT PATTERN in an int16 tensor (2 bytes per record,
like the reference; the megakernel reads and writes it as uint16).
Values >= 0x8000 (the counter saturates at 0x7FFF, shifted left with the
preference bit) read negative in int16, so every function here widens
with `widen_confidence` (int32, ``& 0xFFFF``) before any shift or
compare, and narrows back with `narrow_confidence` when storing.
`convert.py` hands the reference uint16 arrays in and out.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from go_avalanche_tpu_torch.config import AvalancheConfig, DEFAULT_CONFIG
from go_avalanche_tpu_torch.ops import swar
from go_avalanche_tpu_torch.ops.bitops import popcount8


class VoteRecordState(NamedTuple):
    """SoA vote-record state; each leaf has the same shape."""

    votes: torch.Tensor       # uint8
    consider: torch.Tensor    # uint8
    confidence: torch.Tensor  # int16 holding the uint16 bit pattern


def widen_confidence(confidence: torch.Tensor) -> torch.Tensor:
    """The uint16 confidence word as int32 in [0, 0xFFFF]."""
    return confidence.to(torch.int32) & 0xFFFF


def narrow_confidence(confidence: torch.Tensor) -> torch.Tensor:
    """int32 [0, 0xFFFF] -> the int16 storage bit pattern (wraps)."""
    return confidence.to(torch.int16)


def init_state(accepted: torch.Tensor) -> VoteRecordState:
    """Fresh records seeded with an initial preference (`vote.go:33-35`)."""
    return VoteRecordState(
        votes=torch.zeros(accepted.shape, dtype=torch.uint8,
                          device=accepted.device),
        consider=torch.zeros(accepted.shape, dtype=torch.uint8,
                             device=accepted.device),
        confidence=accepted.to(torch.int16),
    )


def is_accepted(confidence: torch.Tensor) -> torch.Tensor:
    """Preference bit (`vote.go:38-40`)."""
    return (confidence & 1).to(torch.bool)


def get_confidence(confidence: torch.Tensor) -> torch.Tensor:
    """Confidence counter (`vote.go:43-45`), int32."""
    return widen_confidence(confidence) >> 1


def has_finalized(confidence: torch.Tensor,
                  cfg: AvalancheConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Counter reached the finalization score (`vote.go:48-50`)."""
    return get_confidence(confidence) >= cfg.finalization_score


def status(confidence: torch.Tensor,
           cfg: AvalancheConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Status codes (`vote.go:77-91`) as int8: FINALIZED 3, ACCEPTED 2,
    REJECTED 1, INVALID 0."""
    acc = is_accepted(confidence)
    fin = has_finalized(confidence, cfg)
    a = acc.to(torch.int8)
    return torch.where(fin, a * 3, a + 1)


def _apply_vote_bits(votes, consider, confidence, yes_bit, non_neutral_bit,
                     cfg: AvalancheConfig):
    """One window shift + confidence transition (`vote.go:54-75`) on a
    widened int32 `confidence`; returns (votes, consider, confidence,
    changed).  The counter saturates at 0x7FFF instead of wrapping."""
    window_mask = (1 << cfg.window) - 1
    votes = ((votes << 1) | yes_bit.to(torch.uint8)) & window_mask
    consider = ((consider << 1)
                | non_neutral_bit.to(torch.uint8)) & window_mask

    threshold = cfg.quorum - 1
    yes = popcount8(votes & consider) > threshold
    no = popcount8(~votes & consider & window_mask) > threshold
    conclusive = yes | no

    accepted = (confidence & 1) == 1
    agree = accepted == yes
    saturated = (confidence >> 1) >= 0x7FFF
    conf_bumped = torch.where(saturated, confidence, confidence + 2)
    new_confidence = torch.where(
        conclusive,
        torch.where(agree, conf_bumped, yes.to(torch.int32)),
        confidence)
    finalized_now = ((conf_bumped >> 1) == cfg.finalization_score) & agree
    changed = conclusive & (~agree | finalized_now)
    return votes, consider, new_confidence, changed


def _masked(state: VoteRecordState, new: VoteRecordState,
            changed: torch.Tensor,
            update_mask: Optional[torch.Tensor]) -> Tuple:
    """Freeze records where `update_mask` is False (the batched
    delete-on-finalize / skip-missing-record)."""
    if update_mask is None:
        return new, changed
    m = update_mask.to(torch.bool)
    return VoteRecordState(
        torch.where(m, new.votes, state.votes),
        torch.where(m, new.consider, state.consider),
        torch.where(m, new.confidence, state.confidence),
    ), changed & m


def register_vote(
    state: VoteRecordState,
    err: torch.Tensor,
    cfg: AvalancheConfig = DEFAULT_CONFIG,
    update_mask: Optional[torch.Tensor] = None,
) -> Tuple[VoteRecordState, torch.Tensor]:
    """Apply one vote per record; `err` is signed (0 = yes, > 0 = no,
    < 0 = neutral), broadcastable to the state shape.  Returns
    (new_state, changed)."""
    votes, consider, confidence, changed = _apply_vote_bits(
        state.votes, state.consider, widen_confidence(state.confidence),
        err == 0, err >= 0, cfg)
    new = VoteRecordState(votes, consider, narrow_confidence(confidence))
    return _masked(state, new, changed, update_mask)


def register_packed_votes(
    state: VoteRecordState,
    yes_pack: torch.Tensor,
    consider_pack: torch.Tensor,
    k: int,
    cfg: AvalancheConfig = DEFAULT_CONFIG,
    update_mask: Optional[torch.Tensor] = None,
    absent_is_skip: Optional[bool] = None,
) -> Tuple[VoteRecordState, torch.Tensor]:
    """Apply k votes per record from bit-packed uint8 planes,
    oldest-first (bit j = vote j); the u8 engine.

    Same contract as the reference: identical to k `register_vote` calls,
    `changed` OR-reduced over the k votes, and `absent_is_skip` (default
    `cfg.skip_absent_votes`) selecting whether a zero consider bit is a
    delivered neutral vote or a vote that registers nothing.  The window
    counts are kept incrementally (+incoming bit, -evicted bit per vote)
    as in the reference's hand-fused loop.
    """
    if not (0 < k <= 8):
        raise ValueError("k must be in (0, 8] for uint8 packing")
    if absent_is_skip is None:
        absent_is_skip = cfg.skip_absent_votes
    if absent_is_skip:
        return _register_packed_votes_skip(state, yes_pack, consider_pack,
                                           k, cfg, update_mask)

    votes, consider = state.votes, state.consider
    confidence = widen_confidence(state.confidence)
    any_changed = torch.zeros(votes.shape, dtype=torch.bool,
                              device=votes.device)
    window_mask = (1 << cfg.window) - 1
    full_window = cfg.window == 8  # uint8 shifts self-truncate
    top_bit = cfg.window - 1
    threshold = cfg.quorum - 1

    yes_cnt = popcount8(votes & consider)
    cons_cnt = popcount8(consider)
    for j in range(k):
        in_yes_raw = (yes_pack >> j) & 1
        in_cons = (consider_pack >> j) & 1
        in_yes = in_yes_raw & in_cons          # counted iff considered

        evict_yes = ((votes & consider) >> top_bit) & 1
        evict_cons = (consider >> top_bit) & 1
        yes_cnt = yes_cnt + in_yes - evict_yes
        cons_cnt = cons_cnt + in_cons - evict_cons

        votes = (votes << 1) | in_yes_raw
        consider = (consider << 1) | in_cons
        if not full_window:
            votes = votes & window_mask
            consider = consider & window_mask

        yes = yes_cnt > threshold
        no = (cons_cnt - yes_cnt) > threshold
        conclusive = yes | no

        agree = ((confidence & 1) == 1) == yes
        saturated = (confidence >> 1) >= 0x7FFF
        conf_bumped = torch.where(saturated, confidence, confidence + 2)
        confidence = torch.where(
            conclusive,
            torch.where(agree, conf_bumped, yes.to(torch.int32)),
            confidence)
        finalized_now = ((conf_bumped >> 1) == cfg.finalization_score) & agree
        any_changed |= conclusive & (~agree | finalized_now)

    new = VoteRecordState(votes, consider, narrow_confidence(confidence))
    return _masked(state, new, any_changed, update_mask)


def register_votes_sequence(
    state: VoteRecordState,
    errs: torch.Tensor,
    cfg: AvalancheConfig = DEFAULT_CONFIG,
    update_mask: Optional[torch.Tensor] = None,
) -> Tuple[VoteRecordState, torch.Tensor]:
    """Apply a sequence of votes (the leading axis of `errs`) one
    `register_vote` at a time; returns ``(final_state, changed)`` with
    `changed` stacked over the votes (``[num_votes, ...]``)."""
    changed = []
    for err in errs:
        state, ch = register_vote(state, err, cfg, update_mask)
        changed.append(ch)
    return state, torch.stack(changed)


def register_packed_votes_engine(
    state: VoteRecordState,
    yes_pack: torch.Tensor,
    consider_pack: torch.Tensor,
    k: int,
    cfg: AvalancheConfig = DEFAULT_CONFIG,
    update_mask: Optional[torch.Tensor] = None,
    absent_is_skip: Optional[bool] = None,
) -> Tuple[VoteRecordState, torch.Tensor]:
    """The ingest-engine dispatch on `cfg.ingest_engine`: "u8" takes
    `register_packed_votes`, "swar32" `register_packed_votes_swar`; both
    return the same bits."""
    engine = (register_packed_votes_swar if cfg.ingest_engine == "swar32"
              else register_packed_votes)
    return engine(state, yes_pack, consider_pack, k, cfg, update_mask,
                  absent_is_skip)


def _confidence_closed_form(
    confidence: torch.Tensor,
    outcome16: torch.Tensor,
    cfg: AvalancheConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k-vote confidence fold in one pass (the reference's algebra).

    `confidence` is the int16 storage plane; `outcome16` holds, per
    record, the per-vote quorum-yes bits (low byte) and conclusive bits
    (high byte), vote j at bit j.  A record flips iff some conclusive
    vote disagrees with its initial preference; the final preference is
    the last conclusive vote's; the final counter is the trailing run of
    conclusive votes agreeing with it (from 0 after a flip, else
    extending the incoming counter, saturating at 0x7FFF); `changed` is a
    flip or the no-flip finalization crossing, plus the re-report of an
    already saturated record when the score is 0x7FFF.  Returns the new
    int16 plane and bool `changed`."""
    conf = widen_confidence(confidence)
    outcome16 = outcome16.to(torch.int32)
    a0 = conf & 1
    c0 = conf >> 1
    concl = outcome16 >> 8
    yes = (outcome16 & 0xFF) & concl          # only conclusive yes bits

    flips = (concl & (yes ^ (a0 * 0xFF))) != 0

    f = concl | (concl >> 1)
    f |= f >> 2
    f |= f >> 4
    high = f ^ (f >> 1)                       # highest conclusive vote
    a_fin = torch.where(concl != 0, (yes & high) != 0,
                        a0 != 0).to(torch.int32)

    disagree = concl & (yes ^ (a_fin * 0xFF))
    d = disagree | (disagree >> 1)
    d |= d >> 2
    d |= d >> 4
    run = popcount8(concl & (~d & 0xFF))
    pc = popcount8(concl)

    counter = torch.where(flips, run - 1, torch.clamp(c0 + pc, max=0x7FFF))
    new_conf = (counter << 1) | a_fin

    score = cfg.finalization_score
    crossed = (c0 < score) & ((c0 + pc) >= score)
    if score == 0x7FFF:
        crossed = crossed | ((c0 == 0x7FFF) & (pc > 0))
    return narrow_confidence(new_conf), flips | crossed


def register_packed_votes_swar(
    state: VoteRecordState,
    yes_pack: torch.Tensor,
    consider_pack: torch.Tensor,
    k: int,
    cfg: AvalancheConfig = DEFAULT_CONFIG,
    update_mask: Optional[torch.Tensor] = None,
    absent_is_skip: Optional[bool] = None,
) -> Tuple[VoteRecordState, torch.Tensor]:
    """`register_packed_votes` on SWAR lanes: 4 tx columns per 32-bit
    word (`ops/swar.py`), the window shift, counts and quorum compares
    lane-parallel, the per-vote outcomes packed per lane, and the
    confidence plane touched once, by `_confidence_closed_form`.  Same
    contract and bits as the u8 engine; `absent_is_skip` gates each lane
    on its present bit instead of taking another path."""
    if not (0 < k <= 8):
        raise ValueError("k must be in (0, 8] for uint8 packing")
    if absent_is_skip is None:
        absent_is_skip = cfg.skip_absent_votes

    shape = state.votes.shape
    t = shape[-1]
    votes_w = swar.pack_u8_lanes(state.votes)
    cons_w = swar.pack_u8_lanes(state.consider)
    yes_w = swar.pack_u8_lanes(torch.broadcast_to(yes_pack, shape))
    pack_w = swar.pack_u8_lanes(torch.broadcast_to(consider_pack, shape))

    lsb = swar.LANE_LSB
    window_lanes = swar.lane_const((1 << cfg.window) - 1)
    full_window = cfg.window == 8
    top_bit = cfg.window - 1
    threshold = cfg.quorum - 1

    yes_cnt = swar.popcount8_lanes(votes_w & cons_w)
    cons_cnt = swar.popcount8_lanes(cons_w)
    out_yes = torch.zeros_like(votes_w)
    out_concl = torch.zeros_like(votes_w)

    for j in range(k):
        in_yes_raw = (yes_w >> j) & lsb
        in_cons = (pack_w >> j) & lsb

        if absent_is_skip:
            # An absent slot registers nothing; a present vote shifts a
            # set consider bit.
            present = in_cons
            evict_yes = ((votes_w & cons_w) >> top_bit) & present
            evict_cons = (cons_w >> top_bit) & present
            yes_cnt = yes_cnt + (in_yes_raw & present) - evict_yes
            cons_cnt = cons_cnt + present - evict_cons

            shifted_v = swar.lane_shl1(votes_w, in_yes_raw)
            shifted_c = swar.lane_shl1(cons_w, present)
            if not full_window:
                shifted_v &= window_lanes
                shifted_c &= window_lanes
            keep = swar.lane_fill(present)
            votes_w = (shifted_v & keep) | (votes_w & ~keep)
            cons_w = (shifted_c & keep) | (cons_w & ~keep)

            yes_m = swar.lane_gt(yes_cnt, threshold)
            no_m = swar.lane_gt(cons_cnt - yes_cnt, threshold)
            concl_m = (yes_m | no_m) & (present << 7)
        else:
            in_yes = in_yes_raw & in_cons      # counted iff considered
            evict_yes = ((votes_w & cons_w) >> top_bit) & lsb
            evict_cons = (cons_w >> top_bit) & lsb
            yes_cnt = yes_cnt + in_yes - evict_yes
            cons_cnt = cons_cnt + in_cons - evict_cons

            votes_w = swar.lane_shl1(votes_w, in_yes_raw)
            cons_w = swar.lane_shl1(cons_w, in_cons)
            if not full_window:
                votes_w &= window_lanes
                cons_w &= window_lanes

            yes_m = swar.lane_gt(yes_cnt, threshold)
            no_m = swar.lane_gt(cons_cnt - yes_cnt, threshold)
            concl_m = yes_m | no_m

        # Outcome packs: lane MSB masks land on lane bit j.
        out_yes |= yes_m >> (7 - j)
        out_concl |= concl_m >> (7 - j)

    new_votes = swar.unpack_u8_lanes(votes_w, t)
    new_consider = swar.unpack_u8_lanes(cons_w, t)
    outcome16 = ((swar.unpack_u8_lanes(out_concl, t).to(torch.int32) << 8)
                 | swar.unpack_u8_lanes(out_yes, t).to(torch.int32))
    confidence, changed = _confidence_closed_form(state.confidence,
                                                  outcome16, cfg)
    new = VoteRecordState(new_votes, new_consider, confidence)
    return _masked(state, new, changed, update_mask)


def _register_packed_votes_skip(state, yes_pack, present_pack, k: int,
                                cfg: AvalancheConfig, update_mask):
    """`register_packed_votes` where an absent slot registers nothing;
    present votes carry non_neutral=True.  Plain per-slot transitions,
    as in the reference."""
    votes, consider = state.votes, state.consider
    confidence = widen_confidence(state.confidence)
    any_changed = torch.zeros(votes.shape, dtype=torch.bool,
                              device=votes.device)
    for j in range(k):
        present = ((present_pack >> j) & 1).to(torch.bool)
        yes_bit = ((yes_pack >> j) & 1).to(torch.bool)
        v2, c2, conf2, ch2 = _apply_vote_bits(
            votes, consider, confidence, yes_bit,
            torch.ones_like(yes_bit), cfg)
        votes = torch.where(present, v2, votes)
        consider = torch.where(present, c2, consider)
        confidence = torch.where(present, conf2, confidence)
        any_changed |= ch2 & present
    new = VoteRecordState(votes, consider, narrow_confidence(confidence))
    return _masked(state, new, any_changed, update_mask)


def register_packed_votes_present(
    state: VoteRecordState,
    yes_pack: torch.Tensor,
    consider_pack: torch.Tensor,
    present_pack: torch.Tensor,
    k: int,
    cfg: AvalancheConfig = DEFAULT_CONFIG,
    update_mask: Optional[torch.Tensor] = None,
) -> Tuple[VoteRecordState, torch.Tensor]:
    """Three-plane ingest of the async query ring (`ops/inflight.py`).

    Per vote slot j the PRESENT bit selects one of three outcomes:
    present off registers nothing (the query is still in flight, was
    delivered earlier or was never sent); present on with consider off
    is a delivered absence (a non-response at its delivery round, or an
    expiry under the delivered-neutral semantics) that shifts the window
    with its consider bit off; present on with consider on is a real
    vote.  With present all ones this equals `register_packed_votes`
    with ``absent_is_skip=False``.  Plain per-slot `_apply_vote_bits`
    and a select, as in the reference; all three planes broadcast to the
    state's shape."""
    if not (0 < k <= 8):
        raise ValueError("k must be in (0, 8] for uint8 packing")
    votes, consider = state.votes, state.consider
    confidence = widen_confidence(state.confidence)
    any_changed = torch.zeros(votes.shape, dtype=torch.bool,
                              device=votes.device)
    for j in range(k):
        present = ((present_pack >> j) & 1).to(torch.bool)
        yes_bit = ((yes_pack >> j) & 1).to(torch.bool)
        cons_bit = ((consider_pack >> j) & 1).to(torch.bool)
        v2, c2, conf2, ch2 = _apply_vote_bits(votes, consider, confidence,
                                              yes_bit, cons_bit, cfg)
        votes = torch.where(present, v2, votes)
        consider = torch.where(present, c2, consider)
        confidence = torch.where(present, conf2, confidence)
        any_changed |= ch2 & present
    new = VoteRecordState(votes, consider, narrow_confidence(confidence))
    return _masked(state, new, any_changed, update_mask)
