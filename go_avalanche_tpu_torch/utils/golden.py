"""Scalar pure-Python oracle of the vote-record state machine — the
port's copy of `go_avalanche_tpu/utils/golden.py`.

A deliberately boring, loop-and-branch transcription of the semantics in
`vote.go:24-98` (see SURVEY.md section 2.2): the record behind the host
`Processor`, and the source of the golden vectors mirroring
`avalanche_test.go:13-92`.  Never used on the hot path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from go_avalanche_tpu_torch.config import AvalancheConfig, DEFAULT_CONFIG
from go_avalanche_tpu_torch.types import Status, normalize_err


@dataclass
class ScalarVoteRecord:
    """One target's Snowball record; semantics of `vote.go:24-98`."""

    votes: int = 0
    consider: int = 0
    confidence: int = 0
    cfg: AvalancheConfig = DEFAULT_CONFIG

    @classmethod
    def new(cls, accepted: bool,
            cfg: AvalancheConfig = DEFAULT_CONFIG) -> "ScalarVoteRecord":
        # `vote.go:33-35`: confidence starts at the preference bit.
        return cls(confidence=1 if accepted else 0, cfg=cfg)

    def is_accepted(self) -> bool:
        return (self.confidence & 1) == 1

    def get_confidence(self) -> int:
        return self.confidence >> 1

    def has_finalized(self) -> bool:
        return self.get_confidence() >= self.cfg.finalization_score

    def register_vote(self, err: int) -> bool:
        """Apply one vote; True iff acceptance/finalization state changed."""
        err = normalize_err(err)
        window_mask = (1 << self.cfg.window) - 1
        self.votes = ((self.votes << 1) | (1 if err == 0 else 0)) & window_mask
        self.consider = ((self.consider << 1)
                         | (1 if err >= 0 else 0)) & window_mask

        threshold = self.cfg.quorum - 1
        yes = bin(self.votes & self.consider).count("1") > threshold
        no = bin((~self.votes) & self.consider & window_mask).count("1") \
            > threshold

        if not yes and not no:
            return False  # inconclusive round (`vote.go:61-63`)

        if self.is_accepted() == yes:
            # Saturate the counter at its 15-bit ceiling, mirroring the
            # batched kernel (the reference deletes records before this
            # matters; long-lived batched records must not wrap uint16).
            if self.get_confidence() < 0x7FFF:
                self.confidence += 2
            # True only at the exact finalization moment (`vote.go:68`).
            return self.get_confidence() == self.cfg.finalization_score

        # Conclusive disagreement: flip preference, reset counter.
        self.confidence = 1 if yes else 0
        return True

    def status(self) -> Status:
        fin, acc = self.has_finalized(), self.is_accepted()
        if fin:
            return Status.FINALIZED if acc else Status.INVALID
        return Status.ACCEPTED if acc else Status.REJECTED


def replay(accepted: bool, errs: Sequence[int],
           cfg: AvalancheConfig = DEFAULT_CONFIG,
           ) -> List[Tuple[int, int, int, bool]]:
    """Replay a vote stream; per-vote (votes, consider, confidence, changed).

    The trace format the kernel parity tests consume.
    """
    vr = ScalarVoteRecord.new(accepted, cfg)
    out = []
    for e in errs:
        changed = vr.register_vote(e)
        out.append((vr.votes, vr.consider, vr.confidence, changed))
    return out


def golden_vector_sequence() -> List[Tuple[int, bool, bool, int]]:
    """The reference suite's exhaustive golden sequence.

    Reproduces the scripted expectations of `TestVoteRecord`
    (`avalanche_test.go:13-92`) as (err, expect_accepted, expect_finalized,
    expect_confidence) tuples, starting from NewVoteRecord(false):
    6 warm-up yes votes, the 7th flips, neutral-stall behavior, count to 128
    and finalize, then flip to rejection and re-finalize the no state.
    """
    seq: List[Tuple[int, bool, bool, int]] = []
    fin = DEFAULT_CONFIG.finalization_score

    # 6 warm-up yes votes before the window can go conclusive.
    for _ in range(6):
        seq.append((0, False, False, 0))
    # 7th yes vote flips preference to accepted.
    seq.append((0, True, False, 0))
    # A single neutral vote changes nothing (window still conclusive-yes).
    seq.append((-1, True, False, 1))
    for i in range(2, 8):
        seq.append((0, True, False, i))
    # Two neutral votes stall progress at confidence 7.
    seq.append((-1, True, False, 7))
    seq.append((-1, True, False, 7))
    for _ in range(2, 8):
        seq.append((0, True, False, 7))
    # Confidence now rises monotonically to the finalization score.
    for i in range(8, fin):
        seq.append((0, True, False, i))
    # The next vote finalizes — even a no vote (window still conclusive-yes).
    seq.append((1, True, True, fin))
    # A few more no votes: window inconclusive, nothing moves.
    for _ in range(5):
        seq.append((1, True, True, fin))
    # 7th no vote flips to rejected, confidence resets.
    seq.append((1, False, False, 0))
    # Mirror image: neutral stalls and the climb to finalized rejection.
    seq.append((-1, False, False, 1))
    for i in range(2, 8):
        seq.append((1, False, False, i))
    seq.append((-1, False, False, 7))
    seq.append((-1, False, False, 7))
    for _ in range(2, 8):
        seq.append((1, False, False, 7))
    for i in range(8, fin):
        seq.append((1, False, False, i))
    # Finalize the rejection (a yes vote; window still conclusive-no).
    seq.append((0, False, True, fin))
    return seq
