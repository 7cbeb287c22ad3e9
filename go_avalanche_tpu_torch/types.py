"""Wire/data types — the port's copy of `go_avalanche_tpu/types.py`.

This is layer L1 of the reference (SURVEY.md section 1): `Vote`/`Response`
(`response.go:5-25`, `vote.go:3-22`), `RequestRecord` (`response.go:27-51`),
`Inv`/`Hash`/`Status`/`StatusUpdate`/`NodeID` (`avalanche.go:24-71`), and the
`Target` interface (`avalanche.go:73-91`).

Conventions:
 * `Hash` is an `int` — same toy stand-in for a 32-byte digest the reference
   uses (`avalanche.go:71`).
 * Vote errors follow the reference encoding (`vote.go:5`, "this is called
   'error' in abc"): 0 = yes, any other non-negative value = no, negative
   (canonically -1, i.e. uint32 0xFFFFFFFF) = neutral/abstain.  We normalise to
   a signed int so the sign test `int32(err) >= 0` (`vote.go:56`) is direct.
"""

from __future__ import annotations

import enum
from typing import List, NamedTuple, Protocol, Sequence, runtime_checkable

Hash = int
NodeID = int

#: Sentinel for "no suitable node available" (`avalanche.go:28`).
NO_NODE: NodeID = -1

#: Canonical neutral/abstain vote error (`avalanche_test.go:8-11`: uint32(-1)).
VOTE_NEUTRAL = -1
#: Yes vote error (`vote.go:55`: err == 0).
VOTE_YES = 0
#: Conventional no vote error (any non-negative non-zero value is a no).
VOTE_NO = 1


def normalize_err(err: int) -> int:
    """Map a raw (possibly uint32) vote error to the signed convention.

    The reference stores `uint32` and tests the sign of `int32(err)`
    (`vote.go:56`); callers that hand us 0xFFFFFFFF mean "neutral".
    """
    if err >= 0x8000_0000:
        err -= 0x1_0000_0000
    return err


class Status(enum.IntEnum):
    """Consensus status of a target (`avalanche.go:44-56`, same ordering).

    The (finalized, accepted) -> status mapping lives in `vote.go:77-91`:
    not finalized & accepted -> ACCEPTED; not finalized & not accepted ->
    REJECTED; finalized & accepted -> FINALIZED; finalized & not accepted ->
    INVALID.
    """

    INVALID = 0
    REJECTED = 1
    ACCEPTED = 2
    FINALIZED = 3


class StatusUpdate(NamedTuple):
    """A change in consensus status for a target (`avalanche.go:59-62`)."""

    hash: Hash
    status: Status


class Vote(NamedTuple):
    """A single vote for a target (`vote.go:3-12`)."""

    err: int
    hash: Hash

    def get_hash(self) -> Hash:
        return self.hash

    def get_error(self) -> int:
        return self.err


class Inv(NamedTuple):
    """A poll request item for a target (`avalanche.go:64-68`)."""

    target_type: str
    target_hash: Hash


class Response(NamedTuple):
    """A list of votes answering a poll (`response.go:5-25`).

    `cooldown` is carried for wire parity but never read — true of the
    reference as well (`response.go:8`, stored and never used).
    """

    round: int
    cooldown: int
    votes: Sequence[Vote]

    def get_votes(self) -> Sequence[Vote]:
        return self.votes

    def get_round(self) -> int:
        return self.round


class RequestRecord(NamedTuple):
    """An outstanding poll awaiting a response (`response.go:27-46`)."""

    timestamp: float
    invs: Sequence[Inv]

    def get_timestamp(self) -> float:
        return self.timestamp

    def get_invs(self) -> Sequence[Inv]:
        return self.invs

    def is_expired(self, now: float, timeout_s: float) -> bool:
        """True if the request is older than the timeout (`response.go:49-51`).

        Unlike the reference (which reads a package-global clock), the current
        time and timeout are explicit arguments — the processor owns the clock.
        """
        return self.timestamp + timeout_s < now


@runtime_checkable
class Target(Protocol):
    """Something being decided by consensus (`avalanche.go:73-91`).

    e.g. a transaction or a block.  Snake-case spellings of the reference's
    interface methods; semantics are identical.
    """

    def hash(self) -> Hash:
        """Digest used as the target's identity (`avalanche.go:76`)."""
        ...

    def type(self) -> str:
        """Kind of thing, e.g. "transaction" or "block" (`avalanche.go:79`)."""
        ...

    def is_accepted(self) -> bool:
        """Initial preference when first considered (`avalanche.go:83`)."""
        ...

    def score(self) -> int:
        """Ordering weight, e.g. cumulative work (`avalanche.go:86`)."""
        ...

    def is_valid(self) -> bool:
        """Polling stops when a target becomes invalid (`avalanche.go:90`)."""
        ...


class Block:
    """Block test fixture implementing Target (`avalanche.go:130-160`).

    Mutable `valid` / `is_in_active_chain` so tests can invalidate mid-flight
    exactly like the reference suite does (`avalanche_test.go:534`).
    """

    def __init__(self, hash_: Hash, work: int, valid: bool,
                 is_in_active_chain: bool) -> None:
        self._hash = hash_
        self.work = work
        self.valid = valid
        self.is_in_active_chain = is_in_active_chain

    def hash(self) -> Hash:
        return self._hash

    def type(self) -> str:
        return "block"

    def score(self) -> int:
        return self.work

    def is_accepted(self) -> bool:
        return self.is_in_active_chain

    def is_valid(self) -> bool:
        return self.valid


class Tx:
    """Transaction fixture implementing Target (example `main.go:196-209`)."""

    def __init__(self, hash_: Hash, is_accepted: bool = True,
                 score: int = 1) -> None:
        self._hash = hash_
        self._is_accepted = is_accepted
        self._score = score

    def hash(self) -> Hash:
        return self._hash

    def type(self) -> str:
        return "tx"

    def score(self) -> int:
        return self._score

    def is_accepted(self) -> bool:
        return self._is_accepted

    def is_valid(self) -> bool:
        return True


def sort_invs_by_score(invs: List[Inv], targets) -> List[Inv]:
    """Deterministic score-descending inv order.

    The reference *intended* work-descending ordering but the call is commented
    out (`processor.go:163`, `avalanche.go:162-174`), leaving map-iteration
    nondeterminism; tests still assert the ordering (`avalanche_test.go:307-313`).
    We implement the intended behavior: stable sort, score descending, hash
    ascending as tiebreak for full determinism.
    """
    return sorted(invs, key=lambda inv: (-targets[inv.target_hash].score(),
                                         inv.target_hash))
