"""Status types — the port's copy of part of `go_avalanche_tpu/types.py`.

Only what `utils/metrics.py` reads: the consensus `Status` of a target
and the `StatusUpdate` stream (`avalanche.go:44-62`).
"""

from __future__ import annotations

import enum
from typing import NamedTuple

Hash = int


class Status(enum.IntEnum):
    """Consensus status of a target (`avalanche.go:44-56`, same ordering):
    not finalized & accepted -> ACCEPTED; not finalized & not accepted ->
    REJECTED; finalized & accepted -> FINALIZED; finalized & not accepted
    -> INVALID (`vote.go:77-91`)."""

    INVALID = 0
    REJECTED = 1
    ACCEPTED = 2
    FINALIZED = 3


class StatusUpdate(NamedTuple):
    """A change in consensus status for a target (`avalanche.go:59-62`)."""

    hash: Hash
    status: Status
