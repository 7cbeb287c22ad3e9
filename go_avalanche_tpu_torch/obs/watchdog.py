"""Invariant watchdog — `go_avalanche_tpu/obs/watchdog.py`: turn silent
state corruption into loud failures.

The opt-in debug mode that asserts, between steps, the structural
invariants every engine keeps by construction:

  * confidence counter ``(conf >> 1) <= 0x7FFF`` (the 15-bit saturation
    cap) and ``<= cfg.finalization_score + cfg.k - 1`` (a record freezes
    once a round ends with it finalized, but the k sequential votes of
    the ingest call it crosses in keep landing);
  * window planes carry no bits above ``cfg.window``;
  * every in-flight ring latency sits in ``[0, timeout_rounds()]`` and
    the ring's depth is ``timeout_rounds() + 1``;
  * a bit-packed ring poll-mask plane has zero padding bits in every
    per-shard byte block;
  * the finalized count never decreases across steps
    (`Watchdog(monotonic=False)` for the streaming schedulers, whose
    refills reset finality);
  * no ring entry can deliver across an active cut (`check_ring_cut`, a
    host-numpy re-derivation of `ops/inflight.partition_cut` from the
    ring's own peer plane);
  * the trace plane's cursor and untouched slots (`check_trace`).

Each check decides on the host after one copy to it, counted in
`sync.reads`.  `check_records` and `check_ring` reduce their planes on
the state's device first, so the copy is a few flags and a count (a
plane comes over only to name the offenders of a violation);
`check_ring_cut` and `check_trace` copy their planes.  A violation
raises `InvariantViolation` with the reference's message and offender
list.  The round loop itself is untouched: a run checked after every
step follows the same trajectory as one that is not.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from go_avalanche_tpu_torch import sync
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.obs import trace as obs_trace
from go_avalanche_tpu_torch.ops import voterecord as vr


class InvariantViolation(AssertionError):
    """A structural invariant of the sim state failed."""


def _offenders(mask: np.ndarray, limit: int = 5) -> str:
    idx = np.argwhere(mask)
    shown = ", ".join(str(tuple(int(x) for x in i)) for i in idx[:limit])
    more = "" if idx.shape[0] <= limit else f" (+{idx.shape[0] - limit} more)"
    return f"{idx.shape[0]} offender(s) at {shown}{more}"


def _first_violation(checks, counts=()):
    """One copy to the host of each check's any-flag and of the device
    scalars `counts`; returns ``(index of the first failed check or None,
    counts as ints)``.  Each check is ``(bad mask tensor, message)``."""
    dev = (checks[0][0] if checks else counts[0]).device
    cells = ([bad.any().to(torch.int64) for bad, _ in checks]
             + [torch.as_tensor(c, device=dev).to(torch.int64)
                for c in counts])
    host = sync.to_host(torch.stack(cells))
    n = len(checks)
    failed = next((i for i in range(n) if host[i]), None)
    return failed, [int(x) for x in host[n:]]


def _raise(message: str, bad: torch.Tensor):
    """Raise `message` with the offenders of `bad` (one more copy to the
    host, on the failure path only)."""
    raise InvariantViolation(f"{message}: {_offenders(sync.to_host(bad))}")


def check_records(records, cfg: AvalancheConfig) -> int:
    """Assert the vote-record invariants; returns the finalized count
    (fuel for the monotonicity check).  `records` is any
    `VoteRecordState` (``[N]`` or ``[N, T]``)."""
    counter = vr.get_confidence(records.confidence)
    # A record freezes once a round ends with it finalized, but the
    # ingest call it crosses applies its remaining sequential votes under
    # a mask computed at call start: overshoot caps at k - 1.
    cap = min(0x7FFF, cfg.finalization_score + cfg.k - 1)
    checks = [
        (counter > 0x7FFF,
         "confidence counter exceeds the 15-bit saturation cap 0x7FFF"),
        (counter > cap,
         f"confidence counter exceeds finalization_score + k - 1 = {cap} "
         f"(a record finalized at a round boundary must freeze)"),
    ]
    if cfg.window < 8:
        above = 0xFF ^ ((1 << cfg.window) - 1)
        for name in ("votes", "consider"):
            plane = getattr(records, name)
            checks.append(
                ((plane & above) != 0,
                 f"{name} window plane carries bits above "
                 f"window={cfg.window}"))
    finalized = vr.has_finalized(records.confidence, cfg).sum()
    failed, (count,) = _first_violation(checks, (finalized,))
    if failed is not None:
        _raise(checks[failed][1], checks[failed][0])
    return count


def check_ring(ring, cfg: AvalancheConfig, t: Optional[int] = None,
               tx_shards: int = 1) -> None:
    """Assert the in-flight ring invariants (None ring passes).

    `t` (the multi-target tx width) enables the packed-plane padding
    check for a coalesced ring; `tx_shards` selects which per-shard byte
    layout the plane must carry."""
    if ring is None:
        return
    timeout = cfg.timeout_rounds()
    depth = int(ring.peers.shape[0])
    if depth != timeout + 1:
        raise InvariantViolation(
            f"ring depth {depth} != timeout_rounds() + 1 = {timeout + 1}: "
            f"entry ages can escape the ring")
    checks = [((ring.lat < 0) | (ring.lat > timeout),
               f"ring latency outside [0, timeout={timeout}]")]
    polled = ring.polled
    if polled.dtype == torch.uint8 and t is not None:
        t_local = t // tx_shards
        pad_bits = -t_local % 8
        if pad_bits:
            blocks = polled.reshape(*polled.shape[:-1], tx_shards, -1)
            # Bits t_local .. of each shard block's last byte are pad.
            pad_mask = ((1 << pad_bits) - 1) << (t_local % 8)
            checks.append(
                ((blocks[..., -1] & pad_mask) != 0,
                 "bit-packed ring poll mask has NON-ZERO padding bits "
                 "(layout-aliased repack? see "
                 "inflight.repack_polled_for_shards)"))
    failed, _ = _first_violation(checks)
    if failed is not None:
        _raise(checks[failed][1], checks[failed][0])


def check_ring_cut(ring, cfg: AvalancheConfig, round_: int,
                   n_global: int, row_offset: int = 0) -> None:
    """Event accounting: no delivery can be pending across an active cut.

    Re-derives, in host numpy, which of the ring's stored (querier, peer)
    draws were severed by a cut event (partition / regional_outage)
    active at their issue round (slot ``r % depth`` holds round r's
    queries, so `round_`, the state's next-round counter, dates every
    slot) and asserts each severed entry carries the never-delivers
    timeout sentinel, as `ops/inflight.apply_faults` stamped it at issue.
    Slots not written yet pass.  None ring or no cut event: no-op.
    """
    if ring is None:
        return
    events = cfg.cut_events()
    if not events:
        return
    from go_avalanche_tpu_torch.ops import inflight

    timeout = cfg.timeout_rounds()
    depth = int(ring.peers.shape[0])
    n_cells = ring.peers.numel()
    host = sync.to_host(torch.cat([ring.peers.reshape(-1),
                                   ring.lat.reshape(-1).to(torch.int32)]))
    peers = host[:n_cells].reshape(tuple(ring.peers.shape))
    lat = host[n_cells:].reshape(tuple(ring.lat.shape))
    rows = peers.shape[1]
    qids = np.arange(rows, dtype=np.int64) + row_offset
    for slot in range(depth):
        if round_ <= slot:            # slot never written yet
            continue
        issue = round_ - 1 - ((round_ - 1 - slot) % depth)
        severed = np.zeros(peers[slot].shape, np.bool_)
        for kind, start, end, param in events:
            if not (start <= issue < end):
                continue
            if kind == "partition":
                split = inflight._partition_split(cfg, n_global, param)
                qside = qids < split
                pside = peers[slot] < split
            else:                      # regional_outage
                qside = (qids * cfg.n_clusters // n_global) == param
                pside = (peers[slot].astype(np.int64)
                         * cfg.n_clusters // n_global) == param
            severed |= qside[:, None] != pside
        bad = severed & (lat[slot] != timeout)
        if bad.any():
            raise InvariantViolation(
                f"ring slot {slot} (issued round {issue}) holds "
                f"deliverable entries across an active cut — severed "
                f"draws must carry the timeout sentinel {timeout}: "
                f"{_offenders(bad)}")


def check_trace(trace, cfg: AvalancheConfig, round_: int) -> None:
    """Trace-plane consistency (None buffer passes): the write cursor
    equals ``ceil(round_ / stride)``, the slots a run of `round_` rounds
    wrote, and every slot at or beyond the cursor is still zero."""
    if trace is None:
        return
    stride = trace.stride
    host = obs_trace.to_host(trace)
    cursor = int(host.cursor)
    expected = -(-int(round_) // stride)       # ceil(round / stride)
    if cursor != expected:
        raise InvariantViolation(
            f"trace cursor {cursor} != ceil(round / stride) = "
            f"ceil({round_} / {stride}) = {expected}: the trace plane "
            f"skipped or double-wrote a slot")
    data = host.data
    if cursor < data.shape[0]:
        bad = (data[cursor:] != 0).any(axis=-1)
        if bad.any():
            raise InvariantViolation(
                f"trace slots beyond the cursor ({cursor}) are "
                f"non-zero — untouched slots must stay zero: "
                f"{_offenders(bad)}")


def _resolve(state):
    """(records, ring, t, round, trace) from any model's state."""
    if hasattr(state, "dag"):                  # StreamingDagState
        state = state.dag
    if hasattr(state, "sim"):                  # Backlog / NodeStream state
        state = state.sim
    if hasattr(state, "base"):                 # DagSimState
        state = state.base
    records = state.records
    t = records.votes.shape[1] if records.votes.ndim == 2 else None
    return (records, getattr(state, "inflight", None), t,
            getattr(state, "round", None),
            getattr(state, "trace", None))


class Watchdog:
    """Stateful checker: call `check(state)` after every step.

    Tracks the finalized count across calls for the monotonicity
    invariant; `monotonic=False` for the streaming schedulers, whose
    column refills legitimately reset finality.  `tx_shards` forwards to
    the packed-plane padding check.
    """

    def __init__(self, cfg: AvalancheConfig, monotonic: bool = True,
                 tx_shards: int = 1):
        self.cfg = cfg
        self.monotonic = monotonic
        self.tx_shards = tx_shards
        self.checks = 0
        self._prev_finalized: Optional[int] = None

    def check(self, state) -> int:
        """Run every invariant against `state`; returns the finalized
        count.  Raises `InvariantViolation` on the first failure."""
        records, ring, t, round_, trace = _resolve(state)
        finalized = check_records(records, self.cfg)
        check_ring(ring, self.cfg, t=t, tx_shards=self.tx_shards)
        if round_ is not None and (trace is not None or (
                ring is not None and self.cfg.cut_events())):
            r = sync.read(round_)
            check_ring_cut(ring, self.cfg, r,
                           n_global=int(records.votes.shape[0]))
            check_trace(trace, self.cfg, r)
        if (self.monotonic and self._prev_finalized is not None
                and finalized < self._prev_finalized):
            raise InvariantViolation(
                f"finalized count decreased: {self._prev_finalized} -> "
                f"{finalized} (finalized records must freeze)")
        self._prev_finalized = finalized
        self.checks += 1
        return finalized
