"""The Processor — layer L2, the per-node poll/response engine; the
port's copy of `go_avalanche_tpu/processor.py` (plain Python, no tensor).

Host-side engine with full API parity to the reference (`processor.go:11-248`):
target admission, vote ingest with status updates, poll construction, peer
selection, and the ticker event loop.  This is the *control-plane* twin of the
batched simulator in `models/` — correct for one node with Python-object
targets; the `[nodes, txs]` array simulators are the scale path.

Deliberate fixes over the reference, each flagged by SURVEY.md section 2.3:
  * The request/response validation contract the reference compiled out behind
    `if false` "while hacking on simulations" (`processor.go:62-90`) is an
    explicit config mode (`AvalancheConfig.strict_validation`); both modes are
    tested.
  * Poll invs are deterministically score-descending (the intended-but-disabled
    `sortBlockInvsByWork`, `processor.go:163`), not map-random.
  * The round counter actually advances per poll (the reference never
    increments `p.round`; its tests bump it by hand, `avalanche_test.go:302`).
    `advance_round=False` restores reference behavior.
  * Peer selection honors an availability timer in strict mode (nodes with an
    outstanding unexpired request are not re-queried) — the TODO the reference
    tests carry (`avalanche_test.go:453-454, 277`) — and supports random
    selection in place of always-lowest-ID (`processor.go:173-182`).
  * Public methods are internally locked; the reference requires caller-side
    mutexes (`processor.go:21`, example `main.go:76`).
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional, Set, Tuple

from go_avalanche_tpu_torch.clock import Clock
from go_avalanche_tpu_torch.config import AvalancheConfig, DEFAULT_CONFIG
from go_avalanche_tpu_torch.net import Connman
from go_avalanche_tpu_torch.types import (
    NO_NODE,
    Hash,
    Inv,
    NodeID,
    RequestRecord,
    Response,
    StatusUpdate,
    Target,
    normalize_err,
    sort_invs_by_score,
)
from go_avalanche_tpu_torch.utils.golden import ScalarVoteRecord


class Processor:
    """Drives the Avalanche process: sends queries, handles responses.

    (`processor.go:11-37`.)
    """

    def __init__(
        self,
        connman: Connman,
        cfg: AvalancheConfig = DEFAULT_CONFIG,
        clock: Optional[Clock] = None,
        advance_round: bool = True,
        node_selection: str = "lowest",
        seed: int = 0,
    ) -> None:
        if node_selection not in ("lowest", "random"):
            raise ValueError("node_selection must be 'lowest' or 'random'")
        self._connman = connman
        self._cfg = cfg
        self._clock = clock if clock is not None else Clock()
        self._advance_round = advance_round
        self._node_selection = node_selection
        self._rng = random.Random(seed)

        self._round: int = 0
        self._targets: Dict[Hash, Target] = {}
        self._vote_records: Dict[Hash, ScalarVoteRecord] = {}
        self._node_ids: Set[NodeID] = set()
        self._queries: Dict[Tuple[int, NodeID], RequestRecord] = {}

        self._mu = threading.RLock()
        self._run_mu = threading.Lock()
        self._running = False
        self._stop_evt: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ state

    def get_round(self) -> int:
        """Current poll round (`processor.go:40-42`)."""
        with self._mu:
            return self._round

    def add_target_to_reconcile(self, t: Target) -> bool:
        """Begin voting on a target (`processor.go:45-58`).

        Idempotent; rejects invalid targets; seeds the record with the
        target's own initial preference.
        """
        with self._mu:
            if not self._is_worthy_polling(t):
                return False
            if t.hash() in self._vote_records:
                return False
            self._targets[t.hash()] = t
            self._vote_records[t.hash()] = ScalarVoteRecord.new(
                t.is_accepted(), self._cfg)
            return True

    def register_votes(self, node_id: NodeID, resp: Response,
                       updates: List[StatusUpdate]) -> bool:
        """Ingest a query response (`processor.go:61-122`).

        Appends one StatusUpdate per state change to `updates` and deletes
        finalized records.  In strict mode the response must answer an
        outstanding, unexpired request from `node_id` for exactly the polled
        invs, in order (`processor.go:64-89`).
        """
        with self._mu:
            if not self._cfg.strict_validation:
                # Opportunistically consume a matching pending query so the
                # queries dict stays bounded in sim mode too (the reference
                # leaks these; it only avoids unbounded growth because its
                # round never advances and the key is overwritten in place).
                self._queries.pop((resp.get_round(), node_id), None)
            else:
                key = (resp.get_round(), node_id)
                record = self._queries.pop(key, None)  # always consume the key
                if record is None:
                    return False
                if record.is_expired(self._clock.now(),
                                     self._cfg.request_timeout_s):
                    return False
                invs = record.get_invs()
                votes = resp.get_votes()
                if len(votes) != len(invs):
                    return False
                for inv, vote in zip(invs, votes):
                    if inv.target_hash != vote.get_hash():
                        return False

            for vote in resp.get_votes():
                vr = self._vote_records.get(vote.get_hash())
                if vr is None:
                    continue  # not voting on this anymore
                if not self._is_worthy_polling(self._targets[vote.get_hash()]):
                    continue
                if not vr.register_vote(normalize_err(vote.get_error())):
                    continue  # vote provided no extra information
                updates.append(StatusUpdate(vote.get_hash(), vr.status()))
                if vr.has_finalized():
                    del self._vote_records[vote.get_hash()]

            self._node_ids.add(node_id)
            return True

    def is_accepted(self, t: Target) -> bool:
        """Current acceptance of a target (`processor.go:125-130`).

        Unknown targets report False (including finalized-accepted ones whose
        records were removed — reference behavior).
        """
        with self._mu:
            vr = self._vote_records.get(t.hash())
            return vr.is_accepted() if vr is not None else False

    def get_confidence(self, t: Target) -> int:
        """Confidence in the target's current state (`processor.go:133-140`).

        Raises KeyError for unknown targets (the reference panics).
        """
        with self._mu:
            vr = self._vote_records.get(t.hash())
            if vr is None:
                raise KeyError(f"VoteRecord not found for hash {t.hash()}")
            return vr.get_confidence()

    # ------------------------------------------------------------------ polls

    def get_invs_for_next_poll(self) -> List[Inv]:
        """Invs for outstanding targets needing more votes
        (`processor.go:144-170`): skip finalized and invalid, order
        score-descending, cap at `max_element_poll`."""
        with self._mu:
            invs = []
            for h, vr in self._vote_records.items():
                if vr.has_finalized():
                    continue
                t = self._targets[h]
                if not self._is_worthy_polling(t):
                    continue
                invs.append(Inv(t.type(), h))
            invs = sort_invs_by_score(invs, self._targets)
            return invs[: self._cfg.max_element_poll]

    def get_suitable_node_to_query(self) -> NodeID:
        """Pick the peer for the next query (`processor.go:173-182`).

        'lowest' reproduces the reference placeholder (sorted, first);
        'random' is the protocol-correct uniform draw.  In strict mode, peers
        with an outstanding unexpired request are unavailable until they
        answer or the request expires.
        """
        with self._mu:
            candidates = self._available_nodes()
            if not candidates:
                return NO_NODE
            if self._node_selection == "random":
                return self._rng.choice(candidates)
            return candidates[0]

    def event_loop(self) -> None:
        """One tick (`processor.go:235-243`): snapshot the poll and record the
        pending query; transport is the caller's job.  Advances the round per
        poll when `advance_round` (the reference never does,
        SURVEY.md section 2.3)."""
        with self._mu:
            self._reap_expired_queries()
            invs = self.get_invs_for_next_poll()
            if not invs:
                return
            node_id = self.get_suitable_node_to_query()
            if node_id == NO_NODE:
                return
            self._queries[(self._round, node_id)] = RequestRecord(
                self._clock.now(), invs)
            if self._advance_round:
                self._round += 1

    # -------------------------------------------------------------- lifecycle

    def start(self) -> bool:
        """Begin the ticker loop (`processor.go:190-216`); False if running."""
        with self._run_mu:
            if self._running:
                return False
            self._running = True
            self._stop_evt = threading.Event()

            def _loop(stop: threading.Event) -> None:
                while not stop.wait(self._cfg.time_step_s):
                    self.event_loop()

            self._thread = threading.Thread(
                target=_loop, args=(self._stop_evt,), daemon=True)
            self._thread.start()
            return True

    def stop(self) -> bool:
        """Stop the ticker loop (`processor.go:219-232`); False if stopped."""
        with self._run_mu:
            if not self._running:
                return False
            assert self._stop_evt is not None and self._thread is not None
            self._stop_evt.set()
            self._thread.join()
            self._running = False
            return True

    # ------------------------------------------------------------- internals

    def _reap_expired_queries(self) -> None:
        """Drop expired pending queries so `_queries` stays bounded by the
        request timeout even for peers that never answer."""
        now = self._clock.now()
        expired = [k for k, r in self._queries.items()
                   if r.is_expired(now, self._cfg.request_timeout_s)]
        for k in expired:
            del self._queries[k]

    def _is_worthy_polling(self, t: Target) -> bool:
        """Polling is pointless for invalid targets (`processor.go:185-187`)."""
        return t.is_valid()

    def _available_nodes(self) -> List[NodeID]:
        node_ids = sorted(self._connman.nodes_ids())
        if not self._cfg.strict_validation:
            return node_ids
        now = self._clock.now()
        busy = {
            nid
            for (_, nid), record in self._queries.items()
            if not record.is_expired(now, self._cfg.request_timeout_s)
        }
        return [n for n in node_ids if n not in busy]

    def outstanding_requests(self) -> int:
        """Number of recorded, unanswered queries (observability helper)."""
        with self._mu:
            return len(self._queries)

    # Reference-spelling aliases for drop-in familiarity.
    GetRound = get_round
    AddTargetToReconcile = add_target_to_reconcile
    RegisterVotes = register_votes
    IsAccepted = is_accepted
    GetConfidence = get_confidence
    GetInvsForNextPoll = get_invs_for_next_poll
