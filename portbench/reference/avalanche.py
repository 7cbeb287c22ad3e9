"""go-avalanche's flat pre-consensus round over ``[nodes, txs]``, in
plain PyTorch: every tx is its own decision, and a node answers a poll
about it with its own acceptance (`processor.go`'s `is_accepted`, as
`examples/basic-preconcensus/main.go` wires the peers).

The state is a dict of named planes, the names the benchmark compares
by: `reference/dag.py`'s without `conflict_set`.  A network to
settlement starts from a 50/50 split of every (node, tx) pair
(``bernoulli(fold_in(key, 0xC0), 0.5, (N, T))``, the port's
`contested_init_pref_from_key`), every node holding every tx at score
1, so the poll order is by index.  The round reuses `reference/dag.py`'s
poll mask with one-member sets (no rival can be settled, so it is the
flat mask: live, valid, unfinalized, at most `max_element_poll` a node
in score order), its peer draw and its vote packs, and
`reference/records.py`'s sequential ingest.

Departures from the port's `models/avalanche.round_step`, all on paths
the configuration does not state (`check_config` refuses them): no
gossip admission, no async ring or fault script, no drops or churn, no
weighted, clustered or staked draws, no adaptive adversary, no
OPPOSE_MAJORITY or EQUIVOCATE lie, no metrics tap or trace plane.  The
two round engines, phased and megakernel, are one semantics here: the
port's megakernel fuses the phased round bit for bit.  The port
computes `votes_applied` as each row's responded count times its polled
records; here it is the popcount of the consider pack, which is the
same number.
"""

from __future__ import annotations

import torch

from portbench.reference import dag as ref_dag
from portbench.reference import prng
from portbench.reference import records as rv

# The configuration keys this reference implements, with the only
# values it implements them at (None: any value): the DAG reference's,
# with gossip off (the flat round's admission is not here) and either
# round engine.
SUPPORTED = {**ref_dag.SUPPORTED, "gossip": (False,),
             "round_engine": ("phased", "megakernel")}

# The fold of a key that draws the contested priors.
PRIOR_FOLD = 0xC0


def check_config(cfg: dict) -> None:
    """Raise unless every key of `cfg` is one this reference implements,
    at a value it implements."""
    for name, value in cfg.items():
        if name not in SUPPORTED:
            raise ValueError(f"the reference does not know key {name!r}")
        allowed = SUPPORTED[name]
        if allowed is not None and value not in allowed:
            raise ValueError(f"the reference implements {name} in "
                             f"{allowed}, not {value!r}")
    if cfg["k"] > 8:
        raise ValueError("k must be at most 8")


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in`: threefry over the counter pair
    ``(0, data)``."""
    zero = torch.zeros(1, dtype=torch.int64, device=key.device)
    b0, b1 = prng.threefry2x32(key, zero, zero + (int(data) & prng.M32))
    return torch.cat([b0, b1])


def init_settle(key: torch.Tensor, n: int, t: int, cfg: dict) -> dict:
    """A fresh network from a 50/50 split: each (node, tx) prefers
    acceptance with probability one half, every node holds every tx,
    every score is 1."""
    dev = key.device
    prior = prng.bernoulli(fold_in(key, PRIOR_FOLD), 0.5, (n, t))
    state = ref_dag.init(key, n, t, 1, cfg,
                         torch.zeros(t, dtype=torch.bool, device=dev),
                         torch.ones((n, t), dtype=torch.bool, device=dev),
                         torch.ones(t, dtype=torch.bool, device=dev))
    del state["conflict_set"]
    state.update(rv.fresh(prior))
    return state


def round_step(state: dict, cfg: dict):
    """One round; returns ``(state, telemetry)``, the telemetry a dict
    of int32 scalars.  As `reference/dag.round_step` with one-member
    sets, except that a peer answers with its acceptance of the tx."""
    n, t = state["votes"].shape
    k = cfg["k"]
    keys = prng.split(state["key"], 5)
    k_sample, k_byz, k_next = keys[0], keys[1], keys[4]
    polled, fin = ref_dag.poll_mask(state, cfg, 1)
    peers = ref_dag.draw_peers(k_sample, n, k)
    lie = state["byzantine"][peers.long()] & prng.bernoulli(
        k_byz, cfg["flip_probability"], (n, k))
    responded = state["alive"][peers.long()]
    prefs = rv.is_accepted(state["confidence"])
    yes_pack, consider_pack = ref_dag.vote_packs(prefs, peers, lie,
                                                 responded)
    rec = {name: state[name] for name in ("votes", "consider", "confidence")}
    rec, changed = rv.ingest(rec, yes_pack, consider_pack, cfg, polled)
    fin_after = rv.has_finalized(rec["confidence"], cfg["finalization_score"])
    newly = fin_after & ~fin
    finalized_at = torch.where(newly & (state["finalized_at"] < 0),
                               state["round"], state["finalized_at"])
    votes_applied = (rv.popcount8(consider_pack).to(torch.int64)
                     * polled).sum()
    zero = torch.zeros((), dtype=torch.int32, device=polled.device)
    telemetry = {
        "polls": polled.sum().to(torch.int32),
        "votes_applied": votes_applied.to(torch.int32),
        "flips": (changed & ~newly).sum().to(torch.int32),
        "finalizations": newly.sum().to(torch.int32),
        "admissions": zero, "deliveries": zero, "expiries": zero,
        "ring_occupancy": zero, "partition_blocked": zero,
        "gossip_writes": zero,
    }
    new = dict(state)
    new.update(rec, finalized_at=finalized_at, round=state["round"] + 1,
               key=k_next)
    return new, telemetry


def settled(state: dict, cfg: dict) -> bool:
    """No live node holds a valid tx it has not finalized."""
    fin = rv.has_finalized(state["confidence"], cfg["finalization_score"])
    pending = (state["added"] & state["alive"][:, None]
               & state["valid"][None, :] & ~fin)
    return not bool(pending.any())


def run_settle(key: torch.Tensor, n: int, t: int, cfg: dict,
               max_rounds: int):
    """One simulation from its key to settlement (or `max_rounds`):
    ``(final state, [telemetry per round])``."""
    state = init_settle(key, n, t, cfg)
    rows = []
    while len(rows) < max_rounds and not settled(state, cfg):
        state, tel = round_step(state, cfg)
        rows.append(tel)
    return state, rows
