"""The conflict-set Avalanche round over ``[nodes, txs]``, in plain
PyTorch: the plain reference's own copy, frozen.

Transactions lie in contiguous conflict sets of `c` members (tx t is in
set ``t // c``).  A node answers a poll about t with yes iff t is its
preferred member of the set: the one with the highest confidence word,
ties to the lowest index.  A set is settled on a node once a member
finalized accepted there, and its rivals are no longer polled.

The state is a dict of named planes, the names the benchmark compares
by.  Only the paths the benchmark's configurations state are here:
synchronous queries, uniform peer draws with replacement and without
self, the FLIP adversary, no drops, no churn, no taps.
`check_config` refuses anything else.
"""

from __future__ import annotations

import torch

from portbench.reference import prng
from portbench.reference import records as rv

# The configuration keys this reference implements, with the only
# values it implements them at (None: any value).
SUPPORTED = {
    "time_step_s": None, "request_timeout_s": None, "max_element_poll": None,
    "finalization_score": None, "window": None, "quorum": None, "k": None,
    "alpha": None, "vote_mode": ("sequential",),
    "sample_with_replacement": (True,), "exclude_self": (True,),
    "weighted_sampling": (False,), "n_clusters": (1,),
    "cluster_locality": None, "fused_exchange": None,
    # The conflict-set round has no gossip admission: the key is inert.
    "gossip": None,
    "ingest_engine": None, "round_engine": ("phased",),
    "fused_sharded_gossip": (False,), "strict_validation": (False,),
    "latency_mode": ("none",), "latency_rounds": (0,),
    "partition_spec": (None,), "fault_script": (None,),
    "rtt_matrix": (None,), "inflight_engine": None, "metrics_every": (0,),
    "trace_every": (0,), "stream_retire_cap": (None,),
    "arrival_mode": ("off",), "arrival_rate": None, "arrival_period": None,
    "arrival_burst_factor": None, "arrival_duty": None,
    "arrival_depth": None, "arrival_backpressure": None,
    "arrival_cluster_weights": None, "arrival_latency_buckets": None,
    "stake_mode": ("off",), "stake_zipf_s": None, "stake_weights": (None,),
    "registry_nodes": (0,), "active_nodes": (0,),
    "node_churn_rate": (0.0,), "byzantine_fraction": None,
    "flip_probability": None, "adversary_strategy": ("flip",),
    "adversary_policy": ("off",), "adversary_margin": None,
    "drop_probability": (0.0,), "churn_probability": (0.0,),
    "skip_absent_votes": (False,),
}


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


def orders(scores: torch.Tensor):
    """``(score_rank, poll_order, poll_order_inv)``: targets by
    descending score, ties by index."""
    t = scores.shape[0]
    order = torch.argsort(-scores.to(torch.int64), stable=True)
    rank = torch.empty(t, dtype=torch.int32, device=scores.device)
    rank[order] = torch.arange(t, dtype=torch.int32, device=scores.device)
    return rank, order.to(torch.int32), rank.clone()


def init(key: torch.Tensor, n: int, t: int, c: int, cfg: dict,
         init_pref: torch.Tensor, added: torch.Tensor,
         valid: torch.Tensor) -> dict:
    """A fresh network: every record holds the bool ``[T]`` `init_pref`
    on every node, every score 1."""
    dev = key.device
    pref = torch.broadcast_to(init_pref[None, :], (n, t))
    rank, order, order_inv = orders(torch.ones(t, dtype=torch.int32,
                                               device=dev))
    n_byz = int(round(cfg["byzantine_fraction"] * n))
    state = rv.fresh(pref)
    state.update(
        added=added, valid=valid, score_rank=rank, poll_order=order,
        poll_order_inv=order_inv,
        byzantine=torch.arange(n, device=dev) < n_byz,
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        latency_weight=torch.ones(n, dtype=torch.float32, device=dev),
        finalized_at=torch.full((n, t), -1, dtype=torch.int32, device=dev),
        round=torch.zeros((), dtype=torch.int32, device=dev),
        key=key.clone(),
        conflict_set=torch.arange(t, dtype=torch.int32, device=dev) // c)
    return state


def init_settle(key: torch.Tensor, n: int, t: int, c: int,
                cfg: dict) -> dict:
    """The DAG of a run to settlement: every node holds every tx and
    prefers the first member of each set."""
    dev = key.device
    lanes = torch.arange(t, device=dev) % c
    ones = torch.ones((n, t), dtype=torch.bool, device=dev)
    return init(key, n, t, c, cfg, lanes == 0, ones,
                torch.ones(t, dtype=torch.bool, device=dev))


def set_any(plane: torch.Tensor, c: int) -> torch.Tensor:
    """Bool ``[N, T]``: does t's set hold a True on this node?"""
    n, t = plane.shape
    return plane.reshape(n, t // c, c).any(dim=2).repeat_interleave(c, dim=1)


def preferred(confidence: torch.Tensor, c: int) -> torch.Tensor:
    """Bool ``[N, T]``: t is this node's preferred member of its set:
    the highest confidence word, the lowest index on a tie."""
    n, t = confidence.shape
    word = rv.widen(confidence).reshape(n, t // c, c)
    best = word.max(dim=2, keepdim=True).values
    lane = torch.arange(c, device=confidence.device)
    first = torch.where(word == best, lane, c).min(dim=2, keepdim=True).values
    return (lane == first).reshape(n, t)


def poll_mask(state: dict, cfg: dict, c: int):
    """``(polled, fin)``: the pairs this round polls, at most
    `max_element_poll` a node in score order, and the pre-round
    finality plane."""
    conf = state["confidence"]
    fin = rv.has_finalized(conf, cfg["finalization_score"])
    fin_acc = fin & rv.is_accepted(conf)
    rival = set_any(fin_acc, c) & ~fin_acc
    pollable = (state["added"] & state["alive"][:, None]
                & state["valid"][None, :] & ~fin & ~rival)
    cap = cfg["max_element_poll"]
    if pollable.shape[1] <= cap:
        return pollable, fin
    in_order = pollable[:, state["poll_order"].long()]
    keep = (torch.cumsum(in_order.to(torch.int64), dim=1) <= cap) & in_order
    return keep[:, state["poll_order_inv"].long()], fin


def draw_peers(key: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """k peers a node, uniform with replacement, never the node itself:
    a draw on [0, n - 1) shifted up by one from the node's own id."""
    draws = prng.randint(key, (n, k), 0, n - 1)
    own = torch.arange(n, dtype=torch.int32, device=key.device)[:, None]
    return draws + (draws >= own).to(torch.int32)


def vote_packs(prefs: torch.Tensor, peers: torch.Tensor,
               lie: torch.Tensor, responded: torch.Tensor):
    """``(yes_pack, consider_pack)``: bit j of a record is draw j's
    answer (the peer's preference, flipped where it lies) and whether
    the peer answered."""
    n, k = peers.shape
    yes = torch.zeros(prefs.shape, dtype=torch.uint8, device=prefs.device)
    consider = torch.zeros((n, 1), dtype=torch.uint8, device=prefs.device)
    for j in range(k):
        answer = prefs[peers[:, j].long()] ^ lie[:, j:j + 1]
        yes |= answer.to(torch.uint8) << j
        consider |= responded[:, j:j + 1].to(torch.uint8) << j
    return yes, consider


def round_step(state: dict, cfg: dict, c: int):
    """One round; returns ``(state, telemetry)``, the telemetry a dict
    of int32 scalars."""
    n, t = state["votes"].shape
    k = cfg["k"]
    keys = prng.split(state["key"], 5)
    k_sample, k_byz, k_next = keys[0], keys[1], keys[4]
    polled, fin = poll_mask(state, cfg, c)
    peers = draw_peers(k_sample, n, k)
    lie = state["byzantine"][peers.long()] & prng.bernoulli(
        k_byz, cfg["flip_probability"], (n, k))
    responded = state["alive"][peers.long()]
    prefs = preferred(state["confidence"], c)
    yes_pack, consider_pack = vote_packs(prefs, peers, lie, responded)
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


def settled(state: dict, cfg: dict, c: int) -> bool:
    """Every set has a member finalized accepted on every live node."""
    conf = state["confidence"]
    fin_acc = (rv.has_finalized(conf, cfg["finalization_score"])
               & rv.is_accepted(conf))
    n, t = fin_acc.shape
    done = fin_acc.reshape(n, t // c, c).any(dim=2)
    return bool((done | ~state["alive"][:, None]).all())


def key_after(key: torch.Tensor, rounds: int) -> torch.Tensor:
    """The round key after `rounds` rounds from `key`: the chain of
    `round_step`'s fifth split, alone."""
    for _ in range(rounds):
        key = prng.split(key, 5)[4]
    return key


def run_settle(key: torch.Tensor, n: int, t: int, c: int, cfg: dict,
               max_rounds: int):
    """One simulation from its key to settlement (or `max_rounds`):
    ``(final state, [telemetry per round])``."""
    state = init_settle(key, n, t, c, cfg)
    rows = []
    while len(rows) < max_rounds and not settled(state, cfg, c):
        state, tel = round_step(state, cfg, c)
        rows.append(tel)
    return state, rows
