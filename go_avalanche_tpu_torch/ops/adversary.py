"""Adversary vote transforms — `go_avalanche_tpu/ops/adversary.py`.

The three static strategies, applied to gathered peer votes (`apply_1d`
for the single-decree models' ``[N, k]`` votes, the plane transforms for
the multi-target rounds):

  FLIP            — lie with the opposite of the peer's true preference;
  EQUIVOCATE      — lie with a fresh coin per (querier, draw, target),
                    drawn from ``fold_in(fold_in(key, 0x5A), draw)`` so the
                    fused and the k-pass exchange see one stream;
  OPPOSE_MAJORITY — lie with the current per-target minority color.

A draw lies iff the sampled peer is byzantine and a Bernoulli
(`cfg.flip_probability`) fires for that (querier, draw).

The adaptive policies (`cfg.adversary_policy`, arXiv 2401.02811 and
2409.02217) choose lies from the network's state.  One per-round
context (`PolicyCtx`, built by `policy_ctx` from the PRE-round records)
is threaded through the exchange and delivery engines:

  split_vote            — lies vote the HONEST population's minority
                          color per target (a fresh coin on an exact
                          honest tie, from its own ``fold_in(key,
                          0xB511)`` stream), holding the split even;
  withhold_near_quorum  — a lying draw to a querier within
                          `cfg.adversary_margin` window votes of the
                          quorum turns into silence (`apply_policy_issue`;
                          async rounds stamp it never-delivers,
                          `apply_policy_latency`);
  stake_eclipse         — lies only reach the top-stake honest queriers;
  timing                — lies land at the last deliverable age
                          (`apply_policy_latency`).

With the policy off every helper passes its inputs through and the
context is None.  The split_vote tie coins are drawn only in a round
whose context holds a tie (`PolicyCtx.split_tied`, one host read a
round): where no target is tied they would all be discarded, and an odd
honest population never ties.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from go_avalanche_tpu_torch import prng, sync
from go_avalanche_tpu_torch.config import AdversaryStrategy, AvalancheConfig
from go_avalanche_tpu_torch.ops import voterecord as vr
from go_avalanche_tpu_torch.ops.bitops import popcount8

_EQUIVOCATE_FOLD = 0x5A
# The split_vote tie coins' own stream off the round's adversary key, so
# the policy never perturbs the strategy draws.
_SPLIT_FOLD = 0xB511


class PolicyCtx(NamedTuple):
    """Per-round adaptive-adversary context; only the active policy's
    fields are set."""

    split_t: Optional[torch.Tensor] = None     # bool [T] (scalar for
                                               # snowball): honest minority
    split_even: Optional[torch.Tensor] = None  # bool [T] / scalar: exact
                                               # honest tie
    withhold_q: Optional[torch.Tensor] = None  # bool [rows]: near-quorum
                                               # queriers
    eclipse_q: Optional[torch.Tensor] = None   # bool [N]: eclipsed
                                               # top-stake honest queriers
    split_tied: bool = True                    # host flag: split_even
                                               # holds a tie somewhere


def honest_split_plane(prefs: torch.Tensor, byzantine: torch.Tensor):
    """``(minority, even)`` of the honest rows' preference tally over the
    bool ``[N]`` or ``[N, T]`` response plane."""
    honest = ~byzantine
    n_honest = honest.sum()
    if prefs.ndim == 1:
        yes = (prefs & honest).sum()
    else:
        yes = (prefs & honest[:, None]).sum(dim=0)
    return yes * 2 < n_honest, yes * 2 == n_honest


def near_quorum_rows(records: vr.VoteRecordState,
                     cfg: AvalancheConfig) -> torch.Tensor:
    """Bool ``[rows]``: queriers holding a live (not finalized) record
    whose window yes- or no-count is at least ``quorum - margin``."""
    yes = popcount8(records.votes & records.consider)
    cons = popcount8(records.consider)
    near = (torch.maximum(yes, cons - yes).to(torch.int32)
            >= cfg.quorum - cfg.adversary_margin)
    near = near & ~vr.has_finalized(records.confidence, cfg)
    return near if near.ndim == 1 else near.any(dim=1)


def eclipse_rows(latency_weight: torch.Tensor, byzantine: torch.Tensor,
                 cfg: AvalancheConfig) -> torch.Tensor:
    """Bool ``[N]``: the ``max(1, round(byzantine_fraction * N))``
    heaviest honest rows of the sampling-propensity plane (ties at the
    threshold all qualify).  Byzantine rows carry -inf, so a set larger
    than the honest population saturates at every honest row."""
    n = latency_weight.shape[0]
    m = min(n, max(1, int(round(cfg.byzantine_fraction * n))))
    w = torch.where(byzantine, -torch.inf, latency_weight.to(torch.float32))
    kth = torch.topk(w, m).values[-1]
    return (w >= kth) & torch.isfinite(w)


def policy_ctx(cfg: AvalancheConfig, records: Optional[vr.VoteRecordState],
               byzantine: Optional[torch.Tensor],
               latency_weight: Optional[torch.Tensor],
               prefs: Optional[torch.Tensor] = None) -> Optional[PolicyCtx]:
    """The round's policy context from the PRE-round `records`; None with
    the policy off.  `prefs` overrides the plane the split tally reads
    (the DAG's preferred-in-set plane; by default the records' accepted
    bits); `latency_weight` None is a uniform plane."""
    if cfg.adversary_policy == "off":
        return None
    if cfg.adversary_policy == "split_vote":
        if prefs is None:
            prefs = vr.is_accepted(records.confidence)
        split_t, even = honest_split_plane(prefs, byzantine)
        return PolicyCtx(split_t=split_t, split_even=even,
                         split_tied=sync.read(even.any()))
    if cfg.adversary_policy == "withhold_near_quorum":
        return PolicyCtx(withhold_q=near_quorum_rows(records, cfg))
    if cfg.adversary_policy == "stake_eclipse":
        if latency_weight is None:
            latency_weight = torch.ones(byzantine.shape, dtype=torch.float32,
                                        device=byzantine.device)
        return PolicyCtx(eclipse_q=eclipse_rows(latency_weight, byzantine,
                                                cfg))
    return PolicyCtx()      # timing: latency plane only


def apply_policy_issue(cfg: AvalancheConfig, ctx: Optional[PolicyCtx],
                       lie: torch.Tensor, responded: torch.Tensor):
    """Issue-time effects on the round's ``[rows, k]`` masks; returns
    ``(lie, responded, withheld)``.  stake_eclipse keeps only the lies to
    eclipsed queriers; withhold_near_quorum silences the near-quorum
    queriers' lying draws (no response, no lie) and hands them on as
    `withheld`."""
    if ctx is None:
        return lie, responded, None
    if cfg.adversary_policy == "stake_eclipse":
        return lie & ctx.eclipse_q[:, None], responded, None
    if cfg.adversary_policy == "withhold_near_quorum":
        withheld = lie & ctx.withhold_q[:, None]
        keep = ~withheld
        return lie & keep, responded & keep, withheld
    return lie, responded, None


def apply_policy_latency(cfg: AvalancheConfig, lat: torch.Tensor,
                         lie: torch.Tensor,
                         withheld: Optional[torch.Tensor]) -> torch.Tensor:
    """Latency-plane effects, applied before the fault script: timing
    stamps lies ``timeout_rounds() - 1``, the last deliverable age;
    withheld draws get the never-delivers sentinel ``timeout_rounds()``
    and expire unanswered."""
    if cfg.adversary_policy == "timing":
        return torch.where(lie, cfg.timeout_rounds() - 1, lat)
    if withheld is not None:
        return torch.where(withheld, cfg.timeout_rounds(), lat)
    return lat


def _split_content(key: torch.Tensor, shape, even: torch.Tensor,
                   split: torch.Tensor, tied: bool) -> torch.Tensor:
    """The split_vote lie content: the honest-minority color, or a fresh
    coin on an exact honest tie; `even` and `split` broadcast against
    `shape`.  Without a tie (`tied` False) no coin is drawn."""
    if not tied:
        return split.expand(tuple(shape))
    coin = prng.bernoulli(key, 0.5, tuple(shape))
    return torch.where(even, coin, split)


def _require_split_ctx(ctx: Optional[PolicyCtx]) -> PolicyCtx:
    if ctx is None or ctx.split_t is None:
        raise ValueError(
            "adversary_policy 'split_vote' needs the round's PolicyCtx "
            "(policy_ctx / _policy_ctx_sharded) threaded through the "
            "exchange engine — every model round builds it")
    return ctx


def lie_mask(key: torch.Tensor, peers: torch.Tensor, byzantine: torch.Tensor,
             cfg: AvalancheConfig) -> torch.Tensor:
    """Bool ``[N, k]`` — draws on which the sampled peer lies."""
    return byzantine[peers.long()] & prng.bernoulli(
        key, cfg.flip_probability, tuple(peers.shape))


def minority_color(prefs: torch.Tensor) -> torch.Tensor:
    """Scalar bool — the color held by fewer of the ``[N]`` nodes; a tie
    counts "no" as the minority."""
    return prefs.sum() * 2 < prefs.shape[0]


def minority_plane(prefs: torch.Tensor) -> torch.Tensor:
    """Bool ``[T]`` — per-target minority color over a ``[N, T]`` plane."""
    return prefs.sum(dim=0) * 2 < prefs.shape[0]


def apply_1d(key: torch.Tensor, votes: torch.Tensor, lie: torch.Tensor,
             cfg: AvalancheConfig, prefs: torch.Tensor,
             ctx: Optional[PolicyCtx] = None) -> torch.Tensor:
    """Adversary transform for the single-decree models: `votes` and
    `lie` are bool ``[N, k]``, `prefs` the bool ``[N]`` preferences
    (read by OPPOSE_MAJORITY only).  EQUIVOCATE's coin per (querier,
    draw) comes from ``fold_in(key, 0x5A)``; under split_vote the lie is
    the context's scalar honest-minority color, a coin from
    ``fold_in(key, 0xB511)`` on a tie."""
    if cfg.adversary_policy == "split_vote":
        ctx = _require_split_ctx(ctx)
        content = _split_content(prng.fold_in(key, _SPLIT_FOLD), votes.shape,
                                 ctx.split_even, ctx.split_t, ctx.split_tied)
        return torch.where(lie, content, votes)
    s = cfg.adversary_strategy
    if s is AdversaryStrategy.FLIP:
        return votes ^ lie
    if s is AdversaryStrategy.EQUIVOCATE:
        coins = prng.bernoulli(prng.fold_in(key, _EQUIVOCATE_FOLD), 0.5,
                               tuple(votes.shape))
        return torch.where(lie, coins, votes)
    return torch.where(lie, minority_color(prefs), votes)


def _equivocation_coins(key: torch.Tensor, draw: int, shape) -> torch.Tensor:
    return prng.bernoulli(prng.fold_in(prng.fold_in(key, _EQUIVOCATE_FOLD),
                                       draw), 0.5, shape)


def _split_plane(key: torch.Tensor, draw: int, shape,
                 ctx: PolicyCtx) -> torch.Tensor:
    """Draw `draw`'s ``[N, T]`` split_vote content, its tie coins from
    ``fold_in(fold_in(key, 0xB511), draw)``."""
    return _split_content(prng.fold_in(prng.fold_in(key, _SPLIT_FOLD), draw),
                          shape, ctx.split_even[None, :],
                          ctx.split_t[None, :], ctx.split_tied)


def apply_draw_planes(key: torch.Tensor, votes: torch.Tensor,
                      lie: torch.Tensor, cfg: AvalancheConfig,
                      minority_t: torch.Tensor,
                      ctx: Optional[PolicyCtx] = None) -> torch.Tensor:
    """Adversary transform for all k draws of the bool ``[N, k, T]``
    gathered-response cube at once (the fused exchange)."""
    lie3 = lie[:, :, None]
    if cfg.adversary_policy == "split_vote":
        ctx = _require_split_ctx(ctx)
        n, k, t = votes.shape
        content = torch.stack([_split_plane(key, j, (n, t), ctx)
                               for j in range(k)], dim=1)
        return torch.where(lie3, content, votes)
    s = cfg.adversary_strategy
    if s is AdversaryStrategy.FLIP:
        return votes ^ lie3
    if s is AdversaryStrategy.EQUIVOCATE:
        n, k, t = votes.shape
        coins = torch.stack([_equivocation_coins(key, j, (n, t))
                             for j in range(k)], dim=1)
        return torch.where(lie3, coins, votes)
    return torch.where(lie3, minority_t[None, None, :], votes)


def apply_plane(key: torch.Tensor, draw: int, vote_j: torch.Tensor,
                lie_j: torch.Tensor, cfg: AvalancheConfig,
                minority_t: torch.Tensor,
                ctx: Optional[PolicyCtx] = None) -> torch.Tensor:
    """Adversary transform for one draw's bool ``[N, T]`` plane (the
    k-pass exchange); bit-exact with `apply_draw_planes`."""
    lie2 = lie_j[:, None]
    if cfg.adversary_policy == "split_vote":
        ctx = _require_split_ctx(ctx)
        return torch.where(lie2, _split_plane(key, draw, tuple(vote_j.shape),
                                              ctx), vote_j)
    s = cfg.adversary_strategy
    if s is AdversaryStrategy.FLIP:
        return vote_j ^ lie2
    if s is AdversaryStrategy.EQUIVOCATE:
        return torch.where(lie2, _equivocation_coins(key, draw,
                                                     tuple(vote_j.shape)),
                           vote_j)
    return torch.where(lie2, minority_t[None, :], vote_j)


def pack_adversarial_votes(get_vote_plane, responded: torch.Tensor,
                           lie: torch.Tensor, key: torch.Tensor,
                           cfg: AvalancheConfig,
                           minority_t: torch.Tensor,
                           ctx: Optional[PolicyCtx] = None) -> tuple:
    """The k-draw vote-pack loop: `get_vote_plane(j)` returns draw j's
    bool ``[N, T]`` plane; returns the ``(yes_pack, consider_pack)``
    uint8 planes (bit j = draw j)."""
    n = responded.shape[0]
    t = minority_t.shape[0]
    yes_pack = torch.zeros((n, t), dtype=torch.uint8, device=lie.device)
    consider_pack = torch.zeros((n, t), dtype=torch.uint8, device=lie.device)
    for j in range(cfg.k):
        vote_j = apply_plane(key, j, get_vote_plane(j), lie[:, j], cfg,
                             minority_t, ctx)
        yes_pack |= vote_j.to(torch.uint8) << j
        consider_pack |= (responded[:, j].to(torch.uint8) << j)[:, None]
    return yes_pack, consider_pack
