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
(`cfg.flip_probability`) fires for that (querier, draw).  The adaptive
policies (`cfg.adversary_policy`) are not ported; the config rejects
them.
"""

from __future__ import annotations

import torch

from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import AdversaryStrategy, AvalancheConfig

_EQUIVOCATE_FOLD = 0x5A


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
             cfg: AvalancheConfig, prefs: torch.Tensor) -> torch.Tensor:
    """Adversary transform for the single-decree models: `votes` and
    `lie` are bool ``[N, k]``, `prefs` the bool ``[N]`` preferences
    (read by OPPOSE_MAJORITY only).  EQUIVOCATE's coin per (querier,
    draw) comes from ``fold_in(key, 0x5A)``."""
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


def apply_draw_planes(key: torch.Tensor, votes: torch.Tensor,
                      lie: torch.Tensor, cfg: AvalancheConfig,
                      minority_t: torch.Tensor) -> torch.Tensor:
    """Adversary transform for all k draws of the bool ``[N, k, T]``
    gathered-response cube at once (the fused exchange)."""
    s = cfg.adversary_strategy
    lie3 = lie[:, :, None]
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
                minority_t: torch.Tensor) -> torch.Tensor:
    """Adversary transform for one draw's bool ``[N, T]`` plane (the
    k-pass exchange); bit-exact with `apply_draw_planes`."""
    s = cfg.adversary_strategy
    lie2 = lie_j[:, None]
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
                           minority_t: torch.Tensor) -> tuple:
    """The k-draw vote-pack loop: `get_vote_plane(j)` returns draw j's
    bool ``[N, T]`` plane; returns the ``(yes_pack, consider_pack)``
    uint8 planes (bit j = draw j)."""
    n = responded.shape[0]
    t = minority_t.shape[0]
    yes_pack = torch.zeros((n, t), dtype=torch.uint8, device=lie.device)
    consider_pack = torch.zeros((n, t), dtype=torch.uint8, device=lie.device)
    for j in range(cfg.k):
        vote_j = apply_plane(key, j, get_vote_plane(j), lie[:, j], cfg,
                             minority_t)
        yes_pack |= vote_j.to(torch.uint8) << j
        consider_pack |= (responded[:, j].to(torch.uint8) << j)[:, None]
    return yes_pack, consider_pack
