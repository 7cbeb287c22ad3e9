"""Slush and Snowflake, the rest of the Avalanche protocol family —
`go_avalanche_tpu/models/family.py`.

    Slush      — memoryless: adopt any alpha-majority color seen in a
                 poll; run a fixed number of rounds.
    Snowflake  — Slush plus a conviction counter: accept a color after
                 beta consecutive alpha-majority polls for it; any other
                 outcome resets the count.

Both share one poll (`_poll_majorities`: k uniform peers, the adversary
and the failure model) with the reference's key splits, so a trajectory
is the reference's bit for bit.  Parameters map as k = cfg.k, alpha =
cfg.alpha, beta = cfg.finalization_score, and Slush's m = the caller's
round budget.  The family builds no adversary-policy context, as the
reference's does not: under `adversary_policy="split_vote"` its poll
raises the reference's `ValueError`.  The entry points run on the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from go_avalanche_tpu_torch import prng, sync
from go_avalanche_tpu_torch.config import AvalancheConfig, DEFAULT_CONFIG
from go_avalanche_tpu_torch.models.avalanche import _device
from go_avalanche_tpu_torch.ops import adversary
from go_avalanche_tpu_torch.ops.sampling import sample_peers_uniform


class SlushState(NamedTuple):
    """``[N]`` color plane and fault masks; no memory beyond the color."""

    color: torch.Tensor      # bool [N] — current color (True = yes)
    byzantine: torch.Tensor  # bool [N]
    alive: torch.Tensor      # bool [N]
    round: torch.Tensor      # int32 scalar
    key: torch.Tensor        # int64 [2] threefry key words


class SnowflakeState(NamedTuple):
    """Slush plus a conviction counter and an acceptance stamp."""

    color: torch.Tensor        # bool [N]
    count: torch.Tensor        # int32 [N] — consecutive successes
    accepted_at: torch.Tensor  # int32 [N] — round of acceptance; -1 before
    byzantine: torch.Tensor    # bool [N]
    alive: torch.Tensor        # bool [N]
    round: torch.Tensor        # int32 scalar
    key: torch.Tensor          # int64 [2] threefry key words


class FamilyTelemetry(NamedTuple):
    yes_colors: torch.Tensor  # int32 — nodes currently colored yes
    switches: torch.Tensor    # int32 — nodes that changed color this round
    accepted: torch.Tensor    # int32 — nodes accepted so far (0 for slush)


def to_device(state, device):
    """Move every leaf of a Slush or Snowflake state to `device`."""
    dev = _device(device)
    return type(state)(*(x.to(dev) for x in state))


def _init_colors(key: torch.Tensor, n_nodes: int, cfg: AvalancheConfig,
                 yes_fraction: float, device) -> Tuple:
    dev = _device(device)
    k_pref, k_next = prng.split(key.to(dev, torch.int64))
    color = prng.bernoulli(k_pref, yes_fraction, (n_nodes,))
    n_byz = int(round(cfg.byzantine_fraction * n_nodes))
    return color, torch.arange(n_nodes, device=dev) < n_byz, k_next


def _count(x: torch.Tensor) -> torch.Tensor:
    return x.sum().to(torch.int32)


def _poll_majorities(state, cfg: AvalancheConfig) -> Tuple:
    """The poll both protocols share: sample k peers, apply the
    adversary and the failure model; returns ``(yes_maj, no_maj,
    churned alive mask, next key)``."""
    n = state.color.shape[0]
    k_sample, k_byz, k_drop, k_churn, k_next = prng.split(state.key, 5)
    peers = sample_peers_uniform(k_sample, n, cfg.k, cfg.exclude_self,
                                 cfg.sample_with_replacement)
    peers_l = peers.long()
    lie = adversary.lie_mask(k_byz, peers, state.byzantine, cfg)
    votes = adversary.apply_1d(k_byz, state.color[peers_l], lie, cfg,
                               state.color)
    responded = state.alive[peers_l]
    if cfg.drop_probability > 0.0:
        responded &= ~prng.bernoulli(k_drop, cfg.drop_probability,
                                     tuple(peers.shape))
    thresh = math.ceil(cfg.alpha * cfg.k)
    yes_cnt = (votes & responded).sum(dim=1, dtype=torch.int32)
    no_cnt = (~votes & responded).sum(dim=1, dtype=torch.int32)
    alive = state.alive
    if cfg.churn_probability > 0.0:
        alive = alive ^ prng.bernoulli(k_churn, cfg.churn_probability, (n,))
    return yes_cnt >= thresh, no_cnt >= thresh, alive, k_next


# --------------------------------------------------------------------------
# Slush


def slush_init(key: torch.Tensor, n_nodes: int,
               cfg: AvalancheConfig = DEFAULT_CONFIG,
               yes_fraction: float = 0.5, device="cuda") -> SlushState:
    """Fresh Slush network on `device`."""
    color, byzantine, k_next = _init_colors(key, n_nodes, cfg, yes_fraction,
                                            device)
    return SlushState(color=color, byzantine=byzantine,
                      alive=torch.ones_like(color),
                      round=torch.zeros((), dtype=torch.int32,
                                        device=color.device),
                      key=k_next)


def slush_round(state: SlushState, cfg: AvalancheConfig = DEFAULT_CONFIG
                ) -> Tuple[SlushState, FamilyTelemetry]:
    """One memoryless round: adopt whichever color won an
    alpha-majority."""
    yes_maj, no_maj, alive, k_next = _poll_majorities(state, cfg)
    new_color = torch.where(yes_maj, True,
                            torch.where(no_maj, False, state.color))
    new_color = torch.where(state.alive, new_color, state.color)
    tel = FamilyTelemetry(
        yes_colors=_count(new_color),
        switches=_count(new_color != state.color),
        accepted=torch.zeros((), dtype=torch.int32, device=alive.device))
    return SlushState(color=new_color, byzantine=state.byzantine,
                      alive=alive, round=state.round + 1, key=k_next), tel


def slush_run(state: SlushState, cfg: AvalancheConfig = DEFAULT_CONFIG,
              m_rounds: int = 100, device="cuda"
              ) -> Tuple[SlushState, FamilyTelemetry]:
    """The paper's Slush loop on `device`: exactly `m_rounds` rounds,
    with stacked telemetry."""
    state = to_device(state, device)
    rows = []
    for _ in range(m_rounds):
        state, tel = slush_round(state, cfg)
        rows.append(tel)
    return state, FamilyTelemetry(*(torch.stack(col) for col in zip(*rows)))


# --------------------------------------------------------------------------
# Snowflake


def snowflake_init(key: torch.Tensor, n_nodes: int,
                   cfg: AvalancheConfig = DEFAULT_CONFIG,
                   yes_fraction: float = 0.5,
                   device="cuda") -> SnowflakeState:
    """Fresh Snowflake network on `device`."""
    color, byzantine, k_next = _init_colors(key, n_nodes, cfg, yes_fraction,
                                            device)
    dev = color.device
    return SnowflakeState(
        color=color, count=torch.zeros(n_nodes, dtype=torch.int32,
                                       device=dev),
        accepted_at=torch.full((n_nodes,), -1, dtype=torch.int32,
                               device=dev),
        byzantine=byzantine, alive=torch.ones_like(color),
        round=torch.zeros((), dtype=torch.int32, device=dev), key=k_next)


def snowflake_round(state: SnowflakeState,
                    cfg: AvalancheConfig = DEFAULT_CONFIG
                    ) -> Tuple[SnowflakeState, FamilyTelemetry]:
    """One round: an alpha-majority for my color counts one more; one
    for the other color switches and counts 1; an inconclusive poll
    resets to 0.  Accepted nodes are frozen but keep answering with
    their accepted color."""
    beta = cfg.finalization_score
    accepted = state.accepted_at >= 0
    yes_maj, no_maj, alive, k_next = _poll_majorities(state, cfg)

    maj_for_mine = torch.where(state.color, yes_maj, no_maj)
    maj_for_other = torch.where(state.color, no_maj, yes_maj)
    new_color = torch.where(maj_for_other, ~state.color, state.color)
    new_count = torch.where(maj_for_mine, state.count + 1,
                            maj_for_other.to(torch.int32))

    frozen = accepted | ~state.alive
    new_color = torch.where(frozen, state.color, new_color)
    new_count = torch.where(frozen, state.count, new_count)

    newly_accepted = (new_count >= beta) & ~accepted
    accepted_at = torch.where(newly_accepted, state.round, state.accepted_at)

    tel = FamilyTelemetry(
        yes_colors=_count(new_color),
        switches=_count((new_color != state.color) & ~frozen),
        accepted=_count(accepted_at >= 0))
    return SnowflakeState(color=new_color, count=new_count,
                          accepted_at=accepted_at,
                          byzantine=state.byzantine, alive=alive,
                          round=state.round + 1, key=k_next), tel


def snowflake_run(state: SnowflakeState,
                  cfg: AvalancheConfig = DEFAULT_CONFIG,
                  max_rounds: int = 10_000, device="cuda") -> SnowflakeState:
    """Run on `device` until every live node accepted or `max_rounds`;
    reads the round and the pending flag back before each round to
    decide whether to go on (`sync.read`)."""
    state = to_device(state, device)
    while (sync.read(state.round) < max_rounds
           and sync.read(((state.accepted_at < 0) & state.alive).any())):
        state = snowflake_round(state, cfg)[0]
    return state
