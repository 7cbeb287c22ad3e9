"""The stake vector and the registry draw — `go_avalanche_tpu/stake.py`.

`node_stake` realizes `cfg.stake_mode` as a float32 stake per node:
"uniform" (equal stake), "zipf" (node i holds ``1 / (i + 1) ** s``, so
id 0 is the richest and, with byzantine nodes, the adversary holds the
top stake) or "explicit" (`cfg.stake_weights`).  `models/avalanche.init`
folds it into the `latency_weight` sampling-propensity plane, so every
peer draw of `ops/sampling.draw_peers` becomes a stake-weighted
committee draw.  `draw_working_set` is the node-stream registry's exact
stake-proportional draw without replacement (Gumbel top-k).
"""

from __future__ import annotations

import math

from typing import Optional, Tuple

import torch

from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import AvalancheConfig


def stake_enabled(cfg: AvalancheConfig) -> bool:
    """Is the stake subsystem on for this config?"""
    return cfg.stake_mode != "off"


def registry_enabled(cfg: AvalancheConfig) -> bool:
    """Is the node-axis streaming registry (`models/node_stream.py`) on?"""
    return cfg.registry_nodes > 0


def _device(device) -> torch.device:
    from go_avalanche_tpu_torch.models.avalanche import _device as resolve

    return resolve(device)


def node_stake(cfg: AvalancheConfig, n_nodes: int,
               device="cuda") -> Optional[torch.Tensor]:
    """float32 ``[n_nodes]`` per-node stake on `device` (the card unless
    the caller asks for the CPU); None when `cfg.stake_mode` is "off".
    An "explicit" vector must hold one stake per node."""
    if not stake_enabled(cfg):
        return None
    device = _device(device)
    if cfg.stake_mode == "uniform":
        return torch.ones(n_nodes, dtype=torch.float32, device=device)
    if cfg.stake_mode == "zipf":
        # The power is taken in float64 and rounded once, so the CPU and
        # the card agree; it is within 2 ulp of XLA's float32 `pow`.
        ranks = torch.arange(1, n_nodes + 1, dtype=torch.float64,
                             device=device)
        s = float(torch.tensor(cfg.stake_zipf_s, dtype=torch.float32))
        return 1.0 / (ranks ** s).float()
    if len(cfg.stake_weights) != n_nodes:
        raise ValueError(
            f"stake_mode 'explicit' needs one stake per node: "
            f"stake_weights has {len(cfg.stake_weights)} entries for "
            f"{n_nodes} nodes")
    return torch.tensor(cfg.stake_weights, dtype=torch.float32,
                        device=device)


def draw_working_set(key: torch.Tensor, stake: torch.Tensor, w: int,
                     mask: Optional[torch.Tensor] = None,
                     device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw `w` distinct registry ids stake-proportionally on `device`
    (exact weighted sampling without replacement: Gumbel top-k).

    Returns ``(ids [w] int32, valid [w] bool)`` in descending perturbed-
    score order, ties to the lower id as `lax.top_k` breaks them (a
    stable descending sort).  `valid[i]` is False where fewer than `w`
    drawable entries exist (zero stake, or excluded by `mask`, bool
    ``[R]``, True = drawable): those entries score -inf and come last,
    in id order.  The log-stake and the Gumbel noise are XLA:CPU's
    float32 bits (`prng.log_f32`, `prng.gumbel`)."""
    dev = _device(device)
    stake = stake.to(dev, torch.float32)
    drawable = stake > 0.0
    if mask is not None:
        drawable = drawable & mask.to(dev)
    log_stake = torch.where(drawable,
                            prng.log_f32(stake.clamp_min(1e-38)),
                            torch.full_like(stake, -math.inf))
    score = log_stake + prng.gumbel(key.to(dev), tuple(stake.shape))
    top, ids = torch.sort(score, descending=True, stable=True)
    return ids[:w].to(torch.int32), top[:w] > -math.inf
