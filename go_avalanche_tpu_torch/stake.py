"""The stake vector — `go_avalanche_tpu/stake.py`, without the node
registry.

`node_stake` realizes `cfg.stake_mode` as a float32 stake per node:
"uniform" (equal stake), "zipf" (node i holds ``1 / (i + 1) ** s``, so
id 0 is the richest and, with byzantine nodes, the adversary holds the
top stake) or "explicit" (`cfg.stake_weights`).  `models/avalanche.init`
folds it into the `latency_weight` sampling-propensity plane, so every
peer draw of `ops/sampling.draw_peers` becomes a stake-weighted
committee draw.  The registry's working-set draw (`draw_working_set`)
belongs to the node-stream scheduler and is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from go_avalanche_tpu_torch.config import AvalancheConfig


def stake_enabled(cfg: AvalancheConfig) -> bool:
    """Is the stake subsystem on for this config?"""
    return cfg.stake_mode != "off"


def node_stake(cfg: AvalancheConfig, n_nodes: int,
               device="cpu") -> Optional[torch.Tensor]:
    """float32 ``[n_nodes]`` per-node stake on `device`; None when
    `cfg.stake_mode` is "off".  An "explicit" vector must hold one stake
    per node."""
    if not stake_enabled(cfg):
        return None
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
