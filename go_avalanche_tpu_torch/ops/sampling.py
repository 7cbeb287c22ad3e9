"""Peer sampling (uniform family) — `go_avalanche_tpu/ops/sampling.py`.

Every node draws k peers per round from the state's threefry key, with
jax's exact bits (`prng.randint`), so the port samples the same peers as
the reference on the same key.
"""

from __future__ import annotations

import torch

from go_avalanche_tpu_torch import prng


def sample_peers_uniform(key: torch.Tensor, n_nodes: int, k: int,
                         exclude_self: bool = True) -> torch.Tensor:
    """Uniform k-peer sample per node, with replacement; int32
    ``[n_nodes, k]``.  With `exclude_self` node i never draws i: draws
    come from [0, n_nodes - 1) and values >= i shift up by one."""
    if exclude_self and n_nodes < 2:
        raise ValueError("exclude_self requires at least 2 nodes")
    if not exclude_self:
        return prng.randint(key, (n_nodes, k), 0, n_nodes)
    self_ids = torch.arange(n_nodes, dtype=torch.int32,
                            device=key.device)[:, None]
    draws = prng.randint(key, (n_nodes, k), 0, n_nodes - 1)
    return draws + (draws >= self_ids).to(torch.int32)


def draw_peers(key: torch.Tensor, cfg, n_nodes: int) -> tuple:
    """The per-round peer draw: the uniform branch of the reference's
    `draw_peers` dispatch (the config rejects the weighted, clustered,
    stake and without-replacement families).  Returns ``(peers,
    self_draw)``; `self_draw` is None because exclusion is exact."""
    return sample_peers_uniform(key, n_nodes, cfg.k, cfg.exclude_self), None
