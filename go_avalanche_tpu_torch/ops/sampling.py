"""Peer sampling — `go_avalanche_tpu/ops/sampling.py`.

Every node draws k peers per round from the state's threefry key, with
jax's exact bits (`prng.randint`, `prng.uniform`), so the port samples
the same peers as the reference on the same key:

  uniform       with replacement, self excluded by a shift;
  distinct      k distinct peers per node (draw-and-shift);
  weighted      inverse-CDF draws over a propensity vector;
  hierarchical  the weighted draws under the reference's two-level name;
  clustered     per-cluster CDFs for a contiguous-block topology.

The inverse-CDF samplers search the reference's own float32 CDF, summed
in XLA:CPU's order (`cumsum_f32`), so that every comparison, and with it
every drawn id, is the reference's.  `draw_peers` is the dispatch every
multi-target round calls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from go_avalanche_tpu_torch import prng, stake

# XLA:CPU rewrites a cumulative sum into scans over blocks of this width.
_SCAN_BLOCK = 16


def cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 running sum along the last axis, in the order in which
    XLA:CPU evaluates `jnp.cumsum`: the axis is padded with zeros at
    its end to a multiple of 16 and cut into blocks of 16; each block
    is summed left to right; the block totals are scanned the same way,
    recursively; and each block adds the total of the blocks before it.
    Each step is an elementwise float32 add, so CUDA and the CPU give
    the same bits (`torch.cumsum` runs in other orders on both)."""
    x = x.to(torch.float32)
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        cols = [x[..., 0] + 0.0]    # XLA's sum starts from +0.0
        for i in range(1, n):
            cols.append(cols[-1] + x[..., i])
        return torch.stack(cols, dim=-1)
    blocks = -(-n // _SCAN_BLOCK)
    padded = F.pad(x, (0, blocks * _SCAN_BLOCK - n))
    inner = cumsum_f32(padded.reshape(*x.shape[:-1], blocks, _SCAN_BLOCK))
    before = F.pad(cumsum_f32(inner[..., -1])[..., :-1], (1, 0))
    out = inner + before[..., None]
    return out.reshape(*x.shape[:-1], blocks * _SCAN_BLOCK)[..., :n]


def _self_ids(rows: int, id_offset: int, device) -> torch.Tensor:
    """int32 global ids of a block's rows: ``id_offset + arange(rows)``."""
    return torch.arange(rows, dtype=torch.int32, device=device) + id_offset


def sample_peers_uniform(key: torch.Tensor, n_nodes: int, k: int,
                         exclude_self: bool = True,
                         with_replacement: bool = True,
                         n_local: int | None = None,
                         id_offset: int = 0) -> torch.Tensor:
    """Uniform k-peer sample per node; int32 ``[n_local or n_nodes, k]``
    of global ids in [0, n_nodes).  With `exclude_self` node i never
    draws i: draws come from [0, n_nodes - 1) and values >= i shift up
    by one.  Without replacement the k draws of a row are distinct
    (`sample_peers_distinct`).  `n_local` / `id_offset` draw for one
    shard's rows only, the global rows [id_offset, id_offset +
    n_local)."""
    if not with_replacement:
        return sample_peers_distinct(key, n_nodes, k, exclude_self,
                                     n_local, id_offset)
    if exclude_self and n_nodes < 2:
        raise ValueError("exclude_self requires at least 2 nodes")
    rows = n_nodes if n_local is None else n_local
    if not exclude_self:
        return prng.randint(key, (rows, k), 0, n_nodes)
    self_ids = _self_ids(rows, id_offset, key.device)[:, None]
    draws = prng.randint(key, (rows, k), 0, n_nodes - 1)
    return draws + (draws >= self_ids).to(torch.int32)


def sample_peers_distinct(key: torch.Tensor, n_nodes: int, k: int,
                          exclude_self: bool = True,
                          n_local: int | None = None,
                          id_offset: int = 0) -> torch.Tensor:
    """k distinct peers per node; int32 ``[rows, k]``.  Draw j takes
    a uniform rank in the remaining pool and shifts it past every id
    already taken, in ascending order, which maps the rank to the
    rank-th smallest untaken id."""
    excl = 1 if exclude_self else 0
    if n_nodes - excl < k:
        raise ValueError(
            f"cannot draw {k} distinct peers from {n_nodes} nodes"
            + (" excluding self" if exclude_self else ""))
    dev = key.device
    rows = n_nodes if n_local is None else n_local
    taken = torch.full((rows, k + 1), n_nodes, dtype=torch.int32,
                       device=dev)
    if exclude_self:
        taken[:, 0] = _self_ids(rows, id_offset, dev)
    keys = prng.split(key, k)
    out = []
    for j in range(k):
        cand = prng.randint(keys[j], (rows,), 0, n_nodes - excl - j)
        srt = torch.sort(taken, dim=1).values
        for i in range(j + excl):
            cand = cand + (cand >= srt[:, i]).to(torch.int32)
        out.append(cand)
        taken[:, j + excl] = cand
    return torch.stack(out, dim=1)


def _inverse_cdf(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Index of the first CDF entry above each `u`, clipped to the
    vector; int32."""
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True,
                             out_int32=True)
    return idx.clamp(0, cdf.shape[-1] - 1)


def sample_peers_weighted(key: torch.Tensor, weights: torch.Tensor,
                          n_rows: int, k: int) -> torch.Tensor:
    """k peers per row drawn in proportion to the non-negative float32
    ``[n_peers]`` `weights`, with replacement; int32 ``[n_rows, k]``.
    Self-draws are not excluded (callers abstain them through
    `self_sample_mask`)."""
    cdf = cumsum_f32(weights)
    u = prng.uniform(key, (n_rows, k)) * cdf[-1]
    return _inverse_cdf(cdf, u)


def sample_peers_hierarchical(key: torch.Tensor, weights: torch.Tensor,
                              n_rows: int, k: int,
                              n_clusters: int) -> torch.Tensor:
    """`sample_peers_weighted`'s draws, bit for bit.  The reference
    searches them in two levels (cluster, then peer within the cluster's
    block), a layout for registries spread over many TPU cores; it makes
    only comparisons the flat search makes, so on one card the flat
    search is the same function with fewer launches."""
    n = weights.shape[0]
    if not (1 <= n_clusters <= n):
        raise ValueError(f"n_clusters={n_clusters} must be in [1, {n}]")
    return sample_peers_weighted(key, weights, n_rows, k)


def cluster_ids(ids: torch.Tensor, n_clusters: int,
                n_nodes: int) -> torch.Tensor:
    """Cluster of each int32 global node id: ``i * C // N``, contiguous
    blocks — the port's copy of the reference's `cluster_of`.  The
    reference's static analysis reserves that name to its one module
    (`go_avalanche_tpu/analysis/lint.py`, canonical-spelling), which the
    port may not import, so the copy takes this name;
    tests/test_torch_sampling.py holds it to `cluster_of` bit for bit."""
    return torch.div(ids.to(torch.int32) * n_clusters, n_nodes,
                     rounding_mode="floor").to(torch.int32)


def sample_peers_clustered(key: torch.Tensor, weights: torch.Tensor,
                           n_rows: int, k: int, n_clusters: int,
                           locality: float,
                           id_offset: int = 0) -> torch.Tensor:
    """Clustered-topology k-peer sample; int32 ``[n_rows, k]``.  A draw
    lands in the drawing node's own cluster with weight `locality` and
    spreads the rest evenly over the other clusters, times the base
    `weights`; one float32 CDF per source cluster (``[C, N]``).  With
    replacement; callers abstain self-draws.  Row i is the node with
    global id ``id_offset + i``."""
    n_nodes = weights.shape[0]
    dev = weights.device
    c_ids = torch.arange(n_clusters, dtype=torch.int32, device=dev)
    all_clusters = cluster_ids(torch.arange(n_nodes, device=dev),
                               n_clusters, n_nodes)
    onehot = all_clusters[None, :] == c_ids[:, None]
    spread = (1.0 - locality) / max(n_clusters - 1, 1)
    w_cn = torch.where(onehot,
                       torch.full((), locality, dtype=torch.float32,
                                  device=dev),
                       torch.full((), spread, dtype=torch.float32, device=dev)
                       ) * weights.to(torch.float32)[None, :]
    cdf = cumsum_f32(w_cn)
    rows_cluster = cluster_ids(_self_ids(n_rows, id_offset, dev),
                               n_clusters, n_nodes).long()
    u = (prng.uniform(key, (n_rows, k))
         * cdf[:, -1][rows_cluster][:, None])
    peers = torch.zeros((n_rows, k), dtype=torch.int32, device=dev)
    for c in range(n_clusters):
        peers = torch.where((rows_cluster == c)[:, None],
                            _inverse_cdf(cdf[c], u), peers)
    return peers


def self_sample_mask(peers: torch.Tensor, id_offset: int = 0) -> torch.Tensor:
    """Bool ``[n, k]``: True where row i drew its own node, global id
    ``id_offset + i``."""
    self_ids = _self_ids(peers.shape[0], id_offset,
                         peers.device).to(peers.dtype)[:, None]
    return peers == self_ids


def draw_peers(key: torch.Tensor, cfg, latency_weight: torch.Tensor,
               alive: torch.Tensor, n_nodes: int, n_local: int | None = None,
               id_offset: int = 0) -> tuple:
    """The per-round peer draw of every multi-target round, dispatched
    as the reference dispatches it: stake-weighted committee draws
    (`stake.stake_enabled`, the stake folded into `latency_weight`
    at init; the hierarchical search for ``n_clusters > 1``, the same
    ids), the clustered topology, latency-weighted draws, or uniform
    ones.  Returns ``(peers [rows, k], self_draw)``: `self_draw` is the
    bool mask of draws that landed on the drawing node in the weighted,
    clustered and stake families (callers abstain them) and None in the
    uniform family, where exclusion is exact.  `n_local` / `id_offset`
    draw for one shard's rows, global ids [id_offset, id_offset +
    n_local), against the global `latency_weight` and `alive`."""
    rows = n_nodes if n_local is None else n_local
    staked = stake.stake_enabled(cfg)
    if staked or cfg.n_clusters > 1 or cfg.weighted_sampling:
        w = latency_weight * alive.to(torch.float32)
        if staked and cfg.n_clusters > 1:
            peers = sample_peers_hierarchical(key, w, rows, cfg.k,
                                              cfg.n_clusters)
        elif staked or cfg.n_clusters == 1:
            peers = sample_peers_weighted(key, w, rows, cfg.k)
        else:
            peers = sample_peers_clustered(key, w, rows, cfg.k,
                                           cfg.n_clusters,
                                           cfg.cluster_locality,
                                           id_offset=id_offset)
        return peers, self_sample_mask(peers, id_offset)
    return sample_peers_uniform(key, n_nodes, cfg.k, cfg.exclude_self,
                                cfg.sample_with_replacement,
                                n_local=n_local, id_offset=id_offset), None
