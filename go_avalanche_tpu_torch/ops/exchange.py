"""The peer exchange — `go_avalanche_tpu/ops/exchange.py`.

  * `fused_vote_packs` — ONE gather of all ``N*k`` peer rows of the
    bit-packed preference plane, unpacked into the ``[N, k, T]`` vote
    cube and re-packed along the draw axis into the ``(yes_pack,
    consider_pack)`` uint8 planes `voterecord.register_packed_votes`
    consumes.  The draw axis is folded with ``|=`` per draw: a shifted
    ``sum`` would promote to an int64 ``[N, T]`` plane.
  * `legacy_vote_packs` — the k-pass loop, one row gather per draw.
  * `fused_gossip_heard` / `legacy_gossip_heard` — gossip admission: every
    (poller i, draw j) pair marks poller i's polled targets as heard at
    peer ``peers[i, j]``.  Duplicate peer draws must OR, not overwrite,
    so both forms count hits with `index_add_` (exact under duplicates)
    and test ``> 0``; the fused form scatters the bit-packed polled plane
    one bit position at a time, so its update operand stays
    ``[N*k, T/8]``.

Fused and legacy are bit-exact twins, selected by `cfg.fused_exchange`.
"""

from __future__ import annotations

from typing import Optional

import torch

from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.ops import adversary
from go_avalanche_tpu_torch.ops.bitops import pack_bool_plane, unpack_bool_plane


def fused_vote_packs(packed_prefs: torch.Tensor, peers: torch.Tensor,
                     responded: torch.Tensor, lie: torch.Tensor,
                     key: torch.Tensor, cfg: AvalancheConfig,
                     minority_t: torch.Tensor, t: int,
                     ctx: Optional[adversary.PolicyCtx] = None) -> tuple:
    """Single-gather k-vote collection; returns ``(yes_pack,
    consider_pack)``, the latter a broadcast ``[N, T]`` view.  `ctx` is
    the round's adaptive-adversary context (None with the policy off)."""
    n, k = peers.shape
    if not (0 < k <= 8):
        raise ValueError("k must be in (0, 8] for uint8 packing")
    t8 = packed_prefs.shape[-1]
    flat = packed_prefs[peers.reshape(n * k).long()]     # THE one gather
    votes = unpack_bool_plane(flat.reshape(n, k, t8), t)  # [N, k, T]
    votes = adversary.apply_draw_planes(key, votes, lie, cfg, minority_t,
                                        ctx)
    yes_pack = torch.zeros((n, t), dtype=torch.uint8, device=peers.device)
    consider = torch.zeros((n,), dtype=torch.uint8, device=peers.device)
    for j in range(k):
        yes_pack |= votes[:, j].to(torch.uint8) << j
        consider |= responded[:, j].to(torch.uint8) << j
    return yes_pack, consider[:, None].expand(n, t)


def legacy_vote_packs(packed_prefs: torch.Tensor, peers: torch.Tensor,
                      responded: torch.Tensor, lie: torch.Tensor,
                      key: torch.Tensor, cfg: AvalancheConfig,
                      minority_t: torch.Tensor, t: int,
                      ctx: Optional[adversary.PolicyCtx] = None) -> tuple:
    """The k-pass engine: one row gather + unpack + adversary per draw."""
    return adversary.pack_adversarial_votes(
        lambda j: unpack_bool_plane(packed_prefs[peers[:, j].long()], t),
        responded, lie, key, cfg, minority_t, ctx)


def gather_vote_packs(packed_prefs: torch.Tensor, peers: torch.Tensor,
                      responded: torch.Tensor, lie: torch.Tensor,
                      key: torch.Tensor, cfg: AvalancheConfig,
                      minority_t: torch.Tensor, t: int,
                      ctx: Optional[adversary.PolicyCtx] = None) -> tuple:
    """Exchange-engine dispatch on `cfg.fused_exchange`."""
    engine = fused_vote_packs if cfg.fused_exchange else legacy_vote_packs
    return engine(packed_prefs, peers, responded, lie, key, cfg,
                  minority_t, t, ctx)


def fused_gossip_heard(peers: torch.Tensor,
                       polled_u8: torch.Tensor) -> torch.Tensor:
    """Flattened gossip admission; uint8 ``[N, T]`` heard plane."""
    n, t = polled_u8.shape
    k = peers.shape[1]
    idx = peers.reshape(n * k).long()          # pair (i, j) at row i*k + j
    packed = pack_bool_plane(polled_u8.to(torch.bool))      # [N, ceil(T/8)]
    heard8 = torch.zeros_like(packed)
    for b in range(8):
        src = ((packed >> b) & 1).to(torch.int32).repeat_interleave(k, dim=0)
        hits = torch.zeros(packed.shape, dtype=torch.int32,
                           device=packed.device).index_add_(0, idx, src)
        heard8 |= (hits > 0).to(torch.uint8) << b
    return unpack_bool_plane(heard8, t).to(torch.uint8)


def legacy_gossip_heard(peers: torch.Tensor,
                        polled_u8: torch.Tensor) -> torch.Tensor:
    """The k-pass gossip admission, one scatter per draw."""
    hits = torch.zeros(polled_u8.shape, dtype=torch.int32,
                       device=polled_u8.device)
    src = polled_u8.to(torch.int32)
    for j in range(peers.shape[1]):
        hits.index_add_(0, peers[:, j].long(), src)
    return (hits > 0).to(torch.uint8)


def gossip_heard(peers: torch.Tensor, polled_u8: torch.Tensor,
                 cfg: AvalancheConfig) -> torch.Tensor:
    """Gossip-admission dispatch on `cfg.fused_exchange`."""
    if cfg.fused_exchange:
        return fused_gossip_heard(peers, polled_u8)
    return legacy_gossip_heard(peers, polled_u8)
