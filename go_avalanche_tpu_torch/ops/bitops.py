"""Small integer bit-twiddling helpers shared by the ops.

Bit order matches `go_avalanche_tpu/ops/bitops.py`: little-endian within
each byte (column ``8*b + j`` at bit j of byte b).  Packing accumulates
with ``|=`` per bit position rather than a shifted ``sum``: torch's
integer sum promotes to int64, which at the flagship shape would stage
an 8-byte-per-element plane.
"""

from __future__ import annotations

import torch


def popcount8(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of a uint8 tensor, or of byte values in a
    wider integer tensor (SWAR, branch-free)."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def pack_bool_plane(x: torch.Tensor) -> torch.Tensor:
    """Pack a bool ``[..., t]`` tensor into uint8 ``[..., ceil(t/8)]``."""
    *lead, t = x.shape
    tp = -(-t // 8) * 8
    if tp != t:
        x = torch.cat([x, x.new_zeros((*lead, tp - t))], dim=-1)
    x = x.reshape(*lead, tp // 8, 8)
    out = torch.zeros((*lead, tp // 8), dtype=torch.uint8, device=x.device)
    for j in range(8):
        out |= x[..., j].to(torch.uint8) << j
    return out


def pack_draws(bits: torch.Tensor) -> torch.Tensor:
    """bool ``[rows, k]`` (k <= 8) -> uint8 ``[rows]``, bit j = draw j."""
    out = torch.zeros(bits.shape[:1], dtype=torch.uint8, device=bits.device)
    for j in range(bits.shape[1]):
        out |= bits[:, j].to(torch.uint8) << j
    return out


def unpack_bool_plane(packed: torch.Tensor, t: int) -> torch.Tensor:
    """Inverse of `pack_bool_plane`: uint8 ``[..., ceil(t/8)]`` -> bool
    ``[..., t]``."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :t].to(torch.bool)
