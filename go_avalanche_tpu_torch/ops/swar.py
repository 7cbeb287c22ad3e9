"""SWAR lane packing: 4 uint8 records per 32-bit word —
`go_avalanche_tpu/ops/swar.py`.

Lane layout (little-endian byte order, as the reference's bitcast):

      32-bit word w                   uint8 columns
      bits [ 0:  8)  = lane 0  <->  column 4*w + 0
      bits [ 8: 16)  = lane 1  <->  column 4*w + 1
      bits [16: 24)  = lane 2  <->  column 4*w + 2
      bits [24: 32)  = lane 3  <->  column 4*w + 3

Word arithmetic: torch on the CPU has no shift, add or compare on
uint32, so a word is its uint32 value held in an int64 tensor, masked
to 32 bits where an operation can leave that range (the discipline of
`prng.py`).  Every primitive below keeps its lanes in [0, 0xFF], so only
a left shift can carry past bit 31, and `lane_gt`'s bias add sets bit 31
of lane 3 as an ordinary bit of a positive int64.  Pack and unpack go
through an int32 `view` of the contiguous uint8 plane (a reinterpret,
not arithmetic); a ragged tail is zero-padded at pack time and sliced
off at unpack time, and zero lanes are inert through every primitive.
"""

from __future__ import annotations

import torch

LANES = 4
M32 = 0xFFFFFFFF

# Per-lane replicated constants (one byte value in every lane).
LANE_LSB = 0x01010101      # bit 0 of every lane
LANE_MSB = 0x80808080      # bit 7 of every lane
_NOCARRY = 0xFEFEFEFE      # everything but bit 0: drops the <<1 lane carry


def lane_const(byte: int) -> int:
    """The 32-bit value with `byte` in all 4 lanes."""
    if not 0 <= byte <= 0xFF:
        raise ValueError("lane_const takes one byte")
    return byte * LANE_LSB


def pack_u8_lanes(x: torch.Tensor) -> torch.Tensor:
    """uint8 ``[..., t]`` -> words ``[..., ceil(t/4)]`` (uint32 values in
    int64), column ``4w + b`` in byte lane ``b`` of word ``w``."""
    *lead, t = x.shape
    tp = -(-t // LANES) * LANES
    if tp != t:
        x = torch.cat([x, x.new_zeros((*lead, tp - t))], dim=-1)
    x = x.contiguous()
    if x.storage_offset() % LANES:     # an int32 view starts on a word
        x = x.clone()
    return x.view(torch.int32).to(torch.int64) & M32


def unpack_u8_lanes(w: torch.Tensor, t: int) -> torch.Tensor:
    """Inverse of `pack_u8_lanes`: words ``[..., ceil(t/4)]`` -> uint8
    ``[..., t]`` (pad columns dropped)."""
    signed = (w - ((w >> 31) << 32)).to(torch.int32)   # exact, no wrap
    return signed.view(torch.uint8)[..., :t]


def expand_lane_mask(mask_w: torch.Tensor, t: int) -> torch.Tensor:
    """Per-lane mask words (any nonzero byte = hit) -> bool ``[..., t]``."""
    return unpack_u8_lanes(mask_w, t) != 0


def popcount8_lanes(w: torch.Tensor) -> torch.Tensor:
    """Per-byte-lane popcount; the masks keep every partial sum inside
    its lane."""
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    return (w + (w >> 4)) & 0x0F0F0F0F


def lane_shl1(w: torch.Tensor, in_bits: torch.Tensor) -> torch.Tensor:
    """Per-lane ``(lane << 1) | in_bit``: the window shift; the mask drops
    each lane's bit 7 carried into its neighbour (and past bit 31).
    `in_bits` may only occupy lane bit 0."""
    return ((w << 1) & _NOCARRY) | in_bits


def lane_gt(w: torch.Tensor, threshold: int) -> torch.Tensor:
    """Per-lane unsigned ``lane > threshold`` as an 0x80-per-hit-lane
    word: lane bit 7 of ``w + (0x7F - threshold)`` is set iff
    ``lane >= threshold + 1``; lane-safe while ``lane <= 0x80 +
    threshold``."""
    if not 0 <= threshold <= 0x7F:
        raise ValueError("lane_gt threshold must be in [0, 0x7F]")
    return (w + lane_const(0x7F - threshold)) & LANE_MSB


def lane_fill(bits: torch.Tensor) -> torch.Tensor:
    """Lane-LSB bits -> 0xFF-filled lanes (``bit * 0xFF`` per lane)."""
    return bits * 0xFF
