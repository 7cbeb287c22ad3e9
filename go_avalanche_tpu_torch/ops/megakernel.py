"""The whole-round megakernel: exchange -> ingest -> confidence in ONE
kernel — `go_avalanche_tpu/ops/megakernel.py`.

`fused_round` is the `cfg.round_engine = "megakernel"` seam of
`models/avalanche.round_step`, with the reference's inputs, shape
contract and errors.  On CUDA tensors it launches the hand-written
Hopper kernel `csrc/megakernel.cu` (built with nvcc at first use, see
`_build.py`; one thread per 16 tx columns of a row, so the record planes
must start on 16-byte boundaries) or raises; on CPU tensors it runs
`fused_round_reference`, the plain PyTorch version — the phased round's
own exchange and u8 ingest — which is also what the kernel is held
against on the card.
`launches` counts kernel launches, so a run can show that it went
through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from go_avalanche_tpu_torch import _build
from go_avalanche_tpu_torch.config import (AdversaryStrategy, AvalancheConfig,
                                           DEFAULT_CONFIG)
from go_avalanche_tpu_torch.ops import exchange
from go_avalanche_tpu_torch.ops import voterecord as vr
from go_avalanche_tpu_torch.ops.bitops import pack_bool_plane

# Kernel launches since the last reset (set it to 0 to start a count).
launches = 0

def _check_shapes(records: vr.VoteRecordState, cfg: AvalancheConfig) -> None:
    t = records.votes.shape[1]
    if not (0 < cfg.k <= 8):
        raise ValueError("megakernel packs per-draw outcomes into byte "
                         "lanes: k must be in (0, 8]")
    if t % 32:
        raise ValueError(f"txs axis ({t}) must divide by 32 (whole "
                         f"bit-packed preference words)")


def fused_round_reference(
    records: vr.VoteRecordState,
    packed_prefs: torch.Tensor,
    peers: torch.Tensor,
    responded: torch.Tensor,
    lie: torch.Tensor,
    minority_t: torch.Tensor,
    polled: torch.Tensor,
    cfg: AvalancheConfig = DEFAULT_CONFIG,
) -> Tuple[vr.VoteRecordState, torch.Tensor]:
    """The plain version: `exchange.fused_vote_packs` followed by the u8
    `register_packed_votes` on the polled mask.  The megakernel's config
    rules exclude EQUIVOCATE, so the exchange needs no coin key."""
    _check_shapes(records, cfg)
    t = records.votes.shape[1]
    yes_pack, consider_pack = exchange.fused_vote_packs(
        packed_prefs, peers, responded, lie, None, cfg, minority_t, t)
    return vr.register_packed_votes(records, yes_pack, consider_pack, cfg.k,
                                    cfg, update_mask=polled,
                                    absent_is_skip=False)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("megakernel").mega_round
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _oppose(cfg: AvalancheConfig) -> int:
    """The kernel's lie transform: 1 = OPPOSE_MAJORITY, 0 = FLIP.  Like
    the plain version it applies the transform wherever `lie` is set
    (with no byzantine nodes the lie mask is all False)."""
    s = cfg.adversary_strategy
    if s is AdversaryStrategy.EQUIVOCATE:
        raise ValueError("megakernel has no in-kernel EQUIVOCATE coins")
    return int(s is AdversaryStrategy.OPPOSE_MAJORITY)


def _launch(records, packed_prefs, peers, responded, lie, minority_t, polled,
            cfg: AvalancheConfig):
    global launches
    n, t = records.votes.shape
    k = cfg.k
    dev = records.votes.device
    minority_bits = pack_bool_plane(minority_t)
    # The record planes are read as 16-byte chunks, the rest as words of
    # at most 8 bytes.
    for tensor, name, dtype, shape, align in (
            (records.votes, "votes", torch.uint8, (n, t), 16),
            (records.consider, "consider", torch.uint8, (n, t), 16),
            (records.confidence, "confidence", torch.int16, (n, t), 16),
            (packed_prefs, "packed_prefs", torch.uint8, (n, t // 8), 8),
            (peers, "peers", torch.int32, (n, k), 8),
            (responded, "responded", torch.bool, (n, k), 8),
            (lie, "lie", torch.bool, (n, k), 8),
            (minority_bits, "minority_t", torch.uint8, (t // 8,), 8),
            (polled, "polled", torch.bool, (n, t), 16)):
        _build.check_arg(tensor, name, dtype, shape, dev, align)
    votes = torch.empty_like(records.votes)
    consider = torch.empty_like(records.consider)
    confidence = torch.empty_like(records.confidence)
    changed = torch.empty((n, t), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel()(
            records.votes.data_ptr(), records.consider.data_ptr(),
            records.confidence.data_ptr(), packed_prefs.data_ptr(),
            peers.data_ptr(), responded.data_ptr(), lie.data_ptr(),
            minority_bits.data_ptr(), polled.data_ptr(), votes.data_ptr(),
            consider.data_ptr(), confidence.data_ptr(), changed.data_ptr(),
            n, t, k, cfg.window, cfg.quorum, cfg.finalization_score,
            _oppose(cfg), stream)
    if rc != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {rc}")
    launches += 1
    return vr.VoteRecordState(votes, consider, confidence), changed


def fused_round(
    records: vr.VoteRecordState,
    packed_prefs: torch.Tensor,
    peers: torch.Tensor,
    responded: torch.Tensor,
    lie: torch.Tensor,
    minority_t: torch.Tensor,
    polled: torch.Tensor,
    cfg: AvalancheConfig = DEFAULT_CONFIG,
) -> Tuple[vr.VoteRecordState, torch.Tensor]:
    """One round's gather -> window ingest -> confidence fold.

    Inputs are the phased round's intermediates: `packed_prefs` the
    bit-packed uint8 ``[N, T/8]`` preference plane, `peers` int32
    ``[N, k]``, `responded`/`lie` bool ``[N, k]``, `minority_t` bool
    ``[T]``, `polled` the bool update mask.  Returns ``(new_records,
    changed)``, bit-identical to `exchange.gather_vote_packs` +
    `voterecord.register_packed_votes_engine`.  Requires ``0 < k <= 8``
    and ``t % 32 == 0``.
    """
    _check_shapes(records, cfg)
    if records.votes.device.type == "cpu":
        return fused_round_reference(records, packed_prefs, peers, responded,
                                     lie, minority_t, polled, cfg)
    if records.votes.device.type != "cuda":
        raise ValueError(f"fused_round runs on CUDA or CPU tensors, got "
                         f"{records.votes.device}")
    return _launch(records, packed_prefs, peers, responded, lie, minority_t,
                   polled, cfg)
