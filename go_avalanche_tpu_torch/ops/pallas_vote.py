"""The two window-ingest kernels — the counterpart of
`go_avalanche_tpu/ops/pallas_vote.py`, whose name it keeps so that a
reader finds it.  It holds hand-written CUDA kernels for Hopper
(sm_90a), not Pallas:

  kernel 1  `register_packed_votes_cuda` -> `csrc/vote_u8.cu`, the port
            of `_vote_kernel`: k sequential window shift-ins per record
            with the per-step confidence transition's bits;
  kernel 2  `register_packed_votes_cuda_swar` -> `csrc/vote_swar.cu`,
            the port of `_vote_kernel_swar`: the SWAR window fold on
            4-record words, then the closed-form confidence.

Each C entry takes the 16-records-a-thread SWAR fast path the two
kernels share (`csrc/ingest_fast.cuh`) where T % 16 == 0 and the planes
lie on 16-byte boundaries, and its own general 4-record walk otherwise.

Each wrapper launches its kernel on CUDA tensors (built with nvcc at
first use, `_build.py`) or raises, and runs its plain PyTorch version on
CPU tensors.  The plain versions are the reference engines themselves
(`voterecord.register_packed_votes` and `register_packed_votes_swar`,
delivered-neutral consider semantics), which the kernels are held
against on the card.  Both kernels take any N and T (their general
paths walk the flat ``[N, T]`` planes): the reference
launchers' tiling errors and the dispatcher's fall-through for
untileable shapes have no counterpart.

`register_packed_votes_fused` is the dispatcher every round calls: it
picks the wrapper by `cfg.ingest_engine`, and the tensors' device picks
the route, not a `prefer_pallas` flag.  `launches` counts
each kernel's launches, so a run can show that it went through them, and
`path_launches` splits them by the path the C entry chose.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from go_avalanche_tpu_torch import _build
from go_avalanche_tpu_torch.config import AvalancheConfig, DEFAULT_CONFIG
from go_avalanche_tpu_torch.ops import voterecord as vr

# Kernel launches since the last reset, per kernel (set an entry to 0 to
# start a count).
launches = {"vote_u8": 0, "vote_swar": 0}
# The same launches by the path the C entry took: "fast"
# (`<kernel>_kernel<K, CONS_ROW>`) or "any" (`<kernel>_kernel_any`).
path_launches = {name: {"fast": 0, "any": 0} for name in launches}


def register_packed_votes_plain(state, yes_pack, consider_pack, k: int,
                                cfg: AvalancheConfig = DEFAULT_CONFIG,
                                update_mask=None):
    """Kernel 1's plain version: the u8 reference engine."""
    return vr.register_packed_votes(state, yes_pack, consider_pack, k, cfg,
                                    update_mask, absent_is_skip=False)


def register_packed_votes_swar_plain(state, yes_pack, consider_pack, k: int,
                                     cfg: AvalancheConfig = DEFAULT_CONFIG,
                                     update_mask=None):
    """Kernel 2's plain version: the SWAR reference engine."""
    return vr.register_packed_votes_swar(state, yes_pack, consider_pack, k,
                                         cfg, update_mask,
                                         absent_is_skip=False)


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    fn = getattr(_build.load(name), name)
    ll, ptr = ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = ([ptr] * 4 + [ll, ll] + [ptr] + [ll, ll] + [ptr] * 5
                   + [ll, ll] + [ctypes.c_int] * 4 + [ptr]
                   + [ctypes.POINTER(ctypes.c_int)])
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, state: vr.VoteRecordState, yes_pack: torch.Tensor,
            consider_pack: torch.Tensor, k: int, cfg: AvalancheConfig,
            update_mask: Optional[torch.Tensor]):
    if state.votes.ndim != 2:
        raise ValueError(f"the ingest kernels take [N, T] records, got "
                         f"shape {tuple(state.votes.shape)}")
    if not (0 < k <= 8):
        raise ValueError("k must be in (0, 8] for uint8 packing")
    n, t = state.votes.shape
    dev = state.votes.device
    _build.check_arg(state.votes, "votes", torch.uint8, (n, t), dev, 4)
    _build.check_arg(state.consider, "consider", torch.uint8, (n, t), dev, 4)
    _build.check_arg(state.confidence, "confidence", torch.int16, (n, t),
                     dev, 8)
    if update_mask is not None:
        _build.check_arg(update_mask, "update_mask", torch.bool, (n, t), dev,
                         4)
    packs = []
    for pack, pname in ((yes_pack, "yes_pack"),
                        (consider_pack, "consider_pack")):
        if pack.device != dev:
            raise ValueError(f"{pname} is on {pack.device}, records on {dev}")
        if pack.dtype != torch.uint8:
            raise TypeError(f"{pname} must be torch.uint8, got {pack.dtype}")
        # Read in place through its strides: a broadcast view (stride 0)
        # is never copied out to a full plane.
        packs.append(torch.broadcast_to(pack, (n, t)))
    yes_v, cons_v = packs
    votes = torch.empty_like(state.votes)
    consider = torch.empty_like(state.consider)
    confidence = torch.empty_like(state.confidence)
    changed = torch.empty((n, t), dtype=torch.bool, device=dev)
    fast = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel(name)(
            state.votes.data_ptr(), state.consider.data_ptr(),
            state.confidence.data_ptr(), yes_v.data_ptr(), *yes_v.stride(),
            cons_v.data_ptr(), *cons_v.stride(),
            None if update_mask is None else update_mask.data_ptr(),
            votes.data_ptr(), consider.data_ptr(), confidence.data_ptr(),
            changed.data_ptr(), n, t, k, cfg.window, cfg.quorum,
            cfg.finalization_score, stream, ctypes.byref(fast))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    launches[name] += 1
    path_launches[name]["fast" if fast.value == 1 else "any"] += 1
    return vr.VoteRecordState(votes, consider, confidence), changed


def _route(name: str, plain, state, yes_pack, consider_pack, k, cfg,
           update_mask):
    device = state.votes.device
    if device.type == "cpu":
        return plain(state, yes_pack, consider_pack, k, cfg, update_mask)
    if device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {device}")
    return _launch(name, state, yes_pack, consider_pack, k, cfg, update_mask)


def register_packed_votes_cuda(
    state: vr.VoteRecordState,
    yes_pack: torch.Tensor,
    consider_pack: torch.Tensor,
    k: int,
    cfg: AvalancheConfig = DEFAULT_CONFIG,
    update_mask: Optional[torch.Tensor] = None,
) -> Tuple[vr.VoteRecordState, torch.Tensor]:
    """Kernel 1 (`csrc/vote_u8.cu`): k votes per record from the uint8
    packs (bit j = vote j, each broadcastable to ``[N, T]``), oldest
    first; returns ``(new_records, changed)``, records outside the bool
    `update_mask` unchanged.  Bit-identical to
    `register_packed_votes_plain`."""
    return _route("vote_u8", register_packed_votes_plain, state, yes_pack,
                  consider_pack, k, cfg, update_mask)


def register_packed_votes_cuda_swar(
    state: vr.VoteRecordState,
    yes_pack: torch.Tensor,
    consider_pack: torch.Tensor,
    k: int,
    cfg: AvalancheConfig = DEFAULT_CONFIG,
    update_mask: Optional[torch.Tensor] = None,
) -> Tuple[vr.VoteRecordState, torch.Tensor]:
    """Kernel 2 (`csrc/vote_swar.cu`): the same function as kernel 1 on
    4-record SWAR words with the closed-form confidence.  Bit-identical
    to `register_packed_votes_swar_plain`."""
    return _route("vote_swar", register_packed_votes_swar_plain, state,
                  yes_pack, consider_pack, k, cfg, update_mask)


def register_packed_votes_fused(
    state: vr.VoteRecordState,
    yes_pack: torch.Tensor,
    consider_pack: torch.Tensor,
    k: int,
    cfg: AvalancheConfig = DEFAULT_CONFIG,
    update_mask: Optional[torch.Tensor] = None,
) -> Tuple[vr.VoteRecordState, torch.Tensor]:
    """The window ingest of a round: the wrapper of `cfg.ingest_engine`
    ("u8" -> kernel 1, "swar32" -> kernel 2), which launches its kernel
    on CUDA tensors and runs its plain version on CPU tensors.
    `cfg.skip_absent_votes` runs `voterecord.register_packed_votes_engine`
    on every device: no TPU kernel implements the absent-vote skip (the
    reference's dispatcher sends it to its jnp engines too), so this is
    the reference's design, not a fallback.
    """
    if cfg.skip_absent_votes:
        return vr.register_packed_votes_engine(state, yes_pack,
                                               consider_pack, k, cfg,
                                               update_mask)
    kernel = (register_packed_votes_cuda_swar
              if cfg.ingest_engine == "swar32"
              else register_packed_votes_cuda)
    return kernel(state, yes_pack, consider_pack, k, cfg, update_mask)
