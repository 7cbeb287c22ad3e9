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

On the card the exchange runs two hand-written kernels of
`csrc/exchange.cu` (built with nvcc at first use, `_build.py`):

  * `prefs_pack` — a DAG round's packed preferred-in-set plane of a
    contiguous partition straight from the int16 confidence, and under
    OPPOSE_MAJORITY the per-tx minority colours in the same pass;
  * `vote_packs` — `fused_vote_packs` under FLIP and OPPOSE_MAJORITY:
    the k packed peer bytes, the lie and the ``k x 8`` bit transpose in
    registers, and the consider byte.

The routes are pure functions of what the round can observe
(`prefs_pack_route`, `vote_packs_route`): every other case, and every
CPU tensor, keeps the plain path, which is also what the kernels are
held against on the card.  `launches` counts each kernel's launches and
`plain_routes` the calls on CUDA tensors that took the plain path
instead, so a run can show how often the kernels engaged.  Each ctypes
call runs inside a torch op (`_build.Launch`), so that the profiler
places the kernels' device time under the span open around the call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from go_avalanche_tpu_torch import _build
from go_avalanche_tpu_torch.config import AdversaryStrategy, AvalancheConfig
from go_avalanche_tpu_torch.ops import adversary
from go_avalanche_tpu_torch.ops.bitops import pack_bool_plane, unpack_bool_plane

# Kernel launches since the last reset, per kernel (set an entry to 0 to
# start a count).
launches = {"prefs_pack": 0, "vote_packs": 0}
# Calls on CUDA tensors that took the plain path instead, per kernel: the
# kernels' share of the card's calls is launches / (launches + these).
plain_routes = {"prefs_pack": 0, "vote_packs": 0}

# The lies `vote_packs` applies in registers; EQUIVOCATE draws coin planes.
_KERNEL_STRATEGIES = (AdversaryStrategy.FLIP,
                      AdversaryStrategy.OPPOSE_MAJORITY)


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


def vote_packs_route(device: torch.device, cfg: AvalancheConfig) -> bool:
    """Does `gather_vote_packs` launch `vote_packs`?  On CUDA tensors
    with the fused engine, a FLIP or OPPOSE_MAJORITY lie and any policy
    but split_vote (whose lie content is a plane a draw)."""
    return (device.type == "cuda" and cfg.fused_exchange
            and cfg.adversary_strategy in _KERNEL_STRATEGIES
            and cfg.adversary_policy != "split_vote")


def prefs_pack_route(device: torch.device, cfg: AvalancheConfig) -> bool:
    """Does a DAG round over a contiguous partition pack its responses
    with `prefs_pack`?  On CUDA tensors, under any policy but split_vote,
    whose honest tally reads the unpacked plane."""
    return device.type == "cuda" and cfg.adversary_policy != "split_vote"


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    fn = getattr(_build.load("exchange"), name)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = {
        "prefs_pack": [ptr] * 3 + [i32] * 3 + [ptr],
        "vote_packs": [ptr] * 7 + [i32] * 5 + [ptr],
    }[name]
    fn.restype = i32
    return fn


def prefs_pack(confidence: torch.Tensor, set_size: int,
               cfg: AvalancheConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `prefs_pack` kernel: ``(packed_prefs, minority_t)`` of a DAG
    round over the contiguous ``arange(T) // set_size`` partition.

    `packed_prefs` is uint8 ``[N, ceil(T/8)]``, bit-identical to
    ``pack_bool_plane(dag.preferred_in_set_fixed(confidence,
    set_size))``.  `minority_t` is bool ``[T]``: under OPPOSE_MAJORITY,
    its only reader, ``adversary.minority_plane`` of that plane from
    exact counts the same pass adds up; otherwise an all-False
    placeholder, whose shape is all its readers take."""
    n, t = confidence.shape
    dev = confidence.device
    if set_size <= 0 or t % set_size:
        raise ValueError(f"set_size {set_size} must divide the txs axis "
                         f"({t})")
    _build.check_arg(confidence, "confidence", torch.int16, (n, t), dev, 2)
    packed = torch.empty((n, -(-t // 8)), dtype=torch.uint8, device=dev)
    oppose = cfg.adversary_strategy is AdversaryStrategy.OPPOSE_MAJORITY
    counts = (torch.zeros((t,), dtype=torch.int32, device=dev) if oppose
              else None)
    with torch.cuda.device(dev):
        rc = _build.Launch.apply(
            _kernel("prefs_pack"), confidence.data_ptr(), packed.data_ptr(),
            counts.data_ptr() if oppose else None, n, t, set_size,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"prefs_pack launch failed: CUDA error {rc}")
    launches["prefs_pack"] += 1
    if oppose:
        return packed, counts * 2 < n
    return packed, torch.zeros((t,), dtype=torch.bool, device=dev)


def vote_packs(packed_prefs: torch.Tensor, peers: torch.Tensor,
               responded: torch.Tensor, lie: torch.Tensor,
               cfg: AvalancheConfig, minority_t: torch.Tensor,
               t: int) -> tuple:
    """The `vote_packs` kernel: `fused_vote_packs` under FLIP or
    OPPOSE_MAJORITY, the same ``(yes_pack, consider_pack)``."""
    n, k = peers.shape
    if not (0 < k <= 8):
        raise ValueError("k must be in (0, 8] for uint8 packing")
    dev = peers.device
    n_src, t8 = packed_prefs.shape
    if t8 != -(-t // 8):
        raise ValueError(f"packed_prefs has {t8} bytes a row, {t} txs "
                         f"need {-(-t // 8)}")
    peers, responded, lie = (x.contiguous() for x in (peers, responded,
                                                       lie))
    args = [(packed_prefs, "packed_prefs", torch.uint8, (n_src, t8)),
            (peers, "peers", torch.int32, (n, k)),
            (responded, "responded", torch.bool, (n, k)),
            (lie, "lie", torch.bool, (n, k))]
    # Under OPPOSE_MAJORITY the kernel reads the bool colours themselves.
    oppose = cfg.adversary_strategy is AdversaryStrategy.OPPOSE_MAJORITY
    if oppose:
        minority_t = minority_t.contiguous()
        args.append((minority_t, "minority_t", torch.bool, (t,)))
    for tensor, name, dtype, shape in args:
        _build.check_arg(tensor, name, dtype, shape, dev, tensor.itemsize)
    yes_pack = torch.empty((n, t), dtype=torch.uint8, device=dev)
    consider = torch.empty((n,), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = _build.Launch.apply(
            _kernel("vote_packs"), packed_prefs.data_ptr(), peers.data_ptr(),
            responded.data_ptr(), lie.data_ptr(),
            minority_t.data_ptr() if oppose else None,
            yes_pack.data_ptr(), consider.data_ptr(), n, n_src, t, k,
            int(oppose), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"vote_packs launch failed: CUDA error {rc}")
    launches["vote_packs"] += 1
    return yes_pack, consider[:, None].expand(n, t)


def gather_vote_packs(packed_prefs: torch.Tensor, peers: torch.Tensor,
                      responded: torch.Tensor, lie: torch.Tensor,
                      key: torch.Tensor, cfg: AvalancheConfig,
                      minority_t: torch.Tensor, t: int,
                      ctx: Optional[adversary.PolicyCtx] = None) -> tuple:
    """Exchange dispatch: the `vote_packs` kernel where `vote_packs_route`
    holds, else the plain engine `cfg.fused_exchange` picks."""
    if vote_packs_route(peers.device, cfg):
        return vote_packs(packed_prefs, peers, responded, lie, cfg,
                          minority_t, t)
    if peers.device.type == "cuda":
        plain_routes["vote_packs"] += 1
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
