"""The streaming scheduler's window passes on the card —
`models/streaming_dag._retire_and_refill`'s two reads of the ``[N, W]``
window, as the hand-written kernels of `csrc/scheduler.cu` (built with
nvcc at first use, `_build.py`):

  * `settle_scan` — one read of the confidence and `added` planes: per
    set-slot, whether a live node still holds a pollable record of a
    valid member (`pending_set`), and per column the nodes whose added
    record finalized accepted (`accept_votes`);
  * `refill` — one out-of-place pass writing the window's new votes,
    consider, confidence, `added` and `finalized_at` planes after a
    retire and refill.

Their plain versions, which CPU tensors take and which the kernels are
held against on the card, are `streaming_dag.settle_scan_plain` and
`streaming_dag.refill_plain`.  The routes are pure functions of what the
scheduler observes (`settle_scan_route`, `refill_route`).  `launches`
counts each kernel's launches and `plain_routes` the calls on CUDA
tensors that took the plain path instead (a set size the scan does not
take, the retire cap's column rewrite), so a run can show that its steps
went through the kernels.  Each ctypes call runs inside a torch op
(`_build.Launch`), so that the profiler places the kernels' device time
under the span open around the call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from go_avalanche_tpu_torch import _build
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.ops import voterecord as vr

# Kernel launches since the last reset, per kernel (set an entry to 0 to
# start a count).
launches = {"settle_scan": 0, "refill": 0}
# Calls on CUDA tensors that took the plain path instead, per kernel.
plain_routes = {"settle_scan": 0, "refill": 0}

# The set sizes `settle_scan_kernel<C>` takes: a thread's 8 columns hold
# whole sets.
SCAN_SET_SIZES = (1, 2, 4, 8)


def settle_scan_route(device: torch.device, set_size: int) -> bool:
    """Does the scheduler's settle test launch `settle_scan`?  On CUDA
    tensors, for a set size that divides 8."""
    return device.type == "cuda" and set_size in SCAN_SET_SIZES


def refill_route(device: torch.device) -> bool:
    """Does the dense refill launch `refill`?  On CUDA tensors."""
    return device.type == "cuda"


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    fn = getattr(_build.load("scheduler"), name)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = {
        "settle_scan": [ptr] * 6 + [i32] * 4 + [ptr],
        "refill": [ptr] * 13 + [i32] * 2 + [ptr],
    }[name]
    fn.restype = i32
    return fn


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def settle_scan(confidence: torch.Tensor, added: torch.Tensor,
                alive: torch.Tensor, valid: torch.Tensor, set_size: int,
                cfg: AvalancheConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `settle_scan` kernel: ``(pending_set, accept_votes)`` of the
    window over the contiguous ``arange(W) // set_size`` partition,
    equal to `streaming_dag.settle_scan_plain`'s.

    `pending_set` is bool ``[W / set_size]``: some live node holds an
    added, unfinalized record of a valid member, and no member of the
    set finalized accepted at that node.  `accept_votes` is int32
    ``[W]``: the nodes whose added record finalized accepted."""
    n, w = confidence.shape
    dev = confidence.device
    if set_size not in SCAN_SET_SIZES or w % set_size:
        raise ValueError(f"set_size {set_size} must divide 8 and the "
                         f"window ({w})")
    alive, valid = alive.contiguous(), valid.contiguous()
    for tensor, name, dtype, shape in (
            (confidence, "confidence", torch.int16, (n, w)),
            (added, "added", torch.bool, (n, w)),
            (alive, "alive", torch.bool, (n,)),
            (valid, "valid", torch.bool, (w,))):
        _build.check_arg(tensor, name, dtype, shape, dev, tensor.itemsize)
    pending_set = torch.zeros((w // set_size,), dtype=torch.bool, device=dev)
    accept_votes = torch.zeros((w,), dtype=torch.int32, device=dev)
    # Any score above the counter's 0x7FFF is never reached, and the C
    # entry takes an int.
    score = max(0, min(cfg.finalization_score, 0x8000))
    with torch.cuda.device(dev):
        rc = _build.Launch.apply(
            _kernel("settle_scan"), confidence.data_ptr(), added.data_ptr(),
            alive.data_ptr(), valid.data_ptr(), pending_set.data_ptr(),
            accept_votes.data_ptr(), n, w, set_size, score, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"settle_scan launch failed: CUDA error {rc}")
    launches["settle_scan"] += 1
    return pending_set, accept_votes


def refill(records: vr.VoteRecordState, added: torch.Tensor,
           finalized_at: Optional[torch.Tensor], take_w: torch.Tensor,
           occupied_after_w: torch.Tensor, fresh_pref: torch.Tensor
           ) -> tuple:
    """The `refill` kernel: ``(records, added, finalized_at)`` of the
    window after a dense retire and refill, new tensors equal to
    `streaming_dag.refill_plain`'s; the planes given are only read.
    `take_w`, `occupied_after_w` and `fresh_pref` are bool ``[W]``;
    `finalized_at` is None with finality tracking off."""
    n, w = added.shape
    dev = added.device
    take_w, occupied_after_w, fresh_pref = (
        x.contiguous() for x in (take_w, occupied_after_w, fresh_pref))
    args = [(records.votes, "votes", torch.uint8, (n, w)),
            (records.consider, "consider", torch.uint8, (n, w)),
            (records.confidence, "confidence", torch.int16, (n, w)),
            (added, "added", torch.bool, (n, w)),
            (take_w, "take_w", torch.bool, (w,)),
            (occupied_after_w, "occupied_after_w", torch.bool, (w,)),
            (fresh_pref, "fresh_pref", torch.bool, (w,))]
    if finalized_at is not None:
        args.append((finalized_at, "finalized_at", torch.int32, (n, w)))
    for tensor, name, dtype, shape in args:
        _build.check_arg(tensor, name, dtype, shape, dev, tensor.itemsize)
    out = vr.VoteRecordState(*(torch.empty_like(p) for p in records))
    added_out = torch.empty_like(added)
    fin_out = None if finalized_at is None else torch.empty_like(finalized_at)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        rc = _build.Launch.apply(
            _kernel("refill"), *(ptr(p) for p in records), added.data_ptr(),
            ptr(finalized_at), take_w.data_ptr(),
            occupied_after_w.data_ptr(), fresh_pref.data_ptr(),
            *(ptr(p) for p in out), added_out.data_ptr(), ptr(fin_out), n, w,
            _stream(dev))
    if rc != 0:
        raise RuntimeError(f"refill launch failed: CUDA error {rc}")
    launches["refill"] += 1
    return out, added_out, fin_out
