"""The collectives `shard_map` lowers, as plain `torch.distributed` calls.

A sharded driver of the reference names its collectives by mesh axis
(``lax.all_gather(x, "nodes")``, ``lax.psum(x, ("nodes", "txs"))``) and
XLA lowers them inside one SPMD program.  The port's drivers call these
functions instead, inside ``with bind(mesh):``, which selects the
process group of the named axes:

  all_gather(x, axes, dim=0)  tiled: the blocks of every rank along
                              `axes`, concatenated along `dim` in mesh
                              order;
  all_to_all(x, axis)         tiled: dim 0 cut into one block per rank
                              along `axis`, block s sent to the rank at
                              index s, the received blocks concatenated
                              in mesh order;
  psum(x, axes)               the elementwise sum over `axes`;
  axis_index(axis)            this rank's index along `axis`.

Over axes of size 1 each returns its input, as `shard_map` does.
Every call adds its ``(kind, axes)`` to `recorded` ("all_gather",
"all_to_all" or "all_reduce", the names of the reference's collective
manifests), so a test can hold a driver's round to its
`DECLARED_COLLECTIVES`; while `calls` is a list (the contract audit,
`analysis/audit.py`, sets one for the round it records), each call also
appends ``(kind, axes, elements of the result)`` to it.  gloo takes no bool or int16 tensors, so they
travel as uint8 and int32.  Ranks sharing one card run gloo (NCCL
refuses two ranks on one device), which takes CUDA tensors and stages
them through host memory itself; `host_staged` counts each CUDA tensor
a gloo collective carries.  NCCL ranks never stage.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

# (kind, axes) of every call since it was last cleared.
recorded: set = set()
# (kind, axes, result elements) of every call while this is a list.
calls = None
# CUDA tensors staged through the host on gloo groups, since last reset.
host_staged = 0

_mesh = None

# dtypes gloo does not take -> the dtype they travel as.
_CARRIER = {torch.bool: torch.uint8, torch.int16: torch.int32}


@contextlib.contextmanager
def bind(mesh):
    """Run the enclosed block's collectives on `mesh`'s groups."""
    global _mesh
    prev, _mesh = _mesh, mesh
    try:
        yield mesh
    finally:
        _mesh = prev


def _bound():
    if _mesh is None:
        raise RuntimeError("no mesh is bound: call the collectives inside "
                           "`with collectives.bind(mesh):`")
    return _mesh


def axis_index(axis: str) -> int:
    """This rank's index along `axis` (``lax.axis_index``)."""
    return _bound().coords[axis]


def _record(kind: str, axes, x: torch.Tensor) -> Optional[tuple]:
    mesh = _bound()
    names = mesh._axes(axes)
    recorded.add((kind, names))
    if calls is not None:
        span = 1
        if kind == "all_gather":
            for a in names:
                span *= mesh.shape[a]
        calls.append((kind, names, x.numel() * span))
    return mesh.group(axes)


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """`x` as the backend takes it: contiguous, bools as uint8 and int16
    as int32; a CUDA tensor on a gloo group is counted in
    `host_staged` (gloo copies it through the host itself)."""
    global host_staged
    t = x.contiguous()
    if t.dtype in _CARRIER:
        t = t.to(_CARRIER[t.dtype])
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host_staged += 1
    return t


def _back(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(device=like.device, dtype=like.dtype)


def all_gather(x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
    """Every rank's block along `axes`, concatenated along `dim` in mesh
    order (``lax.all_gather(..., tiled=True)``)."""
    grp = _record("all_gather", axes, x)
    if grp is None:
        return x
    group, ordered = grp
    t = _wire(x, group)
    parts = [torch.empty_like(t) for _ in ordered]
    dist.all_gather(parts, t, group=group)
    by_rank = dict(zip(sorted(ordered), parts))
    return _back(torch.cat([by_rank[r] for r in ordered], dim=dim), x)


def all_to_all(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Dim 0 of `x` cut into one block per rank along `axis`; block s
    goes to the rank at index s, and the blocks received come back
    concatenated in mesh order (``lax.all_to_all(..., tiled=True)``)."""
    grp = _record("all_to_all", axis, x)
    if grp is None:
        return x
    group, ordered = grp
    n = len(ordered)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 ({x.shape[0]}) does not split over "
                         f"{n} ranks")
    t = _wire(x, group)
    blocks = t.reshape(n, -1, *t.shape[1:])
    in_group = sorted(ordered)
    send = torch.stack([blocks[ordered.index(r)] for r in in_group])
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    got = {r: recv[g] for g, r in enumerate(in_group)}
    out = torch.cat([got[r] for r in ordered], dim=0)
    return _back(out, x)


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """The elementwise sum of `x` over every rank along `axes`
    (``lax.psum``); integer and float tensors."""
    grp = _record("all_reduce", axes, x)
    if grp is None:
        return x
    group, _ = grp
    t = _wire(x, group).clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return _back(t, x)
