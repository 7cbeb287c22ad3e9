"""The ``(nodes, txs)`` rank mesh — `go_avalanche_tpu/parallel/mesh.py`.

The reference lays its devices on a 2-D `jax.sharding.Mesh` and runs a
round as one SPMD program under `shard_map`.  In the port every
process is one device of that grid (a rank of `torch.distributed`),
runs the `shard_map` body for its own block, and talks to the others
through the process groups this mesh holds:

  axis "nodes":  data-parallel rows; the axis that communicates every
                 round (packed-preference all-gather, gossip all-to-all,
                 telemetry all-reduce);
  axis "txs":    independent columns (a vote for target t touches only
                 column t): a psum of the poll cap's counts and of the
                 telemetry, nothing else.

Ranks are laid out row-major, as ``np.asarray(devices).reshape(A, B)``
lays out the reference's devices; `runtime.make_runtime_mesh` builds
other layouts from an explicit rank grid.  Every rank builds every
group, in the same order, because `torch.distributed.new_group` is a
collective over the whole world.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

NODES_AXIS = "nodes"
TXS_AXIS = "txs"


def world() -> Tuple[int, int]:
    """``(world_size, rank)`` of the default process group; ``(1, 0)``
    when none was initialized (one process, no communication)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """A grid of ranks with named axes, this rank's place in it, and
    the process group of every set of axes a collective may span.

    `shape` maps each axis name to its size, as the reference mesh's
    does; `ranks` is the ``[A, B]`` rank grid; `coords` maps each axis
    to this rank's index along it.  An axis (or set of axes) of size 1
    has no group: a collective over it returns its input.
    """

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"rank grid of shape {ranks.shape} does not "
                             f"match axes {tuple(axis_names)}")
        size, rank = world()
        if sorted(ranks.ravel().tolist()) != list(range(ranks.size)):
            raise ValueError(f"rank grid must hold ranks 0..{ranks.size - 1}"
                             f" once each, got {ranks.tolist()}")
        if ranks.size != size:
            raise ValueError(f"mesh {'x'.join(map(str, ranks.shape))} != "
                             f"{size} ranks")
        self.ranks = ranks
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, ranks.shape))
        self.size = int(ranks.size)
        self.rank = rank
        where = np.argwhere(ranks == self.rank)[0]
        self.coords: Dict[str, int] = {a: int(i) for a, i in
                                       zip(self.axis_names, where)}
        self._groups: Dict[Tuple[str, ...], tuple] = {}
        self._build_groups()

    def _axes(self, axes) -> Tuple[str, ...]:
        """`axes` (a name or a sequence of names) in mesh order."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in names if a not in self.shape]
        if unknown:
            raise ValueError(f"unknown mesh axes {unknown}; the mesh has "
                             f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in names)

    def _members(self, axes: Tuple[str, ...]):
        """Every group along `axes`: lists of ranks in mesh order, one
        list per index of the other axes."""
        keep = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in keep]
        grid = np.transpose(self.ranks, rest + keep)
        return grid.reshape(-1, int(np.prod([self.ranks.shape[i]
                                             for i in keep])))

    def _build_groups(self) -> None:
        n = len(self.axis_names)
        subsets = [tuple(self.axis_names[i] for i in range(n)
                         if mask >> i & 1) for mask in range(1, 1 << n)]
        for axes in subsets:
            members = self._members(axes)
            if members.shape[1] == 1:
                continue
            mine = None
            for row in members:
                ordered = [int(r) for r in row]
                if len(ordered) == self.size:
                    group = None          # the whole world: the default
                else:
                    group = dist.new_group(sorted(ordered))
                if self.rank in ordered:
                    mine = (group, ordered)
            self._groups[axes] = mine

    def group(self, axes):
        """``(process group, ranks in mesh order)`` of this rank along
        `axes`; None for a size-1 span."""
        return self._groups.get(self._axes(axes))


def make_mesh(n_node_shards: Optional[int] = None,
              n_tx_shards: int = 1) -> Mesh:
    """A ``(nodes, txs)`` mesh over every rank of the default process
    group (one rank when there is none), row-major.

    With the default `n_node_shards` every rank not taken by the txs
    axis goes to the nodes axis; `n_node_shards * n_tx_shards` must equal
    the world size."""
    n_dev = world()[0]
    if n_node_shards is None:
        if n_dev % n_tx_shards:
            raise ValueError(f"{n_dev} devices not divisible by "
                             f"n_tx_shards={n_tx_shards}")
        n_node_shards = n_dev // n_tx_shards
    if n_node_shards * n_tx_shards != n_dev:
        raise ValueError(
            f"mesh {n_node_shards}x{n_tx_shards} != {n_dev} devices")
    grid = np.arange(n_dev).reshape(n_node_shards, n_tx_shards)
    return Mesh(grid, (NODES_AXIS, TXS_AXIS))
