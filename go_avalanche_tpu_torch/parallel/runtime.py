"""Multi-process runtime — `go_avalanche_tpu/parallel/runtime.py`.

Process-group bring-up over `torch.distributed` and a mesh that knows
the two tiers of links.  The reference's tiers are ICI inside a TPU
slice and DCN between slices; the port's slice is a host:

  inside a host (NVLink, PCIe):  the "nodes" axis, whose all-gather
                                 runs every round;
  between hosts (the network):   the "txs" axis, which needs only the
                                 poll cap's and the telemetry's sums.

The backend follows from the device: NCCL when each rank has a card of
its own, gloo on the CPU.  Ranks that share one card must ask for gloo
(NCCL refuses two ranks on one device), which stages CUDA tensors
through host memory (counted in `collectives.host_staged`).  Nothing
switches backend unasked: any other combination raises and names the
reason.  Under ``torchrun`` pass ``init_method="env://"``.
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from go_avalanche_tpu_torch.parallel.mesh import (NODES_AXIS, TXS_AXIS, Mesh,
                                                  make_mesh, world)

_initialized = False
_hosts = None


def select_backend(device, world_size: int,
                   backend: Optional[str] = None) -> str:
    """The backend for `world_size` ranks on `device`: NCCL on CUDA
    when every rank has a card of its own, gloo on the CPU, and gloo on
    CUDA only when asked for.  Raises on any other combination."""
    dev = torch.device(device)
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("backend 'nccl' needs CUDA tensors; ranks on "
                             "the CPU run gloo")
        return "gloo"
    if dev.type != "cuda":
        raise ValueError(f"ranks run on cuda or cpu, got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           f"torch.cuda.is_available() is False; pass "
                           f"device='cpu' to run the ranks on the CPU")
    cards = torch.cuda.device_count()
    if backend is None:
        if world_size > cards:
            raise ValueError(
                f"{world_size} ranks on {cards} card(s) would share a "
                f"card, and NCCL refuses two ranks on one device: pass "
                f"backend='gloo' (it stages CUDA tensors through the host)")
        return "nccl"
    if backend == "nccl" and world_size > cards:
        raise ValueError(f"backend 'nccl' with {world_size} ranks on "
                         f"{cards} card(s): NCCL refuses two ranks on one "
                         f"device — pass backend='gloo'")
    return backend


def rank_device(device, rank: Optional[int] = None) -> torch.device:
    """The device rank `rank` (default: this rank) runs on: its own card
    ``cuda:(rank % cards)`` on CUDA, the CPU otherwise."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if rank is None:
        rank = world()[1]
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_runtime(init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None,
                       device="cuda",
                       backend: Optional[str] = None) -> int:
    """Bring up the process group; returns this process's rank.

    With no `init_method` and no `world_size` this is a no-op that
    returns the current rank (0 in a single process).  Otherwise it
    calls `torch.distributed.init_process_group` exactly once, with the
    backend `select_backend` picks for `device`; later calls change
    nothing.  On CUDA it also makes the rank's card current."""
    global _initialized
    if init_method is None and world_size is None:
        return world()[1]
    if not _initialized and not dist.is_initialized():
        if world_size is None:
            world_size = int(os.environ["WORLD_SIZE"])
        chosen = select_backend(device, world_size, backend)
        kwargs = {} if rank is None else {"rank": rank}
        dist.init_process_group(chosen, init_method=init_method,
                                world_size=world_size, **kwargs)
        _initialized = True
        dev = rank_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    return world()[1]


def build_on_mesh(make_fn, mesh: Mesh, shard_fn):
    """This rank's block of a state built by `make_fn`.

    `make_fn` must be deterministic (every rank builds the same global
    state from the same seed); `shard_fn(state, mesh)` cuts this rank's
    block (`sharded.shard_state`, `sharded_dag.shard_dag_state`).  Each
    rank holds the global state only while it cuts its block out.
    """
    return shard_fn(make_fn(), mesh)


def _host_of(rank: int) -> str:
    """The host name of `rank`; one all-gather of every rank's name the
    first time it is asked."""
    global _hosts
    if _hosts is None:
        size, _ = world()
        if size == 1:
            _hosts = [socket.gethostname()]
        else:
            _hosts = [None] * size
            dist.all_gather_object(_hosts, socket.gethostname())
    return _hosts[rank]


def group_devices_by_slice(ranks: Optional[Sequence[int]] = None
                           ) -> list:
    """Ranks grouped by host (the port's slice), hosts in the order of
    their lowest rank, each group in rank order."""
    if ranks is None:
        ranks = range(world()[0])
    groups: dict = {}
    for r in sorted(ranks):
        groups.setdefault(_host_of(r), []).append(r)
    return sorted(groups.values(), key=lambda g: g[0])


def make_runtime_mesh(n_tx_shards: Optional[int] = None) -> Mesh:
    """A ``(nodes, txs)`` mesh over every rank that keeps the nodes axis
    inside a host and lets the txs axis span hosts.

    With `n_tx_shards=None` the txs axis gets one shard per host.  On
    one host this is `mesh.make_mesh` with the same arithmetic."""
    groups = group_devices_by_slice()
    n_slices = len(groups)
    per_slice = len(groups[0])
    if any(len(g) != per_slice for g in groups):
        raise ValueError("slices have unequal device counts: "
                         f"{[len(g) for g in groups]}")
    if n_tx_shards is None:
        n_tx_shards = n_slices
    if n_slices == 1:
        return make_mesh(n_tx_shards=n_tx_shards)
    if n_tx_shards % n_slices:
        raise ValueError(
            f"n_tx_shards={n_tx_shards} must be a multiple of the slice "
            f"count {n_slices} so the DCN boundary falls between tx shards")
    tx_per_slice = n_tx_shards // n_slices
    if per_slice % tx_per_slice:
        raise ValueError(
            f"{per_slice} devices/slice not divisible by {tx_per_slice} "
            "tx shards/slice")
    node_shards = per_slice // tx_per_slice
    # [n_slices, node_shards, tx_per_slice] -> (nodes, txs), the txs
    # axis slice-major, so crossing a tx-shard boundary crosses hosts
    # only every `tx_per_slice` shards.
    arr = np.asarray(groups).reshape(n_slices, node_shards, tx_per_slice)
    grid = np.transpose(arr, (1, 0, 2)).reshape(node_shards, n_tx_shards)
    return Mesh(grid, (NODES_AXIS, TXS_AXIS))
