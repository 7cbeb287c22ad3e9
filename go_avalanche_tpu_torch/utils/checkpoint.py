"""Checkpoint / resume for simulator states — the npz backend of
`go_avalanche_tpu/utils/checkpoint.py`.

A checkpoint is one `.npz` file that either package restores: the
state's leaves in the JAX package's `tree_flatten` order as ``leaf_{i}``
(PRNG keys as ``__prngkey__{i}``, their two uint32 key words), in the
reference dtypes (u16 confidence, uint32 keys), plus ``__leaf_count__``.
The port's states differ in layout from the reference's (int16
confidence, int64 key words, `DagSimState`'s plain ints, the frozen
`TraceBuffer`), so the walk goes through `convert.py`: a state becomes
the reference's numpy tree (`*_to_numpy`) and back (`*_from_numpy`), and
`_leaves` flattens that tree exactly as JAX does — NamedTuple fields in
order, None dropped, `DagSimState.n_sets` / `set_size` and the trace
buffer's columns and stride kept as structure, not leaves.

Every device→host transfer of a save is bounded by `max_fetch_bytes`
(row blocks along axis 0, `_row_blocks`) and each gets a
`fetch_timeout_s` deadline; every host→device transfer of a restore is
bounded by `max_transfer_bytes`.  The file is written to ``path.tmp``
and moved into place with `os.replace`, so an interrupted save never
leaves a torn checkpoint.

`save_checkpoint_dcp` / `restore_checkpoint_dcp` are the counterpart of
the reference's orbax pair: a `torch.distributed.checkpoint` directory,
for a state placed on a rank mesh (`parallel/`).  Each rank writes only
its own block of every leaf, as a chunk of the global leaf (a `DTensor`
over a `DeviceMesh` of the mesh's rank grid, `Shard` along the leaf's
cut dimensions, `Replicate` elsewhere; replicated leaves are written
once), and a restore reshards: onto the same mesh shape, another one,
or one device.  The leaves are the npz backend's: the reference's order,
names and dtypes through `convert.py`, PRNG keys as their plain uint32
key words (the reference's `_split_keys`).  The directory is written as
``path.tmp`` and renamed into place by rank 0 after every rank is done.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from go_avalanche_tpu_torch import convert
from go_avalanche_tpu_torch.models import (avalanche, backlog, dag,
                                           node_stream, streaming_dag)
from go_avalanche_tpu_torch.obs.trace import TraceBuffer

_KEY_PREFIX = "__prngkey__"
# The fields that hold a typed PRNG key in the reference's states.
_KEY_FIELDS = ("key", "churn_key")

# state type -> (to the reference's numpy tree, back onto a device)
_KINDS = {
    avalanche.AvalancheSimState: (convert.state_to_numpy,
                                  convert.state_from_numpy),
    dag.DagSimState: (convert.dag_state_to_numpy,
                      convert.dag_state_from_numpy),
    backlog.BacklogSimState: (convert.backlog_state_to_numpy,
                              convert.backlog_state_from_numpy),
    streaming_dag.StreamingDagState: (
        convert.streaming_dag_state_to_numpy,
        convert.streaming_dag_state_from_numpy),
    node_stream.NodeStreamState: (convert.node_stream_state_to_numpy,
                                  convert.node_stream_state_from_numpy),
}
for _model, _cls in convert.FAMILY_STATES.items():
    _KINDS[_cls] = (convert.family_state_to_numpy,
                    lambda tree, device, _m=_model:
                    convert.family_state_from_numpy(_m, tree, device))
del _model, _cls


class CheckpointFetchTimeout(TimeoutError):
    """A bounded device→host fetch missed its deadline.

    Raised by `save_checkpoint(..., fetch_timeout_s=...)` before anything
    is written, so the caller can drop this save and keep the run alive:
    a stuck transfer costs a checkpoint, never the simulation.
    """


def _kind(state) -> tuple:
    try:
        return _KINDS[type(state)]
    except KeyError:
        raise TypeError(f"no checkpoint layout for {type(state).__name__}; "
                        f"expected one of "
                        f"{', '.join(c.__name__ for c in _KINDS)}") from None


def _leaves(tree, field: str = "") -> Iterator[Tuple[bool, Any]]:
    """``(is_key, leaf)`` of a reference numpy tree in the JAX package's
    `tree_flatten` order."""
    if tree is None:
        return
    if isinstance(tree, TraceBuffer):
        yield False, tree.data
        yield False, tree.cursor
    elif isinstance(tree, dag.DagSimState):
        yield from _leaves(tree.base)
        yield False, tree.conflict_set
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), name)
    else:
        yield field in _KEY_FIELDS, tree


def _replace_leaves(tree, values: Iterator):
    """`tree` with its `_leaves` replaced, in order, by `values`."""
    if tree is None:
        return None
    if isinstance(tree, TraceBuffer):
        return dataclasses.replace(tree, data=next(values),
                                   cursor=next(values))
    if isinstance(tree, dag.DagSimState):
        base = _replace_leaves(tree.base, values)
        return tree._replace(base=base, conflict_set=next(values))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_replace_leaves(getattr(tree, name), values)
                            for name in tree._fields))
    return next(values)


def _map_tensors(tree, fn):
    """Every tensor leaf of a port state through `fn`; None, ints and the
    trace buffer's statics pass."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, TraceBuffer):
        return dataclasses.replace(tree, data=fn(tree.data),
                                   cursor=fn(tree.cursor))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tensors(x, fn) for x in tree))
    return tree


def _row_blocks(shape: tuple, nbytes: int, cap: Optional[int]):
    """Axis-0 slice ranges bounding each transfer to ~`cap` bytes — the
    one place the block math lives, so save and restore agree.  Yields
    nothing when the whole array fits (or cannot be row-sliced)."""
    if cap is None or nbytes <= cap or len(shape) == 0 or shape[0] <= 1:
        return
    row_bytes = max(1, nbytes // shape[0])
    rows = max(1, cap // row_bytes)
    for lo in range(0, shape[0], rows):
        yield lo, min(lo + rows, shape[0])


def _copy_to_host(block: torch.Tensor, stream) -> torch.Tensor:
    """One device→host transfer, on `stream` when the block is on the
    card (a synchronous copy: it returns when the bytes are on the
    host)."""
    if stream is None:
        return block.to("cpu", copy=True)
    with torch.cuda.stream(stream):
        return block.to("cpu", copy=True)


def _fetch(block: torch.Tensor, stream,
           timeout_s: Optional[float]) -> torch.Tensor:
    """`_copy_to_host` with an optional deadline.

    The copy runs on a throwaway daemon thread: on a timeout that thread
    stays blocked on the transfer (it cannot be cancelled) and is simply
    orphaned, so the caller's thread is never the one stuck, and a
    daemon thread does not hold up interpreter exit.
    """
    if timeout_s is None:
        return _copy_to_host(block, stream)
    box: list = []

    def work() -> None:
        try:
            box.append(("ok", _copy_to_host(block, stream)))
        except Exception as e:  # noqa: BLE001 — re-raised in the caller
            box.append(("err", e))

    t = threading.Thread(target=work, daemon=True)
    t.start()
    t.join(timeout_s)
    if not box:
        raise CheckpointFetchTimeout(
            f"device→host fetch of {block.numel() * block.element_size()} "
            f"bytes exceeded {timeout_s}s — aborting this save (run "
            f"continues)")
    kind, val = box[0]
    if kind == "err":
        raise val
    return val


def _fetch_leaf(leaf: torch.Tensor, stream, max_fetch_bytes: Optional[int],
                fetch_timeout_s: Optional[float]) -> torch.Tensor:
    """One leaf on the host, never moving more than `max_fetch_bytes` a
    transfer: an oversized leaf comes over in row blocks, each with its
    own deadline."""
    blocks = list(_row_blocks(tuple(leaf.shape),
                              leaf.numel() * leaf.element_size(),
                              max_fetch_bytes))
    if not blocks:
        return _fetch(leaf, stream, fetch_timeout_s)
    out = torch.empty(leaf.shape, dtype=leaf.dtype)
    for lo, hi in blocks:
        out[lo:hi] = _fetch(leaf[lo:hi], stream, fetch_timeout_s)
    return out


def _card_stream(state, ready):
    """The side stream a save copies on, when the state lies on the
    card: it waits for `ready` (an event recorded where the state was
    produced) or else for the calling thread's current stream, so the
    copies never wait on work queued after the state."""
    devices = []
    _map_tensors(state, lambda t: devices.append(t.device) or t)
    card = next((d for d in devices if d.type == "cuda"), None)
    if card is None:
        return None
    stream = torch.cuda.Stream(card)
    if ready is not None:
        stream.wait_event(ready)
    else:
        stream.wait_stream(torch.cuda.current_stream(card))
    return stream


def save_checkpoint(path: str, state: Any, *,
                    max_fetch_bytes: Optional[int] = None,
                    fetch_timeout_s: Optional[float] = None,
                    ready=None) -> None:
    """Save a simulator state to `path` (.npz), restorable by either
    package.

    `max_fetch_bytes` bounds every device→host transfer (oversized
    leaves come over in row blocks); `fetch_timeout_s` puts a deadline
    on each, and a miss raises `CheckpointFetchTimeout` before anything
    is written.  `ready`, a `torch.cuda.Event` recorded after the state
    was produced, lets a background saver copy on a side stream while
    later work runs.  Defaults (None) move whole leaves with no
    deadline.
    """
    to_numpy, _ = _kind(state)
    stream = _card_stream(state, ready)
    host = _map_tensors(state, lambda t: _fetch_leaf(
        t, stream, max_fetch_bytes, fetch_timeout_s))
    leaves = list(_leaves(to_numpy(host)))
    payload = {"__leaf_count__": np.asarray(len(leaves))}
    for i, (is_key, leaf) in enumerate(leaves):
        payload[f"{_KEY_PREFIX}{i}" if is_key else f"leaf_{i}"] = (
            np.asarray(leaf))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)  # atomic: no torn checkpoints on interruption


def _spec(tensor: torch.Tensor) -> torch.Tensor:
    """A CPU stand-in with the leaf's shape and dtype and no storage:
    enough for `*_to_numpy` to give each leaf's reference dtype."""
    return torch.zeros((), dtype=tensor.dtype).expand(tensor.shape)


def _put_bounded(tensor: torch.Tensor, device: torch.device,
                 max_transfer_bytes: Optional[int]) -> torch.Tensor:
    """Host→device placement, never moving more than
    `max_transfer_bytes` a transfer: an oversized leaf goes up in row
    blocks into one buffer on the device."""
    blocks = list(_row_blocks(tuple(tensor.shape),
                              tensor.numel() * tensor.element_size(),
                              max_transfer_bytes))
    if not blocks:
        return tensor.to(device)
    out = torch.empty(tensor.shape, dtype=tensor.dtype, device=device)
    for lo, hi in blocks:
        out[lo:hi].copy_(tensor[lo:hi])
    return out


def restore_checkpoint(path: str, template: Any, *,
                       max_transfer_bytes: Optional[int] = None,
                       device="cuda") -> Any:
    """Restore a state saved by `save_checkpoint` (of either package) on
    `device`.

    `template` is any state of the same kind and structure (e.g. a fresh
    `init()`); its structure and statics are reused, its values
    replaced.  A leaf count, name, shape or dtype that differs raises
    ValueError; nothing is cast.  `max_transfer_bytes` bounds each
    host→device transfer.
    """
    dev = avalanche._device(device)
    to_numpy, from_numpy = _kind(template)
    tree = to_numpy(_map_tensors(template, _spec))
    wanted: List[Tuple[bool, Any]] = list(_leaves(tree))
    restored = []
    with np.load(path) as data:
        if "__leaf_count__" in data:   # absent in pre-marker checkpoints
            saved = int(data["__leaf_count__"])
            if saved != len(wanted):
                raise ValueError(
                    f"checkpoint has {saved} leaves, template has "
                    f"{len(wanted)} — saved from a structurally different "
                    f"state (e.g. the opposite `track_finality` mode, or "
                    f"another model/config); rebuild the template to match "
                    f"how the checkpoint was produced")
        for i, (is_key, want) in enumerate(wanted):
            key_name, plain_name = f"{_KEY_PREFIX}{i}", f"leaf_{i}"
            if is_key and key_name not in data:
                raise ValueError(f"checkpoint leaf {i}: expected a PRNG key")
            if not is_key and plain_name not in data:
                raise ValueError(f"checkpoint missing leaf {i} "
                                 f"(template/checkpoint structure mismatch)")
            arr = data[key_name if is_key else plain_name]
            want = np.asarray(want)
            if arr.shape != want.shape or arr.dtype != want.dtype:
                raise ValueError(
                    f"checkpoint leaf {i}: got {arr.dtype}{list(arr.shape)}, "
                    f"template has {want.dtype}{list(want.shape)}")
            restored.append(arr)
    state = from_numpy(_replace_leaves(tree, iter(restored)), device="cpu")
    return _map_tensors(state, lambda t: _put_bounded(t, dev,
                                                      max_transfer_bytes))


# ---------------------------------------------------------------------------
# torch.distributed.checkpoint backend (sharding-aware, multi-process)


def _sharded_specs(state) -> Any:
    """The per-leaf spec tree of a state kind the sharded drivers place
    (`parallel/`)."""
    from go_avalanche_tpu_torch.parallel import (sharded, sharded_backlog,
                                                 sharded_dag,
                                                 sharded_node_stream,
                                                 sharded_streaming_dag)

    specs_of = {
        avalanche.AvalancheSimState: sharded.specs_of,
        dag.DagSimState: sharded_dag.specs_of,
        backlog.BacklogSimState: sharded_backlog.specs_of,
        streaming_dag.StreamingDagState: sharded_streaming_dag.specs_of,
        node_stream.NodeStreamState: sharded_node_stream.specs_of,
    }.get(type(state))
    if specs_of is None:
        raise TypeError(f"no mesh layout for {type(state).__name__}; the "
                        f"DCP backend takes the sharded drivers' states")
    return specs_of(state)


def _spec_leaves(tree, specs) -> Iterator[tuple]:
    """The spec of every leaf of a port state, in `_leaves` order (a
    trace buffer's two leaves are replicated)."""
    if tree is None:
        return
    if isinstance(tree, TraceBuffer):
        yield specs
        yield specs
    elif isinstance(tree, dag.DagSimState):
        yield from _spec_leaves(tree.base, specs.base)
        yield specs.conflict_set
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _spec_leaves(getattr(tree, name),
                                    getattr(specs, name))
    else:
        yield specs


def _dcp_names(leaves) -> List[str]:
    return [f"{_KEY_PREFIX}{i}" if is_key else f"leaf_{i}"
            for i, (is_key, _) in enumerate(leaves)]


def _mesh_view(mesh):
    """``(DeviceMesh, device type)`` of a multi-rank `mesh`, built once
    per mesh (every rank builds it: `DeviceMesh` makes a group per axis);
    None for one rank.  The blocks travel on the host over gloo and on
    the card over NCCL."""
    import torch.distributed as dist

    if mesh is None or mesh.size == 1:
        return None
    view = getattr(mesh, "_dcp_view", None)
    if view is None:
        from torch.distributed.device_mesh import DeviceMesh

        dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        view = (DeviceMesh(dev_type, torch.as_tensor(mesh.ranks),
                           mesh_dim_names=mesh.axis_names), dev_type)
        mesh._dcp_view = view
    return view


def _as_global(local: torch.Tensor, spec, mesh, view):
    """`local` (this rank's block) as the global leaf DCP writes or
    fills: a `DTensor` when the leaf is cut along a mesh axis, else the
    tensor itself (a replicated leaf, written once)."""
    if view is None or not any(spec):
        return local
    from torch.distributed.tensor import DTensor, Replicate, Shard

    device_mesh, dev_type = view
    shape = list(local.shape)
    placements = [Replicate()] * len(mesh.axis_names)
    for dim, axis in enumerate(spec):
        if axis is not None:
            shape[dim] *= mesh.shape[axis]
            placements[mesh.axis_names.index(axis)] = Shard(dim)
    stride = torch.empty(shape, dtype=torch.uint8, device="meta").stride()
    return DTensor.from_local(local.to(dev_type), device_mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _dcp(call, payload, path: str, view) -> None:
    """`dcp.save` or `dcp.load` of `payload` at `path`: over the mesh's
    ranks, or in this process alone when there is no mesh view (whose
    notice that it assumes so is silenced)."""
    import warnings

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "torch.distributed is disabled")
        call(payload, checkpoint_id=path, no_dist=view is None)


def _barrier(mesh) -> None:
    import torch.distributed as dist

    if mesh is not None and mesh.size > 1:
        dist.barrier()


def _install(tmp: str, path: str) -> None:
    """Move a finished save at `tmp` into place at `path`: an older
    checkpoint goes aside to ``path.old`` first and is deleted last, so
    at every instant `path` or ``path.old`` holds a complete checkpoint
    (`restore_checkpoint_dcp` reads ``path.old`` when `path` is
    missing)."""
    old = path + ".old"
    if os.path.exists(path):
        shutil.rmtree(old, ignore_errors=True)
        os.replace(path, old)
    os.replace(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def _complete(path: str) -> str:
    """The directory of the last complete DCP checkpoint at `path`."""
    for where in (path, path + ".old"):
        if os.path.isfile(os.path.join(where, ".metadata")):
            return where
    raise FileNotFoundError(f"no complete DCP checkpoint at {path}")


def save_checkpoint_dcp(path: str, state: Any, mesh=None) -> None:
    """Save a state — this rank's block on `mesh`, or a whole state with
    `mesh` None — as a `torch.distributed.checkpoint` directory at
    `path`; every rank of the mesh calls it.

    Each rank writes its own block of every leaf as a chunk of the
    global leaf, and the replicated leaves once.  The directory is
    written as ``path.tmp``; after every rank is done, rank 0 moves it
    into place (`_install`), so a save that dies on the way leaves the
    last complete checkpoint, or none, never a torn one."""
    import torch.distributed.checkpoint as dcp

    to_numpy, _ = _kind(state)
    specs = _sharded_specs(state)
    host = _map_tensors(state, lambda t: t.detach().to("cpu", copy=True))
    leaves = list(_leaves(to_numpy(host)))
    leaf_specs = list(_spec_leaves(state, specs))
    view = _mesh_view(mesh)
    payload = {"__leaf_count__": torch.tensor(len(leaves))}
    for name, (_, leaf), spec in zip(_dcp_names(leaves), leaves,
                                     leaf_specs):
        local = torch.from_numpy(np.array(leaf, order="C"))
        payload[name] = _as_global(local, spec, mesh, view)
    lead = mesh is None or mesh.rank == 0
    tmp = path + ".tmp"
    if lead:
        shutil.rmtree(tmp, ignore_errors=True)
    _barrier(mesh)
    _dcp(dcp.save, payload, tmp, view)
    _barrier(mesh)
    if lead:
        _install(tmp, path)
    _barrier(mesh)


def restore_checkpoint_dcp(path: str, template: Any, mesh=None) -> Any:
    """Restore a checkpoint of `save_checkpoint_dcp`, resharded as
    `template` says: this rank's block of a state placed on `mesh` (any
    mesh shape the leaves divide over), or with `mesh` None a whole
    state (the "one device" restore; each caller reads every chunk).
    Every rank of the mesh calls it.  The result's leaves lie on the
    template's devices.  A leaf count, name, shape or dtype that differs
    from the checkpoint's raises ValueError; nothing is cast."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    path = _complete(path)
    to_numpy, from_numpy = _kind(template)
    specs = _sharded_specs(template)
    tree = to_numpy(_map_tensors(template, _spec))
    wanted = list(_leaves(tree))
    leaf_specs = list(_spec_leaves(template, specs))
    names = _dcp_names(wanted)
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    n_saved = len([k for k in saved if k != "__leaf_count__"])
    if n_saved != len(wanted):
        raise ValueError(
            f"checkpoint has {n_saved} leaves, template has {len(wanted)} "
            f"— saved from a structurally different state (e.g. the "
            f"opposite `track_finality` mode, or another model/config); "
            f"rebuild the template to match how the checkpoint was "
            f"produced")
    view = _mesh_view(mesh)
    payload, locals_ = {}, []
    for i, (name, (_, want), spec) in enumerate(zip(names, wanted,
                                                    leaf_specs)):
        meta = saved.get(name)
        if not isinstance(meta, TensorStorageMetadata):
            raise ValueError(f"checkpoint missing leaf {i} ({name}: "
                             f"template/checkpoint structure mismatch)")
        local = torch.from_numpy(np.zeros(want.shape, want.dtype))
        glob = _as_global(local, spec, mesh, view)
        got = (meta.properties.dtype, list(meta.size))
        if got != (local.dtype, list(glob.shape)):
            raise ValueError(
                f"checkpoint leaf {i}: got {got[0]}{got[1]}, template has "
                f"{local.dtype}{list(glob.shape)}")
        payload[name] = glob
        locals_.append(glob)
    _dcp(dcp.load, payload, path, view)
    restored = [(x.to_local() if hasattr(x, "to_local") else x).cpu()
                .numpy() for x in locals_]
    devices = []
    _map_tensors(template, lambda t: devices.append(t.device) or t)
    dev = devices[0] if devices else torch.device("cpu")
    return from_numpy(_replace_leaves(tree, iter(restored)), device=dev)
