"""Op-class histograms of one round — the port's
`go_avalanche_tpu/analysis/drift.py`.

The reference counts the op classes of a program's StableHLO text
(``stablehlo.<op>``, ``custom_call:<target>``) and archives them next
to each pinned hash, so `hlo_pin --explain` can name what drifted.  The
port has no program text: a round is the sequence of ops PyTorch
dispatches, plus the hand-written kernels it launches through `ctypes`,
which no dispatcher sees.  So `op_histogram` runs ``step(state)`` once
under `OpRecorder` (a `TorchDispatchMode`) and counts

  * ``aten.<op>``     — one class per dispatched operator (any other
                        namespace is counted by its own name the same
                        way);
  * ``kernel:<name>`` — the launches of each hand-written kernel, read
                        from the launch counters (`ops/pallas_vote.
                        launches`: ``vote_u8``, ``vote_swar``;
                        `ops/megakernel.launches`: ``megakernel``).
                        These are the counterpart of the reference's
                        ``custom_call:<target>`` classes.  On CPU
                        tensors the wrappers run their plain versions,
                        so no ``kernel:`` class appears there.

`diff_histograms` is the reference's, copied: pure dict logic, the
same strings.  There is no archived pin to diff against
(`benchmarks/hlo_pin.json` holds the reference's StableHLO classes,
which no torch round produces), so the histogram is reported, not
pinned: by the contract audit (`analysis/audit.py`), by
`obs/resources.sharded_driver_records` and by `chip_smoke.py`'s audit
phase.
"""

from __future__ import annotations

import sys
from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# Port modules whose ops are attributed to them by name: an op counts
# as theirs when one of the Python frames above it belongs to the
# module (or, for a "module:function" scope, runs that function).  The
# contract audit reads the attribution for its dtype rule.
_PORT = "go_avalanche_tpu_torch."

# Operators that take index tensors (torch indexes with int64 only).
INDEX_OPS = frozenset({
    "aten.index", "aten.index_put", "aten.index_put_",
    "aten._index_put_impl_", "aten.gather", "aten.scatter",
    "aten.scatter_", "aten.scatter_add", "aten.scatter_add_",
    "aten.scatter_reduce", "aten.scatter_reduce_", "aten.index_select",
    "aten.index_add", "aten.index_add_", "aten.index_copy",
    "aten.index_copy_", "aten.index_fill", "aten.index_fill_",
    "aten.take", "aten.take_along_dim", "aten.embedding",
})


def _tensors(obj):
    """Every tensor in nested args (lists, tuples, dicts)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)


# Operators that make the host wait for the device: their result's
# value or size is read back.  A boolean-mask index is one too
# (`_syncs`), and so is a copy from the card to the host.
SYNC_OPS = frozenset({
    "aten._local_scalar_dense", "aten.is_nonzero", "aten.equal",
    "aten.nonzero", "aten.nonzero_static", "aten.masked_select",
    "aten.unique", "aten._unique", "aten._unique2", "aten.unique_dim",
    "aten.unique_consecutive", "aten.repeat_interleave",
})


def _syncs(name: str, args, kwargs) -> bool:
    """Does this op make the host wait for the device?"""
    if name in SYNC_OPS:
        return True
    if name in ("aten.index", "aten.index_put", "aten.index_put_"):
        idx = args[1] if len(args) > 1 else ()
        return any(isinstance(i, torch.Tensor)
                   and i.dtype in (torch.bool, torch.uint8)
                   for i in (idx or ()))
    if name == "aten._to_copy" and args and isinstance(args[0],
                                                       torch.Tensor):
        dev = kwargs.get("device")
        return args[0].is_cuda and dev is not None and \
            torch.device(dev).type == "cpu"
    if name == "aten.copy_" and len(args) > 1:
        return (isinstance(args[1], torch.Tensor) and args[1].is_cuda
                and not args[0].is_cuda)
    return False


class OpRecorder(TorchDispatchMode):
    """Records every op dispatched inside it: ``(class, outputs,
    scopes)``, where `outputs` are ``(dtype, numel)`` of each tensor the
    op returned and `scopes` the port modules on the Python stack above
    the op (``"prng"``, ``"sync"``, ...).  `scoped` names the modules
    worth attributing; None records none (the histogram needs no stack
    walk).  `syncs` lists ``(class, scopes)`` of every op that makes
    the host wait for the device (`SYNC_OPS`).  `indices` holds the
    positions in `ops` of the ops whose int64 output becomes an index
    (an argument of `INDEX_OPS`, directly or through int64 ops)."""

    def __init__(self, scoped: Optional[Tuple[str, ...]] = None):
        super().__init__()
        self.ops: List[Tuple[str, List[Tuple[torch.dtype, int]],
                             Tuple[str, ...]]] = []
        self.syncs: List[Tuple[str, Tuple[str, ...]]] = []
        self.indices: set = set()
        self._scoped: Dict[str, List[Tuple[Optional[str], str]]] = {}
        for scope in scoped or ():
            mod, _, fn = scope.partition(":")
            self._scoped.setdefault(_PORT + mod, []).append(
                (fn or None, scope))
        self._last: Dict[int, int] = {}     # id(tensor) -> its op
        self._sources: List[List[int]] = []  # op -> its int64 inputs' ops

    def _scopes(self) -> Tuple[str, ...]:
        if not self._scoped:
            return ()
        found = []
        frame = sys._getframe(2)
        while frame is not None:
            for fn, scope in self._scoped.get(
                    frame.f_globals.get("__name__"), ()):
                if (fn is None or frame.f_code.co_name == fn) and \
                        scope not in found:
                    found.append(scope)
            frame = frame.f_back
        return tuple(found)

    def _mark_index(self, pos: int) -> None:
        todo = [pos]
        while todo:
            p = todo.pop()
            if p not in self.indices:
                self.indices.add(p)
                todo.extend(self._sources[p])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = op_class(func)
        syncing = _syncs(name, args, kwargs)
        sources = [self._last[id(t)] for t in _tensors((args, kwargs))
                   if t.dtype == torch.int64 and id(t) in self._last]
        out = func(*args, **kwargs)
        outs = [t for t in _tensors(out)]
        scopes = self._scopes()
        pos = len(self.ops)
        self.ops.append((name, [(t.dtype, t.numel()) for t in outs],
                         scopes))
        self._sources.append(sources)
        for t in outs:
            self._last[id(t)] = pos
        if name in INDEX_OPS:
            for p in sources:
                self._mark_index(p)
        if syncing:
            self.syncs.append((name, scopes))
        return out


def op_class(func) -> str:
    """``aten.add`` for ``aten::add.Tensor``: the namespace and the
    operator, without the overload."""
    return func._schema.name.replace("::", ".")


def kernel_launches() -> Dict[str, int]:
    """The launch counters of every hand-written kernel, by name."""
    from go_avalanche_tpu_torch.ops import megakernel, pallas_vote

    return {**pallas_vote.launches, "megakernel": megakernel.launches}


def kernel_delta(before: Dict[str, int]) -> Dict[str, int]:
    """Launches of each kernel since `before` (`kernel_launches()`),
    the kernels launched at least once."""
    now = kernel_launches()
    return {k: now[k] - before.get(k, 0) for k in now
            if now[k] - before.get(k, 0)}


def op_histogram(step: Callable, state) -> Dict[str, int]:
    """Histogram of op classes of one ``step(state)`` call: ``{class:
    count}``, the ``aten.<op>`` classes the round dispatches and a
    ``kernel:<name>`` class per hand-written kernel it launched.  The
    step's result is dropped; `state` must not be updated in place by
    it (pass a copy otherwise)."""
    before = kernel_launches()
    rec = OpRecorder()
    with rec:
        out = step(state)
    del out
    return histogram(rec.ops, kernel_delta(before))


def histogram(ops, kernels: Dict[str, int]) -> Dict[str, int]:
    """``{class: count}`` of recorded ops (`OpRecorder.ops`) and kernel
    launches (`kernel_delta`)."""
    hist: Counter = Counter(name for name, _, _ in ops)
    for name, n in kernels.items():
        hist[f"kernel:{name}"] += n
    return dict(hist)


def diff_histograms(archived: Dict[str, int],
                    current: Dict[str, int]) -> List[str]:
    """Name the op classes whose counts differ, archived -> current.

    One line per differing class, vanished/appeared called out, sorted
    by |count delta| descending then name (the biggest structural move
    first — usually the one-line answer to "what drifted").  Equal
    histograms return the explicit shape-or-constant note instead of
    [] so `--explain` never prints nothing on a real hash mismatch.
    """
    classes = sorted(set(archived) | set(current))
    rows = []
    for cls in classes:
        a, c = archived.get(cls, 0), current.get(cls, 0)
        if a == c:
            continue
        if a == 0:
            note = "APPEARED"
        elif c == 0:
            note = "VANISHED"
        else:
            note = f"{c - a:+d}"
        rows.append((abs(c - a), cls, f"{cls}: {a} -> {c} ({note})"))
    if not rows:
        return ["op histograms are identical: the drift is in shapes, "
                "constants or operand wiring, not op structure "
                "(diff the lowered text directly)"]
    rows.sort(key=lambda r: (-r[0], r[1]))
    return [r[2] for r in rows]
