"""The resource plane: analytic footprints against the card's allocator —
the port's `go_avalanche_tpu/obs/resources.py`.

  * `plane_bytes` / `footprint` — the analytic per-plane footprint of a
    sim state, from its shapes and dtypes alone (a state on any device,
    the CPU included).  Keys are the reference's `keystr` paths.
    ``dtypes="reference"`` counts each leaf in the reference's dtype
    (equal, plane for plane, to the reference's `plane_bytes` of the
    same state); ``dtypes="device"`` counts what the card holds, which
    differs on the leaves of `DEVICE_DTYPE_DIFFERENCES`.  With a
    driver's `specs_of` tree and a mesh's axis sizes each leaf counts at
    its per-rank block shape.
  * `memory_record` — the card's ledger of one round: the allocated
    bytes of the state, the round's peak above it, and what stays live
    once the old state is released.  The reference reads the same
    quantities from XLA's `memory_analysis()`.
  * `check_memory` — the assertion joining the two: the state holds
    exactly its analytic bytes, and no clone of a plane survives the
    round (the counterpart of the reference's donation check).

`run_sim --report-memory` prints both for the run a flag selection
makes; `chip_smoke.py` checks them on the flagship.
`sharded_driver_records` is a rank's ledger of one round of each sharded
driver on the 2x2 audit mesh beside its analytic per-rank footprint.
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

# Leaves the card holds in another dtype than the reference, by field
# name: (the reference's bytes per element of the port's tensor, why).
DEVICE_DTYPE_DIFFERENCES: Dict[str, Tuple[int, str]] = {
    "key": (4, "a threefry key is int64[..., 2] here (two 32-bit words "
               "in int64: torch has no uint32 shifts), 8 B of key data "
               "in the reference"),
    "churn_key": (4, "the node stream's churn key, as `key`"),
    "confidence": (2, "the u16 counter's bit pattern in int16 (torch "
                      "lacks uint16 arithmetic); the same bytes"),
}

# The reference flattens these two classes by position, not by field
# name (`register_pytree_node_class`): its paths read
# ``[<flat index i>]``.  Their other fields are static.
_FLAT_CHILDREN = {"DagSimState": ("base", "conflict_set"),
                  "TraceBuffer": ("data", "cursor")}


def _children(tree) -> Optional[List[Tuple[str, object]]]:
    """``(path step, child)`` of a state node, or None for a leaf."""
    flat = _FLAT_CHILDREN.get(type(tree).__name__)
    if flat is not None:
        return [(f"[<flat index {i}>]", getattr(tree, f))
                for i, f in enumerate(flat)]
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None)
        return [(f".{names[i]}" if names else f"[{i}]", x)
                for i, x in enumerate(tree)]
    return None


def _is_spec(spec) -> bool:
    return isinstance(spec, tuple) and not hasattr(spec, "_fields")


def _leaves(tree, specs=None, path: str = "", field: str = ""
            ) -> Iterator[Tuple[str, str, torch.Tensor, object]]:
    """``(keystr path, field name, tensor, spec)`` of every tensor leaf;
    None and plain-int statics pass.  A spec tuple met above the leaves
    (a replicated trace buffer) covers every leaf below it."""
    kids = _children(tree)
    if kids is None:
        if isinstance(tree, torch.Tensor):
            yield path, field, tree, specs
        return
    spec_kids = (None if specs is None or _is_spec(specs)
                 else dict(_children(specs)))
    for step, child in kids:
        sub = specs if spec_kids is None else spec_kids[step]
        yield from _leaves(child, sub, path + step,
                           step.lstrip(".") if step.startswith(".")
                           else field)


def _axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a `parallel/mesh.Mesh` or a plain dict."""
    shape = getattr(mesh, "shape", mesh)
    return {str(k): int(v) for k, v in dict(shape).items()}


def _block_shape(shape, spec, sizes: Dict[str, int]) -> Tuple[int, ...]:
    """A leaf's per-rank block shape under its spec (one entry per
    dimension: the mesh axis, or axes, it is cut along, or None)."""
    out = list(shape)
    for dim, axes in enumerate(spec or ()):
        if axes is None:
            continue
        n = 1
        for a in ((axes,) if isinstance(axes, str) else axes):
            n *= sizes[a]
        if out[dim] % n:
            raise ValueError(f"dimension {dim} ({out[dim]}) does not "
                             f"divide over {axes} ({n} shards)")
        out[dim] //= n
    return tuple(out)


def plane_bytes(state, specs=None, mesh=None, *,
                dtypes: str = "device") -> Dict[str, int]:
    """Per-plane byte counts of a state, keyed by the reference's
    `keystr` paths.  Reads only shapes and dtypes.

    `dtypes` is "device" (what the card holds) or "reference" (each
    leaf in the reference's dtype, `DEVICE_DTYPE_DIFFERENCES`).  With
    `specs` (a driver's `specs_of(state)`) and `mesh` (a
    `parallel/mesh.Mesh` or ``{axis: size}``), each leaf of the global
    `state` counts at its per-rank block shape.
    """
    if dtypes not in ("device", "reference"):
        raise ValueError(f"dtypes must be 'device' or 'reference', got "
                         f"{dtypes!r}")
    if specs is not None and mesh is None:
        raise ValueError("plane_bytes: specs without a mesh — per-rank "
                         "accounting needs axis sizes")
    sizes = _axis_sizes(mesh) if specs is not None else {}
    out: Dict[str, int] = {}
    for path, field, leaf, spec in _leaves(state, specs):
        shape = (_block_shape(leaf.shape, spec, sizes) if specs is not None
                 else tuple(leaf.shape))
        n = 1
        for d in shape:
            n *= d
        size = leaf.element_size()
        if dtypes == "reference" and field in DEVICE_DTYPE_DIFFERENCES:
            size = DEVICE_DTYPE_DIFFERENCES[field][0]
        out[path] = n * size
    return out


def footprint(state, specs=None, mesh=None, *,
              dtypes: str = "device") -> Dict:
    """``{"total_bytes": N, "planes": {path: bytes}}`` of a state (see
    `plane_bytes`)."""
    planes = plane_bytes(state, specs, mesh, dtypes=dtypes)
    return {"total_bytes": sum(planes.values()), "planes": planes}


def _storages(tree) -> Dict[int, int]:
    """data pointer -> bytes of every distinct storage the tree's
    tensors keep alive (a view keeps its whole storage)."""
    out: Dict[int, int] = {}
    for _, _, leaf, _ in _leaves(tree):
        st = leaf.untyped_storage()
        if st.nbytes():
            out[st.data_ptr()] = st.nbytes()
    return out


def allocator_slack(state) -> int:
    """What the card's caching allocator may add to a state's analytic
    bytes: every block is rounded up to a multiple of 512 bytes, one
    block a leaf."""
    return 512 * sum(1 for _ in _leaves(state))


def memory_record(step: Callable, state) -> Dict[str, int]:
    """One round's memory ledger on the card: ``step(state)`` (returning
    the new state) runs once and its output is dropped.

    ``argument_bytes`` is the state's allocated bytes; ``output_bytes``
    the new state's; ``temp_bytes`` the round's peak minus what was live
    before it (the counterpart of XLA's temp bytes: scratch and the new
    state as it is built); ``live_bytes`` what stays allocated once the
    old state is released (the new state plus anything the round left
    behind; storages both states share count once); ``live_peak_bytes``
    the state plus the peak.
    """
    leaves = list(_leaves(state))
    dev = leaves[0][2].device
    if dev.type != "cuda":
        raise ValueError(f"memory_record reads the card's allocator; the "
                         f"state is on {dev}")
    # Garbage collected inside the round would free memory the ledger
    # counted before it: collect first, and not during the round.
    gc.collect()
    torch.cuda.synchronize(dev)
    old = _storages(state)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    gc.disable()
    try:
        out = step(state)
        torch.cuda.synchronize(dev)
    finally:
        gc.enable()
    peak = torch.cuda.max_memory_allocated(dev)
    after = torch.cuda.memory_allocated(dev)
    new = _storages(out)
    del out
    shared = sum(n for p, n in new.items() if p in old)
    rec = {
        "argument_bytes": sum(old.values()),
        "output_bytes": sum(new.values()),
        "shared_bytes": shared,
        "temp_bytes": peak - before,
        # after - before is what the round added and kept: the new
        # state's own storages and anything left behind.
        "live_bytes": after - before + shared,
    }
    rec["live_peak_bytes"] = rec["argument_bytes"] + rec["temp_bytes"]
    return rec


def check_memory(record: Dict[str, int], analytic_total: int, *,
                 rel_tol: float = 0.02, abs_tol: int = 4096,
                 what: str = "program") -> List[str]:
    """Assert a `memory_record` against the analytic device footprint.

    * the ARGUMENT bytes (the state's storages) must match
      `analytic_total` within tolerance — a surplus means a leaf keeps
      a larger buffer alive than its shape (a view of a temporary), a
      deficit that planes share storage or are missing;
    * the LIVE bytes after one round, once the old state is released,
      must match too — a surplus is an unaccounted clone that survives
      the round, the counterpart of the reference's undonated copy.

    Returns failure strings (empty = clean).  Tolerance is
    ``max(rel_tol * analytic_total, abs_tol)``: the caching allocator
    rounds every block up to 512 bytes.
    """
    tol = max(int(rel_tol * analytic_total), abs_tol)
    failures: List[str] = []
    arg = record["argument_bytes"]
    live = record["live_bytes"]
    if abs(arg - analytic_total) > tol:
        failures.append(
            f"{what}: allocated argument bytes {arg} != analytic state "
            f"footprint {analytic_total} (tol {tol}) — "
            f"{'an unaccounted buffer rides the state' if arg > analytic_total else 'a state plane never reached the card'}")
    if abs(live - analytic_total) > tol:
        failures.append(
            f"{what}: live bytes after one round {live} != analytic state "
            f"footprint {analytic_total} (tol {tol}) — "
            + (f"{live - analytic_total} bytes of state double-buffer "
               f"instead of being released (an unaccounted buffer clone "
               f"survives the round)" if live > analytic_total else
               "a state plane is missing from the round's output"))
    return failures


def banded_compare(archived: Dict[str, int], current: Dict[str, int],
                   band: float = 0.10, what: str = "program"
                   ) -> List[str]:
    """Tolerance-banded comparison of two memory records.
    Argument/output/alias bytes are shape arithmetic and must match
    EXACTLY; temp and generated-code bytes are compiler decisions and may
    drift within `band` (fractional) before the pin is declared moved."""
    failures: List[str] = []
    for key in ("argument_bytes", "output_bytes", "alias_bytes"):
        if archived.get(key) != current.get(key):
            failures.append(
                f"{what}: {key} moved {archived.get(key)} -> "
                f"{current.get(key)} — the program's buffer interface "
                f"changed (re-pin with --update if intended)")
    for key in ("temp_bytes", "generated_code_bytes"):
        a, c = archived.get(key, 0), current.get(key, 0)
        lo = min(a, c)
        if abs(a - c) > max(band * max(a, 1), 64):
            failures.append(
                f"{what}: {key} drifted {a} -> {c} "
                f"({100.0 * abs(a - c) / max(lo, 1):.1f}% > "
                f"{100 * band:.0f}% band) — the compiler's scratch "
                f"plan changed (re-pin with --update if intended)")
    return failures


def sharded_driver_records(drivers: Optional[List[str]] = None,
                           device="cuda") -> Dict:
    """This rank's `memory_record` of one round of each sharded driver's
    base audit case on the 2x2 audit mesh (`parallel.footprint_cases`:
    the states and steps the contract audit runs), beside the analytic
    per-rank footprint and the round's op histogram
    (`analysis.drift.op_histogram`, in place of the reference's hash of
    the lowered program).  Returns ``{driver: {"record": ...,
    "footprint": ..., "histogram": ...}}``.  Every rank of the 4 calls
    it.  The ledger is the card's, so it raises on the CPU, as
    `memory_record` does; it raises `analysis.audit.AuditUnavailable`
    unless 4 ranks run."""
    from go_avalanche_tpu_torch import parallel
    from go_avalanche_tpu_torch.analysis import audit, drift
    from go_avalanche_tpu_torch.models.avalanche import _device

    dev = _device(device)
    if dev.type != "cuda":
        raise ValueError(f"sharded_driver_records reads the card's "
                         f"allocator; asked for {dev}")
    out: Dict[str, Dict] = {}
    for name, case in parallel.footprint_cases(drivers, dev).items():
        step = case.program_builder(case.mesh)
        # a copy, so that no leaf of the block is a view of the global
        # state (the ledger counts whole storages)
        block = audit.copy_state(case.shard(case.state, case.mesh))
        out[name] = {
            "record": memory_record(lambda b: step(b)[0], block),
            "footprint": footprint(case.state, case.specs, case.mesh),
            "histogram": drift.op_histogram(lambda b: step(b)[0], block),
        }
    return out
