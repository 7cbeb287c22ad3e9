"""Tracing, phase timers and determinism auditing — the port's
`go_avalanche_tpu/utils/tracing.py`.

  * `trace(dir)`        — a `torch.profiler` trace of a whole block (a
                          Chrome trace per run, as
                          `tensorboard_trace_handler` writes it);
  * `annotate(name)`    — a named phase span: `torch.profiler.
                          record_function` under the profiler, a wall
                          timer under `collect_phase_times`.  Names come
                          from `obs/tags.PHASE_SPANS` (the reference's)
                          and `obs/tags.PORT_SPANS` (the port's own);
  * `TelemetryRecorder` — accumulates per-round telemetry on the device
                          and derives the run's totals and votes/s on
                          the host, in the reference's dtypes;
  * `determinism_audit` — replays a step and compares every output leaf
                          byte for byte.

The reference's device-time harvest (`start_server`,
`xplane_op_durations`, `hlo_phase_map`, `device_phase_times`) reads
XLA's XPlane protobufs and compiled HLO, which the port has none of: its
device time per span comes from `round_profile.py`, which joins the
`torch.profiler` kernel events to these spans.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

# Active `collect_phase_times` accumulator, or None (the default: spans
# are profiler ranges only).  Module-level, as the reference's: the
# annotated code needs no handle to the collector.
_PHASE_SINK: Optional[Dict[str, float]] = None


@contextlib.contextmanager
def trace(log_dir: str, device="cuda") -> Iterator[None]:
    """A `torch.profiler` trace of the enclosed block into `log_dir`
    (CUDA activity too when `device` is a CUDA device) — the reference's
    `jax.profiler` trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)):
        yield


def annotate(name: str):
    """A named phase span (a context manager): a profiler range, or a
    wall timer inside `collect_phase_times`.

    `name` must be one of `obs/tags.PHASE_SPANS` or `PORT_SPANS`: the
    span strings are the join key between the profiler timeline,
    `round_profile.py`'s per-span device time and the wall timers, so an
    ad-hoc spelling would mint a phase row nothing else joins against.
    """
    # Imported here: obs/ imports this module for its own spans.
    from go_avalanche_tpu_torch.obs.tags import PHASE_SPANS, PORT_SPANS

    if name not in PHASE_SPANS and name not in PORT_SPANS:
        raise ValueError(
            f"unknown phase span {name!r}: annotate() names are the "
            f"canonical obs.tags.PHASE_SPANS "
            f"({', '.join(PHASE_SPANS)}) — register a new phase there "
            f"(one spelling) before annotating with it")
    if _PHASE_SINK is not None:
        return _TimedPhase(name)
    return torch.profiler.record_function(name)


def _quiesce() -> None:
    """Wait for the card's queue (nothing to wait for on the CPU): a
    span's wall time must not bleed into whichever span reads a result
    first."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _TimedPhase:
    """annotate()'s span under `collect_phase_times`: quiesce, time,
    accumulate."""

    def __init__(self, name: str) -> None:
        self._name = name

    def __enter__(self) -> "_TimedPhase":
        _quiesce()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        _quiesce()
        if _PHASE_SINK is not None:
            dt = time.perf_counter() - self._t0
            _PHASE_SINK[self._name] = _PHASE_SINK.get(self._name, 0.0) + dt
        return False


@contextlib.contextmanager
def collect_phase_times() -> Iterator[Dict[str, float]]:
    """Collect wall seconds per `annotate` span for the enclosed block.

    Yields the accumulating ``{span name: seconds}`` dict; nesting
    restores the outer collector on exit.  Each span boundary waits for
    the card, so the spans time the device work they launched.
    """
    global _PHASE_SINK
    prev, _PHASE_SINK = _PHASE_SINK, {}
    try:
        yield _PHASE_SINK
        _quiesce()  # un-annotated tail work completes before the caller's
    finally:        # surrounding timer stops
        _PHASE_SINK = prev


class TelemetryRecorder:
    """Accumulates per-round telemetry tuples and derives run metrics.

    Keep everything on the device during the run (append the stacked
    telemetry of `run_scan` once per chunk, not per round); the copies
    to the host happen at report time.
    """

    def __init__(self) -> None:
        self._chunks: List = []
        self._t0 = time.perf_counter()
        self._elapsed: Optional[float] = None

    def append(self, telemetry) -> None:
        """Add one telemetry tuple — scalar (one round) or stacked."""
        self._chunks.append(telemetry)

    def finish(self) -> None:
        self._elapsed = time.perf_counter() - self._t0

    @property
    def elapsed_s(self) -> float:
        return (self._elapsed if self._elapsed is not None
                else time.perf_counter() - self._t0)

    def _stacked(self) -> Dict[str, np.ndarray]:
        # Each leaf in the reference's dtype (u16 confidence, not int16).
        from go_avalanche_tpu_torch.convert import reference_numpy

        if not self._chunks:
            return {}
        out: Dict[str, List[np.ndarray]] = {}
        for chunk in self._chunks:
            for field in chunk._fields:
                arr = np.atleast_1d(reference_numpy(getattr(chunk, field)))
                out.setdefault(field, []).append(arr)
        return {k: np.concatenate(v) for k, v in out.items()}

    def per_round(self) -> Dict[str, np.ndarray]:
        """Per-round series, one entry per recorded round."""
        return self._stacked()

    def summary(self) -> Dict[str, float]:
        """Run totals plus derived rates (votes/sec is the north star)."""
        series = self._stacked()
        out: Dict[str, float] = {f"total_{k}": float(v.sum())
                                 for k, v in series.items()}
        out["rounds"] = float(len(next(iter(series.values()), [])))
        out["elapsed_s"] = self.elapsed_s
        if "votes_applied" in series and self.elapsed_s > 0:
            out["votes_per_sec"] = out["total_votes_applied"] / self.elapsed_s
        return out


def _leaves_with_paths(tree, path: str = ""):
    """``(keystr path, leaf)`` of every tensor leaf and trace buffer of
    a (nested) tuple / NamedTuple, in field order; a trace buffer is
    one leaf, as `models/avalanche.move_leaves` treats it."""
    from go_avalanche_tpu_torch.obs.trace import TraceBuffer

    if isinstance(tree, (torch.Tensor, TraceBuffer, np.ndarray)):
        yield path, tree
    elif isinstance(tree, tuple):
        names = getattr(tree, "_fields", None)
        for i, x in enumerate(tree):
            yield from _leaves_with_paths(
                x, f"{path}.{names[i]}" if names else f"{path}[{i}]")


def _raw(leaf):
    """(shape, dtype, bytes) of a leaf; a trace buffer's data and cursor
    together, with its columns and stride."""
    from go_avalanche_tpu_torch.obs.trace import TraceBuffer

    if isinstance(leaf, TraceBuffer):
        return (_raw(leaf.data), _raw(leaf.cursor), leaf.columns,
                leaf.stride)
    a = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
         else np.asarray(leaf))
    return a.shape, str(leaf.dtype), a.tobytes()


def determinism_audit(step_fn: Callable, state,
                      n_repeats: int = 2) -> Dict[str, object]:
    """Replay `step_fn(state)` `n_repeats` times; compare outputs byte
    for byte.

    `step_fn` must be pure (state in, state/aux out) — true of every
    simulator step in `models/` and `parallel/`.  Returns a report dict:
    `deterministic` plus the leaf paths that mismatched, if any.
    """
    outputs = [[(p, _raw(x)) for p, x in _leaves_with_paths(step_fn(state))]
               for _ in range(n_repeats)]
    ref = outputs[0]
    mismatched: List[str] = []
    for other in outputs[1:]:
        if [p for p, _ in other] != [p for p, _ in ref]:
            return {"deterministic": False, "mismatches": ["<structure>"]}
        # Raw-bytes compare: bit for bit is the contract, and identical
        # NaNs compare equal.
        mismatched += [p for (p, a), (_, b) in zip(ref, other) if a != b]
    return {"deterministic": not mismatched,
            "mismatches": sorted(set(mismatched))}
