"""From a `torch.profiler` trace to the numbers the per-layer metrics
read: device time under each span, device time of each kernel, the
device's busy time as the union of its operations' intervals, and the
idle gaps between them by the host span that was open.

A frozen copy of the attribution arithmetic of the program's
`round_profile.py`: a span's device time is the device time of the
operations launched inside it, and a kernel launched through ctypes is
also read by its own symbol.  It reads the profiler's raw events, since
building the profiler's event tree takes tens of seconds at the
benchmark's sizes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# The benchmark's own host spans, opened around the calls it makes in a
# traced window; the program's spans come from its `annotate` calls.
HARNESS_SPANS = ("portbench.init", "portbench.round", "portbench.read",
                 "portbench.snapshot")


@dataclass
class TraceSlice:
    """What a traced window gives the per-layer metrics."""

    rounds: int                 # rounds (or steps) in the window
    polls: List[int]            # polled records of each round
    nodes: int
    card: str
    window_s: float             # host seconds from start to synchronise
    records: int = 0            # records an ingest launch covers (N x T)
    pace_s: Optional[float] = None   # the same work's wall time untraced
    busy_s: float = 0.0         # union of device intervals
    span_ms: Dict[str, float] = field(default_factory=dict)
    kernel_ms: Dict[str, float] = field(default_factory=dict)
    kernel_launches: Dict[str, int] = field(default_factory=dict)
    init_ms: List[float] = field(default_factory=list)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def _is_device(event) -> bool:
    from torch.autograd import DeviceType
    return (event.device_type == DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


def union_seconds(intervals: np.ndarray) -> Tuple[float, np.ndarray]:
    """Total length of the union of ``[start, end)`` rows (microseconds)
    in seconds, and the merged intervals, sorted."""
    if len(intervals) == 0:
        return 0.0, np.zeros((0, 2))
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    merged = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    m = np.asarray(merged, dtype=np.float64)
    return float((m[:, 1] - m[:, 0]).sum()) / 1e6, m


def gaps_by_span(merged: np.ndarray, spans: List[Tuple[str, float, float]],
                 ) -> List[Tuple[str, float]]:
    """Seconds of device idle between merged busy intervals, summed by
    the innermost host span open at each gap's middle ("host" where
    none is), longest first."""
    if len(merged) < 2:
        return []
    starts, ends = merged[1:, 0], merged[:-1, 1]
    length = starts - ends
    mid = (starts + ends) / 2
    names = np.full(len(mid), "host", dtype=object)
    best = np.full(len(mid), np.inf)
    for name, s, e in spans:
        inside = (mid >= s) & (mid < e) & ((e - s) < best)
        names[inside] = name
        best[inside] = e - s
    out: Dict[str, float] = {}
    for name, gap in zip(names, length):
        out[name] = out.get(name, 0.0) + float(gap) / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])


def reduce(prof, span_names: Tuple[str, ...], kernels: Tuple[str, ...],
           slice_: TraceSlice) -> TraceSlice:
    """Fill `slice_` from the profiler `prof`, in one pass over its raw
    events: device ms under each span of `span_names`, device ms and
    launches of each kernel whose symbol holds a part in `kernels`, the
    busy union, the ten device operations with most time, the ten
    longest idle stretches by host span.

    A device operation belongs to a span when the host operation that
    launched it (its linked correlation id) started inside the span's
    host range."""
    from torch.autograd import DeviceType

    launched_at = {}            # host op correlation id -> start (us)
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type()
        if kind == DeviceType.CPU:
            if e.linked_correlation_id() == 0:
                launched_at[e.correlation_id()] = e.start_ns() / 1e3
                name = e.name()
                if name in span_names or name in HARNESS_SPANS:
                    host.append((name, e.start_ns() / 1e3, e.end_ns() / 1e3))
        elif kind == DeviceType.CUDA and not e.is_user_annotation():
            device.append((e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3,
                           e.linked_correlation_id()))

    by_name: Dict[str, float] = {}
    for name, start, end, _ in device:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        for part in kernels:
            if part in name:
                slice_.kernel_ms[part] = (slice_.kernel_ms.get(part, 0.0)
                                          + (end - start) / 1e3)
                slice_.kernel_launches[part] = (
                    slice_.kernel_launches.get(part, 0) + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    slice_.device_ops = [(name[:120], us / 1e6) for name, us in top]

    launch = np.asarray([launched_at.get(c, np.nan) for *_, c in device],
                        dtype=np.float64)
    took = np.asarray([end - start for _, start, end, _ in device],
                      dtype=np.float64)
    known = ~np.isnan(launch)
    order = np.argsort(launch[known], kind="stable")
    at = launch[known][order]
    cum = np.concatenate([[0.0], np.cumsum(took[known][order])])
    for name, start, end in host:
        if name in span_names:
            lo, hi = np.searchsorted(at, [start, end], side="left")
            slice_.span_ms[name] = (slice_.span_ms.get(name, 0.0)
                                    + (cum[hi] - cum[lo]) / 1e3)

    slice_.busy_s, merged = union_seconds(np.asarray(
        [(s, e) for _, s, e, _ in device], dtype=np.float64).reshape(-1, 2))
    slice_.idle_gaps = gaps_by_span(merged, host)[:10]
    return slice_


def per_round(slice_: TraceSlice, span: str) -> Optional[float]:
    """Device ms per round under `span`, or None where no device time was
    read under it."""
    ms = slice_.span_ms.get(span, 0.0)
    if ms <= 0 or slice_.rounds == 0:
        return None
    return ms / slice_.rounds
