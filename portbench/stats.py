"""The benchmark's arithmetic on counted and timed samples."""

from __future__ import annotations

import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: int) -> float:
    """The `q`-th percentile (1..99) of every value, interpolated
    between the two nearest order statistics
    (`statistics.quantiles(..., method="inclusive")`)."""
    if len(values) < 2:
        raise ValueError(f"a percentile needs two samples, got {len(values)}")
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def round_notes(round_s: Sequence[float],
                enqueue_s: Sequence[float] = ()) -> dict:
    """The window's round times for the notes: the median, the median of
    each quarter of the window in order (drift within a run), and the
    median host time to enqueue a round, up to its read."""
    if not round_s:
        return {}
    q = max(1, len(round_s) // 4)
    out = {"round_ms_median": 1e3 * statistics.median(round_s),
           "round_ms_median_by_quarter": [
               1e3 * statistics.median(round_s[i:i + q])
               for i in range(0, q * 4, q) if round_s[i:i + q]]}
    if enqueue_s:
        out["enqueue_ms_median"] = 1e3 * statistics.median(enqueue_s)
    return out
