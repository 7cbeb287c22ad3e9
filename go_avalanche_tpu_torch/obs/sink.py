"""JSONL metrics sink and the in-loop metrics tap —
`go_avalanche_tpu/obs/sink.py`.

Two feeding modes, one file format:

  * host-side — `MetricsSink.write_stacked(telemetry)` streams the
    stacked telemetry a `run_scan` returns: one copy of every leaf to
    the host, then one JSON line per (strided) round;
  * in-loop — `emit_round(cfg, round_, telemetry)` is called by every
    `round_step` and scheduler step.  With `cfg.metrics_every == 0`
    (default), or with no active sink, it returns before any device
    work.  Otherwise, under the profiler span ``metrics_tap``, it
    stacks the round's flattened row on the device
    (floats bitcast to int32, as the trace plane stores them), with the
    round and the device-side gate ``round % metrics_every == 0``, and
    appends it to the active sink's pending rows.  Nothing is read back
    in the round loop: the sink drains its pending rows in one copy to
    the host (counted in `sync.reads`) when it is flushed or closed, or
    when `metrics_sink` exits, and writes the gated rows in the order
    they were emitted.  The reference reaches the same file through an
    unordered `io_callback`; the drain takes the place of its
    `effects_barrier`.

The tap writes to the innermost active sink (`metrics_sink`) at the time
of the round, so a run never captures a file path.  With no active sink
the record is dropped, as the reference drops it.
"""

from __future__ import annotations

import contextlib
import json
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from go_avalanche_tpu_torch import sync

_ACTIVE: list = []   # stack of MetricsSink; the innermost (last) receives


def _flatten_telemetry(tel, out: dict) -> dict:
    """Flatten (possibly nested) telemetry NamedTuples into one flat dict
    by leaf field name: `BacklogTelemetry.round` (a SimTelemetry)
    contributes its own field names, not a 'round' key.  None fields
    (planes the run does not compute, e.g. `BacklogTelemetry.traffic`
    with arrivals off) are skipped."""
    for name in tel._fields:
        v = getattr(tel, name)
        if v is None:
            continue
        if hasattr(v, "_fields"):
            _flatten_telemetry(v, out)
        else:
            out[name] = v
    return out


def encode_value(v: torch.Tensor, kind: str) -> torch.Tensor:
    """Telemetry values as int32 cells, any shape: a float ("f") bitcast
    from float32, a counter ("i") cast."""
    if kind == "f":
        return v.to(torch.float32).view(torch.int32)
    return v.to(torch.int32)


def decode_column(cells, kind: str) -> np.ndarray:
    """Host int32 cells back to their values (`encode_value`'s inverse):
    float columns bitcast to float32, counters as they are."""
    cells = np.asarray(cells, np.int32)
    return cells.view(np.float32) if kind == "f" else cells


class MetricsSink:
    """Append-only JSONL writer; one JSON object per line.

    `tag` (see `obs.tags.config_tag`) is stamped into every record when
    non-empty.  Thread-safe.  Opening truncates: one file is one run's
    trace.  Rows of the in-loop tap wait on the device in `_pending`
    until `flush`, `close` or the end of `metrics_sink`.
    """

    def __init__(self, path, tag: str = ""):
        self.path = Path(path)
        self.tag = tag
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "w", encoding="utf-8")
        self._lock = threading.Lock()
        self._pending: List[Tuple[tuple, torch.Tensor]] = []
        self.records_written = 0

    def write(self, record: dict) -> None:
        if self.tag:
            record = {**record, "tag": self.tag}
        line = json.dumps(record, sort_keys=True)
        with self._lock:
            self._fh.write(line + "\n")
            self.records_written += 1

    def write_stacked(self, telemetry, every: int = 1,
                      start_round: int = 0, round_stride: int = 1) -> int:
        """Stream a `run_scan`'s stacked telemetry: one copy of the whole
        tree to the host (none when its leaves are numpy already), then
        one line per `every`-th round.  Returns the number of records
        written.

        `round_stride` maps entry index -> round number (``round =
        start_round + index * round_stride``): 1 for per-round stacks,
        the trace stride for a decoded trace-plane buffer
        (`obs.trace.write_trace`).
        """
        if every < 1:
            raise ValueError("every must be >= 1")
        if round_stride < 1:
            raise ValueError("round_stride must be >= 1")
        flat = host_columns(_flatten_telemetry(telemetry, {}))
        n = int(next(iter(flat.values())).shape[0])
        wrote = 0
        for r in range(0, n, every):
            self.write({"round": start_round + r * round_stride,
                        **{k: _scalar(v[r]) for k, v in
                           flat.items()}})
            wrote += 1
        return wrote

    def enqueue(self, columns: tuple, row: torch.Tensor) -> None:
        """Hold one tap row ``[round, gate, cells...]`` (int32, on its
        device) until the next drain; `columns` are the cells' ordered
        ``(name, kind)`` pairs."""
        with self._lock:
            self._pending.append((columns, row))

    def drain(self) -> int:
        """Write the pending tap rows whose gate is set, in the order they
        were emitted, after one copy of all of them to the host.  Returns
        the records written."""
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return 0
        host = sync.to_host(torch.cat([row for _, row in pending]))
        wrote, off = 0, 0
        for columns, row in pending:
            cells = host[off:off + row.shape[0]]
            off += row.shape[0]
            if not cells[1]:
                continue
            self.write({"round": int(cells[0]),
                        **{name: _scalar(decode_column(c, kind))
                           for (name, kind), c in zip(columns, cells[2:])}})
            wrote += 1
        return wrote

    def flush(self) -> None:
        self.drain()
        with self._lock:
            self._fh.flush()

    def close(self) -> None:
        self.drain()
        with self._lock:
            self._fh.close()


def host_columns(flat: dict) -> dict:
    """{name: numpy column} of a flat telemetry dict; tensor leaves come
    over in one copy (floats bitcast through int32 on the way)."""
    tensors = {k: v for k, v in flat.items() if isinstance(v, torch.Tensor)}
    if not tensors:
        return flat
    kinds = {k: "f" if v.is_floating_point() else "i"
             for k, v in tensors.items()}
    host = sync.to_host(torch.stack([encode_value(v, kinds[k])
                                     for k, v in tensors.items()]))
    out = dict(flat)
    for i, k in enumerate(tensors):
        out[k] = decode_column(host[i], kinds[k])
    return out


@contextlib.contextmanager
def metrics_sink(path, tag: str = "") -> Iterator[MetricsSink]:
    """Open a sink and make it the active receiver of the in-loop tap for
    the duration of the block; its pending rows drain on the way out."""
    sink = MetricsSink(path, tag=tag)
    _ACTIVE.append(sink)
    try:
        yield sink
    finally:
        _ACTIVE.remove(sink)
        sink.close()


def active_sink() -> Optional[MetricsSink]:
    return _ACTIVE[-1] if _ACTIVE else None


def _scalar(a):
    """JSON-ready Python scalar of a numpy value: floats stay floats (the
    node stream's `resident_stake` fraction), every integer or bool
    counter an int."""
    a = np.asarray(a)
    return float(a) if np.issubdtype(a.dtype, np.floating) else int(a)


def emit_round(cfg, round_, telemetry) -> None:
    """The in-loop telemetry tap (call from a round or scheduler step
    after the round's telemetry is assembled; module docstring).  Returns
    before any device work when `cfg.metrics_every == 0` or no sink is
    active."""
    every = getattr(cfg, "metrics_every", 0)
    sink = active_sink()
    if every <= 0 or sink is None:
        return
    with torch.profiler.record_function("metrics_tap"):
        flat = _flatten_telemetry(telemetry, {})
        round_ = torch.as_tensor(round_)
        columns, cells = [], []
        for name, v in flat.items():
            v = torch.as_tensor(v, device=round_.device)
            kind = "f" if v.is_floating_point() else "i"
            columns.append((name, kind))
            cells.append(encode_value(v, kind))
        gate = torch.remainder(round_, every) == 0
        row = torch.stack([round_.to(torch.int32), gate.to(torch.int32),
                           *cells])
        sink.enqueue(tuple(columns), row)
