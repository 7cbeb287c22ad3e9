"""On-device trace plane — `go_avalanche_tpu/obs/trace.py`: per-round
telemetry as a memory write, not a host round trip.

  * `TraceBuffer` — an int32 ``[S, M]`` plane carried in the sim state
    (S = ceil(rounds / stride) slots, M = the flattened telemetry's
    column count) and an int32 write cursor, with the column manifest
    (ordered ``(name, kind)`` pairs, kind ``"i"`` or ``"f"``) and the
    stride as plain Python values.  A fleet stacks its trials' buffers
    into ``[F, S, M]`` with an ``[F]`` cursor.
  * `write_round` — called by every round and scheduler step after its
    telemetry is assembled.  `cfg.trace_every == 0` (default) or a None
    buffer returns before any device work.  Otherwise, under the
    profiler span ``trace_write``, the round's row (or, off the stride,
    the slot's own) lands at slot ``min(round // stride, S - 1)`` by one
    `index_copy` and the cursor adds the gate ``round % stride == 0``:
    no branch, so nothing is read back in the round loop.  The clamp is the
    reference's (`lax.dynamic_update_slice` clamps its start), and it
    keeps a run past the buffer's horizon from indexing out of range
    on the card, where that would be a device-side assert.
  * decode — `trace_records` / `fleet_trace_records` rebuild the JSONL
    record schema on the host, rows ordered by construction, and
    `write_trace` streams a buffer through the one JSONL writer
    (`MetricsSink.write_stacked`), so trace-plane files and tap files
    are byte-identical on the same run.  A decode copies the buffer to
    the host once (`sync.to_host`).

Float columns (the node stream's `resident_stake`) are stored bitcast
to int32 and bitcast back at decode, an exact round trip.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from go_avalanche_tpu_torch import sync
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.obs.sink import (_flatten_telemetry, _scalar,
                                             decode_column, encode_value)

Columns = Tuple[Tuple[str, str], ...]


@dataclasses.dataclass(frozen=True)
class TraceBuffer:
    """The trace plane; a sim-state leaf.  `data` and `cursor` are
    tensors on the state's device, or numpy arrays once decoded on the
    host (a fleet result keeps its buffer there)."""

    data: object       # int32 [S, M] (a fleet's: [F, S, M]); untouched
                       #   slots stay zero (watchdog-checked)
    cursor: object     # int32 — slots written so far ([F] for a fleet)
    columns: Columns   # ordered (name, kind); "i" int32, "f" float32
                       #   stored bitcast
    stride: int        # = cfg.trace_every

    def to(self, device) -> "TraceBuffer":
        """The buffer with its tensors on `device`."""
        return dataclasses.replace(self, data=self.data.to(device),
                                   cursor=self.cursor.to(device))


def enabled(cfg: AvalancheConfig) -> bool:
    """True when the trace plane is configured on."""
    return getattr(cfg, "trace_every", 0) > 0


def slots_for(n_rounds: int, stride: int) -> int:
    """ceil(n_rounds / stride): the rounds ``r`` in ``[0, n_rounds)`` with
    ``r % stride == 0``, exactly the slots a full run writes."""
    return -(-int(n_rounds) // int(stride))


def columns_from_fields(*field_groups: Sequence[str],
                        floats: frozenset = frozenset()) -> Columns:
    """A column manifest from ordered field-name groups (the telemetry
    NamedTuples' `_fields`, in the order `_flatten_telemetry` flattens
    them).  Names in `floats` get kind ``"f"``; every other is an int32
    counter."""
    return tuple((name, "f" if name in floats else "i")
                 for fields in field_groups for name in fields)


def alloc(cfg: AvalancheConfig, n_rounds: int, columns: Columns,
          device) -> Optional[TraceBuffer]:
    """A zeroed buffer on `device` for an `n_rounds`-horizon run; None
    when `cfg.trace_every == 0`.  Refuses the inert ``rounds < stride``
    combination: such a run would only ever sample round 0 while its tag
    claims a strided trace."""
    if not enabled(cfg):
        return None
    stride = cfg.trace_every
    if n_rounds < stride:
        raise ValueError(
            f"trace_every={stride} exceeds the run horizon "
            f"({n_rounds} rounds): only round 0 would ever be sampled "
            f"— lower the stride or lengthen the run")
    s = slots_for(n_rounds, stride)
    return TraceBuffer(
        data=torch.zeros((s, len(columns)), dtype=torch.int32,
                         device=device),
        cursor=torch.zeros((), dtype=torch.int32, device=device),
        columns=tuple(columns),
        stride=int(stride),
    )


def write_round(buf: Optional[TraceBuffer], cfg: AvalancheConfig, round_,
                telemetry) -> Optional[TraceBuffer]:
    """The trace tap (module docstring).  Returns `buf` untouched when it
    is None or `cfg.trace_every == 0`: a scheduler silences its inner
    round's write by passing `config.inner_round_config(cfg)`.  The
    column manifest is checked here, so telemetry whose flattened fields
    drift from it fails at the first write, not at decode."""
    if buf is None or not enabled(cfg):
        return buf
    items = list(_flatten_telemetry(telemetry, {}).items())
    names = tuple(name for name, _ in items)
    if names != tuple(name for name, _ in buf.columns):
        raise ValueError(
            f"trace column manifest mismatch: buffer carries "
            f"{[n for n, _ in buf.columns]}, telemetry flattens to "
            f"{list(names)} — allocate the buffer from the same "
            f"telemetry schema the step emits")
    dev = buf.data.device
    with torch.profiler.record_function("trace_write"):
        cells = []
        for (name, kind), (_, v) in zip(buf.columns, items):
            v = torch.as_tensor(v, device=dev)
            if kind == "i" and v.is_floating_point():
                raise ValueError(
                    f"trace column {name!r} is declared an int32 counter "
                    f"but the telemetry leaf is "
                    f"{str(v.dtype).removeprefix('torch.')}-valued — "
                    f"declare it in the manifest's float set or the "
                    f"decode would misread its bits")
            cells.append(encode_value(v, kind))
        row = torch.stack(cells)[None, :]                    # [1, M]
        round_ = torch.as_tensor(round_, device=dev).to(torch.int32)
        slot = torch.div(round_, buf.stride, rounding_mode="floor").clamp(
            max=buf.data.shape[0] - 1).reshape(1).long()
        gate = torch.remainder(round_, buf.stride) == 0
        row = torch.where(gate, row, buf.data.index_select(0, slot))
        return dataclasses.replace(
            buf, data=buf.data.index_copy(0, slot, row),
            cursor=buf.cursor + gate.to(torch.int32))


# ------------------------------------------------------------- decode


def _decode_columns(data: np.ndarray, columns: Columns) -> Dict:
    """int32 slot rows -> {name: numpy column}, float columns bitcast
    back to float32."""
    return {name: decode_column(data[..., j], kind)
            for j, (name, kind) in enumerate(columns)}


def to_host(buf: TraceBuffer) -> TraceBuffer:
    """The buffer with numpy data and cursor: one copy to the host for
    tensors, none for a buffer that is there already."""
    if not isinstance(buf.data, torch.Tensor):
        return dataclasses.replace(buf, data=np.asarray(buf.data),
                                   cursor=np.asarray(buf.cursor))
    flat = sync.to_host(torch.cat([buf.data.reshape(-1),
                                   buf.cursor.reshape(-1).to(torch.int32)]))
    n = buf.data.numel()
    return dataclasses.replace(
        buf, data=flat[:n].reshape(tuple(buf.data.shape)),
        cursor=flat[n:].reshape(tuple(buf.cursor.shape)))


def stacked_telemetry(buf: TraceBuffer):
    """A single sim's buffer as a flat telemetry-shaped namedtuple of host
    arrays, one entry per written slot in slot order: the tree
    `MetricsSink.write_stacked` streams."""
    host = to_host(buf)
    if host.data.ndim != 2:
        raise ValueError(
            f"stacked_telemetry decodes a single sim's [S, M] buffer; "
            f"got a {host.data.shape} plane (fleet traces decode via "
            f"fleet_trace_records)")
    n = int(host.cursor)
    cols = _decode_columns(host.data[:n], host.columns)
    tel_cls = collections.namedtuple("TraceTelemetry",
                                     [n_ for n_, _ in host.columns])
    return tel_cls(**cols)


def write_trace(sink, buf: TraceBuffer) -> int:
    """Stream a decoded buffer to a `MetricsSink` through the one JSONL
    writer: one line per written slot, stamped with its round
    (``slot * stride``).  Returns lines written."""
    return sink.write_stacked(stacked_telemetry(buf),
                              round_stride=buf.stride)


def trace_records(buf: TraceBuffer) -> List[Dict]:
    """A single sim's buffer as flight-recorder records (the JSONL dict
    schema, ordered by round), as `obs.recovery.check_recovery` reads
    them."""
    host = to_host(buf)
    if host.data.ndim != 2:
        raise ValueError(
            f"trace_records decodes a single sim's [S, M] buffer; got "
            f"a {host.data.shape} plane (fleet traces decode via "
            f"fleet_trace_records)")
    n = int(host.cursor)
    cols = _decode_columns(host.data[:n], host.columns)
    return [{"round": s * host.stride,
             **{name: _scalar(col[s]) for name, col in cols.items()}}
            for s in range(n)]


def fleet_trace_records(buf: TraceBuffer) -> List[Dict]:
    """A fleet's ``[F, S, M]`` buffer as fleet-stacked records: one dict
    per round whose values are per-trial lists (the format
    `obs.recovery.check_recovery` gives per-trial verdicts on)."""
    host = to_host(buf)
    if host.data.ndim != 3:
        raise ValueError(
            f"fleet_trace_records decodes an [F, S, M] fleet buffer; "
            f"got a {host.data.shape} plane (single-sim traces decode "
            f"via trace_records)")
    cursors = set(int(c) for c in np.asarray(host.cursor).reshape(-1))
    if len(cursors) != 1:
        raise ValueError(
            f"fleet trials wrote different slot counts {sorted(cursors)} "
            f"— one fleet runs one horizon, so a divergent cursor means "
            f"a corrupted trace")
    n = cursors.pop()
    cols = _decode_columns(host.data[:, :n, :], host.columns)
    return [{"round": s * host.stride,
             **{name: [_scalar(col[f, s]) for f in range(col.shape[0])]
                for name, col in cols.items()}}
            for s in range(n)]


def stack_fleet(bufs: Sequence[TraceBuffer]) -> TraceBuffer:
    """Per-trial ``[S, M]`` buffers stacked to one ``[F, S, M]`` buffer
    with an ``[F]`` cursor (the reference's vmapped layout)."""
    return dataclasses.replace(
        bufs[0], data=torch.stack([b.data for b in bufs]),
        cursor=torch.stack([b.cursor for b in bufs]))

