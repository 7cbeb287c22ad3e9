"""Finality statistics, status-update extraction, throughput —
`go_avalanche_tpu/utils/metrics.py`.

Everything here consumes a run's telemetry or state and reduces it on
the host; nothing runs in the round loop.  A tensor argument comes to the
host in one copy (`sync.to_host`); numpy arguments are used as they are.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from go_avalanche_tpu_torch import sync
from go_avalanche_tpu_torch.config import AvalancheConfig, DEFAULT_CONFIG
from go_avalanche_tpu_torch.obs.sink import host_columns
from go_avalanche_tpu_torch.ops import voterecord as vr
from go_avalanche_tpu_torch.types import Status, StatusUpdate


def _np(x) -> np.ndarray:
    return sync.to_host(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def rounds_to_finality(finalized_at) -> Dict[str, float]:
    """Summary statistics of the `finalized_at` plane (-1 = never): min /
    mean / median / p90 / max rounds until finalization, plus the
    unfinalized fraction."""
    if finalized_at is None:
        raise ValueError(
            "finalized_at is None: the state was built with "
            "track_finality=False; per-(node,tx) finality stats need "
            "init(track_finality=True) (streaming paths record latency "
            "per set/tx in their output planes instead)")
    fat = _np(finalized_at).ravel()
    done = fat[fat >= 0]
    out = {"unfinalized_fraction": float((fat < 0).mean())}
    if done.size:
        out.update(
            min=float(done.min()),
            mean=float(done.mean()),
            median=float(np.median(done)),
            p90=float(np.percentile(done, 90)),
            max=float(done.max()),
        )
    return out


def finality_curve(finalizations, population: int) -> np.ndarray:
    """Cumulative finalized fraction per round from stacked telemetry: the
    rounds-to-finality curve."""
    f = _np(finalizations).astype(np.float64)
    return np.cumsum(f) / float(population)


def safety_failure(decided, value, honest=None) -> bool:
    """Did two honest nodes irreversibly decide opposite values?
    `decided` is a bool ``[N]`` plane of irreversible decisions, `value`
    the decided color, `honest` an optional bool ``[N]`` mask."""
    decided = _np(decided).astype(bool).ravel()
    value = _np(value).astype(bool).ravel()
    if honest is not None:
        decided = decided & _np(honest).astype(bool).ravel()
    dv = value[decided]
    return bool(dv.size and dv.any() and not dv.all())


def status_plane(confidence, cfg: AvalancheConfig = DEFAULT_CONFIG):
    """Per-record Status codes (int8 plane), on the records' device."""
    return vr.status(confidence, cfg)


def extract_status_updates(
    changed,
    confidence,
    cfg: AvalancheConfig = DEFAULT_CONFIG,
) -> List[StatusUpdate]:
    """StatusUpdate list for one node's row (or any 1-D slice): the
    records whose `changed` flag fired, with their new status.  Target
    "hash" is the array index."""
    changed = _np(changed).ravel()
    codes = _np(status_plane(torch.as_tensor(confidence), cfg)).ravel()
    return [StatusUpdate(int(i), Status(int(codes[i])))
            for i in np.nonzero(changed)[0]]


def votes_per_second(total_votes: int, seconds: float) -> float:
    return total_votes / seconds if seconds > 0 else float("inf")


def telemetry_summary(telemetry) -> Dict[str, int]:
    """Sum stacked per-round telemetry into run totals: one copy of the
    whole tuple to the host, then host sums per field."""
    host = host_columns({f: getattr(telemetry, f)
                          for f in telemetry._fields})
    return {field: int(np.asarray(col).sum()) for field, col in host.items()}
