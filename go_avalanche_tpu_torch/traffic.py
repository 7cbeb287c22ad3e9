"""Live-traffic service mode — `go_avalanche_tpu/traffic.py`.

The streaming schedulers (`models/backlog.py`, `models/streaming_dag.py`)
thread a `TrafficState` through their state when `cfg.arrivals_enabled()`:

  * the arrival process: a rate schedule (poisson, bursty or diurnal,
    `schedule_rate`) throttled by working-set occupancy
    (`backpressure_factor`) and realized each round by `prng.poisson`
    from a key folded off the sim's init key (`init_traffic`), so the
    consensus draws never move.  The backlog order is the arrival order:
    an `arrived_idx` watermark advances and admission is gated on it;
  * the per-unit arrival-round plane, from which retiring slots add
    their arrival -> settle latency into a fixed-depth histogram
    (`latency_delta`); `percentile_from_hist` reads exact nearest-rank
    p50 / p99 / p999 from it, and `latency_percentiles_host` rebuilds the
    same numbers from the per-unit outputs on the host.

`arrival_mode="external"` draws nothing: `push_arrivals` feeds it.  With
`arrival_mode="off"` the plane is absent (`init_traffic` returns None).
The diurnal schedule's `sin` is taken in float64 and rounded once, so the
CPU and the card agree; XLA:CPU's float32 `sin` rounds some phases one ulp
the other way (ROADMAP.md Queue 3).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.ops.sampling import cluster_ids

# The arrival stream's key is fold_in(sim init key, this): arrivals never
# perturb the consensus PRNG stream.
_TRAFFIC_FOLD = 0x7AF1C

# The nearest-rank percentile fractions the recorder reads, as exact
# integer (num, den) pairs — p50 / p99 / p999.
PERCENTILES = ((1, 2), (99, 100), (999, 1000))


class TrafficState(NamedTuple):
    """The live-traffic plane of a streaming scheduler's state.  ``B`` is
    the admission-unit count (txs, or conflict sets), ``L`` is
    `cfg.arrival_latency_buckets`."""

    key: torch.Tensor            # int64 [2] — the arrival stream's key
    arrived_idx: torch.Tensor    # int32 — units arrived so far
    arrival_round: torch.Tensor  # int32 [B] — arrival round; -1 = future
    lat_hist: torch.Tensor       # int32 [L] — settled finality latencies


class TrafficTelemetry(NamedTuple):
    """Per-round traffic scalars (int32): the arrival counters plus the
    cumulative finality-latency percentiles (-1 while nothing settled)."""

    arrivals: torch.Tensor
    arrived_total: torch.Tensor
    lat_count: torch.Tensor
    lat_p50: torch.Tensor
    lat_p99: torch.Tensor
    lat_p999: torch.Tensor


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """`value` rounded to a float32 scalar on `like`'s device (a fill,
    not a copy from the host)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def init_traffic(cfg: AvalancheConfig, key: torch.Tensor,
                 n_units: int) -> Optional[TrafficState]:
    """None when arrivals are off, else a fresh plane over `n_units`
    backlog units on the key's device."""
    if not cfg.arrivals_enabled():
        return None
    dev = key.device
    return TrafficState(
        key=prng.fold_in(key, _TRAFFIC_FOLD),
        arrived_idx=torch.zeros((), dtype=torch.int32, device=dev),
        arrival_round=torch.full((n_units,), -1, dtype=torch.int32,
                                 device=dev),
        lat_hist=torch.zeros(cfg.arrival_latency_buckets,
                             dtype=torch.int32, device=dev),
    )


def schedule_rate(cfg: AvalancheConfig,
                  round_: torch.Tensor) -> torch.Tensor:
    """float32 scalar: the schedule's offered rate at `round_` (before
    admission control)."""
    rate = _f32(cfg.arrival_rate, round_)
    if cfg.arrival_mode == "poisson":
        return rate
    if cfg.arrival_mode == "bursty":
        burst_rounds = max(1, int(round(cfg.arrival_duty
                                        * cfg.arrival_period)))
        in_burst = torch.remainder(round_, cfg.arrival_period) < burst_rounds
        return torch.where(in_burst,
                           rate * _f32(cfg.arrival_burst_factor, round_),
                           rate)
    if cfg.arrival_mode == "diurnal":
        phase = (_f32(2.0 * np.pi / cfg.arrival_period, round_)
                 * round_.to(torch.float32))
        sin = torch.sin(phase.double()).float()
        # XLA contracts 1 + depth * sin into one fused multiply-add.
        depth = float(np.float32(cfg.arrival_depth))
        return rate * (depth * sin.double() + 1.0).float()
    # "external": the schedule draws nothing (push_arrivals feeds it).
    return _f32(0.0, round_)


def backpressure_factor(cfg: AvalancheConfig,
                        occupancy_frac: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1]: 1 below the lo occupancy fraction, 0 above hi,
    a linear ramp between; 1 without `cfg.arrival_backpressure`."""
    if cfg.arrival_backpressure is None:
        return _f32(1.0, occupancy_frac)
    lo, hi = cfg.arrival_backpressure
    ramp = ((_f32(hi, occupancy_frac) - occupancy_frac.to(torch.float32))
            / _f32(hi - lo, occupancy_frac))
    return ramp.clamp(0.0, 1.0)


def arrive(traffic: TrafficState, cfg: AvalancheConfig,
           round_: torch.Tensor, occupied: torch.Tensor,
           capacity: int) -> Tuple[TrafficState, torch.Tensor]:
    """One round of the arrival process: draw ``Poisson(schedule *
    backpressure)`` new units, advance the watermark and stamp their
    arrival round.  Returns (new_traffic, arrivals this round, int32).
    `occupied` is the working set's occupied-slot count at step entry,
    `capacity` its slot count."""
    b = traffic.arrival_round.shape[0]
    if cfg.arrival_mode == "external":
        # Pushed arrivals only: no draw, no key use.
        return traffic, torch.zeros((), dtype=torch.int32,
                                    device=round_.device)
    lam = schedule_rate(cfg, round_) * backpressure_factor(
        cfg, occupied.to(torch.float32) / _f32(capacity, occupied))
    if cfg.arrival_cluster_weights is not None:
        # Per-cluster skew: units partition into n_clusters contiguous
        # blocks (the node clusters' partition) and the rate scales by
        # the stream head's region weight.
        wts = torch.tensor(cfg.arrival_cluster_weights, dtype=torch.float32,
                           device=round_.device)
        head = cluster_ids(traffic.arrived_idx.clamp(0, b - 1),
                           cfg.n_clusters, b)
        lam = lam * wts[head.long()]
    key, sub = prng.split(traffic.key)
    n_new = torch.minimum(prng.poisson(sub, lam),
                          b - traffic.arrived_idx)
    return traffic._replace(
        key=key, arrived_idx=traffic.arrived_idx + n_new,
        arrival_round=_stamp(traffic, n_new, round_)), n_new


def _stamp(traffic: TrafficState, count: torch.Tensor,
           round_) -> torch.Tensor:
    """`arrival_round` with the next `count` units stamped `round_`."""
    b = traffic.arrival_round.shape[0]
    pos = torch.arange(b, dtype=torch.int32,
                       device=traffic.arrival_round.device)
    fresh = (pos >= traffic.arrived_idx) & (pos < traffic.arrived_idx
                                            + count)
    return torch.where(fresh, torch.as_tensor(round_).to(
        traffic.arrival_round), traffic.arrival_round)


def push_arrivals(traffic: TrafficState, count, round_) -> TrafficState:
    """Advance the arrival watermark by `count` units arriving now (the
    external load generator's path); composes with any mode."""
    b = traffic.arrival_round.shape[0]
    dev = traffic.arrival_round.device
    count = torch.as_tensor(count).to(dev, torch.int32).clamp_min(0)
    new_idx = (traffic.arrived_idx + count).clamp_max(b)
    return traffic._replace(
        arrived_idx=new_idx,
        arrival_round=_stamp(traffic, new_idx - traffic.arrived_idx,
                             torch.as_tensor(round_).to(dev, torch.int32)))


def latency_delta(cfg: AvalancheConfig, latency: torch.Tensor,
                  count: torch.Tensor) -> torch.Tensor:
    """int32 [L] histogram increment: `count[i]` samples at bucket
    ``clamp(latency[i], 0, L-1)`` wherever ``count[i] > 0``."""
    buckets = cfg.arrival_latency_buckets
    idx = latency.clamp(0, buckets - 1).long()
    add = torch.where(count > 0, count, 0).to(torch.int32)
    return torch.zeros(buckets, dtype=torch.int32,
                       device=latency.device).scatter_add_(0, idx, add)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 two's complement (jnp int32 math)."""
    return ((x + (1 << 31)) % (1 << 32)) - (1 << 31)


def percentile_from_hist(hist: torch.Tensor, q_num: int,
                         q_den: int) -> torch.Tensor:
    """int32 scalar: the exact nearest-rank q-th percentile of the
    samples in `hist` — the smallest bucket v with ``cumsum(hist)[v] >=
    ceil(q * total)`` in the reference's int32 arithmetic; -1 while the
    histogram is empty."""
    total = _wrap32(hist.to(torch.int64).sum())
    target = torch.div(_wrap32(total * q_num + (q_den - 1)), q_den,
                       rounding_mode="floor")
    cum = _wrap32(torch.cumsum(hist.to(torch.int64), dim=0))
    idx = torch.argmax((cum >= target).to(torch.int32)).to(torch.int32)
    return torch.where(total > 0, idx, -1).to(torch.int32)


def traffic_telemetry(traffic: TrafficState,
                      arrivals: torch.Tensor) -> TrafficTelemetry:
    """The per-round traffic scalars (percentiles over every unit settled
    so far)."""
    (p50n, p50d), (p99n, p99d), (p999n, p999d) = PERCENTILES
    hist = traffic.lat_hist
    return TrafficTelemetry(
        arrivals=arrivals.to(torch.int32),
        arrived_total=traffic.arrived_idx,
        lat_count=_wrap32(hist.to(torch.int64).sum()).to(torch.int32),
        lat_p50=percentile_from_hist(hist, p50n, p50d),
        lat_p99=percentile_from_hist(hist, p99n, p99d),
        lat_p999=percentile_from_hist(hist, p999n, p999d),
    )


def latency_percentiles(traffic: Optional[TrafficState]) -> dict:
    """Host digest of a final state's traffic plane: arrived total,
    settled sample count and p50/p99/p999; {} when the plane is
    absent."""
    if traffic is None:
        return {}
    tel = traffic_telemetry(traffic, torch.zeros(
        (), dtype=torch.int32, device=traffic.lat_hist.device))
    return {
        "arrived_total": int(tel.arrived_total),
        "finality_latency_count": int(tel.lat_count),
        "finality_latency_p50": int(tel.lat_p50),
        "finality_latency_p99": int(tel.lat_p99),
        "finality_latency_p999": int(tel.lat_p999),
    }


def latency_percentiles_host(arrival_round, settle_round, weights,
                             buckets: int) -> dict:
    """The host twin of the in-graph percentiles: rebuild the clamped
    histogram from per-unit outputs (numpy) and apply the same integer
    nearest-rank formula.  `weights[i]` is unit i's sample count (0 =
    not settled; a conflict set counts one sample per valid member)."""
    arrival = np.asarray(arrival_round).reshape(-1)
    settle = np.asarray(settle_round).reshape(-1)
    w = np.asarray(weights).astype(np.int64).reshape(-1)
    mask = w > 0
    lat = np.clip(settle[mask] - arrival[mask], 0, buckets - 1)
    hist = np.zeros((buckets,), np.int64)
    np.add.at(hist, lat.astype(np.int64), w[mask])
    total = int(hist.sum())
    cum = np.cumsum(hist)
    out = {"finality_latency_count": total}
    for name, (num, den) in zip(("p50", "p99", "p999"), PERCENTILES):
        if total == 0:
            out[f"finality_latency_{name}"] = -1
            continue
        target = (total * num + (den - 1)) // den
        out[f"finality_latency_{name}"] = int(np.argmax(cum >= target))
    return out
