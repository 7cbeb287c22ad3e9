"""Recovery-curve checker — `go_avalanche_tpu/obs/recovery.py`, host
only: machine-verify "does the network recover, and how fast" from a
flight-recorder trace.

Given the config that ran (the fault script is static, so the schedule
is known) and the per-round trace the flight recorder wrote (the metrics
tap's JSONL, `MetricsSink.write_stacked` of a `run_scan`'s telemetry, or
a trace-plane buffer), it verifies the three invariants every healing
network must satisfy:

  1. cut accounting — every fault-blocked draw is reaped exactly once,
     `timeout_rounds()` later: per round,
     ``expiries[r] == partition_blocked[r - timeout]``.  The equality is
     strict when cuts are the only expiry source (bounded latency modes
     whose worst case, base max plus the tallest active spike, stays
     below the timeout); other configs get the one-sided ``>=`` check;
  2. occupancy recovery — the ring's fill returns to its pre-fault
     baseline within ``timeout_rounds() + slack`` rounds of each heal;
  3. finality monotonicity — per-round `finalizations` >= 0 everywhere.

Traces must be stride-1 and are re-sorted by `round`.

    from go_avalanche_tpu_torch.obs import recovery
    report = recovery.check_recovery(cfg, "trace.jsonl")   # raises
    report = recovery.verify_recovery(cfg, records)        # inspects
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

from go_avalanche_tpu_torch.config import AvalancheConfig


class RecoveryViolation(AssertionError):
    """A recovery invariant of the fault script failed on the trace."""


def _ndim(x) -> int:
    """ndim of a tensor or a numpy array."""
    return len(getattr(x, "shape", ()))


@dataclasses.dataclass
class RecoveryReport:
    """Outcome of `verify_recovery`: the machine-checked verdict plus
    the recovery curve's summary numbers (per merged cut window)."""

    ok: bool
    violations: List[str]
    # One dict per MERGED cut window (overlapping cut events — e.g. a
    # cascading two-region outage — verify as one composite outage):
    #   start, heal, baseline_occupancy, recovery_round (first round
    #   >= heal with occupancy back at baseline; None if never),
    #   recovery_rounds (recovery_round - heal), blocked (draws severed
    #   during the window).
    windows: List[Dict]
    totals: Dict

    def __bool__(self) -> bool:  # `assert report` reads naturally
        return self.ok


def load_trace(path: Union[str, Path]) -> List[Dict]:
    """Read a flight-recorder JSONL trace, sorted by `round`.

    Accepts both emission modes (docs/observability.md): the in-graph
    tap's unordered lines and `write_stacked`'s pre-sorted ones.
    """
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return sorted(records, key=lambda r: r["round"])


def merged_cut_windows(cfg: AvalancheConfig) -> List[tuple]:
    """The script's STATIC cut events collapsed into disjoint
    ``[start, heal)`` outage intervals (see `_merge_windows`).
    Stochastic cuts have no static window — callers verifying a
    stochastic script pass the trial's REALIZED windows explicitly
    (`verify_recovery(..., windows=...)`, from
    `fleet.FleetResult.cut_windows`)."""
    return _merge_windows((e[1], e[2]) for e in cfg.cut_events())


def _max_scheduled_latency(cfg: AvalancheConfig) -> Optional[int]:
    """Worst-case deliverable latency any draw can be stamped with
    (base mode max + the tallest active spike — a stochastic spike
    counts its range's HI, the worst realization), or None when the
    mode is unbounded (geometric)."""
    if cfg.latency_mode in ("none",):
        base = 0
    elif cfg.latency_mode in ("fixed", "weighted"):
        base = cfg.latency_rounds
    elif cfg.latency_mode == "rtt":
        base = max(entry for row in cfg.rtt_matrix for entry in row)
    else:  # geometric: unbounded tail expires on its own
        return None
    spike = max((e[3] for e in cfg.spike_events()), default=0)
    spike = max(spike, max((e[3][1] for e in cfg.stochastic_spike_events()),
                           default=0))
    return base + spike


def _merge_windows(spans) -> List[tuple]:
    """Collapse [start, heal) spans into disjoint intervals —
    overlapping or back-to-back outages recover as one composite
    window (occupancy cannot return to baseline between cuts that
    share rounds)."""
    merged: List[tuple] = []
    for start, end in sorted((int(s), int(e)) for s, e in spans):
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def _series(records: Sequence[Dict], field: str) -> List[int]:
    try:
        return [int(r[field]) for r in records]
    except KeyError:
        raise ValueError(
            f"trace records lack the {field!r} counter — recovery "
            f"checking needs the async-era ring telemetry "
            f"(deliveries/expiries/ring_occupancy/partition_blocked; "
            f"every model's round carries it)")


def verify_recovery(
    cfg: AvalancheConfig,
    records: Sequence[Dict],
    occupancy_slack: int = 2,
    windows: Optional[Sequence] = None,
) -> RecoveryReport:
    """Verify the recovery invariants of `cfg`'s fault script against a
    stride-1 per-round trace; returns a `RecoveryReport` (violations
    collected, not raised — `check_recovery` is the raising wrapper).

    `occupancy_slack` widens the occupancy-recovery bound past the
    structural ``timeout_rounds()`` tail (default 2 rounds: scheduling
    jitter from entries issued in the heal round itself).

    `windows` supplies the REALIZED ``[start, heal)`` spans of the
    script's stochastic cuts — REQUIRED when the script schedules any
    (their windows are per-trial; `fleet.run_fleet` returns them as
    `FleetResult.cut_windows`).  They are MERGED with the script's
    static cut windows, not a replacement: a mixed static+stochastic
    script still checks occupancy recovery after every static heal.
    """
    violations: List[str] = []
    if windows is None:
        if cfg.stochastic_cut_events():
            raise ValueError(
                "this script schedules stochastic_partition events, "
                "whose windows are realized per trial — pass the "
                "trial's realized windows explicitly "
                "(verify_recovery(..., windows=...); the fleet driver "
                "returns them as FleetResult.cut_windows)")
        cut_windows = merged_cut_windows(cfg)
    else:
        cut_windows = _merge_windows(
            [(int(s), int(e)) for s, e in windows]
            + [(e[1], e[2]) for e in cfg.cut_events()])
    records = sorted(records, key=lambda r: r["round"])
    rounds = [int(r["round"]) for r in records]
    n_rounds = len(records)
    if rounds != list(range(n_rounds)):
        raise ValueError(
            f"recovery checking needs a stride-1 trace covering rounds "
            f"0..R-1 (metrics_every=1); got rounds "
            f"{rounds[:3]}..{rounds[-3:] if n_rounds >= 3 else rounds}")
    expiries = _series(records, "expiries")
    occupancy = _series(records, "ring_occupancy")
    blocked = _series(records, "partition_blocked")
    finalizations = _series(records, "finalizations")
    timeout = cfg.timeout_rounds()

    # --- 1. cut accounting: blocked draws expire exactly one timeout
    # later; strict equality when cuts are the only expiry source.
    max_lat = _max_scheduled_latency(cfg)
    strict = max_lat is not None and max_lat < timeout
    for r in range(n_rounds):
        expected = blocked[r - timeout] if r >= timeout else 0
        if strict and expiries[r] != expected:
            violations.append(
                f"cut accounting: round {r} reaped {expiries[r]} "
                f"expiries but round {r - timeout} blocked {expected} "
                f"draws (blocked queries must expire exactly "
                f"timeout_rounds={timeout} later, and nothing else "
                f"expires under this config)")
        elif not strict and expiries[r] < expected:
            violations.append(
                f"cut accounting: round {r} reaped only {expiries[r]} "
                f"expiries for {expected} draws blocked at round "
                f"{r - timeout} — blocked queries vanished unreaped")

    # --- 2. occupancy returns to the pre-fault baseline after each heal.
    windows = []
    for start, heal in cut_windows:
        if 1 <= start <= n_rounds:
            baseline = occupancy[start - 1]
        else:
            # A cut live from round 0 has no pre-fault round to anchor
            # on — anchor on the trace's final occupancy, the post-heal
            # steady state the drain must reach (never 0: any nonzero
            # latency keeps ~N*k queries permanently in flight).
            baseline = occupancy[-1] if n_rounds else 0
        bound = heal + timeout + occupancy_slack
        recovery_round = next(
            (r for r in range(min(heal, n_rounds), n_rounds)
             if occupancy[r] <= baseline), None)
        window_blocked = sum(blocked[start:heal])
        windows.append(dict(start=start, heal=heal,
                            baseline_occupancy=baseline,
                            recovery_round=recovery_round,
                            recovery_rounds=(None if recovery_round is None
                                             else recovery_round - heal),
                            blocked=window_blocked))
        if heal >= n_rounds:
            violations.append(
                f"occupancy recovery: the trace ({n_rounds} rounds) ends "
                f"before the cut window [{start}, {heal}) heals — run "
                f"past the heal to verify recovery")
        elif recovery_round is None or recovery_round > bound:
            at = (f"round {recovery_round}" if recovery_round is not None
                  else "never")
            violations.append(
                f"occupancy recovery: after the heal at round {heal}, "
                f"ring occupancy first returned to its pre-fault "
                f"baseline ({baseline}) {at}, past the bound "
                f"heal + timeout + slack = {bound} — blocked entries "
                f"must drain within one timeout of the heal")

    # --- 3. finality monotonicity across events.
    for r, f in enumerate(finalizations):
        if f < 0:
            violations.append(
                f"finality monotonicity: round {r} reports "
                f"{f} finalizations — the finalized count decreased "
                f"(finalized records must freeze across fault events)")

    totals = dict(rounds=n_rounds,
                  blocked_total=sum(blocked),
                  expiries_total=sum(expiries),
                  deliveries_total=sum(_series(records, "deliveries")),
                  finalizations_total=sum(finalizations),
                  peak_occupancy=max(occupancy, default=0),
                  strict_cut_accounting=strict)
    return RecoveryReport(ok=not violations, violations=violations,
                          windows=windows, totals=totals)


def is_fleet_trace(records: Sequence[Dict]) -> bool:
    """True when the trace is FLEET-STACKED: counter fields carry
    per-trial LISTS (a leading trial axis) instead of scalars — the
    format `fleet.fleet_trace_records` emits and a fleet `--metrics`
    run writes (docs/observability.md)."""
    for r in records:
        for field, v in r.items():
            if field != "round" and isinstance(v, (list, tuple)):
                return True
        return False
    return False


def _trial_records(records: Sequence[Dict], trial: int) -> List[Dict]:
    """Slice one trial's scalar record stream out of a fleet-stacked
    trace (non-list fields — `round`, `tag` — pass through)."""
    return [{k: (v[trial] if isinstance(v, (list, tuple)) else v)
             for k, v in r.items()} for r in records]


def verify_recovery_fleet(
    cfg: AvalancheConfig,
    records: Sequence[Dict],
    occupancy_slack: int = 2,
    windows: Optional[Sequence] = None,
) -> List[RecoveryReport]:
    """Per-trial recovery verdicts for a FLEET-STACKED trace: one
    `RecoveryReport` per trial, in trial order — the verdict VECTOR a
    Monte-Carlo sweep reduces to P(recovery) with a Wilson CI
    (`fleet.wilson_interval`).

    `windows`, when given, is PER-TRIAL: ``windows[i]`` holds trial i's
    realized ``[start, heal)`` spans (`fleet.FleetResult.cut_windows`
    is exactly this shape) — required for stochastic scripts, whose
    realized schedules differ per trial.  Mixed-width records (a trial
    axis that changes length mid-trace) raise `ValueError`.
    """
    records = sorted(records, key=lambda r: r["round"])
    widths = {len(v) for r in records for v in r.values()
              if isinstance(v, (list, tuple))}
    if len(widths) != 1:
        raise ValueError(
            f"a fleet-stacked trace carries ONE trial-axis width on "
            f"every counter field; got widths {sorted(widths)}")
    fleet = widths.pop()
    if windows is not None and len(windows) != fleet:
        raise ValueError(
            f"per-trial windows ({len(windows)}) must match the "
            f"trace's trial axis ({fleet})")
    return [verify_recovery(cfg, _trial_records(records, i),
                            occupancy_slack=occupancy_slack,
                            windows=None if windows is None
                            else windows[i])
            for i in range(fleet)]


def check_recovery(
    cfg: AvalancheConfig,
    trace: Union[str, Path, Sequence[Dict]],
    occupancy_slack: int = 2,
    windows: Optional[Sequence] = None,
) -> Union[RecoveryReport, List[RecoveryReport]]:
    """`verify_recovery` that LOADS a JSONL path (or takes records) and
    RAISES `RecoveryViolation` listing every failed invariant; returns
    the passing report otherwise.

    A FLEET-STACKED trace (per-trial list values — `is_fleet_trace`)
    returns the per-trial verdict VECTOR (`verify_recovery_fleet`)
    WITHOUT raising: a Monte-Carlo sweep's product is the fraction of
    trials that recovered, not a first-shape-mismatch exception —
    callers reduce ``[r.ok for r in reports]`` to P(recovery) ± CI.
    `windows` follows the selected mode's contract (scalar spans, or
    per-trial spans for a fleet trace).
    """
    if isinstance(trace, (str, Path)):
        trace = load_trace(trace)
    elif hasattr(trace, "columns") and hasattr(trace, "stride"):
        # A trace-plane buffer (obs/trace.py): decode directly, rows
        # ordered by construction; a fleet's [F, S, M] buffer decodes to
        # the fleet-stacked record format and takes the per-trial
        # verdict path below.
        from go_avalanche_tpu_torch.obs import trace as trace_mod

        trace = (trace_mod.fleet_trace_records(trace)
                 if _ndim(trace.data) == 3
                 else trace_mod.trace_records(trace))
    if is_fleet_trace(trace):
        return verify_recovery_fleet(cfg, trace,
                                     occupancy_slack=occupancy_slack,
                                     windows=windows)
    report = verify_recovery(cfg, trace, occupancy_slack=occupancy_slack,
                             windows=windows)
    if not report.ok:
        raise RecoveryViolation(
            "recovery invariants violated:\n  "
            + "\n  ".join(report.violations))
    return report
