"""Fault-scenario library: scripted outages with machine-checked recovery
— the port's twin of `examples/fault_scenarios.py`.

Named scenarios, each a fault script (`cfg.fault_script`) with a story,
each run ending in a RECOVERY VERDICT — `obs.verify_recovery` checked
against the very script that ran — and optionally streaming its
per-round telemetry as flight-recorder JSONL (`--metrics`):

  partition_heal    — a 50/50 cluster-aligned split that heals
                      (`measure()`, both absence semantics).
  cascading_outage  — two overlapping regional outages: one merged
                      recovery window.
  flaky_isp         — a slow cluster (RTT matrix) and two latency
                      spikes: expiries WITHOUT blocked queries.
  eclipse           — a 12.5% node fraction split off for 30 rounds.
  monte_carlo       — a stochastic partition realized per trial of a
                      fleet with the trace plane on, each trial's
                      recovery checked from its own trace against its
                      realized window: P(recovery) ± a Wilson CI.

    python -m go_avalanche_tpu_torch.examples.fault_scenarios
    python -m go_avalanche_tpu_torch.examples.fault_scenarios eclipse \
        flaky_isp [--device cuda|cpu]
    python -m go_avalanche_tpu_torch.examples.fault_scenarios \
        --metrics /tmp/faults.jsonl
    python -m go_avalanche_tpu_torch.examples.fault_scenarios --json

The async ring these scenarios run on is plain PyTorch by the
reference's design: it launches none of the port's kernels.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from go_avalanche_tpu_torch import fleet as fl
from go_avalanche_tpu_torch import obs, prng
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.examples import _common
from go_avalanche_tpu_torch.models import avalanche as av
from go_avalanche_tpu_torch.obs.sink import _flatten_telemetry, host_columns
from go_avalanche_tpu_torch.ops import voterecord as vr


def measure(
    nodes: int = 512,
    txs: int = 64,
    partition_start: int = 5,
    partition_end: int = 60,
    timeout_rounds: int = 4,
    latency_rounds: int = 1,
    finalization_score: int = 48,
    n_rounds: int = 130,
    skip_absent: bool = False,
    seed: int = 0,
    metrics_path: str | None = None,
    device="cuda",
) -> dict:
    """One partition-outage run; returns per-round telemetry + summary.

    The canonical partition study, the script's API: contested priors
    (per-node 50/50) so the network must genuinely converge per tx;
    fixed `latency_rounds` response
    latency inside each side; the partition splits the nodes 50/50 for
    ``[partition_start, partition_end)`` — spelled `partition_spec`,
    the one-event fault-script sugar.  With `metrics_path`, the stacked
    telemetry streams to that JSONL file (one line per round, tagged
    with the engine config) and a manifest lands next to it.
    """
    dev = av._device(device)
    cfg = AvalancheConfig(
        finalization_score=finalization_score,
        latency_mode="fixed",
        latency_rounds=latency_rounds,
        partition_spec=(partition_start, partition_end, 0.5),
        time_step_s=1.0,
        request_timeout_s=float(timeout_rounds - 1),
        skip_absent_votes=skip_absent,
    )
    state = av.init(prng.key(seed, dev), nodes, txs, cfg,
                    init_pref=av.contested_init_pref(seed, nodes, txs,
                                                     device=dev),
                    device=dev)
    final, tel = av.run_scan(state, cfg, n_rounds=n_rounds, device=dev)
    fins = tel.finalizations.cpu().numpy()                     # [rounds]
    blocked = tel.partition_blocked.cpu().numpy()
    expiries = tel.expiries.cpu().numpy()
    occupancy = tel.ring_occupancy.cpu().numpy()
    fin_frac = float(vr.has_finalized(
        final.records.confidence, cfg).cpu().numpy().mean())

    if metrics_path:
        # Host-side streaming: ONE copy of the whole stacked tree to
        # the host, one JSON line per round, manifest next to the file.
        mode_tag = obs.config_tag(cfg) + (
            ", skip-absent" if skip_absent else "")
        with obs.metrics_sink(metrics_path, tag=mode_tag) as sink:
            sink.write_stacked(tel)
        obs.write_manifest(metrics_path, cfg, extra={
            "study": "fault_scenarios.partition_heal",
            "mode": "skip" if skip_absent else "neutral",
            "workload": {"nodes": nodes, "txs": txs, "rounds": n_rounds,
                         "seed": seed},
        })

    # The stall window: expiry semantics take one timeout to kick in
    # after the cut, and recovery trails the heal by the timeout too.
    stall_lo = partition_start + cfg.timeout_rounds()
    stall_hi = partition_end
    cum = np.cumsum(fins) / (nodes * txs)
    return {
        "mode": "skip" if skip_absent else "neutral",
        "per_round_finalizations": fins.tolist(),
        "per_round_blocked": blocked.tolist(),
        "per_round_expiries": expiries.tolist(),
        "per_round_ring_occupancy": occupancy.tolist(),
        "finalized_fraction_final": fin_frac,
        "finalized_fraction_at_cut": float(cum[partition_start - 1]),
        "finalized_fraction_at_heal": float(cum[stall_hi - 1]),
        "stall_window_finalizations": int(fins[stall_lo:stall_hi].sum()),
        "post_heal_finalizations": int(fins[stall_hi:].sum()),
        "blocked_total": int(blocked.sum()),
        "expiries_total": int(expiries.sum()),
        "peak_ring_occupancy": int(occupancy.max()),
        "timeout_rounds": cfg.timeout_rounds(),
        "metrics_file": metrics_path,
        "config": {
            "nodes": nodes, "txs": txs,
            "partition": [partition_start, partition_end, 0.5],
            "latency_rounds": latency_rounds,
            "finalization_score": finalization_score,
            "rounds": n_rounds,
        },
    }


# ----------------------------------------------------------- scenarios

def _cascading_outage(timing: dict) -> tuple:
    """Two regions fail in cascade: cluster 0 at round 10, cluster 1 at
    20, heals staggered at 30 and 40.  The windows OVERLAP, so the
    recovery checker verifies them as one composite [10, 40) outage."""
    cfg = AvalancheConfig(
        finalization_score=48,
        n_clusters=4,
        latency_mode="fixed", latency_rounds=1,
        fault_script=(("regional_outage", 10, 30, 0),
                      ("regional_outage", 20, 40, 1)),
        **timing,
    )
    return cfg, 70, ("cluster 0 dark rounds [10, 30), cluster 1 "
                     "[20, 40): one merged recovery window [10, 40)")


def _flaky_isp(timing: dict) -> tuple:
    """No cut anywhere — cluster 2 just sits behind a slow ISP
    (cluster-pair RTT 3 vs 1 intra-cluster), and two latency spikes
    push those slow links past the timeout: expiries WITHOUT blocked
    queries, the trace signature separating 'slow' from 'severed'."""
    slow = 2
    rtt = tuple(tuple(3 if slow in (i, j) and i != j else 1
                      for j in range(4)) for i in range(4))
    cfg = AvalancheConfig(
        finalization_score=48,
        n_clusters=4,
        latency_mode="rtt", rtt_matrix=rtt,
        fault_script=(("latency_spike", 12, 16, 2),
                      ("latency_spike", 30, 34, 2)),
        **timing,
    )
    # rtt 3 + spike 2 == 5 >= timeout 4 -> the slow links' draws become
    # the never-delivers sentinel during each spike; intra-cluster
    # draws (1 + 2 == 3 < 4) keep delivering.
    return cfg, 60, ("cluster 2 at RTT 3 (others 1); spikes [12, 16) "
                     "and [30, 34) push only its links past the "
                     "timeout — expiry storms, zero blocked")


def _eclipse(timing: dict) -> tuple:
    """Eclipse-style isolation: a 12.5% node fraction is split off for
    rounds [15, 45).  The eclipsed minority cannot reach quorum alone
    (k-of-N draws mostly cross the cut and expire); the majority loses
    only 1-in-8 draws and barely slows."""
    cfg = AvalancheConfig(
        finalization_score=48,
        latency_mode="fixed", latency_rounds=1,
        fault_script=(("partition", 15, 45, 0.125),),
        **timing,
    )
    return cfg, 80, ("12.5% of nodes eclipsed rounds [15, 45): the "
                     "minority stalls, the majority shrugs, the "
                     "minority catches up within one timeout of heal")


SCENARIOS = {
    "cascading_outage": _cascading_outage,
    "flaky_isp": _flaky_isp,
    "eclipse": _eclipse,
}


def run_monte_carlo(
    nodes: int = 128,
    txs: int = 32,
    fleet: int = 48,
    timeout_rounds: int = 4,
    n_rounds: int = 70,
    seed: int = 0,
    metrics_path: str | None = None,
    device="cuda",
) -> dict:
    """The Monte-Carlo scenario: a stochastic partition-length sweep.

    One `cfg.fault_script` stochastic_partition event — start drawn from
    rounds [5, 10], LENGTH from [6, 28] rounds, split fraction from
    [0.35, 0.65] — realized independently per trial from the init key
    (`ops/inflight.draw_fault_params`), a fleet of whole sims
    (`fleet.run_fleet`, its trials one after another) with the
    ON-DEVICE TRACE PLANE on (`cfg.trace_every=1`, obs/trace.py — each
    trial's ``[S, M]`` buffer stacks into per-trial ``[F, S, M]``
    traces).  Every trial's recovery invariants are then checked against
    ITS OWN realized ``[start, heal)`` window
    (`obs.check_recovery(cfg, res.trace_records(),
    windows=res.cut_windows)`).  The verdict is a POPULATION number:
    P(recovery) with a Wilson CI, plus the recovery rate bucketed by
    realized outage length — short cuts always heal, cuts approaching
    the horizon run out of rounds to drain their expiry tail.

    With `metrics_path`, the decoded fleet-stacked trace streams to
    that JSONL file (per-round rows whose counters are per-trial
    LISTS — the fleet-trace format, docs/observability.md) and the
    verdicts are then checked FROM the file.
    """
    cfg = AvalancheConfig(
        finalization_score=48,
        latency_mode="fixed", latency_rounds=1,
        fault_script=(
            ("stochastic_partition", (5, 10), (6, 28), (0.35, 0.65)),),
        time_step_s=1.0,
        request_timeout_s=float(timeout_rounds - 1),
        trace_every=1,
    )
    res = fl.run_fleet("avalanche", cfg, fleet=fleet, n_nodes=nodes,
                       n_txs=txs, n_rounds=n_rounds, seed=seed,
                       device=device)
    records = res.trace_records()

    if metrics_path:
        with obs.metrics_sink(metrics_path,
                              tag=obs.config_tag(cfg)) as sink:
            for rec in records:
                sink.write(rec)
        obs.write_manifest(metrics_path, cfg, extra={
            "study": "fault_scenarios.monte_carlo",
            "workload": {"nodes": nodes, "txs": txs, "rounds": n_rounds,
                         "fleet": fleet, "seed": seed},
        })
        records = obs.recovery.load_trace(metrics_path)

    # One verdict per trial, each against its own realized window —
    # check_recovery returns the vector (no raise) on a fleet trace.
    reports = obs.check_recovery(cfg, records, windows=res.cut_windows)
    oks = [r.ok for r in reports]
    recovered = sum(oks)
    ci = fl.wilson_interval(recovered, fleet)

    # Recovery rate by realized outage length (the sweep's x-axis).
    lengths = (res.cut_windows[:, 0, 1] - res.cut_windows[:, 0, 0])
    by_length: dict = {}
    for lo, hi in ((6, 12), (12, 20), (20, 29)):
        sel = [i for i in range(fleet) if lo <= int(lengths[i]) < hi]
        if sel:
            by_length[f"[{lo}, {hi})"] = {
                "trials": len(sel),
                "recovered": sum(oks[i] for i in sel),
            }
    return {
        "scenario": "monte_carlo",
        "fleet": fleet,
        "recovered": int(recovered),
        "p_recovery": recovered / fleet,
        "recovery_ci": list(ci),
        "p_settled": res.p_settled,
        "settled_ci": list(res.settled_ci),
        "violations": int(res.violations.sum()),
        "by_length": by_length,
        "realized_windows": res.cut_windows[:, 0, :].tolist(),
        "failed_trials": [i for i, ok in enumerate(oks) if not ok],
        "metrics_file": metrics_path,
        "rounds": n_rounds,
    }


def _print_monte_carlo(r: dict) -> None:
    lo, hi = r["recovery_ci"]
    print("\n== monte_carlo ==")
    print(f"stochastic partition: start ~ U[5, 10], length ~ U[6, 28] "
          f"rounds, split ~ U[0.35, 0.65] — realized per trial, "
          f"{r['fleet']} trials, one after another")
    print(f"P(recovery) = {r['recovered']}/{r['fleet']} "
          f"= {r['p_recovery']:.3f}  (95% Wilson CI "
          f"[{lo:.3f}, {hi:.3f}])")
    print(f"P(settled)  = {r['p_settled']:.3f}  (CI "
          f"[{r['settled_ci'][0]:.3f}, {r['settled_ci'][1]:.3f}]); "
          f"{r['violations']} safety violations")
    print("recovery by realized outage length:")
    for bucket, b in r["by_length"].items():
        print(f"  length {bucket:>9}: {b['recovered']}/{b['trials']} "
              f"recovered")
    if r["failed_trials"]:
        print(f"unrecovered trials: {r['failed_trials']}")
    if r["metrics_file"]:
        print(f"trace: {r['metrics_file']} (+ .manifest.json; "
              f"fleet-stacked rows — per-trial LISTS per counter)")


def run_scenario(
    name: str,
    nodes: int = 512,
    txs: int = 64,
    timeout_rounds: int = 4,
    seed: int = 0,
    metrics_path: str | None = None,
    device="cuda",
) -> dict:
    """Run one named scenario end-to-end: simulate, (optionally) emit
    the flight-recorder trace + manifest, verify the recovery
    invariants against the script that ran, return summary + verdict.
    """
    dev = av._device(device)
    timing = dict(time_step_s=1.0,
                  request_timeout_s=float(timeout_rounds - 1))
    cfg, n_rounds, story = SCENARIOS[name](timing)
    state = av.init(prng.key(seed, dev), nodes, txs, cfg,
                    init_pref=av.contested_init_pref(seed, nodes, txs,
                                                     device=dev),
                    device=dev)
    final, tel = av.run_scan(state, cfg, n_rounds=n_rounds, device=dev)

    if metrics_path:
        with obs.metrics_sink(metrics_path,
                              tag=obs.config_tag(cfg)) as sink:
            sink.write_stacked(tel)
        obs.write_manifest(metrics_path, cfg, extra={
            "study": f"fault_scenarios.{name}",
            "workload": {"nodes": nodes, "txs": txs, "rounds": n_rounds,
                         "seed": seed},
        })
        records = obs.recovery.load_trace(metrics_path)
    else:
        host = host_columns(_flatten_telemetry(tel, {}))
        records = [{"round": r,
                    **{k: int(np.asarray(v[r])) for k, v in host.items()}}
                   for r in range(n_rounds)]

    report = obs.verify_recovery(cfg, records)
    fin_frac = float(vr.has_finalized(
        final.records.confidence, cfg).cpu().numpy().mean())
    return {
        "scenario": name,
        "story": story,
        "recovered": report.ok,
        "violations": report.violations,
        "windows": report.windows,
        "totals": report.totals,
        "finalized_fraction_final": fin_frac,
        "per_round_finalizations": [int(r["finalizations"])
                                    for r in records],
        "per_round_blocked": [int(r["partition_blocked"])
                              for r in records],
        "per_round_expiries": [int(r["expiries"]) for r in records],
        "metrics_file": metrics_path,
        "rounds": n_rounds,
    }


def _strip(series) -> str:
    peak = max(max(series), 1)
    return "".join(
        " .:-=+*#@"[min(8, (9 * f) // (peak + 1))] for f in series)


def _print_partition_heal(results: list) -> None:
    for r in results:
        fins = r["per_round_finalizations"]
        ps, pe = r["config"]["partition"][0], r["config"]["partition"][1]
        print(f"\n== partition_heal / {r['mode']} absence semantics "
              f"(timeout {r['timeout_rounds']} rounds) ==")
        print(f"finalized fraction: at cut "
              f"{r['finalized_fraction_at_cut']:.3f}"
              f" | at heal {r['finalized_fraction_at_heal']:.3f}"
              f" | final {r['finalized_fraction_final']:.3f}")
        print(f"blocked queries: {r['blocked_total']} "
              f"(all reaped: {r['expiries_total']} expiries); "
              f"peak ring occupancy {r['peak_ring_occupancy']}")
        print(f"rounds 0..{len(fins) - 1} (partition [{ps}, {pe})):")
        print(f"finalizations |{_strip(fins)}|")
        print(f"blocked       |{_strip(r['per_round_blocked'])}|")
        print(f"expiries      |{_strip(r['per_round_expiries'])}|")
        if r["metrics_file"]:
            print(f"trace: {r['metrics_file']} (+ .manifest.json)")


def _print_scenario(r: dict) -> None:
    verdict = "RECOVERED" if r["recovered"] else "VIOLATED"
    print(f"\n== {r['scenario']} ==")
    print(r["story"])
    print(f"recovery verdict: {verdict}"
          + (f" — {len(r['violations'])} violation(s)"
             if r["violations"] else ""))
    for v in r["violations"]:
        print(f"  ! {v}")
    for w in r["windows"]:
        rec = (f"recovered {w['recovery_rounds']} round(s) after heal"
               if w["recovery_rounds"] is not None else "NOT recovered")
        print(f"  cut [{w['start']}, {w['heal']}): {w['blocked']} draws "
              f"blocked, {rec} (baseline occupancy "
              f"{w['baseline_occupancy']})")
    t = r["totals"]
    print(f"totals: {t['blocked_total']} blocked, "
          f"{t['expiries_total']} expiries, "
          f"{t['deliveries_total']} deliveries, peak occupancy "
          f"{t['peak_occupancy']}; finalized fraction "
          f"{r['finalized_fraction_final']:.3f}")
    print(f"rounds 0..{r['rounds'] - 1}:")
    print(f"finalizations |{_strip(r['per_round_finalizations'])}|")
    print(f"blocked       |{_strip(r['per_round_blocked'])}|")
    print(f"expiries      |{_strip(r['per_round_expiries'])}|")
    if r["metrics_file"]:
        print(f"trace: {r['metrics_file']} (+ .manifest.json)")


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("scenarios", nargs="*",
                        choices=[[], *SCENARIOS, "partition_heal",
                                 "monte_carlo"],
                        help="scenarios to run (default: all)")
    parser.add_argument("--list", action="store_true",
                        help="list scenarios and exit")
    parser.add_argument("--nodes", type=int, default=512)
    parser.add_argument("--txs", type=int, default=64)
    parser.add_argument("--timeout-rounds", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    # partition_heal-only knobs (the old partition_outage.py CLI): vary
    # the cut window / response latency / horizon without editing source.
    parser.add_argument("--partition-start", type=int, default=5)
    parser.add_argument("--partition-end", type=int, default=60)
    parser.add_argument("--latency-rounds", type=int, default=1)
    parser.add_argument("--finalization-score", type=int, default=48)
    parser.add_argument("--rounds", type=int, default=130,
                        help="partition_heal horizon (other scenarios "
                             "fix their own)")
    parser.add_argument("--fleet", type=int, default=48,
                        help="monte_carlo trial count (Wilson CI "
                             "tightens as 1/sqrt(F))")
    parser.add_argument("--metrics", type=str, default=None,
                        metavar="PATH",
                        help="stream each scenario's per-round telemetry "
                             "to PATH.<scenario>.jsonl with a manifest "
                             "next to each; the recovery verdict is then "
                             "checked FROM the file")
    parser.add_argument("--json", action="store_true",
                        help="emit the raw per-scenario dicts as JSON")
    _common.add_device_arg(parser)
    args = parser.parse_args(argv)

    if args.list:
        print("partition_heal: the canonical 50/50 split, both "
              "absence semantics (measure())")
        for name, fn in SCENARIOS.items():
            print(f"{name}: {fn.__doc__.splitlines()[0].strip()}")
        print("monte_carlo: stochastic partition-length sweep — a "
              "fleet, per-trial realized windows, "
              "P(recovery) ± Wilson CI (run_monte_carlo())")
        return []

    dev = av._device(args.device)
    if not args.json:
        print(f"# fault scenarios on {dev.type}")

    names = args.scenarios or ["partition_heal", *SCENARIOS,
                               "monte_carlo"]
    out = []
    for name in names:
        metrics_path = None
        if args.metrics:
            p = Path(args.metrics)
            metrics_path = str(p.with_name(f"{p.stem}.{name}{p.suffix}"))
        if name == "partition_heal":
            results = []
            for skip in (False, True):
                mp = None
                if metrics_path:
                    q = Path(metrics_path)
                    mode = "skip" if skip else "neutral"
                    mp = str(q.with_name(f"{q.stem}.{mode}{q.suffix}"))
                results.append(measure(
                    nodes=args.nodes, txs=args.txs,
                    partition_start=args.partition_start,
                    partition_end=args.partition_end,
                    timeout_rounds=args.timeout_rounds,
                    latency_rounds=args.latency_rounds,
                    finalization_score=args.finalization_score,
                    n_rounds=args.rounds,
                    skip_absent=skip, seed=args.seed, metrics_path=mp,
                    device=dev))
            out.extend(results)
            if not args.json:
                _print_partition_heal(results)
        elif name == "monte_carlo":
            r = run_monte_carlo(nodes=args.nodes, txs=args.txs,
                                fleet=args.fleet,
                                timeout_rounds=args.timeout_rounds,
                                seed=args.seed,
                                metrics_path=metrics_path, device=dev)
            out.append(r)
            if not args.json:
                _print_monte_carlo(r)
        else:
            r = run_scenario(name, nodes=args.nodes, txs=args.txs,
                             timeout_rounds=args.timeout_rounds,
                             seed=args.seed, metrics_path=metrics_path,
                             device=dev)
            out.append(r)
            if not args.json:
                _print_scenario(r)

    if args.json:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
