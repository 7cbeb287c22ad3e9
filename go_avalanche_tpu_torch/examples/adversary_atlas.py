"""The adaptive-adversary atlas: the 2409.02217 phase boundary as a fleet
phase diagram — the port's twin of `examples/adversary_atlas.py`.

`adversary_policy="split_vote"` (the state-reading stall attack of
arXiv 2401.02811) on Snowball over the (byzantine fraction, k, quorum)
cube as ONE fleet phase grid (`fleet.run_phase_grid`), mapping both
failure modes with Wilson CIs: P(stall) from the liveness detector
(`fleet.liveness_stalled`), monotone-increasing in the byzantine
fraction at fixed (k, quorum), and P(safety violation).  It ends with a
detector spot-check: the most hostile point re-runs with the trace
plane (`cfg.trace_every=1`) and every trial's stall verdict is held
against its trace finality curve.

The port's fleet runs its trials one after another where the JAX
package vmaps them; the results are equal.

Usage:
    python -m go_avalanche_tpu_torch.examples.adversary_atlas
        [--nodes 64] [--fleet 48] [--rounds 120] [--quick]
        [--device cuda|cpu]
        [--json-out go_avalanche_tpu_torch/examples/out/adversary_atlas.json]
"""

from __future__ import annotations

import argparse
import time

from go_avalanche_tpu_torch import fleet
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.examples import _common
from go_avalanche_tpu_torch.models.avalanche import _device

BYZ_GRID = (0.05, 0.15, 0.25, 0.35, 0.45)
K_GRID = (4, 8)
QUORUM_GRID = (5, 7)


def run_atlas(nodes: int, fleet_size: int, rounds: int, fin_score: int,
              byz_grid, k_grid, quorum_grid, seed: int = 0,
              device="cuda"):
    """One `run_phase_grid` over the (byz, k, quorum) cube; returns the
    phase rows.  The base config carries the policy and a non-zero
    byzantine fraction (the grid overrides it per point — an all-zero
    base would reject the policy as inert)."""
    base = AvalancheConfig(finalization_score=fin_score,
                           byzantine_fraction=byz_grid[0],
                           adversary_policy="split_vote")
    grid = {"byzantine_fraction": list(byz_grid),
            "k": list(k_grid),
            "quorum": list(quorum_grid)}
    return fleet.run_phase_grid("snowball", base, grid, fleet=fleet_size,
                                n_nodes=nodes, n_rounds=rounds, seed=seed,
                                yes_fraction=0.5, device=device)


def monotonicity_report(rows, byz_grid, k_grid, quorum_grid):
    """Per-(k, quorum) curve of P(stall) vs byzantine fraction, with the
    monotone-increase check the 2409.02217 boundary predicts.  A dip is
    only counted as a violation when the Wilson CIs are disjoint —
    finite fleets wobble inside their intervals."""
    by_point = {(r["point"]["k"], r["point"]["quorum"],
                 r["point"]["byzantine_fraction"]): r for r in rows}
    curves = []
    for k in k_grid:
        for q in quorum_grid:
            pts = [by_point[(k, q, b)] for b in byz_grid]
            violations = [
                (byz_grid[i], byz_grid[i + 1])
                for i in range(len(pts) - 1)
                # a genuine decrease: the later CI sits wholly below
                # the earlier one
                if pts[i + 1]["stall_ci"][1] < pts[i]["stall_ci"][0]]
            curves.append({
                "k": k, "quorum": q,
                "byz": list(byz_grid),
                "p_stall": [p["p_stall"] for p in pts],
                "stall_ci": [p["stall_ci"] for p in pts],
                "p_violation": [p["p_violation"] for p in pts],
                "monotone": not violations,
                "monotonicity_violations": violations,
            })
    return curves


def spot_check(nodes: int, fleet_size: int, rounds: int, fin_score: int,
               byz: float, seed: int = 0, device="cuda"):
    """Re-run the most hostile point with the per-trial trace plane and
    check every trial's stall verdict against its trace finality curve.
    Returns the per-trial comparison; raises on any disagreement."""
    cfg = AvalancheConfig(finalization_score=fin_score,
                          byzantine_fraction=byz,
                          adversary_policy="split_vote",
                          trace_every=1)
    res = fleet.run_fleet("snowball", cfg, fleet=fleet_size,
                          n_nodes=nodes, n_rounds=rounds, seed=seed,
                          yes_fraction=0.5, device=device)
    records = res.trace_records()
    n_byz = int(round(byz * nodes))
    trials = []
    for i in range(fleet_size):
        total_fin = sum(rec["finalizations"][i] for rec in records)
        stalled = bool(res.stalled[i])
        # Stalled: no HONEST row finalized, so the all-rows trace
        # counter can only carry byzantine finalizations.  Not stalled
        # with any finalized fraction: the curve must be non-zero.
        if stalled:
            ok = total_fin <= n_byz
        elif res.finalized_fraction[i] > 0:
            ok = total_fin > 0
        else:
            ok = True   # honest-minority trials: detector abstains
        trials.append({"trial": i, "stalled": stalled,
                       "trace_finalizations": int(total_fin),
                       "agrees": ok})
        if not ok:
            raise AssertionError(
                f"stall detector disagrees with the trace-plane "
                f"finality curve on trial {i}: stalled={stalled}, "
                f"cumulative finalizations={total_fin} (n_byz={n_byz})")
    return {"byz": byz, "n_byz": n_byz, "p_stall": res.p_stall,
            "trials_checked": fleet_size, "trials": trials}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=int, default=64)
    ap.add_argument("--fleet", type=int, default=48)
    ap.add_argument("--rounds", type=int, default=120)
    ap.add_argument("--finalization-score", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="3-point byz grid at (k=8, quorum=7) only — "
                         "the smoke spelling")
    _common.add_device_arg(ap)
    ap.add_argument("--json-out", type=str,
                    default=_common.out_path("adversary_atlas.json"))
    args = ap.parse_args(argv)
    dev = _device(args.device)
    card = _common.card(dev)

    byz_grid = (0.05, 0.25, 0.45) if args.quick else BYZ_GRID
    k_grid = (8,) if args.quick else K_GRID
    quorum_grid = (7,) if args.quick else QUORUM_GRID

    t0 = time.time()
    rows = run_atlas(args.nodes, args.fleet, args.rounds,
                     args.finalization_score, byz_grid, k_grid,
                     quorum_grid, seed=args.seed, device=dev)
    curves = monotonicity_report(rows, byz_grid, k_grid, quorum_grid)

    print(f"# adversary atlas — split_vote on snowball, {args.nodes} "
          f"nodes, {args.fleet}-trial fleets, {args.rounds}-round "
          f"horizon, finalization {args.finalization_score}")
    for c in curves:
        print(f"\nk={c['k']} quorum={c['quorum']}   "
              f"(monotone: {c['monotone']})")
        print(f"{'byz':>6} {'P(stall)':>9} {'stall CI':>18} "
              f"{'P(violation)':>13}")
        for b, p, ci, v in zip(c["byz"], c["p_stall"], c["stall_ci"],
                               c["p_violation"]):
            print(f"{b:>6} {p:>9.3f} [{ci[0]:.3f}, {ci[1]:.3f}]"
                  f"{v:>12.3f}")

    check = spot_check(args.nodes, min(args.fleet, 16), args.rounds,
                       args.finalization_score, byz_grid[-1],
                       seed=args.seed, device=dev)
    print(f"\nspot-check @ byz={check['byz']}: stall verdicts agree "
          f"with the trace-plane finality curves on all "
          f"{check['trials_checked']} trials "
          f"(P(stall) = {check['p_stall']:.3f})")

    result = {"nodes": args.nodes, "fleet": args.fleet,
              "rounds": args.rounds,
              "finalization_score": args.finalization_score,
              "curves": curves, "rows": rows, "spot_check": check,
              "elapsed_s": round(time.time() - t0, 1),
              "card": card}
    if args.json_out:
        _common.write_json(args.json_out, result)
        print(f"wrote {args.json_out} ({result['elapsed_s']}s"
              f"{_common.card_note(card)})")
    return result


if __name__ == "__main__":
    main()
