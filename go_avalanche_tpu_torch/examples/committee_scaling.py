"""Committee scaling: finality vs registry size at fixed committee k —
the port's twin of `examples/committee_scaling.py`.

Avalanche's per-query sampling is a stake-weighted COMMITTEE draw, so
the scale question is how finality degrades as the registry grows while
the committee size k stays fixed.  The sweep runs a Monte-Carlo fleet
per node count N under zipf stake (contested priors) and prints the
finality-vs-N curve with Wilson CIs and the safety estimates.

Each point runs TWICE: through the flat stake-CDF sampler
(`n_clusters=1`) and through the two-level hierarchical engine
(`n_clusters>1`, `ops/sampling.sample_peers_hierarchical`).  The two
are bit-parity twins of one distribution, so every fleet statistic must
come out IDENTICAL — asserted per point, an end-to-end check of the
port's sampling dispatch.

    python -m go_avalanche_tpu_torch.examples.committee_scaling
    python -m go_avalanche_tpu_torch.examples.committee_scaling \
        --sizes 48,96,192 --fleet 64 --zipf-s 1.2 --clusters 6 \
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

from go_avalanche_tpu_torch import fleet as fl
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.examples import _common
from go_avalanche_tpu_torch.models.avalanche import _device


def sweep_point(n_nodes: int, clusters: int, fleet: int, rounds: int,
                k: int, zipf_s: float, txs: int, seed: int,
                device="cuda") -> dict:
    """One (registry size, sampling engine) fleet: Wilson-CI finality
    and safety estimates over `fleet` contested avalanche trials."""
    cfg = AvalancheConfig(stake_mode="zipf", stake_zipf_s=zipf_s,
                          n_clusters=clusters, k=k,
                          finalization_score=16)
    res = fl.run_fleet("avalanche", cfg, fleet=fleet, n_nodes=n_nodes,
                       n_txs=txs, n_rounds=rounds, seed=seed,
                       contested=True, device=device)
    return {
        "nodes": n_nodes,
        "engine": "flat" if clusters == 1 else f"hier{clusters}",
        "p_settled": res.p_settled,
        "settled_ci": list(res.settled_ci),
        "finality_mean": res.finality_mean,
        "finality_ci": (None if res.finality_ci is None
                        else list(res.finality_ci)),
        "p_violation": res.p_violation,
        "violation_ci": list(res.violation_ci),
    }


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--sizes", type=str, default="48,96,192",
                        help="comma-separated registry sizes N to sweep")
    parser.add_argument("--k", type=int, default=8,
                        help="committee size (fixed across the sweep)")
    parser.add_argument("--fleet", type=int, default=32,
                        help="Monte-Carlo trials per point")
    parser.add_argument("--rounds", type=int, default=200,
                        help="horizon per trial")
    parser.add_argument("--txs", type=int, default=8,
                        help="contested txs per trial")
    parser.add_argument("--zipf-s", type=float, default=1.0,
                        help="stake concentration exponent")
    parser.add_argument("--clusters", type=int, default=4,
                        help="cluster count of the hierarchical engine")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--json", action="store_true",
                        help="emit one JSON line per point instead of "
                             "the table")
    _common.add_device_arg(parser)
    args = parser.parse_args(argv)
    dev = _device(args.device)

    sizes = [int(s) for s in args.sizes.split(",")]
    if not args.json:
        print(f"# committee scaling: k={args.k}, zipf s={args.zipf_s:g}, "
              f"{args.fleet} trials/point, horizon {args.rounds}, on "
              f"{dev.type}")
        print(f"{'N':>7} {'engine':>7} {'P(settled)':>21} "
              f"{'E[finality round]':>24} {'P(violation)':>16}")
    rows = []
    for n in sizes:
        flat = sweep_point(n, 1, args.fleet, args.rounds, args.k,
                           args.zipf_s, args.txs, args.seed, dev)
        hier = sweep_point(n, args.clusters, args.fleet, args.rounds,
                           args.k, args.zipf_s, args.txs, args.seed, dev)
        # The engine-parity acceptance check: the hierarchical draw is
        # bit-identical to the flat CDF on the same key, so the whole
        # fleet's statistics must match exactly.
        for key in ("p_settled", "finality_mean", "p_violation"):
            assert flat[key] == hier[key], (
                f"engine divergence at N={n} {key}: flat={flat[key]} "
                f"hier={hier[key]} — the hierarchical sampler no "
                f"longer matches the flat stake CDF")
        rows.extend([flat, hier])
        for row in (flat, hier):
            if args.json:
                print(json.dumps(row))
                continue
            lo, hi = row["settled_ci"]
            fin = ("--" if row["finality_mean"] is None else
                   f"{row['finality_mean']:8.1f} "
                   f"[{row['finality_ci'][0]:.1f}, "
                   f"{row['finality_ci'][1]:.1f}]")
            vlo, vhi = row["violation_ci"]
            print(f"{row['nodes']:>7} {row['engine']:>7} "
                  f"{row['p_settled']:>7.3f} [{lo:.3f}, {hi:.3f}] "
                  f"{fin:>24} "
                  f"{row['p_violation']:>6.3f} [{vlo:.3f}, {vhi:.3f}]")
    if not args.json:
        settled = [r for r in rows if r["finality_mean"] is not None
                   and r["engine"] == "flat"]
        if len(settled) >= 2:
            lo_n, hi_n = settled[0], settled[-1]
            print(f"# finality moved {lo_n['finality_mean']:.1f} -> "
                  f"{hi_n['finality_mean']:.1f} rounds from N="
                  f"{lo_n['nodes']} to N={hi_n['nodes']} at fixed "
                  f"k={args.k} (flat == hierarchical, asserted per "
                  f"point)")
    return rows


if __name__ == "__main__":
    main()
