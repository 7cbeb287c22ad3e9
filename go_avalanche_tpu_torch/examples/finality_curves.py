"""Rounds-to-finality curves — the Avalanche paper's headline fidelity
plot; the port's twin of `examples/finality_curves.py`.

For each (network size, byzantine fraction) the multi-target model runs
to settlement and the sweep prints the rounds-to-finality percentiles
and the cumulative finality curve, then fits the honest medians against
log2(n) (the paper's "latency grows ~logarithmically with network size")
and against n, as the falsification check.

    python -m go_avalanche_tpu_torch.examples.finality_curves
    python -m go_avalanche_tpu_torch.examples.finality_curves \
        --sizes 256,1024,4096 --txs 64 --device cpu
    python -m go_avalanche_tpu_torch.examples.finality_curves --json
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import AdversaryStrategy, AvalancheConfig
from go_avalanche_tpu_torch.examples import _common
from go_avalanche_tpu_torch.models import avalanche as av
from go_avalanche_tpu_torch.utils import metrics


def run_point(n_nodes: int, n_txs: int, byzantine: float, seed: int,
              max_rounds: int, adversary: str = "flip",
              contested: bool = False, device="cuda") -> dict:
    dev = av._device(device)
    # The strategy knob rides along only when byzantine > 0 — at the
    # honest-baseline point it is inert and the config validator
    # rejects it.
    cfg = AvalancheConfig(
        byzantine_fraction=byzantine,
        **(dict(adversary_strategy=AdversaryStrategy(adversary))
           if byzantine > 0 else {}))
    # Per-NODE 50/50 priors: the paper's experimental setup, where the
    # network must actually converge on a value.
    init_pref = (av.contested_init_pref(seed, n_nodes, n_txs, device=dev)
                 if contested else None)
    state = av.init(prng.key(seed, dev), n_nodes, n_txs, cfg,
                    init_pref=init_pref, device=dev)
    t0 = time.perf_counter()
    state = av.run(state, cfg, max_rounds, device=dev)
    stats = metrics.rounds_to_finality(state.finalized_at)
    fa = state.finalized_at.cpu().numpy()
    n_rounds = int(state.round)
    # Cumulative finality curve: fraction of (node, tx) records finalized
    # by the end of each round, from finalized_at stamps.
    per_round = np.bincount(fa[fa >= 0].ravel(), minlength=max(n_rounds, 1))
    curve = metrics.finality_curve(per_round, fa.size)
    return {
        "nodes": n_nodes,
        "txs": n_txs,
        "byzantine": byzantine,
        "rounds": n_rounds,
        "elapsed_s": round(time.perf_counter() - t0, 3),
        **{k: round(v, 2) for k, v in stats.items()},
        "curve": [round(float(c), 4) for c in curve],
    }


def fit_log_n(points: list) -> dict:
    """Least-squares fit median = a + b*log2(n) over honest sweep points.

    Quantifies the paper's "finality latency grows ~logarithmically with
    network size" claim: reports slope b (rounds per doubling), intercept,
    R^2 of the log fit, per-size residuals, and — as the falsification
    check — the R^2 of a LINEAR-in-n fit, which must be visibly worse for
    the logarithmic reading to stand.
    """
    ns = np.array([p["nodes"] for p in points], float)
    med = np.array([p["median"] for p in points], float)
    x = np.log2(ns)
    b, a = np.polyfit(x, med, 1)
    pred = a + b * x
    ss_res = float(((med - pred) ** 2).sum())
    ss_tot = float(((med - med.mean()) ** 2).sum())
    r2_log = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    bl, al = np.polyfit(ns, med, 1)
    pred_lin = al + bl * ns
    ss_res_l = float(((med - pred_lin) ** 2).sum())
    r2_lin = 1.0 - ss_res_l / ss_tot if ss_tot > 0 else 1.0
    return {
        "model": "median = a + b*log2(n)",
        "a": round(float(a), 3),
        "b_rounds_per_doubling": round(float(b), 3),
        "r2_log": round(r2_log, 4),
        "r2_linear_in_n": round(r2_lin, 4),
        "points": [
            {"nodes": int(n), "measured": float(m),
             "fitted": round(float(p), 2),
             "residual": round(float(m - p), 2)}
            for n, m, p in zip(ns, med, pred)
        ],
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--sizes", type=str, default="128,512,2048")
    parser.add_argument("--txs", type=int, default=32)
    parser.add_argument("--byzantine", type=str, default="0.0,0.1,0.2")
    parser.add_argument("--adversary", type=str, default="flip",
                        choices=[s.value for s in AdversaryStrategy])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-rounds", type=int, default=4000)
    parser.add_argument("--json", action="store_true")
    parser.add_argument("--json-out", type=str, default=None,
                        help="write results + log(n) fit artifact here")
    parser.add_argument("--contested", action="store_true",
                        help="per-node 50/50 initial preferences (the "
                             "paper's setup; unanimous networks give a "
                             "flat, size-independent line)")
    _common.add_device_arg(parser)
    args = parser.parse_args(argv)
    dev = av._device(args.device)
    card = _common.card(dev)

    sizes = [int(s) for s in args.sizes.split(",")]
    byz_fracs = [float(b) for b in args.byzantine.split(",")]

    results = [run_point(n, args.txs, b, args.seed, args.max_rounds,
                         args.adversary, contested=args.contested,
                         device=dev)
               for n in sizes for b in byz_fracs]

    honest_pts = [r for r in results if r["byzantine"] == 0.0
                  and "median" in r]
    fit = fit_log_n(honest_pts) if len(honest_pts) >= 3 else None

    out = {"results": results, "log_n_fit": fit,
           "backend": dev.type, "card": card}
    if args.json_out:
        _common.write_json(args.json_out, out)

    if args.json:
        print(json.dumps(out, indent=2))
        return out

    hdr = (f"{'nodes':>7} {'byz':>5} {'median':>7} {'p90':>7} {'max':>7} "
           f"{'unfinal%':>9} {'secs':>7}")
    if card:
        print(f"# secs on {card}")
    print(hdr)
    print("-" * len(hdr))
    for r in results:
        print(f"{r['nodes']:>7} {r['byzantine']:>5.2f} "
              f"{r.get('median', float('nan')):>7.1f} "
              f"{r.get('p90', float('nan')):>7.1f} "
              f"{r.get('max', float('nan')):>7.0f} "
              f"{100 * r['unfinalized_fraction']:>8.2f}% "
              f"{r['elapsed_s']:>7.2f}")

    # The paper's check, quantified: fit median vs log2(n) for honest runs.
    if fit is not None:
        print(f"\nlog(n) fit: median = {fit['a']} + "
              f"{fit['b_rounds_per_doubling']}*log2(n)   "
              f"R^2(log)={fit['r2_log']}  vs R^2(linear-in-n)="
              f"{fit['r2_linear_in_n']}")
        for p in fit["points"]:
            print(f"  n={p['nodes']:>6}  measured={p['measured']:>6.1f}  "
                  f"fitted={p['fitted']:>6.1f}  residual={p['residual']:+.2f}")
    elif len(honest_pts) == 2:
        lo, hi = honest_pts[0], honest_pts[-1]
        growth = (hi["median"] - lo["median"]) / max(
            np.log2(hi["nodes"] / lo["nodes"]), 1e-9)
        print(f"\nhonest-median growth: {growth:+.2f} rounds per doubling "
              f"of network size ({lo['nodes']} -> {hi['nodes']} nodes)")
    return out


if __name__ == "__main__":
    main()
