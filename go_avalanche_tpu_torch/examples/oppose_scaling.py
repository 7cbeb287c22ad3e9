"""OPPOSE_MAJORITY: the metastability threshold shrinks as ~1/sqrt(n) —
the port's twin of `examples/oppose_scaling.py`.

The Avalanche paper's metastability adversary (lie with the current
global minority color) against a 50/50-split single-decree Snowball
network: holding the tie needs eps*n >~ sqrt(n), so the stall threshold
falls as eps*(n) ~ c / sqrt(n).  This study measures eps*(n) by
bisection (honest finalized fraction within a round budget, averaged
over seeds) and fits log2 eps* against log2 n (the script's docstring
has the measured slope).

Usage:
    python -m go_avalanche_tpu_torch.examples.oppose_scaling
        [--rounds 400] [--seeds 3] [--device cuda|cpu]
        [--json-out go_avalanche_tpu_torch/examples/out/oppose_scaling.json]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import AdversaryStrategy, AvalancheConfig
from go_avalanche_tpu_torch.examples import _common
from go_avalanche_tpu_torch.models import snowball as sb
from go_avalanche_tpu_torch.models.avalanche import _device
from go_avalanche_tpu_torch.ops import voterecord as vr

N_GRID = (256, 1024, 4096, 16384, 65536)


def live_fraction(n: int, eps: float, rounds: int, seeds: int,
                  device="cuda") -> float:
    """Mean honest finalized fraction over `seeds` runs."""
    dev = _device(device)
    cfg = AvalancheConfig(byzantine_fraction=eps, flip_probability=1.0,
                          adversary_strategy=AdversaryStrategy.OPPOSE_MAJORITY)
    out = []
    for s in range(seeds):
        st = sb.init(prng.key(s, dev), n, cfg, yes_fraction=0.5, device=dev)
        fin = sb.run(st, cfg, rounds, device=dev)
        f = vr.has_finalized(fin.records.confidence, cfg).cpu().numpy()
        byz = fin.byzantine.cpu().numpy()
        out.append(float(f[~byz].mean()))
    return float(np.mean(out))


def bisect_threshold(n: int, rounds: int, seeds: int,
                     lo: float = 0.005, hi: float = 0.45,
                     steps: int = 7, device="cuda") -> dict:
    """Smallest eps with live fraction < 0.5, to grid resolution."""
    probes = []
    f_lo = live_fraction(n, lo, rounds, seeds, device)
    f_hi = live_fraction(n, hi, rounds, seeds, device)
    probes += [{"eps": lo, "live": round(f_lo, 4)},
               {"eps": hi, "live": round(f_hi, 4)}]
    if f_lo < 0.5:
        # Stalled even at the floor: the threshold is only known to be
        # <= lo.  Censored — must NOT enter the power-law fit.
        return {"n": n, "eps_star": lo, "censored_at_floor": True,
                "bracket": [0.0, lo], "probes": probes}
    if f_hi >= 0.5:       # live even at the ceiling
        return {"n": n, "eps_star": None, "bracket": [hi, 1.0],
                "probes": probes}
    for _ in range(steps):
        mid = (lo + hi) / 2
        f_mid = live_fraction(n, mid, rounds, seeds, device)
        # Record the EXACT eps used: init rounds eps*n to a byzantine
        # count, so a display-rounded eps can change the trajectory.
        probes.append({"eps": mid, "live": round(f_mid, 4)})
        if f_mid >= 0.5:
            lo = mid
        else:
            hi = mid
        print(f"  n={n} bracket=({lo:.4f}, {hi:.4f})", flush=True)
    return {"n": n, "eps_star": round((lo + hi) / 2, 5),
            "bracket": [round(lo, 5), round(hi, 5)], "probes": probes}


def fit_power_law(points: list) -> dict:
    """Least-squares slope of log2(eps*) vs log2(n) with R^2."""
    xs = np.log2([p["n"] for p in points])
    ys = np.log2([p["eps_star"] for p in points])
    slope, intercept = np.polyfit(xs, ys, 1)
    pred = slope * xs + intercept
    ss_res = float(((ys - pred) ** 2).sum())
    ss_tot = float(((ys - ys.mean()) ** 2).sum())
    return {"slope": round(float(slope), 4),
            "intercept": round(float(intercept), 4),
            "r2": round(1 - ss_res / ss_tot, 4) if ss_tot else 1.0,
            "eps_star_at_100k": round(
                float(2 ** (slope * np.log2(100_000) + intercept)), 5)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=400)
    ap.add_argument("--seeds", type=int, default=3)
    _common.add_device_arg(ap)
    ap.add_argument("--json-out", type=str,
                    default=_common.out_path("oppose_scaling.json"))
    args = ap.parse_args(argv)
    dev = _device(args.device)
    card = _common.card(dev)

    t0 = time.time()
    rows = []
    for n in N_GRID:
        row = bisect_threshold(n, args.rounds, args.seeds, device=dev)
        rows.append(row)
        print(f"n={n}: eps* = {row['eps_star']} "
              f"(bracket {row['bracket']})", flush=True)

    fit_pts = [r for r in rows if r["eps_star"] is not None
               and not r.get("censored_at_floor")]
    fit = fit_power_law(fit_pts) if len(fit_pts) >= 3 else None
    result = {
        "config": {"rounds": args.rounds, "seeds": args.seeds,
                   "backend": dev.type},
        "rows": rows,
        "fit": fit,
        "elapsed_s": round(time.time() - t0, 1),
        "card": card,
    }
    _common.write_json(args.json_out, result)
    if fit:
        print(f"\nlog2 eps* = {fit['slope']} * log2 n + {fit['intercept']}"
              f"  (R^2 {fit['r2']}; sqrt-law predicts slope -0.5); "
              f"extrapolated eps* at 100k nodes: {fit['eps_star_at_100k']}")
    print(f"artifact: {args.json_out} ({result['elapsed_s']}s"
          f"{_common.card_note(card)})")
    return result


if __name__ == "__main__":
    main()
