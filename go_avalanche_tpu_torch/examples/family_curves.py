"""Protocol-family comparison — the Avalanche paper's figs. 2-4 workload;
the port's twin of `examples/family_curves.py`.

Runs Slush, Snowflake and Snowball side by side on identical networks
(same sizes, seeds and fault mix) and reports, per protocol x byzantine
fraction: convergence (final agreement for Slush, the fraction of
honest nodes decided for Snowflake and Snowball), the median rounds to
decision, and safety (runs where two honest nodes decided opposite
values, `utils/metrics.safety_failure`).  The script's docstring has
the measured shape.

    python -m go_avalanche_tpu_torch.examples.family_curves
    python -m go_avalanche_tpu_torch.examples.family_curves --nodes 1024 \
        --byzantine 0.0,0.1,0.2 --seeds 5 --adversary oppose_majority \
        --json [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import AdversaryStrategy, AvalancheConfig
from go_avalanche_tpu_torch.examples import _common
from go_avalanche_tpu_torch.models import family, snowball
from go_avalanche_tpu_torch.models.avalanche import _device
from go_avalanche_tpu_torch.ops import voterecord as vr
from go_avalanche_tpu_torch.utils import metrics


def run_slush(key, n, cfg, m_rounds):
    """Slush on the key's device."""
    state = family.slush_init(key, n, cfg, yes_fraction=0.5,
                              device=key.device)
    final, _ = family.slush_run(state, cfg, m_rounds, device=key.device)
    colors = final.color.cpu().numpy()
    honest = ~final.byzantine.cpu().numpy()
    agree = max(colors[honest].mean(), 1 - colors[honest].mean())
    # Slush never "decides"; report agreement after m rounds. No safety
    # event is defined for it (nothing is irreversible).
    return {"decided_fraction": float(agree), "rounds": m_rounds,
            "safety_failure": False}


def run_snowflake(key, n, cfg, max_rounds):
    """Snowflake on the key's device."""
    state = family.snowflake_init(key, n, cfg, yes_fraction=0.5,
                                  device=key.device)
    final = family.snowflake_run(state, cfg, max_rounds, device=key.device)
    acc_at = final.accepted_at.cpu().numpy()
    colors = final.color.cpu().numpy()
    honest = ~final.byzantine.cpu().numpy()
    decided = acc_at >= 0
    return {
        "decided_fraction": float(decided[honest].mean()),
        "rounds": (float(np.median(acc_at[decided & honest]))
                   if (decided & honest).any() else None),
        "safety_failure": metrics.safety_failure(decided, colors, honest),
    }


def run_snowball(key, n, cfg, max_rounds):
    """Snowball on the key's device."""
    state = snowball.init(key, n, cfg, yes_fraction=0.5, device=key.device)
    final = snowball.run(state, cfg, max_rounds, device=key.device)
    fin = vr.has_finalized(final.records.confidence, cfg).cpu().numpy()
    pref = vr.is_accepted(final.records.confidence).cpu().numpy()
    fin_at = final.finalized_at.cpu().numpy()
    honest = ~final.byzantine.cpu().numpy()
    return {
        "decided_fraction": float(fin[honest].mean()),
        "rounds": (float(np.median(fin_at[fin & honest]))
                   if (fin & honest).any() else None),
        "safety_failure": metrics.safety_failure(fin, pref, honest),
    }


PROTOCOLS = {"slush": run_slush, "snowflake": run_snowflake,
             "snowball": run_snowball}


def main(argv=None) -> list:
    parser = argparse.ArgumentParser()
    parser.add_argument("--nodes", type=int, default=512)
    parser.add_argument("--byzantine", type=str, default="0.0,0.1,0.2")
    parser.add_argument("--adversary", type=str, default="flip",
                        choices=[s.value for s in AdversaryStrategy])
    parser.add_argument("--seeds", type=int, default=3,
                        help="independent runs per cell")
    parser.add_argument("--max-rounds", type=int, default=2000,
                        help="round budget (slush runs exactly 1/10 of it)")
    parser.add_argument("--beta", type=int, default=128,
                        help="snowflake/snowball decision threshold")
    parser.add_argument("--json", action="store_true")
    _common.add_device_arg(parser)
    args = parser.parse_args(argv)
    dev = _device(args.device)
    card = _common.card(dev)

    byz_fracs = [float(b) for b in args.byzantine.split(",")]
    rows = []
    for byz in byz_fracs:
        # The strategy knob rides along only when byz > 0 — at the
        # honest-baseline 0.0 point it is inert and the config
        # validator rejects it.
        adv = (dict(flip_probability=1.0,
                    adversary_strategy=AdversaryStrategy(args.adversary))
               if byz > 0 else {})
        cfg = AvalancheConfig(byzantine_fraction=byz,
                              finalization_score=args.beta, **adv)
        for name, runner in PROTOCOLS.items():
            budget = (args.max_rounds // 10 if name == "slush"
                      else args.max_rounds)
            t0 = time.perf_counter()
            per_seed = [runner(prng.key(s, dev), args.nodes, cfg, budget)
                        for s in range(args.seeds)]
            decided = [r["decided_fraction"] for r in per_seed]
            rounds = [r["rounds"] for r in per_seed
                      if r["rounds"] is not None]
            rows.append({
                "protocol": name,
                "byzantine": byz,
                "decided_fraction_mean": round(float(np.mean(decided)), 4),
                "rounds_median": (round(float(np.median(rounds)), 1)
                                  if rounds else None),
                "safety_failures": sum(r["safety_failure"]
                                       for r in per_seed),
                "seeds": args.seeds,
                "elapsed_s": round(time.perf_counter() - t0, 2),
                "card": card,
            })

    if args.json:
        print(json.dumps(rows, indent=1))
        return rows
    if card:
        print(f"# secs on {card}")
    hdr = (f"{'protocol':>10} {'byz':>5} {'decided':>8} {'rounds':>7} "
           f"{'safety_fail':>11} {'secs':>6}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        rounds = "—" if r["rounds_median"] is None else r["rounds_median"]
        print(f"{r['protocol']:>10} {r['byzantine']:>5.2f} "
              f"{r['decided_fraction_mean']:>8.3f} {rounds:>7} "
              f"{r['safety_failures']:>8}/{r['seeds']:<2} "
              f"{r['elapsed_s']:>6.2f}")
    return rows


if __name__ == "__main__":
    main()
