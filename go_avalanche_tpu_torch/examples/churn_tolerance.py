"""Churn tolerance: the quorum window is a 7th-power availability filter —
the port's twin of `examples/churn_tolerance.py`.

Membership churn (`config.churn_probability`: nodes toggle dead<->alive
per round) and per-slot response drops, measured on the simulator under
both non-response semantics (the default window-shifting neutral vote,
and `config.skip_absent_votes=True`, the reference host's expiry) and
tested against three analytic first-passage models: own uptime, the
two-factor dilution and the exact quorum-window DP.  The script's
docstring has the measured result: in the default semantics the bump
rate is P[Bin(8, a) >= 7] = a^8 + 8 a^7 (1-a), ~8 a^7; the skip mode
recovers linear dilution.  The models below are the script's numpy
code, copied verbatim.

The skip mode ingests through the plain engines on every device, by
the reference's design (no kernel implements the absent-vote skip).

Usage:
    python -m go_avalanche_tpu_torch.examples.churn_tolerance
        [--nodes 4096] [--txs 32] [--rounds 128] [--device cuda|cpu]
        [--json-out go_avalanche_tpu_torch/examples/out/churn_tolerance.json]
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np

from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.examples import _common
from go_avalanche_tpu_torch.models import avalanche as av

CHURN_GRID = (0.0, 0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 0.5)
DROP_GRID = (0.05, 0.1, 0.2, 0.3)
CUTOFFS = (17, 20, 25, 34, 50, 128)
VOTES_NEEDED = 134      # 6 warm-up + 128 bumps at k=8 (golden-pinned)
BUMPS_NEEDED = 128      # finalization_score
WINDOW, QUORUM = 8, 7


def alive_fraction(c: float, r: int) -> float:
    """Mean-field alive fraction at round r (0-based), all-alive start."""
    return 0.5 + 0.5 * (1.0 - 2.0 * c) ** r


def uptime_dp(c: float, k: int, max_rounds: int) -> np.ndarray:
    """Model 1: P[>= ceil(134/k) alive-rounds by round r] (1-based r)."""
    threshold = -(-VOTES_NEEDED // k)
    dist = np.zeros((2, threshold))
    dist[1, 0] = 1.0
    done = np.zeros(max_rounds)
    absorbed = 0.0
    for r in range(max_rounds):
        new = np.zeros_like(dist)
        absorbed += dist[1, threshold - 1]
        new[1, 1:] = dist[1, :-1]
        new[0] = dist[0]
        dist[1] = new[1] * (1 - c) + new[0] * c
        dist[0] = new[0] * (1 - c) + new[1] * c
        done[r] = absorbed
    return done


def _votes_fp_dp(avail_fn, toggle_c: float, k: int,
                 max_rounds: int) -> np.ndarray:
    """First-passage DP to 134 votes: an alive node gains
    Binomial(k, avail_fn(r)) conclusive votes per round, then everything
    toggles dead<->alive with prob `toggle_c` (0 = always alive)."""
    needed = VOTES_NEEDED
    js = np.arange(k + 1)
    comb = np.array([math.comb(k, j) for j in js], dtype=np.float64)
    dist = np.zeros((2, needed))
    dist[1, 0] = 1.0
    done = np.zeros(max_rounds)
    absorbed = 0.0
    c = toggle_c
    for r in range(max_rounds):
        a = avail_fn(r)
        pmf = comb * a ** js * (1.0 - a) ** (k - js)
        alive_row = dist[1]
        acc = pmf[0] * alive_row
        for j in range(1, k + 1):
            absorbed += pmf[j] * alive_row[needed - j:].sum()
            shifted = np.zeros(needed)
            shifted[j:] = alive_row[: needed - j]
            acc = acc + pmf[j] * shifted
        dist = np.stack([dist[0] * (1 - c) + acc * c,
                         acc * (1 - c) + dist[0] * c])
        done[r] = absorbed
    return done


def two_factor_dp(c: float, k: int, max_rounds: int) -> np.ndarray:
    """Model 2: P[>= 134 conclusive votes by round r] (1-based r)."""
    return _votes_fp_dp(lambda r: alive_fraction(c, r), c, k, max_rounds)


def drop_two_factor_dp(d: float, k: int, max_rounds: int) -> np.ndarray:
    """Skip-semantics DP for drops: Binomial(k, 1-d) conclusive votes per
    round, always-alive, first-passage to 134."""
    return _votes_fp_dp(lambda r: 1.0 - d, 0.0, k, max_rounds)


def _window_fp_dp(avail_fn, toggle_c: float, k: int,
                  max_rounds: int) -> np.ndarray:
    """Exact kernel DP — P[finalized by round r] (1-based r).

    State (alive in {0,1}, consider-window pattern in 2^8, bumps<128);
    per vote-slot an ALIVE node shifts a Bernoulli(avail_fn(r)) consider
    bit in and bumps iff the new window has >= QUORUM considered (all
    conclusive votes are honest YES here, so considered ==
    considered-yes); dead nodes' windows freeze, and everything toggles
    dead<->alive with prob `toggle_c` (0 = always alive) after each
    round.  Mean-field over peers, exact in everything else.
    """
    n_w = 1 << WINDOW
    half = n_w >> 1
    popcount = np.array([bin(w).count("1") for w in range(n_w)])
    # Shift map: w -> ((w & 127) << 1) | b; pairs (w, w+128) merge.
    targets0 = (np.arange(half) << 1)           # b = 0 (neutral slot)
    targets1 = targets0 | 1                     # b = 1 (considered yes)
    dist = np.zeros((2, n_w, BUMPS_NEEDED))
    dist[1, 0, 0] = 1.0
    done = np.zeros(max_rounds)
    absorbed = 0.0
    c = toggle_c
    for r in range(max_rounds):
        a = avail_fn(r)
        for _ in range(k):
            mass = dist[1]
            merged = mass[:half] + mass[half:]              # [half, B]
            new = np.zeros_like(mass)
            for b, p, targets in ((0, 1 - a, targets0), (1, a, targets1)):
                bumped = popcount[targets] >= QUORUM
                t_nb, t_b = targets[~bumped], targets[bumped]
                new[t_nb] += p * merged[~bumped]
                src = merged[bumped]
                absorbed += p * src[:, -1].sum()
                new[t_b, 1:] += p * src[:, :-1]
            dist[1] = new
        done[r] = absorbed
        # Toggle: windows and bump counts ride along dead<->alive.
        dead, alive_m = dist[0], dist[1]
        dist = np.stack([dead * (1 - c) + alive_m * c,
                         alive_m * (1 - c) + dead * c])
    return done


def window_dp(c: float, k: int, max_rounds: int) -> np.ndarray:
    """Model 3 under churn: quorum-window DP at the mean-field alive
    fraction, with own-aliveness toggling."""
    return _window_fp_dp(lambda r: alive_fraction(c, r), c, k, max_rounds)


def drop_window_dp(d: float, k: int, max_rounds: int) -> np.ndarray:
    """Default-semantics DP for response DROPS: constant availability
    a = 1-d, node always alive — the clean constant-a validation of the
    C(a) = P[Bin(8,a) >= 7] bump rate (per-slot absences are iid, so no
    trajectory realization noise)."""
    return _window_fp_dp(lambda r: 1.0 - d, 0.0, k, max_rounds)


def measure_cell(n_nodes: int, n_txs: int, rounds: int, c: float,
                 seed: int, skip_absent: bool = False,
                 n_seeds: int = 1, drop: float = 0.0,
                 device="cuda") -> np.ndarray:
    """Per-node finality rounds (1-based; -1 if unfinalized), pooled over
    `n_seeds` alive-trajectory realizations (every node in one run
    shares a single realized alive trajectory)."""
    dev = av._device(device)
    cfg = AvalancheConfig(churn_probability=c, gossip=False,
                          drop_probability=drop,
                          skip_absent_votes=skip_absent)
    out = []
    for s in range(seed, seed + n_seeds):
        state = av.init(prng.key(s, dev), n_nodes, n_txs, cfg, device=dev)
        final, _ = av.run_scan(state, cfg, rounds, device=dev)
        fin_at = final.finalized_at.cpu().numpy()             # [N, T]
        node_round = fin_at.max(axis=1)      # a node's slowest target
        out.append(np.where((fin_at >= 0).all(axis=1), node_round + 1, -1))
    return np.concatenate(out)


def _median_round(done: np.ndarray) -> int | None:
    idx = int(np.searchsorted(done, 0.5))
    return idx + 1 if idx < len(done) else None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=int, default=4096)
    ap.add_argument("--txs", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-seeds", type=int, default=3,
                    help="alive-trajectory realizations pooled per cell "
                    "(see measure_cell)")
    _common.add_device_arg(ap)
    ap.add_argument("--json-out", type=str,
                    default=_common.out_path("churn_tolerance.json"))
    args = ap.parse_args(argv)
    dev = av._device(args.device)
    card = _common.card(dev)

    k = AvalancheConfig().k
    t0 = time.time()

    def sweep(grid, key_name, dps_for, pairings, measure_kw_for):
        """Run one (grid value -> both-semantics measurement + DPs) sweep.

        `dps_for(v)` returns the {model: done-array} dict; `pairings`
        maps a gap name to its (model, mode) comparison; `measure_kw_for`
        returns extra measure_cell kwargs per (value, skip) so churn and
        drop sweeps share every line of accounting (the cross-sweep gap
        comparison in RESULTS.md relies on identical definitions).
        """
        cells = []
        worst = {p: 0.0 for p in pairings}
        for v in grid:
            measured = {
                mode: measure_cell(args.nodes, args.txs, args.rounds,
                                   seed=args.seed, n_seeds=args.n_seeds,
                                   skip_absent=skip, device=dev,
                                   **measure_kw_for(v, skip))
                for mode, skip in (("default", False), ("skip", True))}
            dps = dps_for(v)
            row = {key_name: v,
                   "model_medians": {m: _median_round(d)
                                     for m, d in dps.items()},
                   "completeness": {}}
            for mode, node_round in measured.items():
                fin = node_round >= 0
                row[mode] = {
                    "finalized_fraction": round(float(fin.mean()), 4),
                    "median_final_round": (int(np.median(node_round[fin]))
                                           if fin.any() else None)}
            for r in CUTOFFS:
                if r > args.rounds:
                    continue
                entry = {}
                for mode, node_round in measured.items():
                    fin = node_round >= 0
                    entry[mode] = round(float((node_round[fin] <= r).sum()
                                              / len(node_round)), 4)
                for m, d in dps.items():
                    entry[m] = round(float(d[r - 1]), 4)
                for pairing, (a, b) in pairings.items():
                    worst[pairing] = max(worst[pairing],
                                         abs(entry[a] - entry[b]))
                row["completeness"][str(r)] = entry
            cells.append(row)
            print(f"{key_name}={v:<6} "
                  f"default={row['default']['finalized_fraction']:<7}"
                  f"@{row['default']['median_final_round']} "
                  f"skip={row['skip']['finalized_fraction']:<7}"
                  f"@{row['skip']['median_final_round']} "
                  f"models={row['model_medians']}", flush=True)
        return cells, worst

    cells, worst = sweep(
        CHURN_GRID, "churn",
        lambda c: {"uptime": uptime_dp(c, k, args.rounds),
                   "two_factor": two_factor_dp(c, k, args.rounds),
                   "window": window_dp(c, k, args.rounds)},
        {"uptime_vs_default": ("uptime", "default"),
         "two_factor_vs_default": ("two_factor", "default"),
         "window_vs_default": ("window", "default"),
         "two_factor_vs_skip": ("two_factor", "skip")},
        lambda c, skip: {"c": c})

    # Drop sweep: the same two semantics under per-slot iid response
    # drops (constant availability a = 1-d) — the trajectory-noise-free
    # validation of the C(a) rate and its collapse under the knob.
    drop_cells, drop_worst = sweep(
        DROP_GRID, "drop",
        lambda d: {"window": drop_window_dp(d, k, args.rounds),
                   "two_factor": drop_two_factor_dp(d, k, args.rounds)},
        {"window_vs_default": ("window", "default"),
         "two_factor_vs_skip": ("two_factor", "skip")},
        lambda d, skip: {"c": 0.0, "drop": d})

    # Worst-case 3-sigma band on a measured fraction (p=1/2) over the
    # pooled sample (nodes x seeds); per-node finality events are
    # positively correlated through each run's shared alive trajectory,
    # so treat this as a floor, not the expected residual — the window
    # model's residual above it is mean-field error (see module
    # docstring), conservative side.
    noise = 1.5 / np.sqrt(args.nodes * args.n_seeds)
    result = {
        "config": {"nodes": args.nodes, "txs": args.txs,
                   "rounds": args.rounds, "k": k, "seed": args.seed,
                   "n_seeds": args.n_seeds,
                   "votes_needed": VOTES_NEEDED,
                   "backend": dev.type},
        "cells": cells,
        "drop_cells": drop_cells,
        "worst_gap_per_pairing": {m: round(v, 4) for m, v in worst.items()},
        "drop_worst_gap_per_pairing": {m: round(v, 4)
                                       for m, v in drop_worst.items()},
        "noise_floor_3sigma": round(float(noise), 4),
        "rate_factor_note": "default-mode bump rate per slot = "
                            "P[Bin(8,a)>=7] = a^8 + 8 a^7 (1-a) "
                            "(~8 a^7 for a<1); skip_absent_votes mode "
                            "recovers linear dilution (two-factor DP)",
        "elapsed_s": round(time.time() - t0, 1),
        "card": card,
    }
    _common.write_json(args.json_out, result)
    print(f"\ndrop-sweep worst gaps: {result['drop_worst_gap_per_pairing']}")
    print(f"worst |measured-model| per pairing: "
          f"{result['worst_gap_per_pairing']} "
          f"(3-sigma binomial noise floor "
          f"{result['noise_floor_3sigma']}; the window model's residual "
          f"above it is mean-field error, conservative side)")
    print(f"artifact: {args.json_out} ({result['elapsed_s']}s"
          f"{_common.card_note(card)})")
    return result


if __name__ == "__main__":
    main()
