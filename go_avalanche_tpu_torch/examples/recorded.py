"""The recorded cells: the four cells of `examples/out/` that the JAX
package's own replays hold, re-run by the twins at their recorded
shapes.

  equivocation   `equivocation_threshold.json`: EQUIVOCATE, eps 0.05,
                 p 1.0 (the cell dict);
  quorum_live    `quorum_dial.json`, quorum 7: the eps 0.05 liveness
                 cell (the cell dict);
  quorum_safety  the same row's (eps 0.05, drop 0.0) safety cell: the
                 per-seed conflict counts (seeds are independent, so a
                 run of the first `n_seeds` compares that prefix);
  oppose         `oppose_scaling.json`: row 0's last bisection probe,
                 the honest finalized fraction over the recorded seeds;
  churn_default  `churn_tolerance.json`: churn 0.01 in the default vote
                 semantics, the measured outcome and completeness;
  churn_skip     the same cell under `skip_absent_votes`, which ingests
                 through the plain engines on every device, by the
                 reference's design (no kernel launches).

Each expected value is read from the artifact when the cell runs;
`replay(name, device)` returns ``{"cell", "want", "got", "rounds",
"seconds"}`` and the caller holds ``got == want``.  ``rounds`` counts
the rounds the cell ran (for Snowball's run-until loop, the rounds it
was allowed).  The artifacts belong to the JAX package: nothing here
writes them.

This module is harness code, not a study: `chip_smoke.py` phase 16 (a)
and the replay tests (`tests/test_torch_examples_replay.py`,
`tests/test_torch_cuda.py`) call it, and no twin imports it.  It reads
the artifacts from the repository checkout (`ARTIFACTS`, two levels
above this package), so it runs only from a checkout, not from an
installed copy of the package.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from go_avalanche_tpu_torch.config import AdversaryStrategy
from go_avalanche_tpu_torch.examples import _common
from go_avalanche_tpu_torch.examples import churn_tolerance as churn
from go_avalanche_tpu_torch.examples import equivocation_threshold as eq
from go_avalanche_tpu_torch.examples import oppose_scaling as oppose
from go_avalanche_tpu_torch.examples import quorum_dial as qd
from go_avalanche_tpu_torch.models.avalanche import _device

ARTIFACTS = Path(__file__).resolve().parents[2] / "examples" / "out"
CELLS = ("equivocation", "quorum_live", "quorum_safety", "oppose",
         "churn_default", "churn_skip")


def artifact(name: str) -> dict:
    """`examples/out/<name>.json`."""
    return json.loads((ARTIFACTS / f"{name}.json").read_text())


def _equivocation(device, n_seeds: Optional[int]) -> tuple:
    art = artifact("equivocation_threshold")
    c = art["config"]
    want = next(x for x in art["cells"] if x["strategy"] == "equivocate"
                and x["p"] == 1.0 and x["eps"] == 0.05)
    got = eq.sweep_cell(c["nodes"], c["txs"], c["conflict_size"],
                        c["rounds"], want["eps"], want["p"],
                        AdversaryStrategy.EQUIVOCATE, device=device)
    return want, got, c["rounds"]


def _quorum_row() -> tuple:
    art = artifact("quorum_dial")
    return art["config"], next(r for r in art["rows"] if r["quorum"] == 7)


def _quorum_live(device, n_seeds: Optional[int]) -> tuple:
    c, row = _quorum_row()
    want = next(x for x in row["cells"] if x["eps"] == 0.05)
    got = eq.sweep_cell(c["nodes"], c["txs"], c["conflict_size"],
                        c["rounds"], eps=0.05, p=1.0,
                        strategy=AdversaryStrategy.EQUIVOCATE, quorum=7,
                        device=device)
    return want, got, c["rounds"]


def _quorum_safety(device, n_seeds: Optional[int]) -> tuple:
    c, row = _quorum_row()
    seeds = c["safety_n_seeds"] if n_seeds is None else n_seeds
    safety = next(s for s in row["safety"]
                  if s["eps"] == 0.05 and s["drop"] == 0.0)
    cell = qd.agreement_cell(c["nodes"], c["txs"], c["conflict_size"],
                             c["rounds"], quorum=7, eps=0.05, drop=0.0,
                             n_seeds=seeds, device=device)
    want = safety["conflicting_sets_per_seed"][:seeds]
    return want, cell["conflicting_sets_per_seed"], c["rounds"] * seeds


def _oppose(device, n_seeds: Optional[int]) -> tuple:
    art = artifact("oppose_scaling")
    row, c = art["rows"][0], art["config"]
    probe = row["probes"][-1]
    live = oppose.live_fraction(row["n"], probe["eps"], c["rounds"],
                                c["seeds"], device=device)
    return ({"n": row["n"], "eps": probe["eps"], "live": probe["live"]},
            {"n": row["n"], "eps": probe["eps"], "live": round(live, 4)},
            c["rounds"] * c["seeds"])


def _churn(device, mode: str) -> tuple:
    art = artifact("churn_tolerance")
    c = art["config"]
    cell = next(x for x in art["cells"] if x["churn"] == 0.01)
    node_round = churn.measure_cell(c["nodes"], c["txs"], c["rounds"], 0.01,
                                    c["seed"], skip_absent=mode == "skip",
                                    n_seeds=c["n_seeds"], device=device)
    fin = node_round >= 0
    got = {"finalized_fraction": round(float(fin.mean()), 4),
           "median_final_round": (int(np.median(node_round[fin]))
                                  if fin.any() else None),
           "completeness": {r: round(float((node_round[fin] <= int(r)).sum()
                                           / len(node_round)), 4)
                            for r in cell["completeness"]}}
    want = {**cell[mode], "completeness": {
        r: e[mode] for r, e in cell["completeness"].items()}}
    return want, got, c["rounds"] * c["n_seeds"]


_REPLAYS = {"equivocation": _equivocation, "quorum_live": _quorum_live,
            "quorum_safety": _quorum_safety, "oppose": _oppose,
            "churn_default": lambda d, _: _churn(d, "default"),
            "churn_skip": lambda d, _: _churn(d, "skip")}


def replay(name: str, device="cuda", n_seeds: Optional[int] = None) -> Dict:
    """Re-run one recorded cell on `device`.  `n_seeds` cuts the
    quorum-dial safety cell to its first seeds (None: all recorded)."""
    dev = _device(device)
    t0 = time.perf_counter()
    want, got, rounds = _REPLAYS[name](dev, n_seeds)
    _common.synchronize(dev)
    return {"cell": name, "want": want, "got": got, "rounds": rounds,
            "seconds": time.perf_counter() - t0}
