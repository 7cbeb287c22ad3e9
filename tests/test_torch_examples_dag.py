"""The conflict-DAG studies on the port against `examples/` on the CPU:
`equivocation_threshold` and `quorum_dial`.

The same cell from the same seed goes through the JAX script's function
and its twin's (``device="cpu"``); the result dicts must be equal at
tolerance 0 (every fraction is a ratio of integer counts).  The
equivocation cells include ``flip_probability`` 0.25 and 0.5 for both
strategies.  A `main` runs on a cut grid: the script's module grid is
patched to it, and the twin gets the same grid through its flags.
"""

from __future__ import annotations

import json

import pytest

import examples.equivocation_threshold as j_eq
import examples.quorum_dial as j_qd
from go_avalanche_tpu.config import AdversaryStrategy as JStrategy
from go_avalanche_tpu_torch.config import AdversaryStrategy
from go_avalanche_tpu_torch.examples import equivocation_threshold as t_eq
from go_avalanche_tpu_torch.examples import quorum_dial as t_qd


def strip(obj, keys=("elapsed_s", "card")):
    """`obj` without the keys that are times or the card's label."""
    if isinstance(obj, dict):
        return {k: strip(v, keys) for k, v in obj.items() if k not in keys}
    if isinstance(obj, list):
        return [strip(v, keys) for v in obj]
    return obj


@pytest.mark.parametrize("strategy,p,eps", [
    ("equivocate", 0.25, 0.1),
    ("equivocate", 0.5, 0.05),
    ("flip", 0.25, 0.45),
    ("flip", 0.5, 0.3),
])
def test_equivocation_cell_matches(strategy, p, eps):
    args = (32, 16, 2, 30, eps, p)
    want = j_eq.sweep_cell(*args, JStrategy(strategy))
    got = t_eq.sweep_cell(*args, AdversaryStrategy(strategy), device="cpu")
    assert got == want
    assert list(got) == list(want)


def test_equivocation_cell_window_and_quorum_match():
    args = (24, 12, 3, 30, 0.1, 0.75)
    kw = dict(seed=3, quorum=4, window=6)
    want = j_eq.sweep_cell(*args, JStrategy.EQUIVOCATE, **kw)
    got = t_eq.sweep_cell(*args, AdversaryStrategy.EQUIVOCATE, device="cpu",
                          **kw)
    assert got == want


def test_equivocation_main_matches(tmp_path, monkeypatch):
    for module in (j_eq, t_eq):
        monkeypatch.setattr(module, "EPS_GRID", (0.05, 0.3))
        monkeypatch.setattr(module, "P_GRID", (0.5,))
    shape = ["--nodes", "24", "--txs", "8", "--rounds", "25"]
    want = j_eq.main(shape + ["--json-out", str(tmp_path / "j.json")])
    got = t_eq.main(shape + ["--device", "cpu",
                             "--json-out", str(tmp_path / "t.json")])
    assert got["card"] is None
    assert strip(got) == strip(want)
    assert strip(json.loads((tmp_path / "t.json").read_text())) \
        == strip(json.loads((tmp_path / "j.json").read_text()))


@pytest.mark.parametrize("quorum,eps,drop,window", [
    (5, 0.05, 0.0, 8),
    (7, 0.0, 0.2, 8),
    (3, 0.05, 0.1, 4),
])
def test_agreement_cell_matches(quorum, eps, drop, window):
    args = (32, 16, 2, 30, quorum, eps, drop)
    want = j_qd.agreement_cell(*args, n_seeds=2, window=window)
    got = t_qd.agreement_cell(*args, n_seeds=2, window=window, device="cpu")
    assert got == want
    assert list(got) == list(want)


def test_quorum_dial_main_matches(tmp_path, monkeypatch):
    for module in (j_qd, t_qd):
        monkeypatch.setattr(module, "QUORUM_GRID", (7,))
        monkeypatch.setattr(module, "EPS_GRID", (0.1,))
        monkeypatch.setattr(module, "WINDOW_PAIRS", ((4, 3),))
    shape = ["--nodes", "24", "--txs", "8", "--rounds", "25",
             "--n-seeds", "1"]
    want = j_qd.main(shape + ["--json-out", str(tmp_path / "j.json")])
    got = t_qd.main(shape + ["--device", "cpu",
                             "--json-out", str(tmp_path / "t.json")])
    assert strip(got) == strip(want)
