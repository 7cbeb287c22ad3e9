"""The Snowball, avalanche and protocol-family studies on the port
against `examples/` on the CPU: `oppose_scaling`, `churn_tolerance`,
`finality_curves`, `basic_preconsensus` and `family_curves`.

The same cells from the same seeds go through the JAX script and its
twin (``--device cpu``); the results must be equal at tolerance 0 apart
from times and the card's label.  Where a script's `main` fixes its
grid, the grid is patched to a cut one and the twin gets the same grid
through its flags; a `main` that reads `sys.argv` gets it patched.
"""

from __future__ import annotations

import functools
import json
import re
import sys

import pytest

import examples.basic_preconsensus as j_bp
import examples.churn_tolerance as j_churn
import examples.family_curves as j_fam
import examples.finality_curves as j_fc
import examples.oppose_scaling as j_op
from go_avalanche_tpu_torch.examples import basic_preconsensus as t_bp
from go_avalanche_tpu_torch.examples import churn_tolerance as t_churn
from go_avalanche_tpu_torch.examples import family_curves as t_fam
from go_avalanche_tpu_torch.examples import finality_curves as t_fc
from go_avalanche_tpu_torch.examples import oppose_scaling as t_op
from test_torch_examples_dag import strip


def run_jax_main(module, argv, monkeypatch):
    """A script `main` that parses `sys.argv`."""
    monkeypatch.setattr(sys, "argv", [module.__file__] + list(argv))
    return module.main()


def test_live_fraction_matches():
    for eps in (0.1, 0.2):
        want = j_op.live_fraction(64, eps, 60, 2)
        got = t_op.live_fraction(64, eps, 60, 2, device="cpu")
        assert got == want
    assert 0.0 < got < 1.0


def test_oppose_main_matches(tmp_path, monkeypatch):
    for module in (j_op, t_op):
        monkeypatch.setattr(module, "N_GRID", (48,))
        monkeypatch.setattr(module, "bisect_threshold", functools.partial(
            module.bisect_threshold, steps=1))
    shape = ["--rounds", "50", "--seeds", "1"]
    want = j_op.main(shape + ["--json-out", str(tmp_path / "j.json")])
    got = t_op.main(shape + ["--device", "cpu",
                             "--json-out", str(tmp_path / "t.json")])
    assert strip(got) == strip(want)


@pytest.mark.parametrize("skip", [False, True])
def test_churn_measure_cell_matches(skip):
    kw = dict(skip_absent=skip, n_seeds=2, drop=0.05)
    want = j_churn.measure_cell(48, 8, 40, 0.03, 1, **kw)
    got = t_churn.measure_cell(48, 8, 40, 0.03, 1, device="cpu", **kw)
    assert got.dtype == want.dtype
    assert got.tolist() == want.tolist()


def test_churn_main_matches(tmp_path, monkeypatch):
    for module in (j_churn, t_churn):
        monkeypatch.setattr(module, "CHURN_GRID", (0.1,))
        monkeypatch.setattr(module, "DROP_GRID", (0.2,))
    shape = ["--nodes", "48", "--txs", "8", "--rounds", "30",
             "--n-seeds", "1"]
    want = j_churn.main(shape + ["--json-out", str(tmp_path / "j.json")])
    got = t_churn.main(shape + ["--device", "cpu",
                                "--json-out", str(tmp_path / "t.json")])
    assert strip(got) == strip(want)


def test_finality_curves_main_matches(monkeypatch, capsys):
    argv = ["--sizes", "16,24,32", "--txs", "8", "--byzantine", "0.0",
            "--max-rounds", "120", "--contested", "--json"]
    run_jax_main(j_fc, argv, monkeypatch)
    want = json.loads(capsys.readouterr().out)
    got = t_fc.main(argv + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == got
    assert (got.pop("backend"), got.pop("card")) == ("cpu", None)
    assert strip(got) == strip(want)
    assert got["log_n_fit"] is not None


def test_finality_run_point_matches():
    want = j_fc.run_point(24, 8, 0.2, 3, 80, adversary="oppose_majority")
    got = t_fc.run_point(24, 8, 0.2, 3, 80, adversary="oppose_majority",
                         device="cpu")
    assert strip(got) == strip(want)


def _lines(text):
    """Printed lines without the wall-clock and rate lines."""
    return [ln for ln in text.strip().splitlines()
            if not ln.startswith(("Finished in", "~"))]


def test_basic_preconsensus_matches(monkeypatch, capsys):
    argv = ["--nodes", "16", "--txs", "8", "--byzantine", "0.1",
            "--drop", "0.05", "--max-rounds", "100", "--logging"]
    run_jax_main(j_bp, argv, monkeypatch)
    want = _lines(capsys.readouterr().out)
    t_bp.main(argv + ["--device", "cpu"])
    got = _lines(capsys.readouterr().out)
    assert got[0] == want[0]
    # The stats dict prints numpy floats on one side: compare values.
    nums = [re.findall(r"[-\d.]+", line.split(":", 1)[1]) for line in
            (got[1], want[1])]
    assert nums[0] == nums[1]


def test_basic_preconsensus_host_api_matches(monkeypatch, capsys):
    argv = ["--nodes", "6", "--txs", "4", "--max-rounds", "300",
            "--host-api", "--seed", "2"]
    run_jax_main(j_bp, argv, monkeypatch)
    want = _lines(capsys.readouterr().out)
    t_bp.main(argv)
    got = _lines(capsys.readouterr().out)
    assert got == want and "6/6" in got[0]


def test_family_curves_main_matches(monkeypatch, capsys):
    argv = ["--nodes", "32", "--byzantine", "0.2", "--seeds", "2",
            "--max-rounds", "150", "--beta", "20", "--adversary",
            "oppose_majority", "--json"]
    run_jax_main(j_fam, argv, monkeypatch)
    want = json.loads(capsys.readouterr().out)
    got = t_fam.main(argv + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == got
    assert strip(got) == strip(want)
