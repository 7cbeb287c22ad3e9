"""The Monte-Carlo fleet studies on the port against `examples/` on the
CPU: `adversary_atlas`, `committee_scaling` and `fault_scenarios`'s
`monte_carlo`.

The port's fleet loops over the reference's trial keys where the JAX
package vmaps them; the same fleet from the same seed must give the
same rows, curves, spot-check and verdicts at tolerance 0 (apart from
times and the card's label).
"""

from __future__ import annotations

import json

import examples.adversary_atlas as j_atlas
import examples.committee_scaling as j_cs
import examples.fault_scenarios as j_fs
from go_avalanche_tpu_torch import obs
from go_avalanche_tpu_torch.examples import adversary_atlas as t_atlas
from go_avalanche_tpu_torch.examples import committee_scaling as t_cs
from go_avalanche_tpu_torch.examples import fault_scenarios as t_fs
from test_torch_examples_dag import strip
from test_torch_examples_models import run_jax_main


def test_atlas_quick_main_matches(tmp_path):
    argv = ["--quick", "--nodes", "16", "--fleet", "2", "--rounds", "30",
            "--finalization-score", "12"]
    want = j_atlas.main(argv + ["--json-out", str(tmp_path / "j.json")])
    got = t_atlas.main(argv + ["--device", "cpu",
                               "--json-out", str(tmp_path / "t.json")])
    assert strip(got) == strip(want)
    assert json.loads(json.dumps(strip(got))) == strip(
        json.loads((tmp_path / "j.json").read_text()))


def test_atlas_spot_check_matches():
    want = j_atlas.spot_check(24, 4, 40, 16, 0.35, seed=3)
    got = t_atlas.spot_check(24, 4, 40, 16, 0.35, seed=3, device="cpu")
    assert got == want


def test_committee_main_matches(monkeypatch, capsys):
    argv = ["--sizes", "12", "--fleet", "2", "--rounds", "50",
            "--txs", "4", "--clusters", "3", "--k", "6", "--zipf-s", "1.2",
            "--seed", "1", "--json"]
    run_jax_main(j_cs, argv, monkeypatch)
    want = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    got = t_cs.main(argv + ["--device", "cpu"])
    assert [json.loads(x) for x in capsys.readouterr().out.splitlines()] \
        == got == want


def test_fault_monte_carlo_matches(tmp_path):
    kw = dict(nodes=24, txs=8, fleet=3, n_rounds=40, seed=1)
    want = j_fs.run_monte_carlo(**kw)
    path = tmp_path / "t.jsonl"
    got = t_fs.run_monte_carlo(metrics_path=str(path), device="cpu", **kw)
    assert got.pop("metrics_file") == str(path)
    assert want.pop("metrics_file") is None
    assert got == want
    assert obs.manifest_path_for(path).exists()
    assert len(path.read_text().splitlines()) == kw["n_rounds"]


def test_fault_main_matches(monkeypatch, capsys):
    argv = ["flaky_isp", "--nodes", "24", "--txs", "8", "--json"]
    run_jax_main(j_fs, argv, monkeypatch)
    want = json.loads(capsys.readouterr().out)
    got = t_fs.main(argv + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == got == want
