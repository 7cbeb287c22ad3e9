"""The streaming-scheduler and fault studies on the port against
`examples/` on the CPU: `retire_cap_tradeoff`, `window_scaling`,
`capacity_planning` and `fault_scenarios` (its partition study and
scripted scenarios; the Monte-Carlo one rides with the fleets).

The same cells from the same seeds go through the JAX script and its
twin (``device="cpu"``); the results must be equal at tolerance 0 apart
from times, rates and the card's label.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

import examples.capacity_planning as j_cp
import examples.fault_scenarios as j_fs
import examples.retire_cap_tradeoff as j_rc
import examples.window_scaling as j_ws
from go_avalanche_tpu_torch.examples import capacity_planning as t_cp
from go_avalanche_tpu_torch.examples import fault_scenarios as t_fs
from go_avalanche_tpu_torch.examples import retire_cap_tradeoff as t_rc
from go_avalanche_tpu_torch.examples import window_scaling as t_ws
from test_torch_examples_dag import strip
from test_torch_examples_models import run_jax_main

RATE_KEYS = ("elapsed_s", "card", "wall_s", "txs_per_sec")


def test_retire_cap_main_matches(tmp_path, monkeypatch):
    shape = dict(NODES=8, BACKLOG_SETS=24, WINDOW_SETS=6, CAPS=(None, 2))
    for name, value in shape.items():
        monkeypatch.setattr(j_rc, name, value)
        monkeypatch.setattr(t_rc, name, value)
    want = j_rc.main(["--json-out", str(tmp_path / "j.json")])
    got = t_rc.main(["--device", "cpu",
                     "--json-out", str(tmp_path / "t.json")])
    assert got == want
    assert json.loads((tmp_path / "t.json").read_text()) \
        == json.loads((tmp_path / "j.json").read_text())


def test_window_scaling_main_matches(tmp_path):
    argv = ["--nodes", "24", "--windows", "8", "--fill", "3", "--seed", "1"]
    want = j_ws.main(argv + ["--json-out", str(tmp_path / "j.json")])
    got = t_ws.main(argv + ["--device", "cpu",
                            "--json-out", str(tmp_path / "t.json")])
    assert [c["model"] for c in got] == ["backlog", "streaming_dag"]
    assert all(c["wall_s"] > 0 and c["txs_per_sec"] > 0 for c in got)
    assert strip(got, RATE_KEYS) == strip(want, RATE_KEYS)


def test_capacity_planning_matches(monkeypatch, capsys):
    argv = ["--rates", "3,12", "--nodes", "16", "--slots", "8",
            "--txs", "64", "--slo", "40", "--seed", "2",
            "--backpressure", "0.5,0.9"]
    run_jax_main(j_cp, argv, monkeypatch)
    want = capsys.readouterr().out.strip().splitlines()
    t_cp.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    assert got[0] == want[0] + " on cpu"
    assert got[1:] == want[1:]


def test_fault_measure_matches(tmp_path):
    kw = dict(nodes=32, txs=8, partition_start=3, partition_end=20,
              n_rounds=40, seed=1)
    for skip in (False, True):
        paths = [str(tmp_path / f"{side}{int(skip)}.jsonl")
                 for side in "jt"]
        want = j_fs.measure(skip_absent=skip, metrics_path=paths[0], **kw)
        got = t_fs.measure(skip_absent=skip, metrics_path=paths[1],
                           device="cpu", **kw)
        assert (got.pop("metrics_file"), want.pop("metrics_file")) \
            == (paths[1], paths[0])
        assert got == want
        assert Path(paths[1]).read_text() == Path(paths[0]).read_text()


@pytest.mark.parametrize("name", sorted(j_fs.SCENARIOS))
def test_fault_scenario_matches(name):
    want = j_fs.run_scenario(name, nodes=16, txs=8, seed=2)
    got = t_fs.run_scenario(name, nodes=16, txs=8, seed=2, device="cpu")
    assert got == want
    assert got["recovered"]
