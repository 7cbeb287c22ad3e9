"""Every cell, configuration, traffic mix, driver and metric that
BENCHMARK.json names is a file of its own, found by name."""

import dataclasses
import json
import re

import pytest

from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", BENCH["workloads"],
                         ids=lambda w: w["name"])
def test_portbench_cell_files_match_benchmark(workload):
    cell = harness.load_cell(workload["name"])
    assert cell.params["config"] == workload["config"]
    assert cell.params["traffic"] == workload["traffic"]
    assert workload["chips"] in (1, 4)
    driver = harness.load_module("drivers", cell.traffic["driver"])
    assert callable(driver.run)
    assert len(workload["why"]) <= 200


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_portbench_config_files_state_every_key(config):
    from go_avalanche_tpu_torch.config import AvalancheConfig
    data = json.loads(open(config["file"]).read())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert config["file"].startswith("portbench/configs/")
    assert set(data["avalanche_config"]) == {
        f.name for f in dataclasses.fields(AvalancheConfig)}
    assert data["reduced"] == config["reduced"]
    for key in config["reduced"]:
        assert key in data and NAME.match(key)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_portbench_metric_readers_exist(metric):
    kind = "layer_metrics" if "layer" in metric else "end_to_end"
    module = harness.load_reader(kind, metric["name"])
    assert callable(module.read)
    assert module.__name__.startswith(f"portbench.{kind}.")
    assert NAME.match(metric["name"])


def test_portbench_benchmark_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert 1 <= BENCH["run_seconds"] <= 51
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        e, layer = harness.applicable(w["name"], BENCH)
        names = {m["name"] for m in e}
        assert "setup_s" in names and len(names) >= 2 and layer
