"""The port's fleet sizing (`go_avalanche_tpu_torch/obs/knee.py`) against
the reference's `benchmarks/vmem_knee.py`.

`select_fleet_shape` fed the reference's archived tables
(`benchmarks/vmem_knee.json`) must return the reference's result dicts
and raise its error texts, bar the cited source, over a grid of device
counts, shapes and fleets.  `per_trial_footprint` is the reference's
plus the key's 8 bytes (a key is int64[2] here).  The port's table
under the reference's model reproduces the archived CPU table's knees;
the H100 table under the port's model is monotone and within its budget
at an 80 GiB card.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmarks import vmem_knee
from go_avalanche_tpu_torch.obs import knee

ARCHIVE = json.loads(Path(vmem_knee.OUT).read_text())["tables"]
GIB = 1024 ** 3
DEVICES = (1, 2, 8)
SHAPES = ((64, 64), (1000, 512), (4096, 4096), (8192, 100), (16384, 16384),
          (65536, 65536), (100_000, 8))
FLEETS = (None, 1, 8, 9, 64, 300, 5000, 10 ** 6)


def _call(fn, *args, **kwargs):
    try:
        return "ok", fn(*args, **kwargs)
    except ValueError as e:
        return "error", str(e)


@pytest.mark.parametrize("table", sorted(ARCHIVE))
@pytest.mark.parametrize("devices", DEVICES)
def test_select_fleet_shape_matches_jax(table, devices):
    """Both functions read the same table under the CPU profile's name,
    so every result and message must agree but for the cited source."""
    tables = {"cpu-ci": ARCHIVE[table]}
    for nodes, txs in SHAPES:
        for fleet in FLEETS:
            want = _call(vmem_knee.select_fleet_shape, "cpu", devices,
                         nodes, txs, fleet=fleet, tables=tables)
            got = _call(knee.select_fleet_shape, "cpu", devices, nodes,
                        txs, fleet=fleet, tables=tables)
            if want[0] == "error":
                want = ("error", want[1].replace(
                    f"benchmarks/{vmem_knee.OUT.name}", knee.SOURCE))
            assert got == want, (table, devices, nodes, txs, fleet)


def test_unknown_platform_and_device_count_refused_as_in_jax():
    for args in (("gpu", 1, 64, 64), ("cpu", 0, 64, 64)):
        with pytest.raises(ValueError) as want:
            vmem_knee.select_fleet_shape(*args, tables=ARCHIVE)
        with pytest.raises(ValueError) as got:
            knee.select_fleet_shape(*args, tables=ARCHIVE)
        assert str(got.value).split(" (")[0] == str(want.value).split(" (")[0]


@pytest.mark.parametrize("nt", [64, 128, 256, 512, 1024])
def test_per_trial_footprint_is_the_reference_plus_the_key(nt):
    assert knee.per_trial_footprint(nt) == vmem_knee.per_trial_footprint(
        nt) + 8


def test_reference_model_reproduces_the_archived_cpu_knees():
    ref = ARCHIVE["cpu-ci"]
    got = knee.knee_table("cpu-ci", peak_model="stacked",
                          temp_ratio=ref["temp_ratio"])
    assert got["hbm_bytes"] == ref["hbm_bytes"]
    assert got["headroom"] == ref["headroom"]
    for mine, theirs in zip(got["rows"], ref["rows"]):
        assert mine["fleet"] == theirs["fleet"]
        assert mine["largest_nt"] == theirs["largest_nt"]
        assert (mine["per_trial_state_bytes"]
                == theirs["per_trial_state_bytes"] + 8)


def test_h100_table_is_monotone_and_within_budget():
    tab = knee.knee_table("h100", hbm_bytes=80 * GIB)
    budget = knee.HEADROOM * 80 * GIB
    rows = {r["fleet"]: r for r in tab["rows"]}
    assert tab["peak_model"] == "loop"
    sizes = [r["largest_nt"] for r in tab["rows"]]
    assert sizes == sorted(sizes, reverse=True)
    for r in tab["rows"]:
        assert r["modeled_live_peak_bytes"] <= budget
        assert r["per_device_state_bytes"] == (r["trials_per_device"]
                                               * r["per_trial_state_bytes"])
    assert (rows[1]["largest_nt"], rows[8]["largest_nt"],
            rows[64]["largest_nt"]) == (32768, 16384, 8192)
    # 8 trials of the flagship: the stack plus one round's scratch.
    state = rows[8]["per_trial_state_bytes"]
    assert state == 2_416_230_420
    assert rows[8]["modeled_live_peak_bytes"] == int(
        8 * state + tab["temp_ratio"]["ratio"] * state)
    pick = knee.select_fleet_shape("cuda", 1, 16384, 16384,
                                   tables={"h100": tab})
    assert pick["fleet"] == 8 and pick["profile"] == "h100"
    # the reference's model picks the same F at 16384²
    stacked = knee.knee_table("h100", hbm_bytes=80 * GIB,
                              peak_model="stacked")
    assert knee.select_fleet_shape("cuda", 1, 16384, 16384,
                                   tables={"h100": stacked})["fleet"] == 8
    with pytest.raises(ValueError, match="caps the 64 trials/chip row at "
                                         "8192²"):
        knee.select_fleet_shape("cuda", 1, 16384, 16384, fleet=64,
                                tables={"h100": tab})
