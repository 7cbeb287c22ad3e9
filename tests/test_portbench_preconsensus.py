"""The benchmark's pre-consensus cell and its FLIP cell on the CPU: the
port's flat round (`models/avalanche`) against the plain reference
`portbench/reference/avalanche.py` under a binding poll cap, the DAG
round against `portbench/reference/dag.py` under the `byz20-flip` mix,
the control rule that must break the comparison, the megakernel's bytes,
and the new files of the benchmark.  Tolerance 0.

The drivers' wrappers (`Port`, `Reference`) run here directly, never
through `harness.run_cell`, whose refusal of a loaded JAX would trip in
a test process that imported JAX for other tests.
"""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from portbench import harness, roofline_megakernel, tracing
from portbench.compare import mismatched, rows_to_host, telemetry_mismatches
from portbench.drivers import dag_settle, preconsensus_settle
from portbench.layer_metrics import megakernel_roofline
from portbench.reference import avalanche as ref_av
from portbench.reference import dag as ref_dag

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
H100 = "NVIDIA H100 80GB HBM3"
FLAT = "preconsensus16k-settle"
BYZ = "dag10k-byz20-flip"


def _fields(cell, **changes):
    return {**harness.config_fields(harness.load_cell(cell)), **changes}


def _settle(program, words, n, init_arg, max_rounds):
    """``(final leaves, telemetry rows, settled)`` of one simulation of a
    driver's wrapper, as the drivers run it."""
    state = program.init(words, n, init_arg)
    rows = []
    while len(rows) < max_rounds and not bool(program.settled(state)):
        state, tel = program.round(state)
        rows.append(tel)
    return program.leaves(state), rows, bool(program.settled(state))


@pytest.mark.parametrize("seed", [2**31 + 11, 7])
@pytest.mark.parametrize("engine", ["phased", "megakernel"])
def test_flat_round_matches_the_reference_under_a_binding_cap(engine, seed):
    """64 x 64 with 16 polls a node a round, from a 50/50 split, to
    settlement: every plane and every round's counters equal."""
    fields = _fields(FLAT, max_element_poll=16, round_engine=engine)
    n = t = 64
    words = harness.key_words(seed, 1)
    leaves, rows, done = _settle(preconsensus_settle.Port(fields, CPU),
                                 words, n, t, 2000)
    ref, ref_rows = ref_av.run_settle(torch.tensor(words), n, t, fields,
                                      2000)
    assert done and ref_av.settled(ref, fields)
    assert mismatched(leaves, ref) == dict.fromkeys(ref, 0)
    assert set(leaves) == set(ref)
    got, want = rows_to_host(rows), rows_to_host(ref_rows)
    assert telemetry_mismatches(got, want) == 0 and len(got) == len(want)
    # The cap binds: no round polls more than 16 txs a node, and the
    # first polls exactly that many.
    assert want[0]["polls"] == 16 * n
    assert max(r["polls"] for r in want) <= 16 * n
    assert sum(r["finalizations"] for r in want) == n * t


@pytest.mark.parametrize("seed", [2**32 + 3, 5])
def test_dag_round_matches_the_reference_under_byz20_flip(seed):
    fields = _fields(BYZ)
    assert (fields["byzantine_fraction"], fields["flip_probability"],
            fields["adversary_strategy"]) == (0.2, 1.0, "flip")
    n, t, c = 24, 16, 2
    words = harness.key_words(seed, 1)
    cs = torch.arange(t, dtype=torch.int32) // c
    leaves, rows, done = _settle(dag_settle.Port(fields, CPU), words, n, cs,
                                 600)
    ref, ref_rows = ref_dag.run_settle(torch.tensor(words), n, t, c, fields,
                                       600)
    assert done and ref_dag.settled(ref, fields, c)
    assert mismatched(leaves, ref) == dict.fromkeys(ref, 0)
    assert telemetry_mismatches(rows_to_host(rows),
                                rows_to_host(ref_rows)) == 0
    assert int(leaves["byzantine"].sum()) == round(0.2 * n)


def test_control_rule_breaks_the_flat_comparison():
    """The reference with `vote_mode` "majority" in the program's place,
    as `portbench.control` puts it: its planes and counters differ from
    the sequential reference's after the same rounds."""
    fields = _fields(FLAT, max_element_poll=16)
    n = t = 64
    words = harness.key_words(3, 1)
    control = preconsensus_settle.Reference(fields, CPU, 1,
                                            vote_mode="majority")
    honest = preconsensus_settle.Reference(fields, CPU, 1)
    got, got_rows, _ = _settle(control, words, n, t, 40)
    want, want_rows, _ = _settle(honest, words, n, t, 40)
    assert sum(mismatched(got, want).values()) > 0
    assert telemetry_mismatches(rows_to_host(got_rows),
                                rows_to_host(want_rows)) > 0
    with pytest.raises(ValueError, match="one-tx sets"):
        preconsensus_settle.Reference(fields, CPU, 2)


def test_megakernel_bytes_at_16384_squared():
    import chip_smoke

    n = t = 16384
    b = roofline_megakernel.megakernel_bytes(n, t, 8)
    assert b == 10 * n * t + n * t // 8 + 6 * n * 8 + t // 8
    bound_ms = roofline_megakernel.megakernel_bound_s(n, t, 8, H100) * 1e3
    assert bound_ms == pytest.approx(0.8116, abs=5e-5)
    assert chip_smoke.megakernel_bound(n, t, 8) == (
        pytest.approx(bound_ms, rel=1e-12), "bytes")
    with pytest.raises(ValueError):
        roofline_megakernel.megakernel_bytes(n, t, 9)


def test_megakernel_roofline_reader():
    sl = preconsensus_settle.FlatTraceSlice(
        rounds=2, polls=[16384 * 4096] * 2, nodes=16384,
        records=16384 ** 2, card=H100, window_s=1.0, k=8)
    part = roofline_megakernel.KERNEL
    assert megakernel_roofline.read(sl) is None           # nothing measured
    bound_s = roofline_megakernel.megakernel_bound_s(16384, 16384, 8, H100)
    sl.kernel_ms = {part: 2 * 2 * bound_s * 1e3}
    sl.kernel_launches = {part: 2}
    assert megakernel_roofline.read(sl) == pytest.approx(50.0)
    sl.kernel_launches = {part: 3}                    # not one a round
    assert megakernel_roofline.read(sl) is None
    sl.kernel_launches = {part: 2}
    plain = tracing.TraceSlice(**{f.name: getattr(sl, f.name) for f in
                                  dataclasses.fields(tracing.TraceSlice)})
    assert megakernel_roofline.read(plain) is None    # no k to count by
    sl.card = "a card without a published peak"
    assert megakernel_roofline.read(sl) is None


@pytest.mark.parametrize("cell", [FLAT, BYZ])
def test_new_cell_files_parse_and_state_every_key(cell):
    from go_avalanche_tpu_torch.config import AvalancheConfig

    bench = harness.benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}[cell]
    loaded = harness.load_cell(cell)
    assert (loaded.params["config"], loaded.params["traffic"]) == (
        entry["config"], entry["traffic"])
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    assert loaded.config["source"] == config["source"]
    assert loaded.config["reduced"] == config["reduced"] == []
    assert set(loaded.config["avalanche_config"]) == {
        f.name for f in dataclasses.fields(AvalancheConfig)}
    harness.program_config(harness.config_fields(loaded))    # validates
    driver = harness.load_module("drivers", loaded.traffic["driver"])
    checker = ref_av if cell == FLAT else ref_dag
    checker.check_config(harness.config_fields(loaded))
    assert callable(driver.run)
    e2e, layer = harness.applicable(cell, bench)
    assert {m["name"] for m in e2e} == {"votes_per_s.dag",
                                        "round_ms_p95.dag", "setup_s"}
    want = ({"megakernel_roofline", "fused_round_ms", "poll_mask_ms",
             "gather_prefs_ms.flat"} if cell == FLAT
            else {"gather_prefs_ms.byz"})
    assert {m["name"] for m in layer} == want
    for m in layer:
        assert callable(harness.load_reader("layer_metrics", m["name"]).read)


def test_preconsensus_config_is_go_avalanches_round():
    config = json.loads((REPO / "portbench/configs/preconsensus-16k.json")
                        .read_text())
    fields = config["avalanche_config"]
    dag = json.loads((REPO / "portbench/configs/dag-10k.json").read_text())
    differs = {k for k, v in fields.items()
               if dag["avalanche_config"][k] != v}
    assert differs == {"max_element_poll", "round_engine", "gossip"}
    assert (fields["max_element_poll"], fields["round_engine"],
            fields["gossip"]) == (4096, "megakernel", False)
    assert (fields["finalization_score"], fields["k"], fields["window"],
            fields["quorum"], fields["vote_mode"]) == (128, 8, 8, 7,
                                                       "sequential")
    assert config["shape"] == {"nodes": 16384, "txs": 16384, "set_size": 1}
    assert len(config["source"]) <= 200
    traffic = harness.load_json("traffic", "contested-settle")
    assert (traffic["driver"], traffic["max_rounds"]) == (
        "preconsensus_settle", 2000)
    with pytest.raises(ValueError, match="gossip"):
        ref_av.check_config({**fields, "gossip": True})
    with pytest.raises(ValueError, match="adversary_strategy"):
        ref_av.check_config({**fields, "adversary_strategy": "equivocate"})
