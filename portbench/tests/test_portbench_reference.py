"""Each driver against the plain reference at tiny shapes on the CPU,
leaf for leaf, and the reference's parts against the program's."""

import pytest
import torch

from portbench import harness
from portbench.compare import mismatched, rows_to_host
from portbench.drivers import dag_settle, stream_steady
from portbench.reference import dag as ref_dag
from portbench.reference import prng as ref_prng
from portbench.reference import stream as ref_stream
from portbench.tests.conftest import TINY, run_tiny


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_portbench_cell_is_correct_on_cpu(cell, trace):
    line = run_tiny(cell, trace=trace)
    assert line["correct"], line["checks"]
    assert all(c["value"] == 0 for c in line["checks"].values()
               if c["rule"] == "<=")
    assert list(line)[-1] == "checks"


def test_portbench_prng_matches_program():
    from go_avalanche_tpu_torch import prng
    for words in ((0, 7), (123456789, 2**32 - 1)):
        key = torch.tensor(words, dtype=torch.int64)
        assert torch.equal(ref_prng.split(key, 5), prng.split(key, 5))
        assert torch.equal(ref_prng.randint(key, (64, 8), 0, 99_999),
                           prng.randint(key, (64, 8), 0, 99_999))
        assert torch.equal(ref_prng.uniform(key, (1000,)),
                           prng.uniform(key, (1000,)))


def _fields(cell):
    return harness.config_fields(harness.load_cell(cell))


def test_portbench_dag_rounds_leaf_for_leaf():
    fields = _fields("dag10k-settle")
    n, t, c = 24, 16, 2
    program = dag_settle.Port(fields, torch.device("cpu"))
    words = harness.key_words(99, 1)
    cs = torch.arange(t, dtype=torch.int32) // c
    state = program.init(words, n, cs)
    ref = ref_dag.init_settle(torch.tensor(words), n, t, c, fields)
    for _ in range(20):
        assert sum(mismatched(program.leaves(state), ref).values()) == 0
        state, tel = program.round(state)
        ref, ref_tel = ref_dag.round_step(ref, fields, c)
        assert rows_to_host([tel]) == rows_to_host([ref_tel])
        assert bool(program.settled(state)) == ref_dag.settled(ref, fields, c)


def test_portbench_stream_steps_leaf_for_leaf():
    fields = _fields("stream100k-saturated")
    n, s_w, c, s_b = 24, 8, 2, 64
    dev = torch.device("cpu")
    program = stream_steady.Port(fields, dev)
    words = harness.key_words(5)
    scores = torch.randint(0, 16, (s_b, c), dtype=torch.int32)  # many ties
    state = program.init(words, n, s_w, scores)
    ref = ref_stream.init(torch.tensor(words), n, s_w, scores, fields)
    retired = 0
    for _ in range(60):
        assert sum(mismatched(program.leaves(state), ref).values()) == 0
        state, tel = program.step(state)
        ref, ref_tel = ref_stream.step(ref, fields, c)
        assert rows_to_host([tel]) == rows_to_host([ref_tel])
        retired += int(tel["retired_sets"])
    assert retired >= 2 * s_w


def test_portbench_reference_refuses_unimplemented_keys():
    fields = _fields("dag10k-settle")
    ref_dag.check_config(fields)
    for key, value in (("vote_mode", "majority"), ("gossip_nonsense", 1),
                       ("drop_probability", 0.1), ("latency_mode", "fixed")):
        with pytest.raises(ValueError):
            ref_dag.check_config({**fields, key: value})


def test_portbench_mismatch_counts_every_element():
    a = {"x": torch.zeros(4, dtype=torch.int16),
         "y": torch.ones(3, dtype=torch.float32)}
    b = {"x": torch.tensor([0, 1, 0, 1], dtype=torch.int16),
         "y": torch.ones(2, dtype=torch.float32),
         "z": torch.zeros(5)}
    assert mismatched(a, b) == {"x": 2, "y": 2, "z": 5}
