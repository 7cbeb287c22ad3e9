"""The port's op-class histograms (`go_avalanche_tpu_torch/analysis/drift.py`)
against the JAX package's `analysis/drift.py`.

`diff_histograms` is pure dict logic and must give the reference's exact
lines on pairs with appeared, vanished, changed and identical classes.
`op_histogram` has no reference value (the reference counts StableHLO
text): a 64 x 64 flagship round's histogram must be the same over two
calls, name only dispatched operators on the CPU, and count a
``kernel:`` class per launch the counters record.
"""

from __future__ import annotations

import pytest
import torch

from go_avalanche_tpu.analysis import drift as jdrift
from go_avalanche_tpu_torch import workload
from go_avalanche_tpu_torch.analysis import drift
from go_avalanche_tpu_torch.models import avalanche as av

PAIRS = {
    "appeared": ({"stablehlo.add": 3}, {"stablehlo.add": 3,
                                        "custom_call:x": 1}),
    "vanished": ({"stablehlo.add": 3, "stablehlo.or": 2},
                 {"stablehlo.add": 3}),
    "changed": ({"aten.add": 5, "aten.mul": 1, "kernel:vote_u8": 1},
                {"aten.add": 7, "aten.mul": 1, "kernel:vote_u8": 2}),
    "identical": ({"aten.add": 2}, {"aten.add": 2}),
    "mixed": ({"a": 1, "b": 4, "c": 9}, {"b": 1, "c": 9, "d": 4, "e": 3}),
    "empty": ({}, {}),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_diff_histograms_matches_jax(name):
    archived, current = PAIRS[name]
    assert (drift.diff_histograms(archived, current)
            == jdrift.diff_histograms(archived, current))


def _flagship_step():
    state, cfg = workload.flagship_state(64, 64, device="cpu")
    return (lambda s: av.round_step(s, cfg)[0]), state


def test_op_histogram_of_a_flagship_round_is_deterministic():
    step, state = _flagship_step()
    first = drift.op_histogram(step, state)
    assert first == drift.op_histogram(step, state)
    # dispatched operators only on the CPU (the spans of `annotate` are
    # the profiler's operators)
    assert {k.split(".")[0] for k in first} == {"aten", "profiler"}
    assert first["aten.index"] >= 1       # the one peer gather
    assert sum(first.values()) > 100


def test_op_histogram_counts_kernel_launches(monkeypatch):
    from go_avalanche_tpu_torch.ops import megakernel, pallas_vote

    monkeypatch.setitem(pallas_vote.launches, "vote_u8", 5)
    monkeypatch.setattr(megakernel, "launches", 2)

    def step(x):
        pallas_vote.launches["vote_u8"] += 2
        megakernel.launches += 1
        return x + 1

    hist = drift.op_histogram(step, torch.zeros(3))
    assert hist == {"aten.add": 1, "kernel:vote_u8": 2,
                    "kernel:megakernel": 1}


def test_op_recorder_marks_index_tensors_and_syncs():
    """An int64 tensor that becomes an index (through int64 ops) is
    marked; an int64 plane that never indexes is not; a value read back
    is a sync."""
    x = torch.arange(16, dtype=torch.int32)
    rec = drift.OpRecorder()
    with rec:
        idx = x.long() % 4                # two int64 ops, then an index
        y = torch.arange(8.0)[idx]
        wide = x.long() * 3               # never an index
        flag = bool((y > 2).any())
    names = [name for name, _, _ in rec.ops]
    marked = {names[p] for p in rec.indices}
    assert {"aten._to_copy", "aten.remainder"} <= marked
    assert names.index("aten.mul") not in rec.indices
    assert flag
    assert [s for s, _ in rec.syncs] == ["aten._local_scalar_dense"]
    del wide
