"""The recorded cells of `examples/out/` reproduced by the study twins on
the port's CPU path, at their recorded shapes.

The port's counterparts of `tests/test_examples_analysis.py`'s four
``*_reproduces_cross_backend`` replays (`slow`, as theirs are): each
reads its artifact and asserts the same equality
(`go_avalanche_tpu_torch/examples/recorded.py`).  The card runs the
same cells in `tests/test_torch_cuda.py` and in `chip_smoke.py`.
"""

from __future__ import annotations

import pytest

from go_avalanche_tpu_torch.examples import recorded


@pytest.mark.slow
def test_equivocation_artifact_reproduces_on_the_port():
    row = recorded.replay("equivocation", device="cpu")
    assert row["got"] == row["want"], row


@pytest.mark.slow
def test_quorum_dial_artifact_reproduces_on_the_port():
    for name in ("quorum_live", "quorum_safety"):
        row = recorded.replay(name, device="cpu")
        assert row["got"] == row["want"], row


@pytest.mark.slow
def test_oppose_artifact_reproduces_on_the_port():
    row = recorded.replay("oppose", device="cpu")
    assert row["got"] == row["want"], row


@pytest.mark.slow
def test_retire_cap_artifact_reproduces_on_the_port():
    """The retire-cap study's recorded cap-4 cell at its recorded shape
    (the JAX package's own replay of it is tier-1)."""
    from go_avalanche_tpu_torch.examples import retire_cap_tradeoff

    art = recorded.artifact("retire_cap_tradeoff")
    want = next(c for c in art["cells"] if c["cap"] == 4)
    assert retire_cap_tradeoff.run_cell(4, device="cpu") == want


@pytest.mark.slow
def test_churn_artifact_reproduces_on_the_port():
    for name in ("churn_default", "churn_skip"):
        row = recorded.replay(name, device="cpu")
        assert row["got"] == row["want"], row
