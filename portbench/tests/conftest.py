"""Shared fixtures of the benchmark's tests: the cells at sizes a CPU
test run holds, and the card where one exists (decided inside the
fixture, never at import)."""

import time

import pytest
import torch

from portbench import harness

TINY = {
    "dag10k-settle": {"nodes": 24, "txs": 16, "set_size": 2},
    "stream100k-saturated": {"nodes": 24, "backlog_sets": 64, "set_size": 2,
                             "window_sets": 8},
}


def run_tiny(cell: str, seed: int = 2**31 + 7, trace: bool = False,
             program=None, device="cpu", seconds: float = 0.3) -> dict:
    """A whole run of `cell` at its tiny shape, past the look for a
    card."""
    return harness.run_cell(cell, seed, seconds, trace, torch.device(device),
                            time.perf_counter, time.perf_counter(),
                            shape=TINY[cell], program=program)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)
