"""Host reads of device scalars, counted.

A host loop of the port (`models/backlog.run`, `models/streaming_dag.run`,
`prng.poisson`'s accept/reject loop) decides whether to go on from a
scalar on the device, and reading it waits for the card.  `read` (and
`read_flags`, for the coalesced ring drain's per-age activity flags) is
the one place those loops read, so a run can report how often it
waited: `reads` counts every call since it was last set to 0.  The
flight recorder (`obs/`) copies whole tensors with `to_host`, counted
the same way: the metrics tap's drain, a trace decode and a watchdog
check each make one such copy.

`reading` is nonzero while one of these functions waits on the card,
so the contract audit can tell a counted read from any other
synchronising call (`analysis/audit.py`, under
`torch.cuda.set_sync_debug_mode`).
"""

from __future__ import annotations

import numpy as np
import torch

reads = 0
reading = 0


def read(x: torch.Tensor):
    """The Python value of the one-element tensor `x` (a bool, an int or
    a float), counted in `reads`."""
    global reads, reading
    reads += 1
    reading += 1
    try:
        return x.item()
    finally:
        reading -= 1


def read_flags(x: torch.Tensor) -> list:
    """The Python values of the small one-dimensional tensor `x` in one
    read, counted once in `reads`."""
    global reads, reading
    reads += 1
    reading += 1
    try:
        return x.tolist()
    finally:
        reading -= 1


def to_host(x: torch.Tensor) -> np.ndarray:
    """`x` as a numpy array in one copy to the host, counted once in
    `reads`."""
    global reads, reading
    reads += 1
    reading += 1
    try:
        return x.detach().cpu().numpy()
    finally:
        reading -= 1
