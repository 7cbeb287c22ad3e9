"""Host ms of each simulation's `models/dag.init` in the traced window,
from a synchronise before it to one after it; the mean."""


def read(slice_):
    if not slice_.init_ms:
        return None
    return sum(slice_.init_ms) / len(slice_.init_ms)
