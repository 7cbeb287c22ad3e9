"""Transactions settled per second: the members of every set retired in
the window, over the window's wall time."""


def read(outcome):
    if outcome.window_s <= 0 or "settled_txs" not in outcome.counters:
        return None
    return outcome.counters["settled_txs"] / outcome.window_s
