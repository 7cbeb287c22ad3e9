"""Vote ingests per second: k x the polled records of every round of the
window, summed on the host, over the window's wall time (which ends
after a synchronise and, in a run to settlement, holds each
simulation's init)."""


def read(outcome):
    if outcome.window_s <= 0 or "votes" not in outcome.counters:
        return None
    return outcome.counters["votes"] / outcome.window_s
