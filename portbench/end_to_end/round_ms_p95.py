"""95th percentile of the wall time of every round (or streaming step)
of the window, from the start of its dispatch to the return of its one
host read, in ms."""

from portbench.stats import percentile


def read(outcome):
    if len(outcome.round_s) < 20:
        return None
    return percentile(outcome.round_s, 95) * 1e3
