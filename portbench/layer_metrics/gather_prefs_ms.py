"""Device ms per round under the program's span `gather_prefs`: the
preferred-in-set plane, its packing and the peer exchange
(`ops/exchange`, `ops/adversary`) of `models/dag.round_step`."""

from portbench.tracing import per_round


def read(slice_):
    return per_round(slice_, "gather_prefs")
