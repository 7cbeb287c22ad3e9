"""Device ms per round under the program's span `poll_mask`: the
pollable plane and the poll cap (`avalanche.capped_poll_mask`, at most
`max_element_poll` txs a node in score order) of
`models/avalanche.round_step`."""

from portbench.tracing import per_round


def read(slice_):
    return per_round(slice_, "poll_mask")
