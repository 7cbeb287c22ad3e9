"""Device ms per streaming step under the program's span
`retire_refill` (`models/streaming_dag._retire_and_refill`)."""

from portbench.tracing import per_round


def read(slice_):
    return per_round(slice_, "retire_refill")
