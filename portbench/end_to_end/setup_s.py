"""Seconds from the start of the process to the window's first timed
round: imports, the kernels' load (or build), the state's init and the
warm-up."""


def read(outcome):
    return outcome.setup_s
