"""Share of the wall time of the traced work in which no device
operation ran, in %: one less the union of the profiler's device
intervals over the wall time of the same work run untraced just before
(`pace_s`).  The profiler slows a host-paced round, so its own window
would count its overhead as idle.  None where the driver ran no
untraced stretch, or where the device time exceeds it."""


def read(slice_):
    if not slice_.pace_s or slice_.busy_s <= 0:
        return None
    if slice_.busy_s > slice_.pace_s:
        return None
    return 100.0 * (1.0 - slice_.busy_s / slice_.pace_s)
