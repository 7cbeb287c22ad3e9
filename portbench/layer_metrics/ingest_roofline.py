"""The ingest kernel's share of its roofline, in %: the least time its
launches could take (`roofline.ingest_bound_s`, from the records and
the polled records of each round of the traced window, one launch a
round) over the device time the profiler measured under the kernel's
own symbols (`roofline.INGEST_KERNELS`).  None on a card without a
published peak in `roofline.PEAKS`."""

from portbench import roofline


def read(slice_):
    kernels = roofline.INGEST_KERNELS
    measured_ms = sum(slice_.kernel_ms.get(k, 0.0) for k in kernels)
    launches = sum(slice_.kernel_launches.get(k, 0) for k in kernels)
    if (measured_ms <= 0 or launches != len(slice_.polls)
            or slice_.card not in roofline.PEAKS):
        return None
    bound_s = sum(roofline.ingest_bound_s(p, slice_.records, slice_.nodes,
                                          slice_.card)
                  for p in slice_.polls)
    return 100.0 * bound_s / (measured_ms / 1e3)
