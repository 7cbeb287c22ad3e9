"""The whole-round megakernel's share of its roofline, in %: the least
time its launches could take (`roofline_megakernel.megakernel_bound_s`,
one launch over every record a round) over the device time the profiler
measured under the kernel's own symbol (`roofline_megakernel.KERNEL`).
None unless the kernel launched once a round of the traced window, or
on a card without a published peak in `roofline.PEAKS`."""

from portbench import roofline, roofline_megakernel


def read(slice_):
    part = roofline_megakernel.KERNEL
    measured_ms = slice_.kernel_ms.get(part, 0.0)
    launches = slice_.kernel_launches.get(part, 0)
    k = getattr(slice_, "k", 0)
    if (measured_ms <= 0 or launches != slice_.rounds or not k
            or slice_.card not in roofline.PEAKS):
        return None
    txs = slice_.records // slice_.nodes
    bound_s = launches * roofline_megakernel.megakernel_bound_s(
        slice_.nodes, txs, k, slice_.card)
    return 100.0 * bound_s / (measured_ms / 1e3)
