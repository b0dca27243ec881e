"""K2 in its read-and-clear mode, a window's close (csrc/slot_agg.cu
``region_kernel<true,true>``): each closing group's two aggregate lanes
read once, written once packed for the host and once as the identity."""

from rooflines._work import AGGREGATES, VALUE

KERNELS = ("region_kernel<true,true>",)


def work_bytes(shape, record):
    return shape["close_groups"] * AGGREGATES * VALUE * 3
