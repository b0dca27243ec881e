"""K11, a window's close over the shards (csrc/table_compact.cuh
``compact_table<0>``): each closing group's entry read once and written
once packed for the host, and its slot freed (1 byte)."""

from rooflines._work import GROUP

KERNELS = ("compact_table<0>",)


def work_bytes(shape, record):
    return shape["close_groups"] * (GROUP * 2 + 1)
