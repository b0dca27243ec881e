"""K10's spill, the partials no table slot took appended to the spill rows
(csrc/table_compact.cuh ``compact_table<3>``): each partial's still-flag
read (1 byte); with nothing spilled, nothing more."""

KERNELS = ("compact_table<3>",)


def work_bytes(shape, record):
    return shape["batch_groups"] * 1
