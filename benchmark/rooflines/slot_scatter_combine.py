"""K1, the slot store's update (csrc/slot_agg.cu ``scatter_combine_kernel``):
each bid's slot (4 bytes) and price (8) read; each (window, auction)
group a batch touches has its two aggregate lanes read and written once."""

from rooflines._work import AGGREGATES, VALUE

KERNELS = ("scatter_combine_kernel",)


def work_bytes(shape, record):
    return shape["bids"] * (4 + 8) + shape["batch_groups"] * AGGREGATES * VALUE * 2
