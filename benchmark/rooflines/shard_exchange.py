"""K10's exchange, the partials ranked and placed by owner shard
(csrc/sharded_agg.cu ``ex_count``, ``ex_scatter``): each partial read once
and written once into its owner's send rows."""

from rooflines._work import GROUP

KERNELS = ("ex_count", "ex_scatter")


def work_bytes(shape, record):
    return shape["batch_groups"] * GROUP * 2
