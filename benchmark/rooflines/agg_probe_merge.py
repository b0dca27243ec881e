"""K9, the merge of received partials into each shard's table
(csrc/sharded_agg.cu ``pm_cluster``): each partial read once; its group's
entry read and written once."""

from rooflines._work import GROUP

KERNELS = ("pm_cluster",)


def work_bytes(shape, record):
    return shape["batch_groups"] * GROUP * 3
