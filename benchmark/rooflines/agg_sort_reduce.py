"""K8, the mesh's sort-reduce of a step's rows into partials, one per group
(csrc/sharded_agg.cu, every kernel of one call): each bid's key, bin and
price read once; each group the batch touches written once as a partial."""

from rooflines._work import BIN, GROUP, KEY

KERNELS = ("sr_count", "sr_compact", "sr_block", "sr_sweep", "sr_run_count", "sr_run_scan",
           "sr_reduce", "sr_walk_long")


def work_bytes(shape, record):
    return shape["bids"] * (KEY + BIN + 8) + shape["batch_groups"] * GROUP
