"""K4, the chained segment's one kernel a batch (ops/segment_kernel.py):
filter the bids, project auction and price, fold the watermark, key and
bin each row. Reads what the expressions need: the bid flag of every
event (1 byte) and a bid's time, auction and price (8 bytes each); where
the mesh's fusion filters the bids on the host first, the bids' three
columns alone. Writes what the window store needs of a bid: its key (the
auction), its bin and its price, and the watermark's max and count (16
bytes a batch)."""

from rooflines._work import BIN, KEY, VALUE, mesh

KERNELS = ("segment_fused_kernel",)


def work_bytes(shape, record):
    flags = 0 if mesh(record) else shape["events"]
    return flags + shape["bids"] * (3 * 8 + KEY + BIN + VALUE) + shape["batches"] * 16
