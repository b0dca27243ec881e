"""Each kernel's bytes of work against a count by hand at a small shape, and
the roofline share's arithmetic on a made-up trace."""

import pytest

from metrics import kernel_roofline_share as share
from run import BENCH, load_module

# 2 batches of 100 events: 92 bids, 30 (window, auction) groups touched over both batches,
# 3 windows closing with 12 groups between them
SHAPE = {"batches": 2, "events": 100, "bids": 92, "batch_groups": 30, "windows_closed": 3,
         "close_groups": 12}
SLOTS = {"settings": {"device.mesh-devices": 0}}
MESH = {"settings": {"device.mesh-devices": 8}}
GROUP = 8 + 4 + 2 * 8  # key, bin, MAX and COUNT

HAND = [
    # K4: a flag byte of every event (the slot path only), a bid's time, auction and price
    # read; its key (8), bin (4) and price (8) written; 16 bytes of watermark a batch
    ("segment_fused", SLOTS, 100 * 1 + 92 * (3 * 8 + 8 + 4 + 8) + 2 * 16),
    ("segment_fused", MESH, 92 * (3 * 8 + 8 + 4 + 8) + 2 * 16),
    # K1: a bid's 4-byte slot and 8-byte price; each group's two lanes read and written
    ("slot_scatter_combine", SLOTS, 92 * 12 + 30 * 2 * 8 * 2),
    # K2: a closing group's two lanes read, written packed, written as the identity
    ("slot_region_read_pack", SLOTS, 12 * 2 * 8 * 3),
    # K8: a bid's key, bin and price read; a partial a group written
    ("agg_sort_reduce", MESH, 92 * (8 + 4 + 8) + 30 * GROUP),
    # K10: a partial read and written; its spill: a still-flag a partial
    ("shard_exchange", MESH, 30 * GROUP * 2),
    ("shard_spill", MESH, 30),
    # K9: a partial read, its group's entry read and written
    ("agg_probe_merge", MESH, 30 * GROUP * 3),
    # K11: a closing group read and written packed, its slot freed
    ("shard_extract", MESH, 12 * (GROUP * 2 + 1)),
]


@pytest.mark.parametrize("kernel,record,want", HAND, ids=[f"{k}-{i}" for i, (k, _r, _w) in enumerate(HAND)])
def test_work_bytes_by_hand(kernel, record, want):
    mod = load_module(BENCH / "rooflines" / f"{kernel}.py", f"roofline_{kernel}")
    assert mod.work_bytes(SHAPE, record) == want


def test_every_roofline_has_a_hand_count():
    names = {p.stem for p in (BENCH / "rooflines").glob("[!_]*.py")}
    assert names == {k for k, _r, _w in HAND}


def test_share_over_a_made_up_trace():
    bw = 3.35e12
    record = {"device_kind": "NVIDIA H100 80GB HBM3", "shape": SHAPE, "settings": {},
              "trace": {"device_s_by_name": {
                  "segment_fused_kernel": 2 * 10e-6, "scatter_combine_kernel": 2 * 5e-6,
                  "region_kernel<true,true>": 3e-6, "region_kernel<true,false>": 1e-6,
                  "at::native::elementwise_kernel": 1.0}}}
    bound = ((100 + 92 * 44 + 32) + (92 * 12 + 30 * 32) + 12 * 48) / bw
    measured = 2 * 10e-6 + 2 * 5e-6 + 3e-6  # kernels without a roofline are not counted
    assert share.read(record) == pytest.approx(100 * bound / measured)
    assert share.read({**record, "device_kind": "cpu"}) is None
