#!/usr/bin/env python3
"""Smoke run of the PyTorch port (arroyo_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and the script exits
non-zero, printing no result):

1. probe   -- the card (nvidia-smi name and power limit), torch's CUDA
              version, the device capability (expect (9, 0)), nvcc's version;
2. build   -- every CUDA source of arroyo_tpu_torch/csrc/ (the slot
              aggregator's slot_agg.cu with K1-K3 and K7, the join probe's
              join_probe.cu, the sharded aggregate's sharded_agg.cu with
              K8-K11, the single-device table's hash_agg.cu with K12 and
              K13; K11, K12's walk and K10's spill share table_compact.cuh)
              with nvcc for
              sm_90a, one nvcc per source, all started together;
3. q7      -- Nexmark q7 through the port's run_graph on the GPU at the size
              bench.py measures (2,000,000 events, batch 65536, table 65536,
              region 2048) in the package's default configuration (chaining
              off), held exactly against a closed-form oracle; each kernel's
              launch count over that run must be > 0. A second, profiled run
              gives the device's busy and idle share;
4. segment_build -- the fused segment kernel K4 (Triton, generated from the
              bound plan by arroyo_tpu_torch/ops/segment_kernel.py) compiled
              for the q7, q5, q8, qu and qs plans, seconds per plan;
5. q7c     -- q7 at bench.py's own setting, pipeline.chaining.enabled = True:
              the chain's prefix runs as one K4 launch per micro-batch. Exact
              parity, SEGMENT_COMPILED with no SEGMENT_FALLBACK, K4 launched
              once per source batch of >= segment.compile.min-rows rows, K1-K3
              launched; then a profiled run;
6. q5      -- q5 (sliding 10 s / 2 s COUNT per auction) at 1,000,000 events,
              chaining on, with the same checks against a copy of
              bench.py's oracle_q5;
7. kernels -- K1-K3 against their plain PyTorch versions on the card,
              exactly (float sums bit for bit: K1 adds them in row order), on
              K1's edge cases (one slot taking every row, runs at the
              block walk's threshold and either side of it, padding slots
              inside a long run, -0.0, NaN and infinities in values and
              state, int32 and int64 slots), at q7's shape, at qu's (its
              lanes, 262,144 slots) and at a deployment-size state
              (4,194,304 slots, float32 and float64 sums, a uint64 lane),
              hot and merge mode, k in {1, 2, 4, 8, 16} duplicated bases with
              and without clear, then timed beside the plain version, a
              PyTorch library yardstick and the bound (device time per call
              from a torch.profiler trace, and the per-call time bracketed by
              CUDA events, which adds the host's launch cost);
8. segment -- K4 against its plain version on the card, byte for byte
              (values, dtypes, mask, watermark aux) on the q7 and q5 insert
              plans, q8's two emit-batch plans (filter hoisted and not), the
              bids chains of qu and qs, an
              expression grid over every allowlisted operator and function
              and int32/int64/float32/float64/bool columns with their edge
              values, all at an odd row count; on its own edge cases (n = 0,
              P not a multiple of BLOCK, every row filtered, two NaN payloads
              in one batch, the fold's loop over many partials, 1,000
              back-to-back launches of one program: the fold's ticket counter
              resets), one Triton launch a call; then timed at q7's plan;
9. q8c     -- bench.py's q8 (auctions JOIN bids per tumbling 10 s window,
              events 100 us apart) at its own setting: 500,000 events,
              chaining on, batch 65536, queue 1 x 65536. Exact parity with a
              copy of bench.py's oracle_q8; K5/K6 launched once per window
              whose sides both hold rows and one holds >= device.join-min-rows;
              K4 batches per chain, no SEGMENT_FALLBACK; then a profiled run;
10. join   -- the join probe's kernels K5 (join_sort_pairs) and K6
              (join_search_bounds, csrc/join_probe.cu) against their plain
              versions on the card, exactly (order, lo, hi and the expanded
              (li, ri) pairs): at q8's shape with q8's own keys, at a
              deployment-size window (1,048,576 probe x 16,777,216 build
              rows) and on edge cases (empty sides, INT64_MAX and INT64_MIN
              keys, one key everywhere, negative keys, sizes that are not
              powers of two, runs of equal keys across K6's cached splitters
              and multiples of 2048, probes below and above every key and
              at both int64 limits); K5 alone on its own edge cases (keys equal in
              all but the top or the bottom digit, 2^20 + 3 equal keys, one
              tile and one key past it, int32 negatives, key_bits < 64,
              range mode); then timed like K1-K3, with K5's launches per
              call;
11. qu     -- the Nexmark running aggregate per auction (bids -> GROUP BY
              auction with COUNT, SUM and AVG of price, a changelog of
              retract/append pairs) through the updating aggregate's device
              mode: 2,000,000 events, chaining on, batch 65536, queue 2 x
              65536, table 262144 slots (every auction of the run on the
              card). The merged changelog equals a closed-form oracle
              exactly, every retraction equals its key's last append, K1, K4
              and K7 launched, no SEGMENT_FALLBACK; then a profiled run;
12. qu_ttl -- the stream's first 1,000,000 events at bench.py's table
              size (65536 slots), TTL 300 s and no timed flush: the device
              mode's changelog equals
              the host mode's row for row, with keys evicted and the device
              store compacted; then the operator fed an updating input
              (retractions, keys retracted to zero) in both modes on the card,
              integer lanes (changelog equal to the host mode's) and float
              lanes (changelog equal to the device mode's on the CPU);
13. qs     -- bench.py's qs (session windows per bidder, gap 2 s) at its
              setting: 500,000 events, chaining on, exact parity with a copy
              of bench.py's oracle_qs, K4 on the bids chain; then profiled;
14. gather -- K7 (slot_gather) against its plain version exactly at qu's
              shape, at a deployment-size state (16,777,216 slots x 4 lanes,
              1,048,576 slots gathered), over mixed int32/int64/float32/
              float64/uint64 lanes with int32 and int64 indices and on edge cases
              (k = 1, k not a power of two, duplicated slots, slot 0, slot
              cap - 1; k of 1-5 and k % 4 of 1-3, slot arrays one element
              off a 16-byte boundary, every lane dtype alone, float32
              subnormals), each call one kernel by the library's counter
              and its views in the packed buffer it hands back equal; then
              timed, and the host's cost of one read_slots, with its steps
              stamped on the function itself;

15. q7m    -- q7 at bench.py's sizes through an 8-shard mesh
              (device.mesh-devices = 8, bench.py's mesh width; spill capacity
              and probes at their defaults), fused (segment.compile.mesh-fuse
              on) then on the host path: exact parity each time, the chain
              compiled with no SEGMENT_FALLBACK, K4 and K8-K11 launched, the
              ledger at one aggregate step per fused micro-batch (fusion on)
              or host steps alone (off); each mode then profiled;
16. q5m    -- q5 (1,000,000 events) through the mesh, fused: exact parity,
              at least one K11 launch per slide bin; then profiled;
17. mesh_ab -- bench.py's --mesh-ab pipeline at its own settings (impulse,
              200,000 events, 7 keys, 8 shards, table 8192, batch 2048, emit
              4096, spill 4096, probes 32, source batch 4096): a warm-up of
              each mode, then host and fused against the closed-form oracle,
              calls per step 1.0, each profiled;
18. table_reads -- K11 in each of its modes (the mesh's close, B9's
              extract with zeros past the emitted rows, B9's packed scan) and
              K12 in both (the walk and one chunk) against their plain
              versions on the card, exactly, on the shared edge cases
              (chip_smoke.table_read_cases at 1 and 8 shards and
              walk_cases, also tests/test_torch_table_reads.py's: E below,
              equal to and above the emitting slots, emit_cap above cap,
              free_below inside, above and below the range, an empty range,
              every slot emitting, fill rows across tiles, 8-slot shards;
              emit_cap dividing cap and not, more than one tile; every lane
              dtype with NaN payloads and -0.0), K11's launches a call from
              the library's counter, and the walk against the one-chunk
              mode's valid rows concatenated (the reference's loop);
19. sharded -- K8 (agg_sort_reduce), K9 (agg_probe_merge), K10
              (shard_exchange, shard_spill) and K11 (shard_extract) of
              csrc/sharded_agg.cu against their plain versions on the card,
              exactly, step by step: at q7m's shapes, at a deployment state
              (8 shards x 1,048,576 entries, 4 int64 lanes and a float64 sum,
              65536 rows per shard) and on edge cases (a hot key past
              dest_cap, the spill buffer and its exhaustion, max_probes
              exhausted, duplicates after a free, key INT64_MAX in bin
              INT32_MAX, 1, 4 and 8 shards), K8 alone on its own edge cases
              (chip_smoke.sort_reduce_edge_cases: both of its paths, hot runs
              walked by a block, the padding run's cases, bins at the int32
              limits, n_valid inside a shard), each call's kernel launches
              from the library's counter, its path, passes, live rows per
              shard and passes per shard's block as the library reports them
              equal to sort_reduce_plan's; K11 in each mode at q7m's table
              and the deployment state, and K9's reported rounds at q7m's
              merged step held to its plain version run r rounds; K10's
              exchange on its own edge cases (chip_smoke.exchange_cases:
              1, 2, 3, 5, 7, 8 and 32 shards with keys at every range
              start, L of 1 and a tile either side, dest_cap 1, one owner
              past dest_cap, every row inactive) and K9 on its own
              (chip_smoke.probe_cases: 4,096 partials on one home slot at
              1 and 32 shards, matches and claims in one round, max_probes
              exhausted and 0), each with its launches a call from the
              library's counter (exchange_kernel_launches: 2,
              probe_merge_kernel_launches: 1) and K9's rounds and cluster;
              K10's spill on its own (chip_smoke.spill_cases: every shard
              empty, fill = spill_cap, exhaustion inside a tile, M % 16 != 0,
              M below one tile, rows at tile edges, three appends on one
              state buffer, 32 shards), one kernel a call by
              spill_kernel_launches;
              then timed at q7m's shapes, mesh_ab's (8 x 2,048, table
              8192) and the deployment state, K8's launches a call held to
              the plan and the trace, K9's and K10's to the library's
              count; K9 at q7m's merged step again right after a 64 MB
              write (a cold L2);
20. hash_agg -- the single-device table (B9: DeviceHashAggregator, K8 and
              K9 per batch, K11 per close and packed scan at one shard, K12's
              walk where a scan holds more than emit_cap rows, K13 frees):
              q7's 2,000,000 events closing through extract_start exactly
              against the oracle and the host store, the same stream's
              float64 SUM / MIN of price with every kernel checked against
              its plain version step by step (K9 reporting its rounds), and
              q5's hop windows (500,000 events, scan_range + free_bins_below,
              every kernel checked) exactly against the oracle; launches are
              read per drive (q7: K8, K9, K11; hop: K11, K12's walk, K13);
              the hop drive again unchecked, wall to wall, through the walk
              and through the chunk loop it replaced (loop, walk, walk,
              loop: launches and host fetches counted); then a 222 MB
              deployment state (4,194,304 entries, 8 x 1,048,576 rows; K12
              in both modes checked and timed there) and edge cases (hot
              runs through both of K8's paths among them), every kernel
              checked the same way; then timed at a state the q7 drive
              reaches (its first five batches and their closes), K9's
              rounds there held to its plain version, K12's walk at the hop
              drive's state. K8's calls of the q7 drive (as of q7m's) are
              reported by path, passes and launches; K13 one kernel a call
              in the hop drive by the library's counter, and on its own edge
              cases (caps of 1, 15, 16, 17 and 4,101, arrays one element off
              a 16-byte boundary, nothing and everything freed, below at the
              int32 limits), then timed at q7's table and the hop drive's
              size;
21. q7_host -- q7c with the window on the host store ("backend":
              "numpy"): exact parity, K4 on the card, no K1-K3.

``--only a,b`` runs those phases alone after probe and build (a short
check) and prints no result line. ``--only segment_sweep`` (in no default
run) times K4 at q7c's, q5's and q8c's batches for each BLOCK and
num_warps, each held to its plain version first.

On every chained path K4 is one Triton launch a call
(``segment_fused.kernel_launches`` equal to its calls), and K10's spill
one kernel a call by the library's counter; qu's run holds K7 to one
kernel a call the same way. Every chained run's profiled run counts its
copies by kind (``copies_by_kind``) and must hold fewer pageable
host-to-device copies than batches.

Then the {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Details go to <out-dir>/chip_smoke.json, the
nvcc/ptxas logs to <out-dir>/<source>_build.log and the generated K4 sources
to <out-dir>/segment_src/ (``--out-dir``, default chip_smoke_out/). A kernel's
build or launch error fails the run: the port never falls back to the plain
version on the card.

The script imports nothing of JAX or arroyo_tpu: the oracles below are its
own copies over the port's generator.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import arroyo_tpu_torch.config as tcfg
from arroyo_tpu_torch.batch import TIMESTAMP_FIELD, Batch, Schema
from arroyo_tpu_torch.connectors.nexmark import NexmarkSource
from arroyo_tpu_torch.engine import construct_operator, run_graph
from arroyo_tpu_torch.engine import segment as seg
from arroyo_tpu_torch.expr import BinOp, Col, Lit
from arroyo_tpu_torch.graph import EdgeType, Graph, Node, OpName
from arroyo_tpu_torch.obs.events import recorder
from arroyo_tpu_torch.hashing import hash_columns
from arroyo_tpu_torch.metrics import registry
from arroyo_tpu_torch.ops import (hash_kernels, join_kernels, join_probe, kernels,
                                  segment_kernel, sharded_kernels)
from arroyo_tpu_torch.ops.aggregate import DeviceHashAggregator, _identity, combine_by_key_bin
from arroyo_tpu_torch.parallel import all_to_all, sharded_agg

WIDTH = 10_000_000
SLIDE = 2_000_000
Q7_EVENTS = 2_000_000
Q5_EVENTS = Q7_EVENTS // 2  # bench.py runs q5 at events // 2
Q8_EVENTS = Q7_EVENTS // 4  # bench.py runs q8 at events // 4, queue 1 x batch
BENCH_BATCH = 65536
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SOURCE = "arroyo_tpu_torch/csrc/slot_agg.cu"
JOIN_SOURCE = "arroyo_tpu_torch/csrc/join_probe.cu"
REPLACES = {
    "slot_scatter_combine": "arroyo_tpu/ops/slot_agg.py:285",  # _build_slot_jax step / step_merge
    "slot_region_read_pack": "arroyo_tpu/ops/slot_agg.py:338",  # make_read_multi.go / _pack
    "slot_region_clear": "arroyo_tpu/ops/slot_agg.py:322",  # _clear / clear
    "segment_fused": "arroyo_tpu/engine/segment.py:511",  # _trace_fn.fn, with B1 (:242-278)
    "join_sort_pairs": "arroyo_tpu/ops/join_probe.py:82",  # _probe_jit.probe: argsort
    "join_search_bounds": "arroyo_tpu/ops/join_probe.py:82",  # _probe_jit.probe: searchsorted
    "slot_gather": "arroyo_tpu/ops/slot_agg.py:361",  # _build_slot_jax make_read_slots.go
    "agg_sort_reduce": "arroyo_tpu/ops/aggregate.py:231",  # sort_reduce (B7)
    "agg_probe_merge": "arroyo_tpu/ops/aggregate.py:261",  # probe_merge (B8)
    "shard_exchange": "arroyo_tpu/parallel/sharded_agg.py:177",  # exchange_merge steps 2-3
    "shard_spill": "arroyo_tpu/parallel/sharded_agg.py:243",  # exchange_merge step 7
    "shard_extract": "arroyo_tpu/parallel/sharded_agg.py:304",  # local_extract
    "hash_scan_chunk": "arroyo_tpu/ops/aggregate.py:331",  # _build_jax scan (B9)
    # _build_jax scan, walked over the table by scan_range's loop (:752)
    "hash_scan_walk": "arroyo_tpu/ops/aggregate.py:331",
    "hash_free": "arroyo_tpu/ops/aggregate.py:344",  # _build_jax free (B9)
}
SEGMENT_SOURCE = "arroyo_tpu_torch/ops/segment_kernel.py"
NP_DT = {torch.int32: np.int32, torch.int64: np.int64, torch.float32: np.float32,
         torch.float64: np.float64, torch.uint64: np.uint64}
TIMING_REPS = 30
WARM_TRACE_S = 0.05  # device_trace: the profiler idles this long around the traced work
# the kernels q7c and q5 must launch (K1, K2 in its read-and-clear mode,
# K4); q8c's are K4, K5, K6. A destructive close launches no K3.
AGG_PATH_KERNELS = ("slot_scatter_combine", "slot_region_read_pack_clear", "segment_fused")
# every launch count of the device window's kernels (K1-K3, K2 by mode)
WINDOW_KERNELS = ("slot_scatter_combine", "slot_region_read_pack", "slot_region_read_pack_clear",
                  "slot_region_clear")
WATCHDOG_S = 1100  # dump every thread's stack and exit before the 1200 s limit
_T0 = time.perf_counter()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def log(msg: str) -> None:
    print(f"[chip_smoke {time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------- probe


def probe() -> tuple[str, dict]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([kernels._find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip().splitlines()[-1]
    cap = torch.cuda.get_device_capability(0)
    info = {"phase": "probe", "nvidia_smi": smi, "torch": torch.__version__,
            "torch_cuda": torch.version.cuda, "capability": list(cap),
            "device_count": torch.cuda.device_count(), "nvcc": nvcc}
    emit(info)
    if cap != (9, 0):
        raise RuntimeError(f"device capability {cap}: the kernels are built for sm_90a")
    return smi, info


def build(out_dir: str) -> dict:
    """Every csrc/*.cu, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    libs = (kernels.build_library, join_kernels.build_library, sharded_kernels.build_library,
            hash_kernels.build_library)
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(b) for b in libs]:
            f.result()
    info = {"phase": "build", "seconds": time.perf_counter() - t0, "sources": {}}
    for name, b in kernels.build_info.items():
        info["sources"][name] = {
            "nvcc_seconds": b["seconds"], "cached": b["cached"], "library": b["path"],
            "ptxas": [ln.strip() for ln in b["log"].splitlines()
                      if "registers" in ln or "spill" in ln]}
        with open(os.path.join(out_dir, f"{name}_build.log"), "w") as f:
            f.write(b["log"])
    emit(info)
    return info


# ---------------------------------------------------------------- q7


def build_q7(rows: list, event_count: int) -> Graph:
    """bench.py's q7: bids -> tumbling 10 s MAX(price) + COUNT per auction."""
    S = Schema.of([("x", "int64"), (TIMESTAMP_FIELD, "int64")])
    g = Graph()
    g.add_node(Node("src", OpName.SOURCE, {
        "connector": "nexmark", "event_count": event_count, "inter_event_micros": 1000,
        "first_event_micros": 0, "include_strings": False,
        "columns": ["bid.auction", "bid.price"]}, 1))
    g.add_node(Node("bids", OpName.VALUE, {
        "projections": [("auction", Col("bid.auction")), ("price", Col("bid.price"))],
        "filter": Col("bid")}, 1))
    g.add_node(Node("wm", OpName.WATERMARK, {
        "expr": Col(TIMESTAMP_FIELD), "interval_micros": 1_000_000}, 1))
    g.add_node(Node("key", OpName.KEY, {"keys": [("auction", Col("auction"))]}, 1))
    g.add_node(Node("agg", OpName.TUMBLING_AGGREGATE, {
        "width_micros": WIDTH, "key_fields": ["auction"],
        "aggregates": [("max_price", "max", Col("price")), ("bids", "count", None)],
        "input_dtype_of": lambda e: np.dtype(np.int64)}, 1))
    g.add_node(Node("sink", OpName.SINK, {"connector": "vec", "rows": rows, "columnar": True}, 1))
    g.add_edge("src", "bids", EdgeType.FORWARD, S)
    g.add_edge("bids", "wm", EdgeType.FORWARD, S)
    g.add_edge("wm", "key", EdgeType.FORWARD, S)
    g.add_edge("key", "agg", EdgeType.SHUFFLE, S)
    g.add_edge("agg", "sink", EdgeType.FORWARD, S)
    return g


def oracle_q7(event_count: int) -> dict:
    """(window_start, auction) -> (max_price, count), numpy alone."""
    b = NexmarkSource({"event_count": event_count, "inter_event_micros": 1000,
                       "first_event_micros": 0, "include_strings": False,
                       "columns": ["bid.auction", "bid.price"]})._generate(
        np.arange(event_count, dtype=np.int64))
    bid = b["bid"]
    w = (b[TIMESTAMP_FIELD][bid] // WIDTH) * WIDTH
    uniq, inv = np.unique(np.stack([w, b["bid.auction"][bid]], axis=1), axis=0,
                          return_inverse=True)
    inv = inv.ravel()
    mx = np.full(len(uniq), np.iinfo(np.int64).min, dtype=np.int64)
    np.maximum.at(mx, inv, b["bid.price"][bid])
    cnt = np.bincount(inv, minlength=len(uniq))
    return {(int(u[0]), int(u[1])): (int(m), int(c)) for u, m, c in zip(uniq, mx, cnt)}


def bench_config(chaining: bool, queue_mult: int = 2, table_capacity: int = 65536,
                 extra: dict = None) -> None:
    """bench.py's sizes (bench.py:1046-1060, run_config): source batch
    65536, queue queue_mult x 65536 (bench.py: 2, and 1 for q8), table 65536
    slots (qu: 262144), region 2048; chaining as given (bench.py runs with it
    on); then ``extra`` (the mesh phases' keys)."""
    tcfg.reset()
    tcfg.update({
        "pipeline.source-batch-size": BENCH_BATCH,
        "device.batch-capacity": BENCH_BATCH,
        "worker.queue-size": queue_mult * BENCH_BATCH,
        "device.table-capacity": table_capacity,
        "device.region-size": 2048,
        "pipeline.chaining.enabled": chaining,
        **(extra or {}),
    })


def drive(build, events: int, job_id: str, chaining: bool, queue_mult: int = 2,
          table_capacity: int = 65536, extra: dict = None) -> tuple[list, float, object]:
    """One run through the port's run_graph (default device: CUDA)."""
    bench_config(chaining, queue_mult, table_capacity, extra)
    rows: list = []
    g = build(rows, events)
    recorder.clear_job(job_id)
    t0 = time.perf_counter()
    eng = run_graph(g, job_id=job_id, timeout=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if eng.device.type != "cuda":
        raise RuntimeError(f"{job_id} ran on {eng.device}, not on the GPU")
    return rows, wall, eng


def drive_q7() -> tuple[list, float, object]:
    return drive(build_q7, Q7_EVENTS, "chip-smoke-q7", chaining=False)


def check_q7(rows: list, want: dict) -> dict:
    got: dict = {}
    for b in rows:
        for ws, a, m, c in zip(b["window_start"].tolist(), b["auction"].tolist(),
                               b["max_price"].tolist(), b["bids"].tolist()):
            if (ws, a) in got:
                raise AssertionError(f"q7 window {(ws, a)} emitted twice")
            got[(ws, a)] = (m, c)
    if got != want:
        diff = next(iter(set(got.items()) ^ set(want.items())), None)
        raise AssertionError(f"q7 parity failure: {len(got)} windows vs {len(want)}; "
                             f"first diff {diff}")
    return got


def run_q7() -> dict:
    """The main path: launch counts are zeroed just before it and read just
    after; then a second, profiled run gives the device's busy share."""
    want = oracle_q7(Q7_EVENTS)
    kernels.reset_launch_counts()
    rows, wall, _eng = drive_q7()
    launches = kernels.launch_counts()
    got = check_q7(rows, want)
    unlaunched = [k for k in AGG_PATH_KERNELS[:2] if launches[k] == 0]
    if unlaunched:
        raise AssertionError(f"q7 ran without launching {unlaunched}: {launches}")
    if launches["slot_region_clear"]:
        raise AssertionError(f"q7's destructive closes launched K3: {launches}")
    out = []
    prof = device_trace(lambda: out.append(drive_q7()), warm_device)
    rows_p, wall_p, _eng = out[0]
    check_q7(rows_p, want)
    by_name = device_us_by_name(prof)
    busy_s = sum(by_name.values()) / 1e6 if by_name else None  # None: not measured
    info = {"phase": "q7", "events": Q7_EVENTS, "wall_s": wall,
            "events_per_s": Q7_EVENTS / wall, "windows": len(got),
            "bids": sum(c for _m, c in got.values()), "launches": launches,
            "profiled_run": {"wall_s": wall_p, "device_busy_s": busy_s,
                             "device_idle_share": None if busy_s is None else 1.0 - busy_s / wall_p,
                             "device_us_by_name": dict(sorted(
                                 by_name.items(), key=lambda kv: -kv[1])[:12])}}
    emit(info)
    return info


# ---------------------------------------------------------------- q7c, q5


def build_q5(rows: list, event_count: int) -> Graph:
    """bench.py's q5: bids -> sliding 10 s / 2 s COUNT per auction."""
    S = Schema.of([("x", "int64"), (TIMESTAMP_FIELD, "int64")])
    g = Graph()
    g.add_node(Node("src", OpName.SOURCE, {
        "connector": "nexmark", "event_count": event_count, "inter_event_micros": 1000,
        "first_event_micros": 0, "include_strings": False, "columns": ["bid.auction"]}, 1))
    g.add_node(Node("bids", OpName.VALUE, {
        "projections": [("auction", Col("bid.auction"))], "filter": Col("bid")}, 1))
    g.add_node(Node("wm", OpName.WATERMARK, {
        "expr": Col(TIMESTAMP_FIELD), "interval_micros": 1_000_000}, 1))
    g.add_node(Node("key", OpName.KEY, {"keys": [("auction", Col("auction"))]}, 1))
    g.add_node(Node("agg", OpName.SLIDING_AGGREGATE, {
        "width_micros": WIDTH, "slide_micros": SLIDE, "key_fields": ["auction"],
        "aggregates": [("bids", "count", None)],
        "input_dtype_of": lambda e: np.dtype(np.int64)}, 1))
    g.add_node(Node("sink", OpName.SINK, {"connector": "vec", "rows": rows, "columnar": True}, 1))
    g.add_edge("src", "bids", EdgeType.FORWARD, S)
    g.add_edge("bids", "wm", EdgeType.FORWARD, S)
    g.add_edge("wm", "key", EdgeType.FORWARD, S)
    g.add_edge("key", "agg", EdgeType.SHUFFLE, S)
    g.add_edge("agg", "sink", EdgeType.FORWARD, S)
    return g


def oracle_q5(event_count: int) -> dict:
    """(window_start, auction) -> count over sliding 10 s / 2 s windows
    (bench.py oracle_q5, vectorized): slide bin sb feeds the windows that
    start at sb, sb - 2 s, ..., sb - 8 s."""
    b = NexmarkSource({"event_count": event_count, "inter_event_micros": 1000,
                       "first_event_micros": 0, "include_strings": False,
                       "columns": ["bid.auction"]})._generate(np.arange(event_count, dtype=np.int64))
    bid = b["bid"]
    sbin = (b[TIMESTAMP_FIELD][bid] // SLIDE) * SLIDE
    uniq, inv = np.unique(np.stack([sbin, b["bid.auction"][bid]], axis=1), axis=0,
                          return_inverse=True)
    cnt = np.bincount(inv.ravel(), minlength=len(uniq))
    nb = WIDTH // SLIDE
    starts = (uniq[:, 0][:, None] - np.arange(nb) * SLIDE).ravel()
    auc = np.repeat(uniq[:, 1], nb)
    w, winv = np.unique(np.stack([starts, auc], axis=1), axis=0, return_inverse=True)
    tot = np.bincount(winv.ravel(), weights=np.repeat(cnt, nb), minlength=len(w)).astype(np.int64)
    return {(int(a), int(c)): int(t) for (a, c), t in zip(w, tot)}


def check_q5(rows: list, want: dict) -> dict:
    ws = np.concatenate([b["window_start"] for b in rows]) if rows else np.empty(0, np.int64)
    au = np.concatenate([b["auction"] for b in rows]) if rows else np.empty(0, np.int64)
    ct = np.concatenate([b["bids"] for b in rows]) if rows else np.empty(0, np.int64)
    got = {(int(a), int(c)): int(t) for a, c, t in zip(ws.tolist(), au.tolist(), ct.tolist())}
    if len(got) != len(ws):
        raise AssertionError(f"q5: {len(ws) - len(got)} (window, auction) rows emitted twice")
    if got != want:
        diff = next(iter(set(got.items()) ^ set(want.items())), None)
        raise AssertionError(f"q5 parity failure: {len(got)} windows vs {len(want)}; "
                             f"first diff {diff}")
    return got


def all_launch_counts() -> dict:
    """Every wrapper's calls, and K4's Triton launches beside its calls
    (``segment_fused_kernels``)."""
    return {**kernels.launch_counts(), **segment_kernel.launch_counts(),
            "segment_fused_kernels": segment_kernel.segment_fused.kernel_launches,
            **join_kernels.launch_counts(), **sharded_kernels.launch_counts(),
            **hash_kernels.launch_counts()}


def check_k4_one_launch(name: str, launches: dict) -> None:
    """K4 is one Triton launch a call on every chained path."""
    if launches["segment_fused_kernels"] != launches["segment_fused"]:
        raise AssertionError(f"{name}: K4 made {launches['segment_fused_kernels']} Triton "
                             f"launches in {launches['segment_fused']} calls")


def reset_all_launch_counts() -> None:
    kernels.reset_launch_counts()
    segment_kernel.reset_launch_counts()
    join_kernels.reset_launch_counts()
    sharded_kernels.reset_launch_counts()
    hash_kernels.reset_launch_counts()


def run_chained(name: str, build, events: int, oracle, check,
                path_kernels=AGG_PATH_KERNELS, table_capacity: int = 65536,
                stats=None, library=None) -> dict:
    """A chaining-on main path: counts zeroed just before the run and read
    just after; the chain must have run compiled, K4 once per source batch
    of at least segment.compile.min-rows rows, every kernel of
    ``path_kernels`` (default K1, K2's read-and-clear and K4; then no K3)
    at least once. ``library`` maps a wrapper's count to its library's
    kernel counter: the run's kernels must equal its calls (one kernel a
    call). ``stats(eng)`` adds what the run's operators counted. Then a
    second, profiled run gives the device's busy share and its copies,
    which must hold fewer pageable host-to-device copies than the run has
    batches (every batch's arrays cross staged, in pinned copies)."""
    want = oracle(events)
    job = f"chip-smoke-{name}"
    library = library or {}
    reset_all_launch_counts()
    lib_before = {k: c() for k, c in library.items()}
    rows, wall, eng = drive(build, events, job, chaining=True, table_capacity=table_capacity)
    launches = all_launch_counts()
    lib_kernels = {k: c() - lib_before[k] for k, c in library.items()}
    if any(lib_kernels[k] != launches[k] for k in library):
        raise AssertionError(f"{name}: library kernels {lib_kernels} against calls "
                             f"{ {k: launches[k] for k in library} }")
    got = check(rows, want)
    chained = [n for n in eng.graph.nodes if "+" in n]
    fallbacks = recorder.events(job, "SEGMENT_FALLBACK")
    compiled = recorder.events(job, "SEGMENT_COMPILED")
    seg_metrics = registry.job_metrics(job)
    min_rows = int(tcfg.config().get("segment.compile.min-rows"))
    sizes = [min(BENCH_BATCH, events - lo) for lo in range(0, events, BENCH_BATCH)]
    want_k4 = sum(1 for n in sizes if n >= min_rows)
    if not chained or not compiled or fallbacks:
        raise AssertionError(f"{name}: the chain did not run compiled: nodes {list(eng.graph.nodes)}, "
                             f"compiled {compiled}, fallbacks {fallbacks}")
    if not any(st.get("segment_compiled") for st in seg_metrics.get(chained[0], {}).values()):
        raise AssertionError(f"{name}: segment_compiled is not set: {seg_metrics}")
    if launches["segment_fused"] != want_k4:
        raise AssertionError(f"{name}: K4 launched {launches['segment_fused']} times, "
                             f"expected one per batch of >= {min_rows} rows ({want_k4})")
    check_k4_one_launch(name, launches)
    unlaunched = [k for k in path_kernels if launches[k] == 0]
    if unlaunched:
        raise AssertionError(f"{name} ran without launching {unlaunched}: {launches}")
    if "slot_region_read_pack_clear" in path_kernels and launches["slot_region_clear"]:
        raise AssertionError(f"{name}: a destructive close launched K3: {launches}")
    info = {"phase": name, "events": events, "chaining": True, "wall_s": wall,
            "events_per_s": events / wall, "windows": len(got), "chained_node": chained[0],
            "segment_events": [e["message"] for e in compiled], "launches": launches,
            "k4_expected": want_k4, "table_capacity": table_capacity,
            "stats": stats(eng) if stats else None, "library_kernels": lib_kernels,
            "profiled_run": profiled_run(build, events, job + "-profiled", check, want,
                                         table_capacity=table_capacity)}
    pageable = info["profiled_run"]["copies_by_kind"]["HtoD pageable"]
    if pageable >= len(sizes):
        raise AssertionError(f"{name}: {pageable} pageable host-to-device copies in "
                             f"{len(sizes)} batches: {info['profiled_run']['copies']}")
    emit(info)
    return info


def profiled_run(build, events: int, job: str, check, want, queue_mult: int = 2,
                 table_capacity: int = 65536, extra: dict = None) -> dict:
    """One more chaining-on run under torch.profiler: the device's busy and
    idle share of the run's wall time, and its top device operations."""
    out = []
    prof = device_trace(lambda: out.append(drive(build, events, job, chaining=True,
                                                 queue_mult=queue_mult,
                                                 table_capacity=table_capacity, extra=extra)),
                        warm_device)
    rows_p, wall_p, _eng = out[0]
    check(rows_p, want)
    by_name = device_us_by_name(prof)
    busy_s = sum(by_name.values()) / 1e6 if by_name else None  # None: not measured
    copies = {e.key: e.count for e in prof.key_averages() if e.key.startswith("Memcpy")}
    return {"wall_s": wall_p, "device_busy_s": busy_s,
            "device_idle_share": None if busy_s is None else 1.0 - busy_s / wall_p,
            "device_us_by_name": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:14]),
            "copies": copies, "copies_by_kind": copies_by_kind(copies)}


def copies_by_kind(copies: dict) -> dict:
    """A trace's memcpy counts by direction and host memory: CUPTI names
    them "Memcpy HtoD (Pageable -> Device)", "Memcpy DtoH (Device ->
    Pinned)" and so on."""
    out = {f"{d} {m}": 0 for d in ("HtoD", "DtoH") for m in ("pageable", "pinned")}
    out["other"] = 0
    for key, n in copies.items():
        d = "HtoD" if "HtoD" in key else "DtoH" if "DtoH" in key else None
        m = "pageable" if "Pageable" in key else "pinned" if "Pinned" in key else None
        out[f"{d} {m}" if d and m else "other"] += n
    return out


# ---------------------------------------------------------------- q8c


def q8_graph(B, E, G, rows: list, event_count: int, backend: str = "jax"):
    """bench.py's q8 (bench.py:149-196) over either package's modules (B, E,
    G: its batch, expr and graph modules): auctions JOIN bids on auction id
    within tumbling 10 s windows, events 100 us apart, the watermark floored
    to the window start, rows stamped with their window start."""
    S = B.Schema.of([("x", "int64"), (B.TIMESTAMP_FIELD, "int64")])
    members = {side: q8_members(E, side) for side in ("auctions", "bids")}
    win = members["auctions"][0][1]["projections"][1][1]
    g = G.Graph()
    g.add_node(G.Node("src", G.OpName.SOURCE, {
        "connector": "nexmark", "event_count": event_count, "inter_event_micros": 100,
        "first_event_micros": 0, "include_strings": False,
        "columns": ["auction.id", "bid.auction"]}, 1))
    g.add_node(G.Node("wm", G.OpName.WATERMARK, {"expr": win}, 1))
    for side, (val, key) in members.items():
        g.add_node(G.Node(side, G.OpName.VALUE, val[1], 1))
        g.add_node(G.Node(side[0] + "key", G.OpName.KEY, key[1], 1))
    g.add_node(G.Node("join", G.OpName.INSTANT_JOIN, {
        "join_type": "inner", "left_names": [("id", "id")],
        "right_names": [("bid_auction", "auction")], "backend": backend}, 1))
    g.add_node(G.Node("sink", G.OpName.SINK, {
        "connector": "vec", "rows": rows, "columnar": True,
        "include_internal": True}, 1))  # the join's window rides _timestamp
    for a, b, t in [("src", "wm", G.EdgeType.FORWARD), ("wm", "auctions", G.EdgeType.FORWARD),
                    ("wm", "bids", G.EdgeType.FORWARD), ("auctions", "akey", G.EdgeType.FORWARD),
                    ("bids", "bkey", G.EdgeType.FORWARD), ("akey", "join", G.EdgeType.LEFT_JOIN),
                    ("bkey", "join", G.EdgeType.RIGHT_JOIN), ("join", "sink", G.EdgeType.FORWARD)]:
        g.add_edge(a, b, t, S)
    return g


def build_q8(rows: list, event_count: int) -> Graph:
    from arroyo_tpu_torch import batch as B
    from arroyo_tpu_torch import expr as E
    from arroyo_tpu_torch import graph as G

    return q8_graph(B, E, G, rows, event_count)


def q8_events(event_count: int) -> dict:
    return nexmark_columns(event_count, ["auction.id", "bid.auction"], 100)


def oracle_q8(event_count: int) -> dict:
    """(window_start, auction_id) -> n_auction_events * n_bid_events
    (bench.py oracle_q8, over the port's generator)."""
    b = q8_events(event_count)
    w = (b[TIMESTAMP_FIELD] // WIDTH) * WIDTH

    def counts(mask, ids):
        uniq, c = np.unique(np.stack([w[mask], ids[mask]], axis=1), axis=0, return_counts=True)
        return {(int(u[0]), int(u[1])): int(n) for u, n in zip(uniq, c)}

    na = counts(b["auction"], b["auction.id"])
    nb = counts(b["bid"], b["bid.auction"])
    return {k: na[k] * nb[k] for k in na.keys() & nb.keys()}


def q8_window_sides(event_count: int) -> dict:
    """window_start -> (auction rows, bid rows) of the join's two inputs."""
    b = q8_events(event_count)
    w = (b[TIMESTAMP_FIELD] // WIDTH) * WIDTH
    return {int(t): (int((b["auction"] & (w == t)).sum()), int((b["bid"] & (w == t)).sum()))
            for t in np.unique(w)}


def check_q8(rows: list, want: dict) -> int:
    """bench.py's check_parity_q8, vectorized: the emitted rows counted per
    (window, id) equal the oracle's; every row joins equal ids. Returns the
    number of rows."""
    w = np.concatenate([b[TIMESTAMP_FIELD] for b in rows]) if rows else np.empty(0, np.int64)
    ids = np.concatenate([b["id"] for b in rows]) if rows else np.empty(0, np.int64)
    bid_auction = (np.concatenate([b["bid_auction"] for b in rows]) if rows
                   else np.empty(0, np.int64))
    if not np.array_equal(ids, bid_auction):
        raise AssertionError("q8: a row joins an auction with another auction's bid")
    uniq, c = np.unique(np.stack([w, ids], axis=1), axis=0, return_counts=True)
    got = {(int(u[0]), int(u[1])): int(n) for u, n in zip(uniq, c)}
    if got != want:
        diff = next(iter(set(got.items()) ^ set(want.items())), None)
        raise AssertionError(f"q8 parity failure: {len(got)} (window, id) groups vs "
                             f"{len(want)}; first diff {diff}")
    return len(w)


def run_q8c() -> dict:
    """q8 at bench.py's setting, the join's main path: counts zeroed just
    before the run and read just after. K5 and K6 must launch once per
    window whose sides both hold rows and one holds at least
    device.join-min-rows; the bids chain's K4 once per source batch of at
    least segment.compile.min-rows rows; no SEGMENT_FALLBACK. Then a
    profiled run."""
    want = oracle_q8(Q8_EVENTS)
    job = "chip-smoke-q8c"
    reset_all_launch_counts()
    rows, wall, eng = drive(build_q8, Q8_EVENTS, job, chaining=True, queue_mult=1)
    launches = all_launch_counts()
    n_rows = check_q8(rows, want)
    join_min = int(tcfg.config().get("device.join-min-rows"))
    seg_min = int(tcfg.config().get("segment.compile.min-rows"))
    sides = q8_window_sides(Q8_EVENTS)
    want_probe = sum(1 for a, b in sides.values() if a and b and max(a, b) >= join_min)
    sizes = [min(BENCH_BATCH, Q8_EVENTS - lo) for lo in range(0, Q8_EVENTS, BENCH_BATCH)]
    chains = {}
    seg_metrics = registry.job_metrics(job)
    for node in eng.graph.nodes:
        if "+" in node:
            st = seg_metrics.get(node, {}).get(0, {})
            chains[node] = {"k4_batches": registry.task(job, node, 0).segment_batches,
                            "segment_compiled": st.get("segment_compiled"),
                            "segment_reason": st.get("segment_reason")}
    fallbacks = recorder.events(job, "SEGMENT_FALLBACK")
    if set(chains) != {"auctions+akey", "bids+bkey"} or fallbacks:
        raise AssertionError(f"q8c: chains {chains}, fallbacks {fallbacks}")
    if launches["segment_fused"] != sum(c["k4_batches"] for c in chains.values()):
        raise AssertionError(f"q8c: K4 launched {launches['segment_fused']} times, the chains "
                             f"count {chains}")
    check_k4_one_launch("q8c", launches)
    if chains["bids+bkey"]["k4_batches"] != sum(1 for n in sizes if n >= seg_min):
        raise AssertionError(f"q8c: the bids chain ran {chains['bids+bkey']['k4_batches']} "
                             f"batches through K4, expected one per batch of >= {seg_min} rows")
    for k in ("join_sort_pairs", "join_search_bounds"):
        if launches[k] != want_probe:
            raise AssertionError(f"q8c: {k} launched {launches[k]} times, expected one per "
                                 f"window with a side of >= {join_min} rows ({want_probe})")
    info = {"phase": "q8c", "events": Q8_EVENTS, "chaining": True, "queue_rows": BENCH_BATCH,
            "wall_s": wall, "events_per_s": Q8_EVENTS / wall, "output_rows": n_rows,
            "groups": len(want), "windows": {str(t): list(v) for t, v in sides.items()},
            "launches": launches, "probe_expected": want_probe, "chains": chains,
            "profiled_run": profiled_run(build_q8, Q8_EVENTS, job + "-profiled", check_q8, want,
                                         queue_mult=1)}
    emit(info)
    return info


# ---------------------------------------------------------------- qu, qu_ttl, qs

QU_EVENTS = Q7_EVENTS
# qu_ttl's stream, cut to half of qu's to keep the script's time (it still
# evicts keys and compacts the device store)
QU_TTL_EVENTS = Q7_EVENTS // 2
QU_CAP = 262144  # holds every auction of the 2,000,000-event run on the card
QU_TTL_MICROS = 300_000_000
QU_TTL_CAP = 65536  # bench.py's table size
QS_EVENTS = Q7_EVENTS // 4  # bench.py runs qs at events // 4
SESSION_GAP = 2_000_000  # bench.py SESSION_GAP
DAY_MICROS = 24 * 3600 * 1_000_000
# the kernels qu must launch: K4 on the bids chain, K1 and K7 in the
# updating aggregate
QU_PATH_KERNELS = ("segment_fused", "slot_scatter_combine", "slot_gather")


def qu_graph(B, E, G, rows: list, event_count: int, backend: str = "jax",
             ttl_micros: int = DAY_MICROS, flush_interval_micros: int = 1_000_000):
    """The Nexmark running aggregate per auction over either package's
    modules (B, E, G: its batch, expr and graph modules): bids -> non-windowed
    GROUP BY auction with COUNT(*), SUM(price) and AVG(price), emitted as a
    changelog (retract/append pairs in ``_is_retract``); the shape of
    tests/smoke/queries/updating_aggregate.sql over Nexmark bids. ``backend``
    "jax" is the device mode, "numpy" the host mode."""
    S = B.Schema.of([("x", "int64"), (B.TIMESTAMP_FIELD, "int64")])
    c = E.Col
    g = G.Graph()
    g.add_node(G.Node("src", G.OpName.SOURCE, {
        "connector": "nexmark", "event_count": event_count, "inter_event_micros": 1000,
        "first_event_micros": 0, "include_strings": False,
        "columns": ["bid.auction", "bid.price"]}, 1))
    g.add_node(G.Node("bids", G.OpName.VALUE, {
        "projections": [("auction", c("bid.auction")), ("price", c("bid.price"))],
        "filter": c("bid")}, 1))
    g.add_node(G.Node("wm", G.OpName.WATERMARK, {
        "expr": c(B.TIMESTAMP_FIELD), "interval_micros": 1_000_000}, 1))
    g.add_node(G.Node("key", G.OpName.KEY, {"keys": [("auction", c("auction"))]}, 1))
    g.add_node(G.Node("agg", G.OpName.UPDATING_AGGREGATE, {
        "key_fields": ["auction"],
        "aggregates": [("bids", "count", None), ("volume", "sum", c("price")),
                       ("avg_price", "avg", c("price"))],
        "ttl_micros": ttl_micros, "flush_interval_micros": flush_interval_micros,
        "backend": backend, "input_dtype_of": lambda e: np.dtype(np.int64)}, 1))
    g.add_node(G.Node("sink", G.OpName.SINK, {
        "connector": "vec", "rows": rows, "columnar": True,
        "include_internal": True}, 1))  # the changelog rides _is_retract
    for a, b, t in [("src", "bids", G.EdgeType.FORWARD), ("bids", "wm", G.EdgeType.FORWARD),
                    ("wm", "key", G.EdgeType.FORWARD), ("key", "agg", G.EdgeType.SHUFFLE),
                    ("agg", "sink", G.EdgeType.FORWARD)]:
        g.add_edge(a, b, t, S)
    return g


def build_qu(rows: list, event_count: int, **kw) -> Graph:
    from arroyo_tpu_torch import batch as B
    from arroyo_tpu_torch import expr as E
    from arroyo_tpu_torch import graph as G

    return qu_graph(B, E, G, rows, event_count, **kw)


def oracle_qu(event_count: int) -> dict:
    """auction -> (count, sum, sum / max(count, 1)) of price over all bids."""
    b = nexmark_columns(event_count, ["bid.auction", "bid.price"], 1000)
    auc, price = b["bid.auction"][b["bid"]], b["bid.price"][b["bid"]]
    uniq, inv = np.unique(auc, return_inverse=True)
    cnt = np.bincount(inv, minlength=len(uniq))
    tot = np.zeros(len(uniq), dtype=np.int64)
    np.add.at(tot, inv, price)
    return {int(a): (int(n), int(t), float(t) / max(int(n), 1))
            for a, n, t in zip(uniq.tolist(), cnt.tolist(), tot.tolist())}


def changelog(rows: list) -> dict:
    """The emitted changelog's columns, concatenated in emission order."""
    names = ["auction", "bids", "volume", "avg_price", "_is_retract", TIMESTAMP_FIELD]
    return {n: np.concatenate([np.asarray(b[n]) for b in rows]) if rows else np.empty(0)
            for n in names}


def check_changelog(rows: list) -> dict:
    """Every retraction equals the last append for its key, and follows
    one; returns the keys' live rows after applying the changelog in order
    (merge_updating_rows), as auction -> (count, sum, avg)."""
    from arroyo_tpu_torch.operators.updating_aggregate import merge_updating_rows

    cl = changelog(rows)
    last: dict = {}
    for a, n, v, m, r in zip(cl["auction"].tolist(), cl["bids"].tolist(),
                             cl["volume"].tolist(), cl["avg_price"].tolist(),
                             cl["_is_retract"].tolist()):
        if r:
            if last.pop(a, None) != (n, v, m):
                raise AssertionError(f"qu: retraction {(a, n, v, m)} does not match the "
                                     f"last append for its key")
        elif a in last:
            raise AssertionError(f"qu: key {a} appended twice without a retraction")
        else:
            last[a] = (n, v, m)
    dicts = [{k: v for k, v in r.items() if k != TIMESTAMP_FIELD}
             for b in rows for r in b.to_pylist()]
    merged = merge_updating_rows(dicts)
    got = {r["auction"]: (r["bids"], r["volume"], r["avg_price"]) for r in merged}
    if len(got) != len(merged) or got != last:
        raise AssertionError(f"qu: merge_updating_rows gives {len(merged)} rows for "
                             f"{len(got)} keys; the walk leaves {len(last)}")
    return got


def check_qu(rows: list, want: dict) -> dict:
    got = check_changelog(rows)
    if got != want:
        diff = next(iter(set(got.items()) ^ set(want.items())), None)
        raise AssertionError(f"qu parity failure: {len(got)} keys vs {len(want)}; "
                             f"first diff {diff}")
    return got


def updating_stats(eng) -> dict:
    """What the run's updating aggregate counted."""
    op = eng.tasks[("agg", 0)].operator
    spill = op._dev.spill if op._dev is not None else {}
    return {"device_mode": op.device_mode, "device": str(op.device),
            "lanes": [str(d) for d in op._dev_dtypes()] if op.device_mode else None,
            "evicted_keys": op.evicted_keys, "compactions": op.compactions,
            "spill_keys_at_end": len(spill), "flushed_keys_read_from_spill": op.spill_reads}


def run_qu() -> dict:
    """qu, the updating aggregate's main path: K1, K4 and K7 each launched,
    the merged changelog equal to the oracle exactly."""
    return run_chained("qu", build_qu, QU_EVENTS, oracle_qu, check_qu,
                       path_kernels=QU_PATH_KERNELS, table_capacity=QU_CAP,
                       stats=updating_stats,
                       library={"slot_gather": kernels.gather_kernel_launches})


def same_changelog(a: dict, b: dict, what: str) -> int:
    for n in a:
        if a[n].dtype != b[n].dtype or not np.array_equal(a[n], b[n]):
            raise AssertionError(f"{what}: column {n} differs ({a[n].dtype}, {len(a[n])} rows "
                                 f"vs {b[n].dtype}, {len(b[n])})")
    return len(a["auction"])


def run_qu_ttl(dev) -> dict:
    """qu's first 1,000,000 events at bench.py's table size (65536 slots),
    a 300 s TTL and no timed flush (a day): the flushes follow the
    watermarks alone, so the changelog is fixed by the data. The device mode's changelog must equal
    the host mode's row for row, with keys evicted and the device store
    compacted; then the operator-level runs (updating input, float lanes)."""
    out = {"phase": "qu_ttl", "events": QU_TTL_EVENTS, "table_capacity": QU_TTL_CAP,
           "ttl_micros": QU_TTL_MICROS}
    logs = {}
    for backend in ("jax", "numpy"):
        job = f"chip-smoke-qu-ttl-{backend}"
        reset_all_launch_counts()
        rows, wall, eng = drive(
            lambda r, e, _b=backend: build_qu(r, e, backend=_b, ttl_micros=QU_TTL_MICROS,
                                              flush_interval_micros=DAY_MICROS),
            QU_TTL_EVENTS, job, chaining=True, table_capacity=QU_TTL_CAP)
        logs[backend] = changelog(rows)
        check_changelog(rows)
        out[backend] = {"wall_s": wall, "events_per_s": QU_TTL_EVENTS / wall,
                        "launches": all_launch_counts(), "stats": updating_stats(eng),
                        "changelog_rows": len(logs[backend]["auction"]),
                        "retractions": int(logs[backend]["_is_retract"].sum())}
    same_changelog(logs["jax"], logs["numpy"], "qu_ttl device vs host mode")
    st = out["jax"]["stats"]
    if not st["device_mode"] or out["numpy"]["stats"]["device_mode"]:
        raise AssertionError(f"qu_ttl: modes {st}, {out['numpy']['stats']}")
    if st["evicted_keys"] == 0 or st["compactions"] == 0:
        raise AssertionError(f"qu_ttl: no eviction or no compaction in device mode: {st}")
    if out["jax"]["launches"]["slot_gather"] == 0:
        raise AssertionError("qu_ttl: the device mode never launched K7")
    out["operator_level"] = updating_operator_runs(dev)
    emit(out)
    return out


def updating_operator_runs(dev) -> dict:
    """The port's UpdatingAggregate fed one seeded stream in device mode (on
    the card) and host mode: an updating input (retractions of earlier rows,
    keys retracted to zero and coming back) through watermarks, ticks and
    TTL evictions. Integer lanes: the changelogs must be equal batch for
    batch. Float lanes (SUM and AVG of a float column): the host mode adds
    each batch's per-key sum to the stored value, the device mode (in both
    packages) adds row after row, so the two modes' float bits differ (a
    residue after a retraction defeats the no-op suppression); the merged
    views are held to 1e-9 relative. The device mode on the card must equal
    the device mode on the CPU (the kernels' plain versions, the reference's
    row order) batch for batch: K1 adds float sums in row order."""
    from arroyo_tpu_torch.batch import KEY_FIELD
    from arroyo_tpu_torch.hashing import hash_columns
    from arroyo_tpu_torch.operators.base import OperatorContext
    from arroyo_tpu_torch.operators.updating_aggregate import (IS_RETRACT_FIELD,
                                                                UpdatingAggregate,
                                                                merge_updating_rows)
    from arroyo_tpu_torch.types import TaskInfo, Watermark

    class Sink:
        def __init__(self):
            self.batches = []

        def collect(self, b):
            self.batches.append(b)

    def run(backend, value_expr, dtype, dev):
        tcfg.reset()
        tcfg.update({"device.table-capacity": 4096, "device.region-size": 256,
                     "device.batch-capacity": 4096})
        op = UpdatingAggregate({
            "key_fields": ["k"], "backend": backend, "ttl_micros": 40_000_000,
            "aggregates": [("n", "count", None), ("total", "sum", value_expr),
                           ("mean", "avg", value_expr)],
            "input_dtype_of": lambda e: np.dtype(dtype)})
        ctx = OperatorContext(TaskInfo("upd-card", "agg", "updating_aggregate", 0, 1), dev)
        op.on_start(ctx)
        sink = Sink()
        rng = np.random.default_rng(20261017)
        sent: list = []  # (key, value) of appended rows not yet retracted
        seen: dict = {}  # key -> the last step that touched it
        for step in range(40):
            n = 3000
            hi = 5000 if step < 20 else 2500
            ks = rng.integers(0, hi, n)
            vs = rng.integers(1, 1000, n)
            rt = np.zeros(n, dtype=bool)
            # rows of keys idle for 8 steps (40 s, the TTL) may have been
            # evicted: they are never retracted
            sent = [(k, v) for k, v in sent if step - seen[k] < 8]
            live = [i for i, (k, _v) in enumerate(sent) if k < hi]
            if live and step % 3 == 1:
                take = sorted(rng.choice(live, size=min(800, len(live)), replace=False),
                              reverse=True)
                back = [sent.pop(i) for i in take]
                ks = np.concatenate([ks, [k for k, _v in back]])
                vs = np.concatenate([vs, [v for _k, v in back]])
                rt = np.concatenate([rt, np.ones(len(back), dtype=bool)])
            sent.extend((k, v) for k, v, r in zip(ks.tolist(), vs.tolist(), rt) if not r)
            seen.update((k, step) for k in ks.tolist())
            ts = np.full(len(ks), step * 5_000_000, dtype=np.int64)
            op.process_batch(Batch({"k": ks, "v": vs, "f": vs * 0.01, TIMESTAMP_FIELD: ts,
                                    IS_RETRACT_FIELD: rt, KEY_FIELD: hash_columns([ks])}),
                             ctx, sink)
            if step % 4 == 3:
                op.handle_tick(ctx, sink)
            else:
                op.handle_watermark(Watermark.event_time(int(ts[0])), ctx, sink)
        op.on_close(ctx, sink)
        torch.cuda.synchronize()
        return sink.batches, op

    def same_batches(xs, ys) -> bool:
        return len(xs) == len(ys) and all(
            list(x.columns) == list(y.columns) and all(
                np.asarray(x[c]).dtype == np.asarray(y[c]).dtype
                and np.array_equal(np.asarray(x[c]), np.asarray(y[c])) for c in x.columns)
            for x, y in zip(xs, ys))

    res = {}
    for label, expr, dtype in (("int64 lanes", Col("v"), np.int64),
                               ("float64 lanes", Col("f"), np.float64)):
        launches0 = kernels.launch_counts()["slot_gather"]
        (b_dev, op_dev), (b_host, _op) = (run("jax", expr, dtype, dev),
                                          run("numpy", expr, dtype, dev))
        launches1 = kernels.launch_counts()["slot_gather"]
        rows_dev = [r for b in b_dev for r in b.to_pylist()]
        rows_host = [r for b in b_host for r in b.to_pylist()]
        same = same_batches(b_dev, b_host)
        # the float lanes' reference is the device mode's row order (the
        # integer lanes' is the host mode, checked above)
        same_as_plain = label == "int64 lanes" or same_batches(
            b_dev, run("jax", expr, dtype, torch.device("cpu"))[0])
        strip = lambda rows: [{k: v for k, v in r.items() if k != TIMESTAMP_FIELD} for r in rows]
        m_dev = {r["k"]: r for r in merge_updating_rows(strip(rows_dev))}
        m_host = {r["k"]: r for r in merge_updating_rows(strip(rows_host))}
        rel = 0.0
        if set(m_dev) != set(m_host):
            raise AssertionError(f"updating operator ({label}): live keys differ")
        for k, r in m_host.items():
            if m_dev[k]["n"] != r["n"]:
                raise AssertionError(f"updating operator ({label}): count of key {k} differs")
            for c in ("total", "mean"):
                rel = max(rel, abs(m_dev[k][c] - r[c]) / max(abs(r[c]), 1e-300))
        info = {"rows_device": len(rows_dev), "rows_host": len(rows_host),
                "changelogs_equal": bool(same), "merged_max_rel_err": rel,
                "retractions": sum(1 for r in rows_host if r[IS_RETRACT_FIELD]),
                "evicted_keys": op_dev.evicted_keys, "compactions": op_dev.compactions,
                "k7_launches": launches1 - launches0}
        if label == "float64 lanes":
            info["changelog_equals_cpu_device_mode"] = bool(same_as_plain)
        if label == "int64 lanes" and not same:
            raise AssertionError(f"updating operator on the card: device mode's changelog "
                                 f"differs from the host mode's: {info}")
        if not same_as_plain:
            raise AssertionError(f"updating operator ({label}): the card's changelog differs "
                                 f"from the device mode's on the CPU: {info}")
        if rel > 1e-9 or info["k7_launches"] == 0:
            raise AssertionError(f"updating operator ({label}): {info}")
        res[label] = info
    return res


def qs_graph(B, E, G, rows: list, event_count: int):
    """bench.py's qs (bench.py:116-146) over either package's modules:
    session windows per bidder, gap 2 s, COUNT(*) and SUM(price)."""
    S = B.Schema.of([("x", "int64"), (B.TIMESTAMP_FIELD, "int64")])
    c = E.Col
    g = G.Graph()
    g.add_node(G.Node("src", G.OpName.SOURCE, {
        "connector": "nexmark", "event_count": event_count, "inter_event_micros": 1000,
        "first_event_micros": 0, "include_strings": False,
        "columns": ["bid.bidder", "bid.price"]}, 1))
    g.add_node(G.Node("bids", G.OpName.VALUE, {
        "projections": [("bidder", c("bid.bidder")), ("price", c("bid.price"))],
        "filter": c("bid")}, 1))
    g.add_node(G.Node("wm", G.OpName.WATERMARK, {
        "expr": c(B.TIMESTAMP_FIELD), "interval_micros": 1_000_000}, 1))
    g.add_node(G.Node("key", G.OpName.KEY, {"keys": [("bidder", c("bidder"))]}, 1))
    g.add_node(G.Node("agg", G.OpName.SESSION_AGGREGATE, {
        "gap_micros": SESSION_GAP, "key_fields": ["bidder"],
        "aggregates": [("bids", "count", None), ("spend", "sum", c("price"))],
        "input_dtype_of": lambda e: np.dtype(np.int64)}, 1))
    g.add_node(G.Node("sink", G.OpName.SINK, {"connector": "vec", "rows": rows,
                                               "columnar": True}, 1))
    for a, b, t in [("src", "bids", G.EdgeType.FORWARD), ("bids", "wm", G.EdgeType.FORWARD),
                    ("wm", "key", G.EdgeType.FORWARD), ("key", "agg", G.EdgeType.SHUFFLE),
                    ("agg", "sink", G.EdgeType.FORWARD)]:
        g.add_edge(a, b, t, S)
    return g


def build_qs(rows: list, event_count: int) -> Graph:
    from arroyo_tpu_torch import batch as B
    from arroyo_tpu_torch import expr as E
    from arroyo_tpu_torch import graph as G

    return qs_graph(B, E, G, rows, event_count)


def oracle_qs(event_count: int) -> dict:
    """(session_start, bidder) -> (count, spend) with gap-merged sessions
    (bench.py oracle_qs, over the port's generator)."""
    b = nexmark_columns(event_count, ["bid.bidder", "bid.price"], 1000)
    is_bid = b["bid"]
    bidder, price, ts = b["bid.bidder"][is_bid], b["bid.price"][is_bid], b[TIMESTAMP_FIELD][is_bid]
    out: dict = {}
    order = np.lexsort((ts, bidder))
    bs, tss, ps = bidder[order], ts[order], price[order]
    i0 = 0
    for i in range(1, len(bs) + 1):
        if i == len(bs) or bs[i] != bs[i - 1] or tss[i] - tss[i - 1] > SESSION_GAP:
            out[(int(tss[i0]), int(bs[i0]))] = (i - i0, int(ps[i0:i].sum()))
            i0 = i
    return out


def check_qs(rows: list, want: dict) -> dict:
    """bench.py's check_parity_qs, and no session emitted twice."""
    got: dict = {}
    for b in rows:
        for ws, bd, n, sp in zip(b["window_start"].tolist(), b["bidder"].tolist(),
                                 b["bids"].tolist(), b["spend"].tolist()):
            if (ws, bd) in got:
                raise AssertionError(f"qs session {(ws, bd)} emitted twice")
            got[(ws, bd)] = (n, sp)
    if got != want:
        diff = next(iter(set(got.items()) ^ set(want.items())), None)
        raise AssertionError(f"qs parity failure: {len(got)} sessions vs {len(want)}; "
                             f"first diff {diff}")
    return got


def run_qs() -> dict:
    """qs at bench.py's setting: K4 on the bids chain; the session window
    is host numpy in both packages."""
    return run_chained("qs", build_qs, QS_EVENTS, oracle_qs, check_qs,
                       path_kernels=("segment_fused",))


# ---------------------------------------------------------------- gather (K7)


def qu_touched_keys(events: int = QU_EVENTS) -> int:
    """The most distinct auctions of any one source batch of qu's stream:
    the keys one flush reads back with K7."""
    b = nexmark_columns(events, ["bid.auction"], 1000)
    return max(len(np.unique(b["bid.auction"][lo:lo + BENCH_BATCH][b["bid"][lo:lo + BENCH_BATCH]]))
               for lo in range(0, events, BENCH_BATCH))


def gather_state(rng, dtypes, cap, dev):
    out = []
    for dt in dtypes:
        npdt = NP_DT[dt]
        if dt.is_floating_point:
            a = rng.normal(0, 1e6, cap).astype(npdt)
            a[:7] = [np.nan, -0.0, np.inf, -np.inf, 1e-30, 1e-40, -1e-40]
            a[-1] = -7.5
        else:
            a = rng.integers(np.iinfo(npdt).min, np.iinfo(npdt).max, cap, dtype=npdt)
        out.append(torch.from_numpy(a).to(dev))
    return out


K7_KERNELS = {"gather_kernel": 1}


def check_gather(state, slots) -> None:
    """K7 against its plain version, exactly: the int64 views with
    torch.equal, the float64 views bit for bit (NaN and -0.0 included);
    one kernel by the library's counter; with ``packed``, the same views
    of the one buffer it hands back (the int part from byte 0, the float
    part from the next 16-byte boundary)."""
    before = kernels.gather_kernel_launches()
    ib, fb = kernels.slot_gather(state, slots)
    n = kernels.gather_kernel_launches() - before
    pib, pfb = kernels.slot_gather_plain(state, slots)
    oib, ofb, packed = kernels.slot_gather(state, slots, packed=True)
    f_off = -(-oib.numel() * 8 // 16) * 16
    torch.cuda.synchronize()
    what = (f"k {slots.numel()}, {slots.dtype}, lanes {[str(a.dtype) for a in state]}, "
            f"slots at {slots.data_ptr() % 16} mod 16")
    if not (torch.equal(ib, pib) and torch.equal(fb.view(torch.int64), pfb.view(torch.int64))):
        raise AssertionError(f"slot_gather differs from its plain version ({what})")
    if not (torch.equal(oib, pib) and torch.equal(ofb.view(torch.int64), pfb.view(torch.int64))
            and (oib.numel() == 0 or oib.data_ptr() == packed.data_ptr())
            and (ofb.numel() == 0 or ofb.data_ptr() == packed.data_ptr() + f_off)):
        raise AssertionError(f"slot_gather's packed buffer differs ({what})")
    if slots.numel() and n != 1:
        raise AssertionError(f"slot_gather made {n} kernel launches in one call ({what})")


def gather_edge_cases(rng, dev) -> dict:
    """K7's edge cases: k of 1-5 and k % 4 of 1, 2 and 3 past whole quads,
    a slot array offset by one element (off a 16-byte boundary), every
    lane dtype on its own, output rows off a 16-byte boundary (k odd with
    two lanes of a class), slots out of range, with both index dtypes."""
    cap = 4099
    lane_sets = {**{str(d).replace("torch.", ""): [d] for d in
                    (torch.int32, torch.int64, torch.float32, torch.float64, torch.uint64)},
                 "two of each class": [torch.int64, torch.int32, torch.float64, torch.float32]}
    checked = {}
    for label, dts in lane_sets.items():
        st = gather_state(rng, dts, cap, dev)
        for idx_dt in (torch.int32, torch.int64):
            for k in (1, 2, 3, 4, 5, 9, 10, 11, 1001):
                sl = rng.integers(-3, cap + 3, k)
                sl[: min(k, 2)] = [0, cap - 1][: min(k, 2)]
                t = torch.from_numpy(sl).to(idx_dt).to(dev)
                check_gather(st, t)
                off = torch.empty(k + 1, dtype=idx_dt, device=dev)[1:]
                off.copy_(t)
                check_gather(st, off)
                checked[f"{label} {str(idx_dt).replace('torch.', '')} k = {k}"] = 2
    return checked


def qu_lanes() -> list:
    """The device lanes of qu's updating aggregate, as its operator builds
    them: COUNT's int64, SUM(price)'s int64, AVG's float64 sum and int64
    count (windows/tumbling.py acc_plan)."""
    node = build_qu([], 1).nodes["agg"]
    return [str(d) for d in construct_operator(node.op, node.config)._dev_dtypes()]


def gather_phase(dev) -> dict:
    """K7 at qu's shape (qu's lanes, 262144 slots, one batch's touched
    keys), at a deployment-size state (16,777,216 slots x 4 int64 lanes,
    512 MB, 1,048,576 slots gathered), over mixed lanes with int32 and int64
    indices, and on edge cases; then timed."""
    rng = np.random.default_rng(20261017)
    k_qu = qu_touched_keys()
    qu_dt = [getattr(torch, d) for d in qu_lanes()]
    shapes = {"qu": (qu_dt, QU_CAP, k_qu),
              "deployment": ([torch.int64] * 4, 1 << 24, 1 << 20),
              "mixed": ([torch.int32, torch.int64, torch.float32, torch.float64,
                         torch.float32, torch.int32, torch.uint64], 1 << 20, 50_001)}
    checked = {}
    states = {}
    for name, (dts, cap, k) in shapes.items():
        log(f"gather: check {name}")
        st = gather_state(rng, dts, cap, dev)
        states[name] = st
        for idx_dt in (torch.int32, torch.int64):
            base = rng.integers(0, cap, k)
            for label, sl in (("random", base),
                              ("k = 1", base[:1]), ("slot 0", np.zeros(1, np.int64)),
                              ("slot cap - 1", np.full(1, cap - 1)),
                              ("k not a power of two", base[:max(1, k - 37)]),
                              ("duplicated slots", np.repeat(base[:257], 5)),
                              ("edges mixed", np.concatenate([[0, cap - 1, 0, cap - 1], base[:61]]))):
                check_gather(st, torch.from_numpy(sl.astype(np.int64)).to(idx_dt).to(dev))
                checked[f"{name} {str(idx_dt).replace('torch.', '')} {label}"] = len(sl)
    log("gather: edge cases")
    edge = gather_edge_cases(rng, dev)
    timing = {}
    for name in ("qu", "deployment"):
        dts, cap, k = shapes[name]
        st = states[name]
        slots = torch.from_numpy(rng.integers(0, cap, k).astype(np.int32)).to(dev)
        ints = [a for a in st if not a.dtype.is_floating_point]
        flts = [a for a in st if a.dtype.is_floating_point]
        sl64 = slots.long()
        log(f"gather: time {name}")
        call = lambda: kernels.slot_gather(st, slots)  # noqa: E731
        t = timed(
            call,
            lambda: kernels.slot_gather_plain(st, slots),
            lambda: (torch.cat([kernels.bits(a).index_select(0, sl64).to(torch.int64)
                                for a in ints])
                     if ints else None,
                     torch.cat([a.index_select(0, sl64).to(torch.float64) for a in flts])
                     if flts else None),
            library="torch.index_select per lane, widened and concatenated per lane class",
            bytes=k * slots.element_size() + k * sum(a.element_size() for a in st) + k * 8 * len(st),
            bytes_counted="k slot indices read, k words of each lane gathered, k x 8 bytes "
                          "per lane written",
            sector_floor_ms=k * len(st) * 32 / HBM_BYTES_PER_S * 1e3,
            k=k, cap=cap, lanes=[str(a.dtype).replace("torch.", "") for a in st])
        t.update(library_launch_report(call, kernels.gather_kernel_launches,
                                       {"device_ops_per_call": t["ops_per_call"],
                                        "device_us_per_call": t["us_per_call"],
                                        "method": t["method"], "device_ms": t["ms"]},
                                       K7_KERNELS, f"K7 at {name}"))
        t["read_slots_host_ms"], t["read_slots_breakdown_ms"] = read_slots_host_ms(
            dts, cap, k, dev, rng)
        timing[name] = t
    info = {"phase": "gather", "cases_checked": len(checked) + len(edge), "max_abs_err": 0.0,
            "qu_touched_keys": k_qu, "checked": checked, "edge_cases": edge, "timing": timing}
    emit(info)
    return info


def read_slots_host_ms(dts, cap, k, dev, rng) -> tuple[float, dict]:
    """Median wall time of SlotAggregator.read_slots (what one flush pays:
    slot staging and upload, K7, the copy into pinned memory, the wait on
    its event, the split into lanes) at this shape, host clock; and, over
    as many more calls, the median of each of its steps, from timestamps
    taken as read_slots's own calls return (its module's ``staging.stage``,
    ``kernels.slot_gather`` and ``HostFetch`` wrapped for those calls
    alone): ``stage`` (the slots converted, packed into the pinned buffer
    and their copy queued), ``launch`` (the output allocated and K7
    queued), ``fetch`` (the pinned buffer and the copy back queued),
    ``wait`` (until the copy has landed) and ``split`` (the lanes carved
    and converted)."""
    from types import SimpleNamespace
    from unittest import mock

    from arroyo_tpu_torch.ops import slot_agg as sa

    agg = sa.SlotAggregator(["sum"] * len(dts), [NP_DT[d] for d in dts], cap=cap,
                            batch_cap=65536, region_size=2048, device=dev)
    slots = rng.integers(0, cap, k)
    times = []
    for _ in range(2 + TIMING_REPS):
        t0 = time.perf_counter()
        agg.read_slots(slots)
        times.append((time.perf_counter() - t0) * 1e3)
    marks: list = []

    def stamped(fn):
        def call(*a, **kw):
            r = fn(*a, **kw)
            marks.append(time.perf_counter())
            return r
        return call

    class Fetch(sa.HostFetch):
        __init__ = stamped(sa.HostFetch.__init__)
        result = stamped(sa.HostFetch.result)

    steps: dict = {s: [] for s in ("stage", "launch", "fetch", "wait", "split")}
    with mock.patch.object(sa, "staging", SimpleNamespace(stage=stamped(sa.staging.stage))), \
            mock.patch.object(sa, "kernels", SimpleNamespace(slot_gather=stamped(kernels.slot_gather))), \
            mock.patch.object(sa, "HostFetch", Fetch):
        for _ in range(2 + TIMING_REPS):
            torch.cuda.synchronize()
            marks.clear()
            t0 = time.perf_counter()
            agg.read_slots(slots)
            t = [t0, *marks, time.perf_counter()]
            if len(t) != len(steps) + 1:
                raise AssertionError(f"read_slots made {len(marks)} of the 4 timed calls")
            for name, a, b in zip(steps, t, t[1:]):
                steps[name].append((b - a) * 1e3)
    del agg
    return statistics.median(times[2:]), {n: statistics.median(v[2:]) for n, v in steps.items()}


# ---------------------------------------------------------------- join kernels


def q8_join_keys() -> tuple[np.ndarray, np.ndarray]:
    """The probe (auctions) and build (bids) keys of q8's fullest window, as
    the KEY operator hashes them and the join views them (int64)."""
    b = q8_events(Q8_EVENTS)
    w = (b[TIMESTAMP_FIELD] // WIDTH) * WIDTH
    sides = q8_window_sides(Q8_EVENTS)
    t = max(sides, key=lambda k: sides[k][1])
    a, bid = b["auction"] & (w == t), b["bid"] & (w == t)
    return (hash_columns([b["auction.id"][a]]).view(np.int64),
            hash_columns([b["bid.auction"][bid]]).view(np.int64))


def join_edge_cases(rng) -> list:
    """(label, probe keys, build keys) of the edge cases, 0 to 10,007 rows:
    empty sides, real INT64_MAX and INT64_MIN keys on both sides, one key
    everywhere, negative keys, sizes that are not powers of two."""
    i64 = np.iinfo(np.int64)
    small = rng.integers(-50, 50, 10_007).astype(np.int64)
    some = hash_columns([rng.integers(0, 300, 1000)]).view(np.int64)
    cases = [("empty probe", np.empty(0, np.int64), some),
             ("empty build", some[:700], np.empty(0, np.int64)),
             ("both empty", np.empty(0, np.int64), np.empty(0, np.int64)),
             ("INT64_MAX keys", np.array([i64.max, 5, i64.max, -3]),
              np.array([i64.max, 7, -3, i64.max, i64.max, 5])),
             ("INT64_MIN keys", np.array([i64.min, 0, i64.min]),
              np.array([0, i64.min, 9, i64.min])),
             ("one key everywhere", np.full(99, 42, np.int64), np.full(3001, 42, np.int64)),
             ("negative keys", -rng.integers(1, 1000, 2049), -rng.integers(1, 1000, 4095)),
             ("odd sizes", small[:63], small)]
    for n in (1, 3, 65, 2047, 2049, 4097):
        cases.append((f"{n} build rows", rng.integers(-99, 99, 100),
                      rng.integers(-99, 99, n).astype(np.int64)))
    # K6 caches every ceil(m / 2048)-th sorted key: runs of equal keys across
    # those splitters and across multiples of 2048, m not a multiple of the
    # stride, probes outside the keys' range and at both int64 limits
    long_runs = np.repeat(rng.integers(-10**6, 10**6, 40), rng.integers(65, 700, 40))
    probes = np.concatenate([rng.choice(long_runs, 500), rng.integers(-10**6, 10**6, 500),
                             [i64.min, i64.max, -10**7, 10**7]])
    cases += [("long runs across splitters and multiples of 2048", probes, long_runs),
              ("a run of 5000 equal keys across rows 2048, 4096 and 6144 of 10,243", rng.integers(-5, 6, 700),
               np.concatenate([rng.integers(-50, 0, 2000), np.zeros(5000, np.int64),
                               rng.integers(1, 50, 3243)])),
              ("100,003 build rows, runs of ~100", rng.integers(-600, 600, 3000),
               rng.integers(-500, 500, 100_003)),
              ("probes below and above every key", np.concatenate([
                  rng.integers(-10**9, -10**6, 300), rng.integers(10**6, 10**9, 300)]),
               rng.integers(-999_999, 999_999, 7000)),
              ("INT64_MIN and INT64_MAX probes on keys without them",
               np.array([i64.min, i64.max, i64.min, 0, i64.max]),
               rng.integers(-(1 << 62), 1 << 62, 3000))]
    return [(label, np.asarray(lk, np.int64), np.asarray(rk, np.int64))
            for label, lk, rk in cases]


def sort_edge_cases(rng) -> list:
    """(label, keys, mode) of K5's edge cases: int64 keys (int32 where
    named), mode the keyword arguments of join_sort_pairs (key_bits,
    range_cap). Sizes below, at and past one tile (4096 keys) and not
    powers of two."""
    i64, i32 = np.iinfo(np.int64), np.iinfo(np.int32)
    edges = np.array([i64.min, -1, 0, i64.max, i64.min + 1, 1, i64.max - 1], np.int64)
    top = (rng.integers(0, 256, 10_000).astype(np.uint64) << np.uint64(56)
           | np.uint64(0x00123456789ABCDE)).view(np.int64)
    bottom = (np.uint64(0x8765432101234500)
              | rng.integers(0, 256, 10_000).astype(np.uint64)).view(np.int64)
    hashed = hash_columns([rng.integers(0, 5000, 131_071)]).view(np.int64)
    slots = (rng.zipf(1.2, 65_536) - 1) % 262_160
    slots[rng.random(65_536) < 0.01] = -1
    slots[:3] = [i64.min, i64.max, 1 << 40]
    return [
        ("INT64_MIN, -1, 0 and INT64_MAX", rng.choice(edges, 5000), {}),
        ("INT64_MIN, -1, 0 and INT64_MAX, one tile", rng.choice(edges, 9), {}),
        ("equal but the top digit", top, {}),
        ("equal but the bottom digit", bottom, {}),
        ("all equal, 2^20 + 3 rows", np.full((1 << 20) + 3, -12345, np.int64), {}),
        ("131,071 hashed keys", hashed, {}),
        ("n of 1", np.array([7], np.int64), {}),
        ("n of 2", np.array([3, -3], np.int64), {}),
        ("4095 keys", hashed[:4095], {}),
        ("4096 keys", hashed[:4096], {}),
        ("4097 keys", hashed[:4097], {}),
        ("int32 negatives", np.concatenate([[i32.min, -1, 0, i32.max],
                                            rng.integers(i32.min, i32.max, 9000)]).astype(np.int32),
         {}),
        ("key_bits 16", rng.integers(0, 1 << 16, 7000).astype(np.int64), {"key_bits": 16}),
        ("range mode, cap 262144", slots.astype(np.int64), {"range_cap": 262_144}),
        ("range mode, cap 1", rng.integers(-2, 3, 5000).astype(np.int64), {"range_cap": 1}),
        ("range mode, cap 2^31 - 1, int32 keys",
         rng.integers(i32.min, i32.max, 9000).astype(np.int32), {"range_cap": int(i32.max)}),
        ("range mode, cap 4096, int32 keys",
         rng.integers(-5, 4200, 4097).astype(np.int32), {"range_cap": 4096}),
        ("range mode, cap 300, one tile", rng.integers(-5, 310, 777).astype(np.int64),
         {"range_cap": 300}),
    ]


def check_sort_case(label: str, keys: np.ndarray, mode: dict, dev) -> dict:
    """K5 against its plain version on the card, exactly (keys and
    order); int32 keys through K5's launch, as K1 runs it."""
    kt = torch.from_numpy(keys).to(dev)
    if kt.dtype == torch.int32:
        got = join_kernels.sort_pairs_launch(kt, **mode)
    else:
        got = join_kernels.join_sort_pairs(kt, **mode)
    want = join_kernels.join_sort_pairs_plain(kt, **mode)
    torch.cuda.synchronize()
    for name, g, w in zip(("sorted keys", "order"), got, want):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"K5 {label}: {name} differs from the plain version")
    return {"n": len(keys), "passes": join_kernels.sort_passes(**mode),
            "launches": join_kernels.sort_launches(len(keys), **mode)}


def join_cases(rng) -> list:
    """The edge cases, q8's fullest window with q8's own (hot-skewed) keys,
    and a deployment-size window: 1,048,576 probe x 16,777,216 build rows
    (200 MB of pairs, a 10 s window at about 1.8 M events/s), keys hashed
    from 2^20 ids."""
    lk, rk = q8_join_keys()
    dep_r = hash_columns([rng.integers(0, 1 << 20, 1 << 24)]).view(np.int64)
    dep_l = hash_columns([rng.integers(0, 1 << 20, 1 << 20)]).view(np.int64)
    return [("q8 window", lk, rk), ("deployment window", dep_l, dep_r)] + join_edge_cases(rng)


def check_join_case(label: str, lk: np.ndarray, rk: np.ndarray, dev) -> dict:
    """K5 and K6 against their plain versions on the card, exactly: on the
    keys as the join pads them (_bucket sizes, INT64_MAX) and unpadded (the
    kernel pads inside), then the expanded pairs of device_join_start
    against the plain version's expansion and the host probe."""
    n_l, n_r = len(lk), len(rk)
    l_cap, r_cap = join_probe._bucket(n_l), join_probe._bucket(n_r)
    lp = np.full(l_cap, join_probe._SENTINEL, np.int64)
    lp[:n_l] = lk
    rp = np.full(r_cap, join_probe._SENTINEL, np.int64)
    rp[:n_r] = rk
    for tag, lkeys, rkeys in (("padded", lp, rp), ("unpadded", lk, rk)):
        lt, rt = torch.from_numpy(lkeys).to(dev), torch.from_numpy(rkeys).to(dev)
        sk, order = join_kernels.join_sort_pairs(rt)
        sk_p, order_p = join_kernels.join_sort_pairs_plain(rt)
        lo, hi = join_kernels.join_search_bounds(sk_p, lt)
        lo_p, hi_p = join_kernels.join_search_bounds_plain(sk_p, lt)
        torch.cuda.synchronize()
        for name, g, w in (("sorted keys", sk, sk_p), ("order", order, order_p),
                           ("lo", lo, lo_p), ("hi", hi, hi_p)):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"join {label} ({tag}): {name} differs from the plain "
                                     f"version ({g.dtype} vs {w.dtype})")
    lt, rt = torch.from_numpy(lp).to(dev), torch.from_numpy(rp).to(dev)
    sk_p, order_p = join_kernels.join_sort_pairs_plain(rt)
    plain = join_probe.JoinHandle(n_l, n_r, *(join_probe.HostFetch(t) for t in (
        order_p, *join_kernels.join_search_bounds_plain(sk_p, lt))))
    li_p, ri_p = plain.result()
    li, ri = join_probe.device_join_start(lk, rk, dev).result()
    li_h, ri_h = join_probe.host_join_indices(lk, rk)
    if not (torch.equal(torch.from_numpy(li), torch.from_numpy(li_p))
            and torch.equal(torch.from_numpy(ri), torch.from_numpy(ri_p))
            and np.array_equal(li, li_h) and np.array_equal(ri, ri_h)):
        raise AssertionError(f"join {label}: the expanded (li, ri) pairs differ")
    return {"probe": n_l, "build": n_r, "l_cap": l_cap, "r_cap": r_cap, "pairs": len(li)}


def join_phase(dev) -> dict:
    rng = np.random.default_rng(20261017)
    checked = {}
    cases = join_cases(rng)
    for label, lk, rk in cases:
        log(f"join: check {label}")
        checked[label] = check_join_case(label, lk, rk, dev)
    log("join: K5 edge cases")
    sort_checked = {label: check_sort_case(label, keys, mode, dev)
                    for label, keys, mode in sort_edge_cases(rng)}
    timing, sort_inputs = {}, {}
    for label in ("q8 window", "deployment window"):
        _l, lk, rk = next(c for c in cases if c[0] == label)
        l_cap, r_cap = join_probe._bucket(len(lk)), join_probe._bucket(len(rk))
        lt = torch.full((l_cap,), join_probe._SENTINEL, dtype=torch.int64)
        lt[:len(lk)] = torch.from_numpy(lk)
        rt = torch.full((r_cap,), join_probe._SENTINEL, dtype=torch.int64)
        rt[:len(rk)] = torch.from_numpy(rk)
        lt, rt = lt.to(dev), rt.to(dev)
        sort_inputs[label] = rt
        sk, _order = join_kernels.join_sort_pairs_plain(rt)
        log(f"join: time {label}")
        timing[label] = {
            "join_sort_pairs": timed(
                lambda: join_kernels.join_sort_pairs(rt),
                lambda: join_kernels.join_sort_pairs_plain(rt),
                lambda: torch.sort(rt, stable=True),
                library="torch.sort(stable=True)",
                bytes=8 * r_cap + 12 * r_cap, bytes_counted="8 r_cap read, 12 r_cap written",
                r_cap=r_cap, passes=join_kernels.sort_passes(),
                launches=join_kernels.sort_launches(r_cap)),
            "join_search_bounds": timed(
                lambda: join_kernels.join_search_bounds(sk, lt),
                lambda: join_kernels.join_search_bounds_plain(sk, lt),
                lambda: (torch.searchsorted(sk, lt, side="left"),
                         torch.searchsorted(sk, lt, side="right")),
                library="two torch.searchsorted calls",
                bytes=8 * l_cap + 8 * l_cap,
                bytes_counted="8 l_cap read, 8 l_cap written; the sorted keys are not counted "
                              "(each search reads log2(r_cap) of them)",
                l_cap=l_cap, r_cap=r_cap)}
    for label, t in timing.items():
        # kernel launches of one call, counted by the library as it launches
        # them; the trace's count (each kernel's launches per call, rounded)
        # can only miss some, never add one
        k5 = t["join_sort_pairs"]
        rt = sort_inputs[label]
        before = join_kernels.sort_kernel_launches()
        join_kernels.join_sort_pairs(rt)
        k5["kernel_launches_per_call"] = join_kernels.sort_kernel_launches() - before
        k5["trace_kernel_launches_per_call"] = sum(
            max(1, round(c)) for name, c in k5["ops_per_call"].items()
            if not name.startswith(("Memset", "Memcpy")))
        if not (k5["kernel_launches_per_call"] == k5["launches"]
                and k5["trace_kernel_launches_per_call"] <= k5["launches"]):
            raise AssertionError(f"K5 at the {label}: {k5['kernel_launches_per_call']} kernel "
                                 f"launches per call ({k5['trace_kernel_launches_per_call']} in "
                                 f"the trace), expected {k5['launches']}")
        if label == "q8 window" and k5["launches"] > 9:
            raise AssertionError(f"K5 at the q8 window: {k5['launches']} launches, at most 9")
    info = {"phase": "join", "cases_checked": len(checked) + len(sort_checked),
            "max_abs_err": 0.0, "checked": checked, "sort_checked": sort_checked,
            "timing": timing}
    emit(info)
    return info


# ---------------------------------------------------------------- segment plans

GRID_N = 65536 - 37  # odd, not a multiple of the kernel's block


def q7_members(E) -> list:
    c = E.Col
    return [("value", {"projections": [("auction", c("bid.auction")), ("price", c("bid.price"))],
                       "filter": c("bid")}),
            ("watermark", {"expr": c(TIMESTAMP_FIELD), "interval_micros": 1_000_000}),
            ("key", {"keys": [("auction", c("auction"))]}),
            ("tumbling_aggregate", {"width_micros": WIDTH, "key_fields": ["auction"],
                                    "aggregates": [("max_price", "max", c("price")),
                                                   ("bids", "count", None)],
                                    "input_dtype_of": lambda e: np.dtype(np.int64)})]


def q5_members(E) -> list:
    c = E.Col
    return [("value", {"projections": [("auction", c("bid.auction"))], "filter": c("bid")}),
            ("watermark", {"expr": c(TIMESTAMP_FIELD), "interval_micros": 1_000_000}),
            ("key", {"keys": [("auction", c("auction"))]}),
            ("sliding_aggregate", {"width_micros": WIDTH, "slide_micros": SLIDE,
                                   "key_fields": ["auction"], "aggregates": [("bids", "count", None)],
                                   "input_dtype_of": lambda e: np.dtype(np.int64)})]


def bids_chain_members(E, key: str) -> list:
    """qu's and qs's chains (bids -> wm -> key; the keyed operator after the
    shuffle is not chained): VALUE (``key`` and price of each bid), the
    watermark, KEY on ``key``."""
    c = E.Col
    return [("value", {"projections": [(key, c(f"bid.{key}")), ("price", c("bid.price"))],
                       "filter": c("bid")}),
            ("watermark", {"expr": c(TIMESTAMP_FIELD), "interval_micros": 1_000_000}),
            ("key", {"keys": [(key, c(key))]})]


def q8_members(E, side: str) -> list:
    """bench.py's q8 chains (bench.py:160-174): the auctions or the bids
    VALUE (window-start stamp, filter) + KEY."""
    c, win = E.Col, E.BinOp("*", E.BinOp("/", E.Col(TIMESTAMP_FIELD), E.Lit(WIDTH)), E.Lit(WIDTH))
    if side == "auctions":
        proj, key = [("id", c("auction.id")), (TIMESTAMP_FIELD, win)], "id"
    else:
        proj, key = [("auction", c("bid.auction")), (TIMESTAMP_FIELD, win)], "auction"
    return [("value", {"projections": proj, "filter": c(side[:-1])}),
            ("key", {"keys": [(key, c(key))]})]


def nexmark_columns(n: int, columns: list, inter_event: int) -> dict:
    return dict(NexmarkSource({"event_count": n, "inter_event_micros": inter_event,
                               "first_event_micros": 0, "include_strings": False,
                               "columns": columns})._generate(np.arange(n, dtype=np.int64)).columns)


def grid_columns(n: int, seed: int = 20261017) -> dict:
    """Columns of every dtype the grid reads, with their edge values:
    negatives, zeros and -1 divisors, INT_MIN/INT_MAX, +-0.0, NaN, +-inf,
    and negative timestamps."""
    rng = np.random.default_rng(seed)
    i64 = rng.integers(-(1 << 40), 1 << 40, n)
    i64[:8] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1, 1, -7, 7, -(1 << 62)]
    i32 = rng.integers(-1000, 1000, n).astype(np.int32)
    i32[:8] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0, -1, 1, -3, 3, -2]
    d32 = rng.integers(-4, 5, n).astype(np.int32)  # divisors: zeros and -1 included
    d32[:8] = [-1, -1, 0, 0, -3, 2, -1, 5]
    f64 = rng.normal(0, 1e3, n)
    f64[:12] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 2.5, -2.5, 1e300, -1e-300, 9.3e18, -9.3e18, 3.0]
    f32 = rng.normal(0, 50, n).astype(np.float32)
    f32[:10] = [np.nan, -np.inf, np.inf, -0.0, 0.0, 0.5, -1.5, 3e38, -7.0, 1e-30]
    g64 = rng.normal(0, 1e6, n)  # finite, for the float watermark
    g64[:2] = [-0.0, 0.0]
    b = rng.random(n) < 0.5
    ts = rng.integers(-(10 ** 11), 10 ** 11, n)
    ts[:4] = [-1, -10_000_000, -10_000_001, 0]
    return {TIMESTAMP_FIELD: ts, "i32": i32, "i64": i64, "f32": f32, "f64": f64, "b": b,
            "d32": d32, "g64": g64}


def expression_grid(E) -> list:
    """Every allowlisted binop over every pair of the grid's column dtypes
    and literals, every allowlisted function, Not, Neg, Cast and CASE; the
    one combination jax.numpy itself refuses (bool - bool) left out."""
    c, lit = E.Col, E.Lit
    operands = [("i32", c("i32")), ("i64", c("i64")), ("f32", c("f32")), ("f64", c("f64")),
                ("b", c("b")), ("d32", c("d32")), ("int", lit(-3)), ("float", lit(2.5)),
                ("bool", lit(True))]
    bools = {"b", "bool"}
    out = []
    for op in sorted(seg._TRACEABLE_BINOPS):
        for ln, le in operands:
            for rn, re in operands:
                if ln in ("int", "float", "bool") and rn in ("int", "float", "bool"):
                    continue
                if op == "-" and ln in bools and rn in bools:
                    continue
                if op in ("/", "%") and rn not in ("d32", "f64", "int", "float", "i32"):
                    continue  # divisors: the columns and literals holding zeros and negatives
                out.append((f"{ln} {op} {rn}", E.BinOp(op, le, re)))
    cols = [(n, e) for n, e in operands if n not in ("int", "float", "bool")]
    for name in ("abs", "floor", "ceil", "sqrt", "extract_epoch", "to_timestamp_micros"):
        for n, e in cols:
            out.append((f"{name}({n})", E.Func(name, (e,))))
    for n, e in cols:
        if n != "b":
            out.append((f"date_trunc_micros(1000, {n})", E.Func("date_trunc_micros", (lit(1000), e))))
            out.append((f"-{n}", E.Neg(e)))
        out.append((f"not {n}", E.Not(e)))
        for t in ("int32", "int64", "uint64", "float32", "float64", "bool"):
            out.append((f"cast({n}, {t})", E.Cast(e, t)))
    out.append(("case", E.Case(((E.BinOp("<", c("i64"), lit(0)), c("f32")), (c("b"), c("i32"))),
                               lit(1.5))))
    out.append(("case int", E.Case(((E.BinOp(">", c("f64"), lit(0.0)), lit(1)),), c("d32"))))
    out.append(("nested", E.BinOp("+", E.BinOp("*", c("f32"), c("f32")), c("f64"))))
    return out


def segment_grid(E, chunk: int = 48) -> list:
    """(label, member configs, hoist) of every plan K4 is held on besides
    the nexmark ones: the expression grid in chunks of projections behind an
    in-trace filter and a float watermark, multi-column keys (with the
    filter hoisted), and a tumbling insert over negative timestamps."""
    c, lit = E.Col, E.Lit
    exprs = expression_grid(E)
    plans = []
    filt = E.BinOp(">", c("i32"), lit(-900))
    for k in range(0, len(exprs), chunk):
        part = exprs[k:k + chunk]
        proj = [(f"e{k + j}", e) for j, (_l, e) in enumerate(part)] + [("w", c("g64"))]
        plans.append((f"exprs {k}-{k + len(part) - 1}", [
            ("value", {"projections": proj, "filter": filt}),
            ("watermark", {"expr": c("w")})], False))
    keys = [("k1", c("i32")), ("k2", c("f64")), ("k3", c("b")), ("k4", c("f32")), ("k5", c("i64"))]
    plans.append(("watermark over NaN", [
        ("value", {"projections": [("x", c("f64"))], "filter": None}),
        ("watermark", {"expr": c("x")})], False))  # NaN reaches the max
    plans.append(("multi-column key, hoisted filter", [
        ("value", {"projections": None, "filter": c("b")}),
        ("watermark", {"expr": c("g64")}),
        ("watermark", {"expr": c("i32")}),
        ("key", {"keys": keys})], True))
    plans.append(("tumbling insert, negative timestamps", [
        ("value", {"projections": [("auction", c("i64")), ("price", c("f32")), ("i32", c("i32")),
                                   (TIMESTAMP_FIELD, c(TIMESTAMP_FIELD))],
                   "filter": E.BinOp("!=", c("d32"), lit(0))}),
        ("watermark", {"expr": c(TIMESTAMP_FIELD)}),
        ("key", {"keys": [("auction", c("auction")), ("k2", c("i32"))]}),
        ("tumbling_aggregate", {"width_micros": WIDTH, "key_fields": ["auction"],
                                "aggregates": [("s", "sum", c("price")), ("n", "count", None),
                                               ("m", "min", E.BinOp("*", c("price"), lit(2)))],
                                "input_dtype_of": lambda e: np.dtype(np.float64)})], False))
    return plans


def bind_plan(members: list, batch: Batch, hoist: bool):
    """The port's bound plan for member configs over one batch, as the
    segment runner binds it (the insert member's key transport first)."""
    ops = [construct_operator(OpName(op), cfg) for op, cfg in members]
    marking = seg.segment_marking(members)
    if marking is None:
        raise AssertionError(f"plan not marked compilable: {seg.segment_reject_reason(members)}")
    k = int(marking["prefix"])
    if marking["insert"]:
        probe = seg._bind(ops[:k - 1], k - 1, batch, probe=True)
        ops[k - 1]._setup_key_transport(Batch(seg._reference(probe, batch)["cols"]))
    return seg._bind(ops[:k], k, batch, hoist=hoist)


def staged_inputs(plan, batch: Batch, dev) -> tuple[int, list]:
    """The kernel's inputs as CompiledSegment.execute stages them: hoisted
    filter applied, padded to _padded_size(n), on ``dev``."""
    n = batch.num_rows
    fm = None
    if plan.prefilter is not None:
        fm = np.asarray(seg.eval_expr(plan.prefilter, batch.columns, n), dtype=bool)
        n = int(fm.sum())
    p = seg._padded_size(n)
    ins = []
    for name in plan.traced_in:
        a = np.asarray(batch.columns[name])
        buf = np.zeros(p, dtype=a.dtype)
        buf[:n] = a[fm] if fm is not None else a
        if buf.dtype == np.uint64:
            buf = buf.view(np.int64)
        ins.append(torch.from_numpy(buf).to(dev))
    return n, ins


def nexmark_plans() -> list:
    """(label, plan, batch) for the q7 and q5 insert plans at P = 65536,
    q8's two emit-batch plans and the bids chains of qu and qs (their
    segment_build compiles are then Triton cache hits in the qu and qs
    runs, as q7c's are)."""
    from arroyo_tpu_torch import expr as E

    q7b = Batch(nexmark_columns(BENCH_BATCH, ["bid.auction", "bid.price"], 1000))
    q5b = Batch(nexmark_columns(BENCH_BATCH, ["bid.auction"], 1000))
    q8b = Batch(nexmark_columns(BENCH_BATCH - 37, ["auction.id", "bid.auction"], 100))
    qsb = Batch(nexmark_columns(BENCH_BATCH, ["bid.bidder", "bid.price"], 1000))
    return [("q7 insert", bind_plan(q7_members(E), q7b, hoist=False), q7b),
            ("q5 insert", bind_plan(q5_members(E), q5b, hoist=False), q5b),
            ("q8 auctions, filter hoisted", bind_plan(q8_members(E, "auctions"), q8b, hoist=True), q8b),
            ("q8 bids, filter in the kernel", bind_plan(q8_members(E, "bids"), q8b, hoist=False), q8b),
            ("qu bids chain", bind_plan(bids_chain_members(E, "auction"), q7b, hoist=False), q7b),
            ("qs bids chain", bind_plan(bids_chain_members(E, "bidder"), qsb, hoist=False), qsb)]


def grid_plans() -> list:
    from arroyo_tpu_torch import expr as E

    gb = Batch(grid_columns(GRID_N))
    return [(label, bind_plan(members, gb, hoist), gb) for label, members, hoist in segment_grid(E)]


def segment_build(out_dir: str) -> tuple[dict, list]:
    """Compile K4 for the q7 and q5 plans (and load the rest): the generated
    source goes to <out-dir>/segment_src/, seconds per plan to the line."""
    dev = torch.device("cuda")
    src_dir = os.path.join(out_dir, "segment_src")
    os.makedirs(src_dir, exist_ok=True)
    plans = nexmark_plans()
    timing = {}
    for label, plan, batch in plans:
        t0 = time.perf_counter()
        prog = segment_kernel.SegmentProgram(plan, [np.asarray(batch[c]).dtype for c in plan.traced_in])
        n, ins = staged_inputs(plan, batch, dev)
        segment_kernel.segment_fused(prog, n, ins)
        torch.cuda.synchronize()
        timing[label] = {"seconds": time.perf_counter() - t0, "source_lines": prog.source.count("\n"),
                         "digest": prog.digest}
        with open(os.path.join(src_dir, f"{label.split()[0]}_{label.split()[1].strip(',')}_{prog.digest}.py"),
                  "w") as f:
            f.write(prog.source)
    info = {"phase": "segment_build", "plans": timing}
    emit(info)
    return info, plans


def compare_k4(label, prog, n: int, ins: list) -> dict:
    """K4 against its plain version on the same CUDA tensors, byte for
    byte: every output's dtype and bytes, the mask, and each watermark
    stage's (max, count) as execute() reads them (int(max) when count > 0);
    one Triton launch for the call."""
    plan = prog.plan
    before = segment_kernel.segment_fused.kernel_launches
    outs_k, mask_k, aux_k = segment_kernel.segment_fused(prog, n, ins)
    launched = segment_kernel.segment_fused.kernel_launches - before
    outs_p, mask_p, aux_p = segment_kernel.segment_plain(prog, n, ins)
    torch.cuda.synchronize()
    if launched != 1:
        raise AssertionError(f"segment {label}: {launched} Triton launches for one call")
    for name in plan.traced_out:
        g, w = outs_k[name], outs_p[name]
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"segment {label}: {name} is {g.dtype}{tuple(g.shape)}, plain "
                                 f"{w.dtype}{tuple(w.shape)}")
        gb, wb = g.cpu().numpy().tobytes(), w.cpu().numpy().tobytes()
        if gb != wb:
            gn, wn = g.cpu().numpy(), w.cpu().numpy()
            bad = np.flatnonzero(gn.view(f"u{gn.itemsize}") != wn.view(f"u{wn.itemsize}"))
            raise AssertionError(f"segment {label}: {name} differs from the plain version at "
                                 f"{len(bad)} rows, first {bad[:3].tolist()}: kernel "
                                 f"{gn[bad[:3]].tolist()} plain {wn[bad[:3]].tolist()}")
    if (mask_k is None) != (mask_p is None) or (
            mask_k is not None and not torch.equal(mask_k, mask_p)):
        raise AssertionError(f"segment {label}: the mask differs from the plain version")
    if k4_aux_read(aux_k) != k4_aux_read(aux_p):
        raise AssertionError(f"segment {label}: watermark aux {k4_pairs(aux_k)} != plain "
                             f"{k4_pairs(aux_p)}")
    return {"n": n, "P": ins[0].shape[0], "outputs": len(plan.traced_out),
            "programs": -(-ins[0].shape[0] // segment_kernel.BLOCK), "aux": repr(k4_pairs(aux_k))}


def k4_aux_read(aux) -> list:
    """Each watermark stage's max as execute() reads it (a NaN max raises
    there, whatever its payload), with both dtypes, and its count."""
    return [(m.dtype, c.dtype, "nan" if m.dtype.is_floating_point and bool(torch.isnan(m))
             else m.item(), int(c)) for m, c in aux]


def k4_pairs(aux) -> list:
    return [(m.item() if int(c) else None, int(c)) for m, c in aux]


def compare_segment(label, plan, batch, dev) -> dict:
    """compare_k4 on a bound plan's staged inputs (CompiledSegment.execute's
    staging)."""
    prog = segment_kernel.SegmentProgram(plan, [np.asarray(batch[c]).dtype for c in plan.traced_in])
    n, ins = staged_inputs(plan, batch, dev)
    return {**compare_k4(label, prog, n, ins), "source_lines": prog.source.count("\n")}


K4_BACK_TO_BACK = 1000
K4_FOLD_LOOP_ROWS = 1 << 20


def nan_payload_plan():
    """(plan, batch) of a float watermark over a column holding two NaNs of
    different payloads far apart in one batch (different programs)."""
    from arroyo_tpu_torch import expr as E

    cols = grid_columns(BENCH_BATCH)
    x = cols["g64"].copy()
    bits = x.view(np.uint64)
    bits[3] = 0x7FF8000000000123
    bits[40_000] = 0xFFF8000000000456
    cols["g64"] = x
    batch = Batch(cols)
    members = [("value", {"projections": [("x", E.Col("g64"))], "filter": None}),
               ("watermark", {"expr": E.Col("x")})]
    return bind_plan(members, batch, hoist=False), batch


def k4_edge_cases(nex_plans: list, dev) -> dict:
    """K4's own edge cases, each held to its plain version (compare_k4)."""
    out = {}
    _label, plan, batch = nex_plans[0]  # q7's insert: an in-kernel filter, one watermark
    prog = segment_kernel.SegmentProgram(plan, [np.asarray(batch[c]).dtype for c in plan.traced_in])
    n, ins = staged_inputs(plan, batch, dev)
    P = ins[0].shape[0]
    out["n = 0"] = compare_k4("n = 0", prog, 0, ins)
    out["P not a multiple of BLOCK"] = compare_k4(
        "P not a multiple of BLOCK", prog, P - 41, [t[:P - 37].contiguous() for t in ins])
    out["P below one BLOCK"] = compare_k4("P below one BLOCK", prog, 77,
                                          [t[:100].contiguous() for t in ins])
    none = [t.clone() for t in ins]
    none[plan.traced_in.index("bid")].zero_()  # q7's filter: the bid flag
    out["every row filtered"] = compare_k4("every row filtered", prog, n, none)
    if out["every row filtered"]["aux"] != repr([(None, 0)]):
        raise AssertionError(f"K4 with every row filtered: aux {out['every row filtered']}")
    # the largest G the main path drives is a full batch's (P = 65536,
    # above); the fold's loop over many BLOCKs of partials at 2^20 rows
    rep = K4_FOLD_LOOP_ROWS // P
    out["fold loop"] = compare_k4("fold loop", prog, rep * P - 3, [t.repeat(rep) for t in ins])
    # two NaN payloads: the fold meets the partials in program order, so
    # the max's bits are the same on every launch
    nplan, nbatch = nan_payload_plan()
    nprog = segment_kernel.SegmentProgram(nplan, [np.asarray(nbatch[c]).dtype
                                                  for c in nplan.traced_in])
    nn, nins = staged_inputs(nplan, nbatch, dev)
    out["two NaN payloads"] = compare_k4("two NaN payloads", nprog, nn, nins)
    bits = set()
    for _ in range(20):
        m = segment_kernel.segment_fused(nprog, nn, nins)[2][0][0]
        bits.add(int(m.view(torch.int64).item()) & ((1 << 64) - 1))
    plain_bits = int(segment_kernel.segment_plain(nprog, nn, nins)[2][0][0]
                     .view(torch.int64).item()) & ((1 << 64) - 1)
    if len(bits) != 1:
        raise AssertionError(f"K4's NaN max changes from launch to launch: {sorted(map(hex, bits))}")
    out["two NaN payloads"].update(max_bits=hex(bits.pop()), plain_max_bits=hex(plain_bits))
    # back-to-back launches of one program, no synchronisation between
    # them, each batch with its own n: the ticket counter must be back at
    # 0 before every launch for each fold to run
    small = [t[:4096].contiguous() for t in ins]
    ns = [4096 - 97 * (i % 37) for i in range(K4_BACK_TO_BACK)]
    before = segment_kernel.segment_fused.kernel_launches
    got = [segment_kernel.segment_fused(prog, k, small)[2] for k in ns]
    torch.cuda.synchronize()
    launched = segment_kernel.segment_fused.kernel_launches - before
    want = {k: k4_aux_read(segment_kernel.segment_plain(prog, k, small)[2]) for k in set(ns)}
    bad = [i for i, (k, a) in enumerate(zip(ns, got)) if k4_aux_read(a) != want[k]]
    ticket = prog._fold_state(small[0].device, 1)[0]
    if bad or launched != K4_BACK_TO_BACK or int(ticket.item()) != 0:
        raise AssertionError(f"K4 back to back: {len(bad)} of {K4_BACK_TO_BACK} launches differ "
                             f"(first {bad[:3]}), {launched} launches, counter {int(ticket.item())}")
    out["back to back"] = {"launches": launched, "P": 4096, "distinct_n": len(want)}
    return out


SWEEP_BLOCKS = (128, 256, 512, 1024)
SWEEP_WARPS = (1, 2, 4, 8)
SWEEP_PLANS = ("q7 insert", "q5 insert", "q8 bids, filter in the kernel")


def segment_sweep() -> dict:
    """K4's device time at q7c's, q5's and q8c's 65,536-row batches for each
    BLOCK and num_warps (held to the plain version first at each): how the
    module's BLOCK and NUM_WARPS were chosen."""
    dev = torch.device("cuda")
    plans = [p for p in nexmark_plans() if p[0] in SWEEP_PLANS]
    saved = segment_kernel.BLOCK, segment_kernel.NUM_WARPS
    table = []
    try:
        for label, plan, batch in plans:
            prog = segment_kernel.SegmentProgram(plan, [np.asarray(batch[c]).dtype
                                                        for c in plan.traced_in])
            n, ins = staged_inputs(plan, batch, dev)
            for block in SWEEP_BLOCKS:
                for warps in SWEEP_WARPS:
                    segment_kernel.BLOCK, segment_kernel.NUM_WARPS = block, warps
                    log(f"segment_sweep: {label} BLOCK {block} num_warps {warps}")
                    compare_k4(f"{label} at BLOCK {block}, {warps} warps", prog, n, ins)
                    m = measure(lambda: segment_kernel.segment_fused(prog, n, ins))
                    table.append({"plan": label, "block": block, "num_warps": warps,
                                  "programs": -(-ins[0].shape[0] // block), "ms": m["device_ms"],
                                  "call_ms": m["call_ms"], "method": m["method"]})
    finally:
        segment_kernel.BLOCK, segment_kernel.NUM_WARPS = saved
    best = {}
    for label in SWEEP_PLANS:
        rows = [r for r in table if r["plan"] == label]
        b = min(rows, key=lambda r: r["ms"])
        best[label] = {"block": b["block"], "num_warps": b["num_warps"], "ms": b["ms"]}
    info = {"phase": "segment_sweep", "module": {"block": saved[0], "num_warps": saved[1]},
            "best": best, "table": table}
    emit(info)
    return info


def segment_phase(nex_plans: list) -> dict:
    dev = torch.device("cuda")
    checked = {}
    t0 = time.perf_counter()
    for label, plan, batch in nex_plans + grid_plans():
        log(f"segment: check {label}")
        checked[label] = compare_segment(label, plan, batch, dev)
    log("segment: K4's edge cases")
    edge = k4_edge_cases(nex_plans, dev)
    check_s = time.perf_counter() - t0
    # timing at q7's plan
    label, plan, batch = nex_plans[0]
    prog = segment_kernel.SegmentProgram(plan, [np.asarray(batch[c]).dtype for c in plan.traced_in])
    n, ins = staged_inputs(plan, batch, dev)
    k = measure(lambda: segment_kernel.segment_fused(prog, n, ins))
    p = measure(lambda: segment_kernel.segment_plain(prog, n, ins))
    P = ins[0].shape[0]
    in_bytes = sum(t.element_size() * P for t in ins)
    out_bytes = sum(np.dtype(prog.out_dtypes[o]).itemsize * P for o in plan.traced_out) + \
        (P if prog.has_mask else 0)
    timing = {"ms": k["device_ms"], "call_ms": k["call_ms"], "method": k["method"],
              "kernel_names": k["device_kernels"], "plain_ms": p["device_ms"],
              "trace_whole": k["trace_whole"] and p["trace_whole"],
              "plain_call_ms": p["call_ms"], "bytes": in_bytes + out_bytes,
              "bound_ms": (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
              "library_ms": None,
              "library": "none: no single PyTorch call computes the fused segment "
                         "(filter, projections, splitmix64 hash, masked max/count, bins)",
              "rows": n, "P": P, "block": segment_kernel.BLOCK,
              "num_warps": segment_kernel.NUM_WARPS,
              "launches_per_call": k["device_ops_per_call"]}
    info = {"phase": "segment", "plans_checked": len(checked), "check_seconds": check_s,
            "max_abs_err": 0.0, "checked": checked, "edge_cases": edge, "timing_q7": timing}
    emit(info)
    return info


# ---------------------------------------------------------------- kernels


def device_us_by_name(prof) -> dict:
    """Device time (us) of every kernel and copy in a profiler trace."""
    return {e.key: e.self_device_time_total for e in prof.key_averages()
            if e.self_device_time_total > 0}


def device_trace(run, warm):
    """A torch.profiler (CUPTI) trace of the device work of ``run()`` alone.
    A trace that starts or stops right at the work it measures can drop
    that work's first or last launches, so the profiler's warm-up step
    (which records and discards) runs ``warm()``, and the recorded step
    idles WARM_TRACE_S before and after ``run()``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        warm()
        torch.cuda.synchronize()
        time.sleep(WARM_TRACE_S)
        prof.step()
        time.sleep(WARM_TRACE_S)
        run()
        torch.cuda.synchronize()
        time.sleep(WARM_TRACE_S)
        prof.step()
    return prof


def trace_calls(call, reps: int, make_args=tuple):
    """device_trace of reps calls of ``call(*make_args())``, each call's
    arguments made before the trace. Returns (trace, operations per call,
    whether the trace held every call). Every call launches the same work,
    so a whole trace holds a whole number of each operation per call. On
    the H100 CUPTI still drops one or two launches from some traces, the
    same ones each time a trace is taken again, so the times per call come
    from device_us_per_call, which rounds the count."""
    args = [make_args() for _ in range(reps + 1)]
    prof = device_trace(lambda: [call(*args.pop()) for _ in range(reps)],
                        lambda: call(*args.pop()))
    ops = device_ops_per_call(prof, reps)
    whole = all(c == round(c) for c in ops.values())
    if not whole:
        log(f"a trace of {reps} calls lost launches: "
            f"{ {k[:60]: v for k, v in ops.items() if v != round(v)} }")
    return prof, ops, whole


def warm_device():
    """A trace's warm-up work where the traced work cannot run twice."""
    torch.ones(1, device="cuda").add_(1)


def device_us_per_call(prof, reps: int) -> dict:
    """Device time (us) per call of every operation in a trace of reps
    calls: its mean time per launch times its launches per call, the
    nearest whole number to its count over reps, so launches the trace
    dropped do not lower the figure."""
    return {e.key: e.self_device_time_total / e.count * max(1, round(e.count / reps))
            for e in prof.key_averages() if e.self_device_time_total > 0}


def device_ops_per_call(prof, reps: int) -> dict:
    """Launches per call of every kernel, memset and copy in a trace of
    reps calls."""
    return {e.key: e.count / reps for e in prof.key_averages() if e.self_device_time_total > 0}


def measure(fn, reps: int = TIMING_REPS) -> dict:
    """``device_ms``: the device time of everything fn launches, per call,
    from a torch.profiler (CUPTI) trace of reps calls -- or, where the trace
    holds no device time, CUDA events around reps back-to-back calls over
    reps (``method`` says which); ``call_ms``: median of per-call CUDA-event
    brackets, i.e. the host's launch cost and the device time together.
    Two warm-up calls first."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    prof, ops, whole = trace_calls(fn, reps)
    by_name = device_us_per_call(prof, reps)
    out = {"call_ms": statistics.median(times), "device_kernels": sorted(by_name),
           "device_us_per_call": by_name, "device_ops_per_call": ops, "trace_whole": whole}
    if by_name:
        out.update(device_ms=sum(by_name.values()) / 1e3, method="profiler")
    else:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.update(device_ms=a.elapsed_time(b) / reps, method="events")
    return out


def make_state(rng, lanes, cap, dev):
    """One [cap] tensor per (kind, dtype) lane, random values on half the
    slots and the identity elsewhere."""
    out = []
    for kind, dt in lanes:
        a = np.full(cap, _identity(kind, NP_DT[dt]), dtype=NP_DT[dt])
        hit = rng.random(cap) < 0.5
        a[hit] = make_vals(rng, kind, dt, int(hit.sum()))
        out.append(torch.from_numpy(a).to(dev))
    return out


def make_vals(rng, kind, dt, n):
    npdt = NP_DT[dt]
    if dt == torch.uint64:  # both ends of the range: unsigned order, wrapping sums
        return (rng.integers(-(1 << 20), 1 << 20, n).astype(np.int64) << 40).view(np.uint64)
    if not dt.is_floating_point:
        return rng.integers(-(1 << 20), 1 << 20, n).astype(npdt)
    v = rng.normal(0, 1000, n).astype(npdt)
    if kind in ("min", "max"):
        pick = rng.random(n)
        v[pick < 0.01] = -0.0
        v[(pick >= 0.01) & (pick < 0.02)] = 0.0
        v[(pick >= 0.02) & (pick < 0.0201)] = np.nan
    return v


def zipf_slots(rng, n, cap, dtype):
    s = (rng.zipf(1.2, n) - 1) % cap
    s[rng.random(n) < 0.05] = cap  # padding rows, dropped by the kernel
    return torch.from_numpy(s.astype(dtype))


# K1's edge cases: the float sums (a float64 and a float32 sum, a float64
# count that ships no values in the hot path) walk beside atomic lanes
EDGE_LANES = [("sum", np.float64), ("count", np.int64), ("sum", np.float32),
              ("max", np.int64), ("count", np.float64), ("min", np.float32)]
EDGE_CAP = 4096


def edge_state(rng, lanes, cap) -> list:
    """One [cap] array per lane: random values on half the slots and the
    identity elsewhere; the float lanes' first slots hold -0.0, +0.0, NaN,
    inf and -inf, where the first add from the state shows its order."""
    out = []
    for kind, dt in lanes:
        a = np.full(cap, _identity(kind, np.dtype(dt)), dtype=dt)
        hit = rng.random(cap) < 0.5
        a[hit] = (rng.normal(0, 100, int(hit.sum())) if np.issubdtype(dt, np.floating)
                  else rng.integers(-1000, 1000, int(hit.sum()))).astype(dt)
        if np.issubdtype(dt, np.floating):
            a[:5] = [-0.0, 0.0, np.nan, np.inf, -np.inf]
        out.append(a)
    return out


def edge_vals(rng, lanes, n, specials: bool = True) -> list:
    """One value per row and lane; float values with -0.0, NaN, inf and
    -inf sprinkled in (specials)."""
    out = []
    for _kind, dt in lanes:
        if np.issubdtype(dt, np.floating):
            v = rng.normal(0, 100, n).astype(dt)
            if specials:
                pick = rng.random(n)
                v[pick < 0.02] = -0.0
                v[(pick >= 0.02) & (pick < 0.021)] = np.inf
                v[(pick >= 0.021) & (pick < 0.022)] = -np.inf
                v[(pick >= 0.022) & (pick < 0.0225)] = np.nan
        else:
            v = rng.integers(-1000, 1000, n).astype(dt)
        out.append(v)
    return out


def scatter_edge_cases(rng, long_run: int = 128) -> list:
    """K1's edge cases as numpy arrays: dicts of label, lanes [(kind, numpy
    dtype)], cap, state (one [cap] array per lane), slots (int64) and vals
    (one array per lane; the hot path drops a count lane's). Slots outside
    [0, cap) are cap or above, as the reference pads them (a negative slot:
    ``negative_slot_case``). long_run is K1's threshold between a run one
    thread walks and one a block walks (kernels.LONG_RUN)."""
    L, cap, lanes = long_run, EDGE_CAP, EDGE_LANES
    cases = []

    def add(label, slots, specials=True):
        slots = np.asarray(slots, np.int64)
        cases.append({"label": label, "lanes": lanes, "cap": cap,
                      "state": edge_state(rng, lanes, cap), "slots": slots,
                      "vals": edge_vals(rng, lanes, len(slots), specials)})

    add("one slot takes every row", np.full(20 * L + 7, 9))
    runs = np.repeat(np.arange(100, 130), [L - 1, L, L + 1] * 10)
    add("runs at long_run - 1, long_run and long_run + 1",
        rng.permutation(np.concatenate([runs, rng.integers(0, cap, 500)])))
    hot = np.full(6 * L, 17)
    hot[::3] = cap
    hot[1::7] = cap + 3
    add("slots cap and cap + 3 inside a long run",
        np.concatenate([rng.integers(0, cap, 50), hot, np.full(L, cap), np.full(L, 18)]))
    special_runs = np.repeat([0, 1, 2, 3, 4], [3, L + 2, 2, L, 1])  # the special state slots
    add("-0.0, +0.0, NaN and infinities in state and values",
        rng.permutation(np.concatenate([special_runs, rng.integers(0, 5, 3 * L),
                                        np.full(L + 1, 5), np.full(7, 6)])))
    for v in cases[-1]["vals"]:  # slots 5 and 6 (+0.0 or -0.0 in state) add -0.0 alone
        if v.dtype.kind == "f":
            v[np.isin(cases[-1]["slots"], (5, 6))] = -0.0
    for a in cases[-1]["state"]:
        if a.dtype.kind == "f":
            a[5:7] = [-0.0, 0.0]
    add("n of 1", [cap - 1])
    add("one row past a sort tile", rng.integers(0, 64, 4097))
    z = (rng.zipf(1.2, 65536) - 1) % (cap + 16)  # slots past cap: padding
    add("Zipf(1.2) over the state", z, specials=False)
    return cases


def negative_slot_case(rng, long_run: int = 128) -> dict:
    """A long run and short runs with slot -1 rows among them: K1 drops
    them as it drops cap (the reference's padding; the reference never
    ships a negative slot, and its indexing would wrap one)."""
    s = np.concatenate([np.full(3 * long_run, 5), rng.integers(0, EDGE_CAP, 700)])
    s[rng.random(len(s)) < 0.2] = -1
    return {"label": "slot -1 inside runs", "lanes": EDGE_LANES, "cap": EDGE_CAP,
            "state": edge_state(rng, EDGE_LANES, EDGE_CAP), "slots": s,
            "vals": edge_vals(rng, EDGE_LANES, len(s))}


def lane_err(got, want, kind) -> float:
    """0.0, or raises: every lane must equal the plain version bit for bit
    (floats as bits, so signed zeros count; a NaN equals a NaN)."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if g.dtype != w.dtype:
        raise AssertionError(f"{kind} lane of {w.dtype} came back as {g.dtype}")
    if not np.issubdtype(w.dtype, np.floating):
        if not np.array_equal(g, w):
            raise AssertionError(f"{kind} lane of {w.dtype} differs from the plain version")
        return 0.0
    nan = np.isnan(w)
    if not np.array_equal(np.isnan(g), nan):
        raise AssertionError(f"{kind} lane of {w.dtype}: NaN positions differ")
    ib = np.int64 if w.dtype == np.float64 else np.int32
    if not np.array_equal(g[~nan].view(ib), w[~nan].view(ib)):
        raise AssertionError(f"{kind} lane of {w.dtype} differs from the plain version")
    return 0.0


def check_scatter(rng, lanes, cap, B, merge, dev) -> float:
    """K1 against its plain version, exactly, float sums included (both
    add each slot's rows in row order from the state value)."""
    kinds = [k for k, _ in lanes]
    st_k = make_state(rng, lanes, cap, dev)
    st_p = [a.clone() for a in st_k]
    for idx_dt in (np.int32, np.int64):
        slots = zipf_slots(rng, B, cap, idx_dt).to(dev)
        vals = [None if (k == "count" and not merge) else
                torch.from_numpy(make_vals(rng, k, dt, B)).to(dev) for k, dt in lanes]
        kernels.slot_scatter_combine(st_k, kinds, slots, vals)
        kernels.slot_scatter_combine_plain(st_p, kinds, slots, vals)
    torch.cuda.synchronize()
    return max(lane_err(g, w, k) for (k, _dt), g, w in zip(lanes, st_k, st_p))


def check_scatter_case(case: dict, idx_dt, merge: bool, dev) -> None:
    """K1 against its plain version on one of scatter_edge_cases, exactly."""
    kinds = [k for k, _ in case["lanes"]]
    st_k = [torch.from_numpy(a.copy()).to(dev) for a in case["state"]]
    st_p = [a.clone() for a in st_k]
    slots = torch.from_numpy(case["slots"].astype(idx_dt)).to(dev)
    vals = [None if (k == "count" and not merge) else torch.from_numpy(v).to(dev)
            for k, v in zip(kinds, case["vals"])]
    kernels.slot_scatter_combine(st_k, kinds, slots, vals)
    kernels.slot_scatter_combine_plain(st_p, kinds, slots, vals)
    torch.cuda.synchronize()
    for k, g, w in zip(kinds, st_k, st_p):
        lane_err(g, w, f"{case['label']} ({np.dtype(idx_dt).name} slots): {k}")


def add_chain_ns(dev, n: int = 1 << 21) -> dict:
    """ns per add of one thread's chain of dependent __dadd_rn / __fadd_rn
    (csrc/slot_agg.cu add_chain_kernel), by dtype: a slot's run of float
    sums can go no faster (K1's chain floor)."""
    lib = kernels.build_library()
    x = torch.tensor([1.0, 1e-3], dtype=torch.float64, device=dev)
    out = torch.empty(1, dtype=torch.float64, device=dev)
    res = {}
    for name, f32 in (("float64", 0), ("float32", 1)):
        def run():
            kernels._raise_on(lib.arroyo_slot_add_chain(
                dev.index or 0, x.data_ptr(), n, f32, out.data_ptr(), kernels._stream(dev)),
                "add_chain")
        run()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        res[name] = a.elapsed_time(b) * 1e6 / n
    return res


def check_regions(rng, lanes, cap, R, dev) -> float:
    """K2 (a read; a read then K3's clear; the read-and-clear launch) at k
    1-16 with padding duplicates, exactly against the plain versions: the
    buffers and the state after."""
    kinds = [k for k, _ in lanes]
    n_regions = cap // R
    for k in (1, 2, 4, 8, 16):
        real = [int(b) * R for b in rng.choice(n_regions, max(1, k - k // 4), replace=False)]
        bases = real + [real[0]] * (k - len(real))
        for mode in ("read", "read_then_clear", "read_and_clear"):
            check_region_call(rng, lanes, cap, bases, R, mode, dev)
    return 0.0


def check_region_call(rng, lanes, cap, bases, R, mode, dev) -> None:
    kinds = [k for k, _ in lanes]
    st_k = make_state(rng, lanes, cap, dev)
    for a in st_k:
        if a.dtype == torch.float32:  # subnormals widen to zeros of their sign
            n = min(2, cap - bases[0])
            a[bases[0]: bases[0] + n] = torch.tensor([1e-40, -1e-40][:n], dtype=torch.float32)
    st_p = [a.clone() for a in st_k]
    clear_kinds = kinds if mode == "read_and_clear" else None
    ib, fb = kernels.slot_region_read_pack(st_k, bases, R, clear_kinds=clear_kinds)
    pib, pfb = kernels.slot_region_read_pack_plain(st_p, bases, R, clear_kinds)
    if mode == "read_then_clear":
        kernels.slot_region_clear(st_k, kinds, bases, R)
        kernels.slot_region_clear_plain(st_p, kinds, bases, R)
    torch.cuda.synchronize()
    what = f"{mode} k={len(bases)} R={R} bases={bases[:3]}"
    lane_err(ib, pib, f"{what}: int buffer")
    lane_err(fb, pfb, f"{what}: float buffer")
    for (kd, _dt), g, w in zip(lanes, st_k, st_p):
        lane_err(g, w, f"{what}: state after, {kd}")


# the read-and-clear mode's own cases: every lane dtype and kind, one lane
# class alone, and regions off every 16-byte boundary (odd R, odd bases,
# state lanes that start one slot past a 16-byte boundary)
REGION_LANE_SETS = {
    "all": [(k, d) for d in (torch.int32, torch.int64, torch.uint64, torch.float32,
                             torch.float64) for k in ("sum", "count", "min", "max")],
    "int_only": [("count", torch.int64), ("max", torch.int32), ("min", torch.uint64)],
    "float_only": [("sum", torch.float64), ("min", torch.float32), ("max", torch.float32)],
}


def check_read_clear_cases(rng, dev) -> list:
    """K2's read-and-clear launch against the plain read-then-clear on
    REGION_LANE_SETS at k 1-16 with padding duplicates, and on unaligned
    regions; returns the cases' labels."""
    cap, R = 65536, 2048
    labels = []
    for name, lanes in REGION_LANE_SETS.items():
        for k in (1, 2, 4, 8, 16):
            real = [int(b) * R for b in rng.choice(cap // R, max(1, k - k // 4), replace=False)]
            check_region_call(rng, lanes, cap, real + [real[0]] * (k - len(real)), R,
                              "read_and_clear", dev)
            labels.append(f"{name} k={k} R={R}")
        for r, bases in ((2045, [1, 3 * 2045 + 2, 7 * 2045 + 3, 1]), (3, [5, 9, 5, 5]),
                         (6, [2, 14, 30, 2]), (2050, [2050 * 5 + 1])):
            check_region_call(rng, lanes, cap, bases, r, "read_and_clear", dev)
            check_region_call(rng, lanes, cap, bases, r, "read", dev)
            labels.append(f"{name} unaligned R={r} bases={bases}")
    # state lanes that start one slot past a 16-byte boundary: slices of
    # larger tensors, so every slot takes the scalar path
    lanes = REGION_LANE_SETS["all"]
    kinds = [k for k, _ in lanes]
    big = make_state(rng, lanes, cap + 4, dev)
    st_k = [a[1:cap + 1] for a in big]
    st_p = [a.clone() for a in st_k]
    bases = [0, 4 * R, 0]
    ib, fb = kernels.slot_region_read_pack(st_k, bases, R, clear_kinds=kinds)
    pib, pfb = kernels.slot_region_read_pack_plain(st_p, bases, R, kinds)
    torch.cuda.synchronize()
    lane_err(ib, pib, "offset lanes: int buffer")
    lane_err(fb, pfb, "offset lanes: float buffer")
    for (kd, _dt), g, w in zip(lanes, st_k, st_p):
        lane_err(g, w, f"offset lanes: state after, {kd}")
    labels.append("all lanes offset by one slot")
    return labels


def time_kernels(rng, lanes, cap, B, R, dev) -> dict:
    """ms / plain_ms / library_ms / bound_ms for each kernel at one shape.
    K1 runs in the hot path's form (count lanes ship no values)."""
    kinds = [k for k, _ in lanes]
    st = make_state(rng, lanes, cap, dev)
    idx_dt = np.int32 if cap < (1 << 31) - 1 else np.int64
    slots = zipf_slots(rng, B, cap, idx_dt).to(dev)
    vals = [None if k == "count" else torch.from_numpy(make_vals(rng, k, dt, B)).to(dev)
            for k, dt in lanes]
    keep = slots < cap
    s_lib = slots[keep].long()
    bits = kernels.bits  # uint64 lanes as their int64 bits: torch's scatters take no uint64
    v_lib = [torch.ones(len(s_lib), dtype=torch.int64, device=dev) if v is None
             else bits(v)[keep] for v in vals]

    def library_k1():
        for (k, _dt), a, v in zip(lanes, st, v_lib):
            if k in ("sum", "count"):
                bits(a).index_add_(0, s_lib, v)
            else:
                bits(a).scatter_reduce_(0, s_lib, v, "amin" if k == "min" else "amax")

    elem = [a.element_size() for a in st]
    touched = int(torch.unique(s_lib).numel())
    k1_bytes = (B * slots.element_size() + sum(B * e for e, v in zip(elem, vals) if v is not None)
                + 2 * touched * sum(elem))
    out = {"slot_scatter_combine": timed(
        lambda: kernels.slot_scatter_combine(st, kinds, slots, vals),
        lambda: kernels.slot_scatter_combine_plain(st, kinds, slots, vals),
        library_k1,
        library="one index_add_ / scatter_reduce_ per lane, on the in-range rows "
                "(index_add_ on the card adds with atomics, in no fixed order)",
        bytes=k1_bytes, rows=B, touched_slots=touched,
        ordered_lanes=sum(kernels.ordered_add(k, dt) for k, dt in lanes),
        longest_run=int(torch.bincount(s_lib).max()))}
    if out["slot_scatter_combine"]["ordered_lanes"]:
        # K5 in range mode on the same slots, as K1's float sums run it
        clamped = torch.where(slots < cap, slots.long(), torch.full_like(slots.long(), cap))
        out["join_sort_pairs_range"] = timed(
            lambda: join_kernels.sort_pairs_launch(slots, range_cap=cap),
            lambda: join_kernels.join_sort_pairs_plain(slots, range_cap=cap),
            lambda: torch.sort(clamped, stable=True),
            library="torch.sort(stable=True) of the slots as int64, clamped to cap",
            bytes=B * slots.element_size() + 12 * B,
            bytes_counted="the slots read, 8 B of key and 4 B of order written per row",
            rows=B, cap=cap, passes=join_kernels.sort_passes(range_cap=cap),
            launches=join_kernels.sort_launches(B, range_cap=cap))
    for k in (1, 16):
        bases = [int(b) * R for b in rng.choice(cap // R, k, replace=False)]
        idx = (torch.tensor(bases, device=dev)[:, None] + torch.arange(R, device=dev)).reshape(-1)
        ints = [a for a in st if not a.dtype.is_floating_point]
        flts = [a for a in st if a.dtype.is_floating_point]
        n_out = k * len(st) * R * 8
        out[f"slot_region_read_pack_k{k}"] = timed(
            lambda: kernels.slot_region_read_pack(st, bases, R),
            lambda: kernels.slot_region_read_pack_plain(st, bases, R),
            lambda: (
                torch.cat([bits(a).index_select(0, idx).to(torch.int64) for a in ints])
                if ints else None,
                torch.cat([a.index_select(0, idx).to(torch.float64) for a in flts])
                if flts else None),
            library="index_select + cat per lane class",
            bytes=k * R * sum(elem) + n_out, k=k)
        idents = [sharded_kernels.ident_bits(kd, a.dtype) for kd, a in zip(kinds, st)]
        out[f"slot_region_clear_k{k}"] = timed(
            lambda: kernels.slot_region_clear(st, kinds, bases, R),
            lambda: kernels.slot_region_clear_plain(st, kinds, bases, R),
            lambda: [bits(a).index_fill_(0, idx, v) for a, v in zip(st, idents)],
            library="index_fill_ per lane", bytes=k * R * sum(elem), k=k)

        def library_read_clear():
            out_i = (torch.cat([bits(a).index_select(0, idx).to(torch.int64) for a in ints])
                     if ints else None)
            out_f = (torch.cat([a.index_select(0, idx).to(torch.float64) for a in flts])
                     if flts else None)
            for a, v in zip(st, idents):
                bits(a).index_fill_(0, idx, v)
            return out_i, out_f

        # the close's mode: each distinct region read once and cleared, the
        # widened words written once per output position
        n_distinct = len(set(bases))
        out[f"slot_region_read_pack_clear_k{k}"] = timed(
            lambda: kernels.slot_region_read_pack(st, bases, R, clear_kinds=kinds),
            lambda: kernels.slot_region_read_pack_plain(st, bases, R, kinds),
            library_read_clear,
            library="index_select + cat per lane class, then index_fill_ per lane",
            bytes=2 * n_distinct * R * sum(elem) + n_out, k=k, distinct_bases=n_distinct,
            grid=kernels.region_grid(bases, R, len(st)))
        out[f"launch_floor_k{k}"] = launch_floor(bases, R, len(st), dev)
    return out


def launch_floor(bases, R, n_lanes, dev) -> dict:
    """The card's floor for a kernel on K2's grid: an empty kernel
    (csrc/slot_agg.cu empty_kernel) on the grid K2 takes for these bases
    and lanes, measured as K2 is."""
    lib = kernels.build_library()
    grid = kernels.region_grid(bases, R, n_lanes)

    def run():
        kernels._raise_on(lib.arroyo_slot_empty(dev.index or 0, *grid, kernels._stream(dev)),
                          "empty_kernel")

    m = measure(run)
    return {"ms": m["device_ms"], "method": m["method"], "call_ms": m["call_ms"],
            "grid": list(grid), "kernel_names": m["device_kernels"]}


def timed(kernel, plain, library_call, **extra) -> dict:
    """Kernel, plain version and library yardstick measured alike; ``ms``,
    ``plain_ms`` and ``library_ms`` are device times per call, the bound is
    the bytes moved (each input read once, each output written once) over
    the HBM rate."""
    k, p, lib = measure(kernel), measure(plain), measure(library_call)
    return {"ms": k["device_ms"], "plain_ms": p["device_ms"], "library_ms": lib["device_ms"],
            "method": k["method"], "call_ms": k["call_ms"], "plain_call_ms": p["call_ms"],
            "library_call_ms": lib["call_ms"], "kernel_names": k["device_kernels"],
            "trace_whole": k["trace_whole"] and p["trace_whole"] and lib["trace_whole"],
            "ops_per_call": k["device_ops_per_call"], "us_per_call": k["device_us_per_call"],
            "bound_ms": extra["bytes"] / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", **extra}


def long_run_sweep(rng, sh, dev) -> dict:
    """K1's device ms at one shape with the threshold between a run one
    thread walks and one a block walks at 32, 64, 128 and 256 rows (the
    package's kernels.LONG_RUN is the measured choice), each checked
    against the plain version first."""
    kinds = [k for k, _ in sh["lanes"]]
    st = make_state(rng, sh["lanes"], sh["cap"], dev)
    slots = zipf_slots(rng, sh["B"], sh["cap"], np.int32).to(dev)
    vals = [None if k == "count" else torch.from_numpy(make_vals(rng, k, dt, sh["B"])).to(dev)
            for k, dt in sh["lanes"]]
    chosen, out = kernels.LONG_RUN, {}
    try:
        for lr in (32, 64, 128, 256):
            kernels.LONG_RUN = lr
            check_scatter(rng, sh["lanes"], sh["cap"], sh["B"], False, dev)
            out[lr] = measure(lambda: kernels.slot_scatter_combine(st, kinds, slots, vals))["device_ms"]
    finally:
        kernels.LONG_RUN = chosen
    return out


def kernel_phase(dev) -> dict:
    rng = np.random.default_rng(20261017)
    shapes = {
        # q7: max(price), count, and the auction key riding as a max lane
        "q7": dict(lanes=[("max", torch.int64), ("count", torch.int64), ("max", torch.int64)],
                   cap=65536, B=65536, R=2048),
        # a deployment-size keyed state: 4,194,304 slots x 48 B = 201 MB,
        # float sums (K1's row-ordered walk) and a uint64 group-by key lane
        "deployment": dict(lanes=[("sum", torch.float64), ("count", torch.int64),
                                  ("min", torch.int64), ("max", torch.float64),
                                  ("max", torch.int32), ("min", torch.float32),
                                  ("sum", torch.float32), ("max", torch.uint64)],
                           cap=1 << 22, B=65536, R=2048),
        # qu: the updating aggregate's lanes (AVG's float64 sum walked in
        # row order), one source batch into its 262144 slots
        "qu": dict(lanes=[("sum", getattr(torch, d)) for d in qu_lanes()],
                   cap=QU_CAP, B=BENCH_BATCH, R=2048),
    }
    errs = {"slot_scatter_combine": 0.0, "slot_region_read_pack": 0.0, "slot_region_clear": 0.0,
            "slot_region_read_pack_clear": 0.0}
    log("kernels: K1 edge cases")
    edge = scatter_edge_cases(rng, kernels.LONG_RUN) + [negative_slot_case(rng, kernels.LONG_RUN)]
    for case in edge:
        for idx_dt in (np.int32, np.int64):
            for merge in (False, True):
                check_scatter_case(case, idx_dt, merge, dev)
    chain_ns = add_chain_ns(dev)
    log("kernels: K2's read-and-clear cases")
    read_clear_cases = check_read_clear_cases(rng, dev)
    timing = {}
    for name, sh in shapes.items():
        log(f"kernels: check {name}")
        for merge in (False, True):
            e = check_scatter(rng, sh["lanes"], sh["cap"], sh["B"], merge, dev)
            errs["slot_scatter_combine"] = max(errs["slot_scatter_combine"], e)
        check_regions(rng, sh["lanes"], sh["cap"], sh["R"], dev)
        log(f"kernels: time {name}")
        timing[name] = time_kernels(rng, sh["lanes"], sh["cap"], sh["B"], sh["R"], dev)
        k1 = timing[name]["slot_scatter_combine"]
        ordered = [str(dt).replace("torch.", "") for k, dt in sh["lanes"]
                   if kernels.ordered_add(k, dt)]
        if ordered:
            # the walk of the longest run can go no faster than its chain of adds
            k1["chain_floor_ms"] = k1["longest_run"] * max(chain_ns[d] for d in ordered) / 1e6
    log("kernels: K1's long-run threshold")
    long_run_ms = long_run_sweep(rng, shapes["deployment"], dev)
    info = {"phase": "kernels", "max_abs_err": errs,
            "edge_cases": [c["label"] for c in edge], "read_clear_cases": read_clear_cases,
            "long_run": kernels.LONG_RUN,
            "long_run_sweep_ms": long_run_ms,
            "add_chain_ns": chain_ns,
            "shapes": {n: {"cap": s["cap"], "B": s["B"], "R": s["R"],
                           "lanes": [[k, str(d).replace("torch.", "")] for k, d in s["lanes"]]}
                       for n, s in shapes.items()},
            "timing": timing}
    emit(info)
    return info


# ---------------------------------------------------------------- q7m, q5m, mesh_ab

MESH_KERNELS = ("segment_fused", "agg_sort_reduce", "agg_probe_merge", "shard_exchange",
                "shard_spill", "shard_extract")
MESH_AB_EVENTS = 200_000  # bench.py ARROYO_BENCH_EVENTS default for --mesh-ab
MESH_AB_KEYS = 7
MESH_AB_WIDTH = 1_000_000
MESH_AB_BATCH = 4096
# bench.py --mesh-ab's settings (bench.py:836-849); the queue stays at its
# default, as bench.py leaves it
MESH_AB = {"device.mesh-devices": 8, "device.table-capacity": 8192,
           "device.batch-capacity": 2048, "device.emit-capacity": 4096,
           "device.spill-capacity": 4096, "device.max-probes": 32,
           "pipeline.source-batch-size": MESH_AB_BATCH,
           "engine.coalesce.max-rows": MESH_AB_BATCH, "segment.compile.min-rows": 1,
           "worker.queue-size": 8192}


def mesh_ledger() -> dict:
    return {"segment": seg.mesh_dispatch_counts(), "aggregate": sharded_agg.dispatch_counts()}


def reset_mesh_ledger() -> None:
    seg.reset_mesh_dispatch_counts()
    sharded_agg.reset_dispatch_counts()


class K8Recorder:
    """The K8 wrapper, appending what the library says each call on the
    card did (``sharded_kernels.sort_reduce_last``) to ``log``. The wrapper
    counts its launches on the module's ``agg_sort_reduce``, which this
    stands in for while ``k8_recorded`` is open, so ``launches`` is the
    wrapper's own count."""

    def __init__(self, log: list):
        self.log, self.wrapped = log, sharded_kernels.agg_sort_reduce

    launches = property(lambda self: self.wrapped.launches,
                        lambda self, n: setattr(self.wrapped, "launches", n))

    def __call__(self, *args, **kw):
        out = self.wrapped(*args, **kw)
        self.log.append(sharded_kernels.sort_reduce_last())
        return out


@contextlib.contextmanager
def k8_recorded():
    """While open, every K8 call made through the ``sharded_kernels``
    module (the mesh path's) is logged into the list it yields."""
    log: list = []
    wrapped = sharded_kernels.agg_sort_reduce
    sharded_kernels.agg_sort_reduce = K8Recorder(log)
    try:
        yield log
    finally:
        sharded_kernels.agg_sort_reduce = wrapped


def k8_call_summary(log: list, launches: int) -> dict:
    """K8's calls of a run (a ``K8Recorder``'s log), grouped by what the
    library says each did: its path (one block per shard, or onesweep
    passes), kernel launches, passes run and skipped, memsets, whether it
    read its digit counts back; with the live rows' range per group (-1:
    not read back) and the host's wait for the read-back per call."""
    if len(log) != launches:
        raise AssertionError(f"K8's call log holds {len(log)} calls, its counter {launches}")
    groups: dict = {}
    for r in log:
        key = (f"{'onesweep' if r['onesweep'] else 'block'}: {r['launches']} launches, "
               f"{r['passes']} passes, {r['skipped']} skipped, {r['memsets']} memsets, "
               f"{'read back' if r['synced'] else 'no read-back'}")
        g = groups.setdefault(key, {"calls": 0, "live": [], "wait_us": []})
        g["calls"] += 1
        g["live"].append(r["live"])
        g["wait_us"].append(r["wait_ns"] / 1e3)
    out = {"calls": len(log), "kernel_launches": sum(r["launches"] for r in log),
           "read_back_wait_us": sum(r["wait_ns"] for r in log) / 1e3, "groups": {}}
    for k, g in groups.items():
        w = g["wait_us"]
        out["groups"][k] = {"calls": g["calls"], "live_min": min(g["live"]),
                            "live_max": max(g["live"]), "wait_us_mean": statistics.fmean(w),
                            "wait_us_median": statistics.median(w), "wait_us_max": max(w)}
    return out


def mesh_run(name: str, build, events: int, oracle, check, fuse: bool, extra: dict,
             want=None, path_kernels=MESH_KERNELS, profile_it: bool = True,
             warm_events: int = 0) -> dict:
    """One mesh-mode run (counts zeroed just before it, read just after),
    held to its oracle; the chain must run compiled with no
    SEGMENT_FALLBACK, every kernel of ``path_kernels`` launched, and the
    ledger must read one aggregate step per fused micro-batch with fusion on
    (segment_mesh set) and host steps alone with it off. ``warm_events``
    first runs a short warm-up of the same mode (K4's Triton build for the
    mode's plan: fusion hoists the leading filter, so the plans differ).
    Then, if asked, a profiled run of the same mode."""
    want = oracle(events) if want is None else want
    extra = {**extra, "segment.compile.mesh-fuse": fuse}
    job = f"chip-smoke-{name}-{'fused' if fuse else 'host'}"
    if warm_events:
        drive(build, warm_events, job + "-warm", chaining=True, extra=extra)
    reset_all_launch_counts()
    reset_mesh_ledger()
    spill_before = sharded_kernels.spill_kernel_launches()
    with k8_recorded() as k8_calls:
        rows, wall, eng = drive(build, events, job, chaining=True, extra=extra)
    launches = all_launch_counts()
    spill_kernels = sharded_kernels.spill_kernel_launches() - spill_before
    check_k4_one_launch(name, launches)
    if spill_kernels != launches["shard_spill"]:
        raise AssertionError(f"{name}: K10's spill made {spill_kernels} kernel launches in "
                             f"{launches['shard_spill']} calls")
    ledger = mesh_ledger()
    got = check(rows, want)
    chained = [n for n in eng.graph.nodes if "+" in n]
    fallbacks = recorder.events(job, "SEGMENT_FALLBACK")
    compiled = recorder.events(job, "SEGMENT_COMPILED")
    metrics = registry.job_metrics(job).get(chained[0], {}) if chained else {}
    if not chained or not compiled or fallbacks:
        raise AssertionError(f"{name}: the chain did not run compiled: compiled {compiled}, "
                             f"fallbacks {fallbacks}")
    seg_l, agg_l = ledger["segment"], ledger["aggregate"]
    mesh_flag = any(m.get("segment_mesh") for m in metrics.values())
    if fuse and not (seg_l["fused"] == agg_l["fused_steps"] > 0 and mesh_flag):
        raise AssertionError(f"{name} fused: ledger {ledger}, segment_mesh {mesh_flag}")
    if not fuse and not (agg_l["fused_steps"] == 0 and agg_l["host_steps"] > 0):
        raise AssertionError(f"{name} host: ledger {ledger}")
    unlaunched = [k for k in path_kernels if launches[k] == 0]
    if unlaunched:
        raise AssertionError(f"{name} ran without launching {unlaunched}: {launches}")
    info = {"mode": "fused" if fuse else "host", "wall_s": wall, "events_per_s": events / wall,
            "windows": len(got), "launches": {k: launches[k] for k in launches if launches[k]},
            "ledger": ledger, "segment_mesh": mesh_flag,
            "calls_per_step": (agg_l["fused_steps"] / seg_l["fused"]) if seg_l["fused"] else None,
            "spill_kernels_per_call": spill_kernels / max(1, launches["shard_spill"]),
            "mesh_stats": [m.get("mesh") for m in metrics.values()],
            "k8_calls": k8_call_summary(k8_calls, launches["agg_sort_reduce"])}
    if profile_it:
        info["profiled_run"] = profiled_run(build, events, job + "-profiled", check, want,
                                            extra=extra)
    return info


def run_q7m() -> dict:
    """q7 at bench.py's sizes through an 8-shard mesh, fusion on then off."""
    want = oracle_q7(Q7_EVENTS)
    extra = {"device.mesh-devices": MESH_N}
    info = {"phase": "q7m", "events": Q7_EVENTS, "mesh_devices": MESH_N,
            "fused": mesh_run("q7m", build_q7, Q7_EVENTS, oracle_q7, check_q7, True, extra,
                              want=want, warm_events=2 * BENCH_BATCH),
            "host": mesh_run("q7m", build_q7, Q7_EVENTS, oracle_q7, check_q7, False, extra,
                             want=want, warm_events=2 * BENCH_BATCH)}
    emit(info)
    return info


def run_q5m() -> dict:
    """q5 at bench.py's sizes through the mesh with fusion on: each 2 s
    slide bin is one sharded close, at least one K11 launch each."""
    want = oracle_q5(Q5_EVENTS)
    r = mesh_run("q5m", build_q5, Q5_EVENTS, oracle_q5, check_q5, True,
                 {"device.mesh-devices": MESH_N}, want=want, warm_events=2 * BENCH_BATCH)
    # events 1 ms apart: every 2 s slide bin of the run holds bids
    slide_bins = -(-Q5_EVENTS * 1000 // SLIDE)
    if r["launches"]["shard_extract"] < slide_bins:
        raise AssertionError(f"q5m: {r['launches']['shard_extract']} K11 launches for "
                             f"{slide_bins} slide bins")
    info = {"phase": "q5m", "events": Q5_EVENTS, "mesh_devices": MESH_N, "slide_bins": slide_bins,
            "fused": r}
    emit(info)
    return info


def mesh_ab_graph(rows: list, event_count: int) -> Graph:
    """bench.py's --mesh-ab pipeline (bench.py:853-877): impulse ->
    watermark -> key (counter % 7) -> tumbling 1 s COUNT + SUM(counter)."""
    S = Schema.of([("x", "int64"), (TIMESTAMP_FIELD, "int64")])
    g = Graph()
    g.add_node(Node("src", OpName.SOURCE, {
        "connector": "impulse", "message_count": event_count, "interval_micros": 1000,
        "start_time_micros": 0, "event_rate": 0}, 1))
    g.add_node(Node("wm", OpName.WATERMARK, {"expr": Col(TIMESTAMP_FIELD)}, 1))
    g.add_node(Node("key", OpName.KEY, {
        "keys": [("k", BinOp("%", Col("counter"), Lit(MESH_AB_KEYS)))]}, 1))
    g.add_node(Node("agg", OpName.TUMBLING_AGGREGATE, {
        "width_micros": MESH_AB_WIDTH, "key_fields": ["k"],
        "aggregates": [("cnt", "count", None), ("total", "sum", Col("counter"))],
        "input_dtype_of": lambda e: np.dtype(np.int64), "backend": "jax"}, 1))
    g.add_node(Node("sink", OpName.SINK, {"connector": "vec", "rows": rows}, 1))
    g.add_edge("src", "wm", EdgeType.FORWARD, S)
    g.add_edge("wm", "key", EdgeType.FORWARD, S)
    g.add_edge("key", "agg", EdgeType.SHUFFLE, S)
    g.add_edge("agg", "sink", EdgeType.FORWARD, S)
    return g


def oracle_mesh_ab(event_count: int) -> dict:
    """bench.py:879-882: (window, key) -> (count, sum of counters)."""
    c = np.arange(event_count, dtype=np.int64)
    w, k = (c * 1000) // MESH_AB_WIDTH, c % MESH_AB_KEYS
    uniq, inv = np.unique(np.stack([w, k], axis=1), axis=0, return_inverse=True)
    inv = inv.ravel()
    cnt = np.bincount(inv, minlength=len(uniq))
    tot = np.zeros(len(uniq), dtype=np.int64)
    np.add.at(tot, inv, c)
    return {(int(a), int(b)): (int(n), int(t)) for (a, b), n, t in zip(uniq, cnt, tot)}


def check_mesh_ab(rows: list, want: dict) -> dict:
    got = {(r["window_start"] // MESH_AB_WIDTH, r["k"]): (r["cnt"], r["total"]) for r in rows}
    if len(got) != len(rows) or got != want:
        raise AssertionError(f"mesh_ab parity failure: {len(rows)} rows, {len(got)} windows "
                             f"vs {len(want)}")
    return got


def run_mesh_ab() -> dict:
    """bench.py --mesh-ab at its own settings: a warm-up of each mode, then
    host and fused back to back, each against the closed-form oracle, with
    the ledger's calls per step."""
    want = oracle_mesh_ab(MESH_AB_EVENTS)
    for fuse in (False, True):
        mesh_run("mesh_ab-warm", mesh_ab_graph, MESH_AB_EVENTS, oracle_mesh_ab, check_mesh_ab,
                 fuse, MESH_AB, want=want, profile_it=False)
    host = mesh_run("mesh_ab", mesh_ab_graph, MESH_AB_EVENTS, oracle_mesh_ab, check_mesh_ab,
                    False, MESH_AB, want=want)
    fused = mesh_run("mesh_ab", mesh_ab_graph, MESH_AB_EVENTS, oracle_mesh_ab, check_mesh_ab,
                     True, MESH_AB, want=want)
    if fused["calls_per_step"] != 1.0:
        raise AssertionError(f"mesh_ab: {fused['calls_per_step']} aggregate steps per fused "
                             f"micro-batch")
    info = {"phase": "mesh_ab", "events": MESH_AB_EVENTS, "settings": MESH_AB,
            "host": host, "fused": fused,
            "fused_over_host": fused["events_per_s"] / host["events_per_s"]}
    emit(info)
    return info


# ---------------------------------------------------------------- sharded (K8-K11)

MESH_N = 8  # bench.py's mesh width (bench.py:834 n_dev)
SHARDED_SOURCE = "arroyo_tpu_torch/csrc/sharded_agg.cu"
Q7M_LANES = [("max", torch.int64), ("count", torch.int64), ("max", torch.int64)]
DEPLOY_LANES = [("sum", torch.int64), ("count", torch.int64), ("min", torch.int64),
                ("max", torch.int64), ("sum", torch.float64)]
MESH_AB_LANES = [("count", torch.int64), ("sum", torch.int64)]  # mesh_ab's COUNT, SUM(counter)
SHARDED_KERNELS = ("agg_sort_reduce", "agg_probe_merge", "shard_exchange", "shard_spill",
                   "shard_extract")


def same(a, b) -> bool:
    """Exact equality of two tensors: dtype, shape and bytes (floats as
    bits, so -0.0 and NaN payloads count)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        ity = torch.int64 if a.dtype == torch.float64 else torch.int32
        return torch.equal(a.view(ity), b.view(ity))
    return torch.equal(a, b)


def require_same(label: str, got, want) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(g, (list, tuple)):
            require_same(f"{label}[{i}]", g, w)
        elif not same(g, w):
            raise AssertionError(f"{label}: output {i} differs from the plain version "
                                 f"({g.dtype} {tuple(g.shape)})")


def mesh_rows(rng, S, L, n_valid, lanes, n_keys, dev, bins_range=(0, 3), hot=0.0,
              max_key_rows=0):
    """[S, L] rows: keys from hashing Zipf(1.2) ids (q7's hot auctions) or a
    hot key, bins in bins_range, the first n_valid of each shard valid."""
    ids = (rng.zipf(1.2, (S, L)) - 1) % n_keys
    if hot:
        ids = np.where(rng.random((S, L)) < hot, 17, ids)
    key = hash_columns([ids.reshape(-1).astype(np.int64)]).view(np.int64).reshape(S, L)
    bins = rng.integers(bins_range[0], bins_range[1], (S, L)).astype(np.int32)
    if max_key_rows:
        key[:, :max_key_rows] = np.iinfo(np.int64).max
        bins[:, :max_key_rows] = np.iinfo(np.int32).max
    valid = np.zeros((S, L), dtype=bool)
    valid[:, :n_valid] = True
    vals = []
    for kind, dt in lanes:
        npdt = NP_DT[dt]
        if dt.is_floating_point:
            v = np.round(rng.normal(0, 1000, (S, L)), 2).astype(npdt)
        else:
            v = rng.integers(-(1 << 20), 1 << 20, (S, L)).astype(npdt)
        vals.append(torch.from_numpy(v).to(dev))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t(key), t(bins), t(valid), vals


def empty_table(S, cap, lanes, dev):
    return (torch.zeros((S, cap), dtype=torch.int64, device=dev),
            torch.zeros((S, cap), dtype=torch.int32, device=dev),
            torch.zeros((S, cap), dtype=torch.bool, device=dev),
            [torch.full((S, cap), _identity(k, NP_DT[dt]).item(), dtype=dt, device=dev)
             for k, dt in lanes])


def empty_spill(S, sc, lanes, dev):
    return (torch.zeros((S, sc), dtype=torch.int64, device=dev),
            torch.zeros((S, sc), dtype=torch.int32, device=dev),
            torch.zeros(S, dtype=torch.int32, device=dev),
            [torch.full((S, sc), _identity(k, NP_DT[dt]).item(), dtype=dt, device=dev)
             for k, dt in lanes],
            torch.zeros(S, dtype=torch.int32, device=dev))


def clone_nested(x):
    if isinstance(x, (list, tuple)):
        return [clone_nested(y) for y in x]
    return x.clone()


def checked_step(kinds, table, spill, key, bins, valid, vals, dc, max_probes, checks,
                 bin_offset=0, n_valid=None):
    """One exchange + merge step with every kernel held against its plain
    version on the same inputs (stateful ones on clones); the kernels'
    outputs carry on. Records the shapes each kernel saw in ``checks``."""
    S = key.shape[0]
    recv = S * dc
    u = sharded_kernels.agg_sort_reduce(kinds, key, bins, valid, vals, bin_offset, n_valid)
    require_same("agg_sort_reduce (local)", u, sharded_kernels.agg_sort_reduce_plain(
        kinds, key, bins, valid, vals, bin_offset, n_valid))
    ex = sharded_kernels.shard_exchange(kinds, *u, dc)
    ex_p = sharded_kernels.shard_exchange_plain(kinds, *u, dc)
    require_same("shard_exchange send", ex[:4], ex_p[:4])
    require_same("shard_exchange kept", [t[:, recv:] for t in ex[4:7]] + [
        [t[:, recv:] for t in ex.m_accs]], [t[:, recv:] for t in ex_p[4:7]] + [
        [t[:, recv:] for t in ex_p.m_accs]])
    for s_t, m_t in zip((ex.s_key, ex.s_bin, ex.s_valid, *ex.s_accs),
                        (ex.m_key, ex.m_bin, ex.m_valid, *ex.m_accs)):
        all_to_all(s_t, out=m_t[:, :recv])
    c = sharded_kernels.agg_sort_reduce(kinds, ex.m_key, ex.m_bin, ex.m_valid, ex.m_accs)
    require_same("agg_sort_reduce (merged)", c, sharded_kernels.agg_sort_reduce_plain(
        kinds, ex.m_key, ex.m_bin, ex.m_valid, ex.m_accs))
    table_p = clone_nested(table)
    still = sharded_kernels.agg_probe_merge(kinds, table, *c, max_probes)
    still_p = sharded_kernels.agg_probe_merge_plain(kinds, table_p, *c, max_probes)
    require_same("agg_probe_merge", [still, *table[:3], table[3]],
                 [still_p, *table_p[:3], table_p[3]])
    spill_p = clone_nested(spill)
    sharded_kernels.shard_spill(kinds, c[0], c[1], c[3], still, spill,
                                spill_state(S, c[0].shape[1]))
    sharded_kernels.shard_spill_plain(kinds, c[0], c[1], c[3], still, spill_p)
    require_same("shard_spill", spill, spill_p)
    checks.setdefault("agg_sort_reduce", set()).update({key.shape[1], ex.m_key.shape[1]})
    checks.setdefault("agg_probe_merge", set()).add(int(still.sum()))
    return u, ex, c, still


_SPILL_STATES: dict = {}


def spill_state(S: int, M: int) -> torch.Tensor:
    """K10's spill state for (S, M) on the current stream, kept across calls
    as ShardedAggregator keeps it."""
    key = (S, M, torch.cuda.current_stream().cuda_stream)
    if key not in _SPILL_STATES:
        _SPILL_STATES[key] = sharded_kernels.spill_scratch(S, M, torch.device("cuda"))
    return _SPILL_STATES[key]


def checked_extract(table, lo, hi, free_below, emit_cap, checks):
    table_p = clone_nested(table)
    got = sharded_kernels.shard_extract(table, lo, hi, free_below, emit_cap)
    want = sharded_kernels.shard_extract_plain(table_p, lo, hi, free_below, emit_cap)
    require_same("shard_extract", [got.key, got.bin, got.valid, got.accs, got.total, table[2]],
                 [want.key, want.bin, want.valid, want.accs, want.total, table_p[2]])
    checks.setdefault("shard_extract", set()).add(int(got.total.sum()))
    return got


def sharded_case(label, rng, dev, S, cap, L, dc, max_probes, emit_cap, sc, lanes, steps,
                 checks, n_keys=5000, hot=0.0, max_key_rows=0, valid_frac=1.0, closes=None,
                 close_after=None, expect=None):
    """A run of steps and closes over one sharded state, every kernel held
    exactly against its plain version; ``expect(table, spill)`` checks what
    the case exists for (spill rows, overflow, kept-local rows)."""
    kinds = [k for k, _ in lanes]
    table, spill = empty_table(S, cap, lanes, dev), empty_spill(S, sc, lanes, dev)
    kept = 0
    for step in range(steps):
        rows = mesh_rows(rng, S, L, max(1, int(L * valid_frac)), lanes, n_keys, dev,
                         bins_range=(step, step + 3), hot=hot, max_key_rows=max_key_rows)
        _u, ex, _c, _still = checked_step(kinds, table, spill, *rows, dc, max_probes, checks)
        kept += int(ex.m_valid[:, S * dc:].sum())
        for lo, hi, fb in (close_after or {}).get(step, []):
            checked_extract(table, lo, hi, fb, emit_cap, checks)
    occ = table[2].cpu().numpy()
    live = [np.stack([table[0][d].cpu().numpy()[occ[d]],
                      table[1][d].cpu().numpy()[occ[d]].astype(np.int64)]) for d in range(S)]
    dups = sum(int(occ[d].sum()) - len(np.unique(live[d], axis=1).T) for d in range(S))
    for lo, hi, fb in (closes or [(0, 2, 2)]):
        checked_extract(table, lo, hi, fb, emit_cap, checks)
    torch.cuda.synchronize()
    facts = {"kept_local_rows": kept, "spill_fill": spill[2].tolist(),
             "overflow": spill[4].tolist(), "occupied": int(table[2].sum()),
             "duplicate_entries": dups}
    if expect is not None:
        expect(facts)
    return {"label": label, "shards": S, "cap": cap, "rows": L, "dest_cap": dc,
            "max_probes": max_probes, **facts}


def sharded_cases(rng, dev) -> list:
    q7m_dc = BENCH_BATCH // (MESH_N // 2)
    checks: dict = {}
    out = []

    def need(cond, what):
        def f(facts):
            if not cond(facts):
                raise AssertionError(f"sharded case does not show {what}: {facts}")
        return f

    # q7m's shapes: the fused step's local 8192 rows per shard (merged
    # 131072 + 8192), the host step's 65536 (merged 196608)
    out.append(sharded_case("q7m fused shapes", rng, dev, MESH_N, 65536, 8192, q7m_dc, 64,
                            8192, 2048, Q7M_LANES, 2, checks, n_keys=60000, valid_frac=0.94,
                            closes=[(0, 1, 1), (1, 3, 1)]))
    out.append(sharded_case("q7m host shapes", rng, dev, MESH_N, 65536, 65536, q7m_dc, 64,
                            8192, 2048, Q7M_LANES, 2, checks, n_keys=60000, valid_frac=0.12))
    out.append(sharded_case("deployment state", rng, dev, MESH_N, 1 << 20, 65536, 16384, 64,
                            8192, 2048, DEPLOY_LANES, 2, checks, n_keys=1 << 22,
                            closes=[(0, 1, 1)]))
    for n in (1, 4, 8):
        out.append(sharded_case(f"n_dev {n}", rng, dev, n, 4096, 2048,
                                2048 // max(n // 2, 1), 32, 4096, 4096,
                                Q7M_LANES + [("sum", torch.float64), ("min", torch.float32)],
                                3, checks, n_keys=3000, valid_frac=0.7))
    out.append(sharded_case("hot key past dest_cap", rng, dev, MESH_N, 4096, 2048, 4, 32,
                            4096, 4096, Q7M_LANES + [("sum", torch.float64)], 3, checks,
                            n_keys=40, hot=0.9, expect=need(lambda f: f["kept_local_rows"] > 0,
                                                           "kept-local rows")))
    out.append(sharded_case("table pressure into the spill buffer", rng, dev, 4, 64, 512, 512,
                            2, 64, 4096, Q7M_LANES, 3, checks, n_keys=4000,
                            expect=need(lambda f: sum(f["spill_fill"]) > 0
                                        and sum(f["overflow"]) == 0, "spill rows")))
    out.append(sharded_case("spill exhaustion", rng, dev, 4, 64, 512, 512, 2, 64, 16,
                            Q7M_LANES, 2, checks, n_keys=4000,
                            expect=need(lambda f: sum(f["overflow"]) > 0, "overflow")))
    out.append(sharded_case("max_probes exhausted", rng, dev, MESH_N, 1024, 1024, 512, 1,
                            1024, 4096, Q7M_LANES, 2, checks, n_keys=20000,
                            expect=need(lambda f: sum(f["spill_fill"]) > 0, "unplaced rows")))
    out.append(sharded_case("duplicates after a free", rng, dev, 4, 256, 256, 256, 16, 64,
                            1024, Q7M_LANES, 4, checks, n_keys=300,
                            close_after={1: [(0, 1, 1)], 2: [(1, 2, 2)]},
                            closes=[(2, 3, 2), (0, 10, 10)],
                            expect=need(lambda f: f["duplicate_entries"] > 0,
                                        "duplicate (key, bin) entries")))
    out.append(sharded_case("key INT64_MAX in bin INT32_MAX", rng, dev, 4, 1024, 512, 256, 16,
                            256, 256, Q7M_LANES + [("sum", torch.float64)], 2, checks,
                            n_keys=500, max_key_rows=3, valid_frac=0.8,
                            closes=[(0, np.iinfo(np.int32).max, 5)]))
    return out, {k: sorted(v) for k, v in checks.items()}


# ---------------------------------------------------------------- K10 and K9 edge cases
# (shared with tests/test_torch_exchange_probe.py, which holds the plain
# versions to the JAX package on the CPU; here the kernels are held to the
# plain versions on the card)

U64_MAX = (1 << 64) - 1
I64 = np.iinfo(np.int64)
EXCHANGE_TILE = sharded_kernels.EXCHANGE_TILE
# every lane width and fill pattern: 8-byte and 4-byte identities, zero and not
EXCHANGE_LANES = [("max", torch.int64), ("count", torch.int64), ("sum", torch.float64),
                  ("min", torch.float32), ("sum", torch.int32), ("max", torch.uint64)]
PROBE_LANES = EXCHANGE_LANES
_MIX1, _MIX2 = 0xFF51AFD7ED558CCD, 0xC4CEB9FE1A85EC53


def owner_boundary_keys(S: int) -> np.ndarray:
    """int64 keys whose uint64 bits lie at every range start of S shards
    (j (U64_MAX // S + 1), j = 1 .. S - 1) and either side of it, and 0, 1,
    -1, INT64_MIN and INT64_MAX."""
    out = [0, 1, -1, int(I64.min), int(I64.max)]
    if S > 1:
        R = U64_MAX // S + 1
        for j in range(1, S):
            for d in (-1, 0, 1):
                u = (j * R + d) & U64_MAX
                out.append(u - (1 << 64) if u >= 1 << 63 else u)
    return np.array(out, dtype=np.int64)


def lane_values(rng, lanes, shape) -> list:
    """numpy values of each (kind, torch dtype) lane: floats with -0.0 and
    infinities, integers over a quarter of their range, uint64 over all."""
    out = []
    for _kind, dt in lanes:
        npdt = NP_DT[dt]
        if dt.is_floating_point:
            v = np.round(rng.normal(0, 1000, shape), 2).astype(npdt)
            pick = rng.random(shape)
            v[pick < 0.05] = -0.0
            v[(pick >= 0.05) & (pick < 0.07)] = np.inf
            v[(pick >= 0.07) & (pick < 0.09)] = -np.inf
        elif dt == torch.uint64:
            v = rng.integers(0, U64_MAX, shape, dtype=np.uint64, endpoint=True)
        else:
            info = np.iinfo(npdt)
            v = rng.integers(info.min // 4, info.max // 4, shape).astype(npdt)
        out.append(v)
    return out


def exchange_cases(rng) -> list:
    """K10's exchange edge cases, numpy: S in {1, 2, 3, 5, 7, 8, 32} with
    keys at every range start and either side of it, the int64 limits and
    -1; every row inactive; one owner taking more than dest_cap rows; dest_cap
    1; L of 1 and one tile (EXCHANGE_TILE rows) less and more, and more than
    two tiles at 7 shards."""
    out = []

    def case(label, S, L, dc, active_frac=0.8, hot_owner=None):
        key = rng.integers(I64.min, I64.max, (S, L), dtype=np.int64, endpoint=True)
        edges = owner_boundary_keys(S)
        for s in range(S):
            at = rng.permutation(L)[:len(edges)]
            key[s, at] = edges[:len(at)]
        if hot_owner is not None:
            start = np.uint64(hot_owner * (U64_MAX // S + 1))
            u = start + rng.integers(0, 1 << 40, (S, L)).astype(np.uint64)
            key = np.where(rng.random((S, L)) < 0.6, u.view(np.int64), key)
        out.append({"label": label, "S": S, "L": L, "dc": dc, "key": key,
                    "bins": rng.integers(-5, 5, (S, L)).astype(np.int32),
                    "active": rng.random((S, L)) < active_frac,
                    "vals": lane_values(rng, EXCHANGE_LANES, (S, L))})

    for S in (1, 2, 3, 5, 7, 8, 32):
        case(f"{S} shards, keys at the range starts", S, 300, 64)
    case("every row inactive", 4, 500, 64, active_frac=0.0)
    case("one owner past dest_cap", 8, 1500, 16, hot_owner=3)
    case("dest_cap 1", 5, 200, 1)
    case("L 1", 3, 1, 4)
    case("L one tile less", 4, EXCHANGE_TILE - 1, 256)
    case("L one tile more", 4, EXCHANGE_TILE + 1, 256)
    case("L past two tiles, 7 shards", 7, 2 * EXCHANGE_TILE + 1, 100, hot_owner=6)
    return out


def exchange_tensors(c: dict, dev) -> tuple:
    """(kinds, u_key, u_bin, active, u_accs) of an exchange case on dev."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return ([k for k, _ in EXCHANGE_LANES], t(c["key"]), t(c["bins"]), t(c["active"]),
            [t(v) for v in c["vals"]])


def _xs33(z):
    return z ^ (z >> np.uint64(33))


def keys_at_home(rng, n: int, home: int, cap: int, bin_: int = 0) -> np.ndarray:
    """n distinct int64 keys whose first probe slot with ``bin_`` is
    ``home`` (K9's mix(key ^ bin * C1) & (cap - 1)): the mix inverted (the
    33-bit xorshift is its own inverse, the multiply by C2 has an inverse
    mod 2^64) from random words whose low bits are ``home``."""
    mask = np.uint64(cap - 1)
    z2 = (rng.integers(0, U64_MAX, 4 * n, dtype=np.uint64, endpoint=True) & ~mask) | np.uint64(home)
    z2 = np.unique(z2)[:n]
    inv = np.uint64(pow(_MIX2, -1, 1 << 64))
    with np.errstate(over="ignore"):
        z0 = _xs33(_xs33(z2) * inv)
        key = z0 ^ (np.uint64(bin_ & U64_MAX) * np.uint64(_MIX1))
    return rng.permutation(key.view(np.int64))


def probe_home_np(key: np.ndarray, bins: np.ndarray, cap: int) -> np.ndarray:
    """K9's first probe slot of each (key, bin), in numpy."""
    with np.errstate(over="ignore"):
        z = key.view(np.uint64) ^ (bins.astype(np.int64).view(np.uint64) * np.uint64(_MIX1))
        z = _xs33(z) * np.uint64(_MIX2)
        z = _xs33(z)
    return (z & np.uint64(cap - 1)).astype(np.int64)


def probe_cases(rng, hot: int = 300, hot_shards=(1, 8)) -> list:
    """K9's edge cases, numpy: tables (keys, bins, occ, accs [S, cap]) and
    unique partials (u_key, u_bin, active, u_accs [S, B]): ``hot`` partials
    on one home slot (the highest index wins each round) at each of
    ``hot_shards``; matches and claims in one round (entries at some
    partials' home slots, stale keys in freed slots); max_probes exhausted
    with the overflow counter; a list longer than one CTA's threads;
    max_probes 0; random tables at 1 and 8 shards; max_probes -1."""
    out = []

    def case(label, S, cap, B, max_probes, n_active, occupied=0.3, hot_home=False,
             at_home=0.0, stale=0.0):
        keys = rng.integers(I64.min, I64.max, (S, cap), dtype=np.int64, endpoint=True)
        bins = rng.integers(0, 4, (S, cap)).astype(np.int32)
        occ = rng.random((S, cap)) < occupied
        accs = lane_values(rng, PROBE_LANES, (S, cap))
        u_key = np.zeros((S, B), np.int64)
        u_bin = np.zeros((S, B), np.int32)
        active = np.zeros((S, B), bool)
        for s in range(S):
            pos = np.sort(rng.permutation(B)[:n_active])
            if hot_home:
                k = keys_at_home(rng, n_active, int(rng.integers(cap)), cap)
                b = np.zeros(n_active, np.int32)
            else:
                k = np.unique(rng.integers(I64.min, I64.max, 2 * n_active, dtype=np.int64))
                k = rng.permutation(k)[:n_active]
                b = rng.integers(0, 4, n_active).astype(np.int32)
            u_key[s, pos], u_bin[s, pos], active[s, pos] = k, b, True
            home = probe_home_np(k, b, cap)
            # entries of some partials at their home slot: a match in round 0
            # beside claims of empty slots; stale copies in freed slots
            for pick, occupied_now in ((rng.random(n_active) < at_home, True),
                                       (rng.random(n_active) < stale, False)):
                keys[s, home[pick]] = k[pick]
                bins[s, home[pick]] = b[pick]
                occ[s, home[pick]] = occupied_now
        out.append({"label": label, "S": S, "cap": cap, "B": B, "max_probes": max_probes,
                    "table": (keys, bins, occ, accs), "u_key": u_key, "u_bin": u_bin,
                    "active": active, "u_accs": lane_values(rng, PROBE_LANES, (S, B)),
                    "oflow": rng.integers(0, 100, S).astype(np.int32)})

    for S in hot_shards:
        cap = 1 << max(8, int(hot - 1).bit_length() + 1)
        case(f"{hot} partials on one home slot, {S} shards", S, cap, hot + 37, 64 if hot > 1000
             else 16, hot, hot_home=True)
    case("matches and claims in one round", 2, 256, 200, 8, 120, at_home=0.4, stale=0.2)
    case("max_probes exhausted", 4, 64, 200, 2, 150, occupied=0.5)
    case("a list past one CTA", 1, 4096, 3000, 16, 2500, occupied=0.2, at_home=0.1)
    case("max_probes 0", 2, 64, 40, 0, 30)
    for S in (1, 8):
        case(f"{S} shards", S, 512, 300, 8, 200, at_home=0.2, stale=0.1)
    # the reference's fori_loop(0, max_probes) runs no round below 0 either
    case("max_probes -1", 2, 64, 40, -1, 30)
    return out


SPILL_LANES = [("max", torch.int64), ("count", torch.int64), ("sum", torch.float64),
               ("min", torch.float32), ("max", torch.uint64), ("sum", torch.int32)]


def spill_cases(rng) -> list:
    """K10's spill on its edge cases (shared with tests/test_torch_spill.py,
    which holds the plain version to the reference's step 7 and to a numpy
    model of the kernel's tile walk): each a dict of S, M, sc, the still
    flags [S, M], the fill [S] (0 to sc), and ``calls`` appends of the
    same flags in a row on one state buffer."""
    q7m_M = MESH_N * (BENCH_BATCH // (MESH_N // 2)) + BENCH_BATCH // MESH_N
    tile = sharded_kernels.COMPACT_TILE

    def case(label, S, M, sc, p, fill, calls=1, spread=None):
        still = rng.random((S, M)) < p
        if spread is not None:  # flags only at these positions
            still[:] = False
            still[:, spread] = True
        return {"label": label, "S": S, "M": M, "sc": sc, "still": still, "calls": calls,
                "fill": np.asarray(fill, dtype=np.int32), "lanes": SPILL_LANES}

    return [
        case("q7m's merged step, every shard empty", MESH_N, q7m_M, 2048, 0.0, [0] * MESH_N),
        case("q7m's merged step, a few rows", MESH_N, q7m_M, 2048, 40 / q7m_M,
             rng.integers(0, 2049, MESH_N)),
        case("fill = sc: every row lost", 4, 5000, 64, 0.1, [64] * 4),
        case("exhaustion inside a tile", 4, 3 * tile + 5, 1000, 0.2, [0, 500, 999, 1000]),
        case("M % 16 != 0", 3, 2 * tile + 7, 4096, 0.3, [0, 17, 4095]),
        case("M below one tile", 5, 100, 30, 0.5, [0, 1, 29, 30, 15]),
        case("rows at tile edges", 2, 4 * tile, 64, 0.0, [3, 0],
             spread=[0, tile - 1, tile, 2 * tile - 1, 3 * tile, 4 * tile - 1]),
        case("every flag set, one shard", 1, 8192 + 3, 20000, 1.0, [11]),
        case("three appends on one state", 1, 20000, 3000, 0.04, [0], calls=3),
        case("32 shards", 32, 1000, 100, 0.05, rng.integers(0, 101, 32)),
    ]


def spill_tensors(c: dict, dev) -> tuple:
    """(kinds, c_key, c_bin, c_accs, still, spill) of a spill case on
    ``dev``: keys and bins drawn over their whole ranges, lanes with their
    bits drawn (NaN payloads and -0.0 among the floats), a spill buffer
    whose rows past the fill hold other values."""
    rng = np.random.default_rng(c["S"] * 1_000_003 + c["M"])
    S, M, sc = c["S"], c["M"], c["sc"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731

    def bits(dt, shape):
        a = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, shape, dtype=np.int64,
                         endpoint=True)
        return t(a.astype(np.int32) if dt in (torch.int32, torch.float32) else a).view(dt)

    kinds = [k for k, _ in c["lanes"]]
    c_key = t(rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, (S, M),
                           dtype=np.int64, endpoint=True))
    c_bin = t(rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max, (S, M),
                           dtype=np.int32, endpoint=True))
    c_accs = [bits(dt, (S, M)) for _k, dt in c["lanes"]]
    spill = (t(rng.integers(-9, 9, (S, sc), dtype=np.int64)),
             t(rng.integers(-9, 9, (S, sc), dtype=np.int32)), t(c["fill"]),
             [bits(dt, (S, sc)) for _k, dt in c["lanes"]],
             t(rng.integers(0, 5, S).astype(np.int32)))
    return kinds, c_key, c_bin, c_accs, t(c["still"]), spill


def check_spill_case(c: dict, dev) -> dict:
    """K10's spill against its plain version on one case, exactly (every
    spill row, the fill and the overflow), ``calls`` appends in a row on one
    state buffer, each one kernel launch by the library's counter."""
    kinds, c_key, c_bin, c_accs, still, spill = spill_tensors(c, dev)
    spill_p = clone_nested(spill)
    state = sharded_kernels.spill_scratch(c["S"], c["M"], dev)
    for i in range(c["calls"]):
        before = sharded_kernels.spill_kernel_launches()
        sharded_kernels.shard_spill(kinds, c_key, c_bin, c_accs, still, spill, state)
        n = sharded_kernels.spill_kernel_launches() - before
        sharded_kernels.shard_spill_plain(kinds, c_key, c_bin, c_accs, still, spill_p)
        torch.cuda.synchronize()
        require_same(f"shard_spill {c['label']}, call {i}", spill, spill_p)
        if n != 1:
            raise AssertionError(f"shard_spill {c['label']}: {n} kernel launches a call")
    return {"label": c["label"], "S": c["S"], "M": c["M"], "sc": c["sc"],
            "flags": int(still.sum()), "fill": spill[2].tolist()[:8],
            "overflow": spill[4].tolist()[:8], "calls": c["calls"]}


def probe_tensors(c: dict, dev) -> tuple:
    """(kinds, table, (u_key, u_bin, active, u_accs), oflow) of a probe
    case on dev."""
    t = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa: E731  (a copy: K9 writes in place)
    keys, bins, occ, accs = c["table"]
    return ([k for k, _ in PROBE_LANES], (t(keys), t(bins), t(occ), [t(a) for a in accs]),
            (t(c["u_key"]), t(c["u_bin"]), t(c["active"]), [t(a) for a in c["u_accs"]]),
            t(c["oflow"]))


def build_library_words(S: int, L: int) -> int:
    """The int32 words of K10's counts scratch the library asks for."""
    return sharded_kernels.build_library().arroyo_shard_exchange_counts_words(S, L)


def check_exchange_case(c: dict, dev) -> dict:
    """K10's exchange against its plain version on one case, exactly, and
    its launches a call by the library's count."""
    kinds, *u = exchange_tensors(c, dev)
    S, dc = c["S"], c["dc"]
    recv = S * dc
    before = sharded_kernels.exchange_kernel_launches()
    ex = sharded_kernels.shard_exchange(kinds, *u, dc)
    torch.cuda.synchronize()
    n = sharded_kernels.exchange_kernel_launches() - before
    ex_p = sharded_kernels.shard_exchange_plain(kinds, *u, dc)
    require_same(f"shard_exchange {c['label']} send", ex[:4], ex_p[:4])
    require_same(f"shard_exchange {c['label']} kept",
                 [t[:, recv:] for t in ex[4:7]] + [[t[:, recv:] for t in ex.m_accs]],
                 [t[:, recv:] for t in ex_p[4:7]] + [[t[:, recv:] for t in ex_p.m_accs]])
    if n != 2:
        raise AssertionError(f"shard_exchange {c['label']}: {n} kernel launches, not 2")
    return {"label": c["label"], "shards": S, "rows": c["L"], "dest_cap": dc,
            "sent": int(ex.s_valid.sum()), "kept_local": int(ex.m_valid[:, recv:].sum()),
            "kernel_launches_per_call": n}


def check_probe_case(c: dict, dev) -> dict:
    """K9 against its plain version on one case, exactly (table, still,
    the overflow counter), its reported rounds held to the plain version
    run r rounds, one launch a call by the library's count."""
    kinds, table, u, oflow = probe_tensors(c, dev)
    mp = c["max_probes"]
    table_p, oflow_p = clone_nested(table), oflow.clone()
    base = clone_nested(table)
    before = sharded_kernels.probe_merge_kernel_launches()
    still = sharded_kernels.agg_probe_merge(kinds, table, *u, mp, oflow)
    torch.cuda.synchronize()
    n = sharded_kernels.probe_merge_kernel_launches() - before
    still_p = sharded_kernels.agg_probe_merge_plain(kinds, table_p, *u, mp, oflow_p)
    require_same(f"agg_probe_merge {c['label']}", [still, *table[:3], table[3], oflow],
                 [still_p, *table_p[:3], table_p[3], oflow_p])
    if n != 1:
        raise AssertionError(f"agg_probe_merge {c['label']}: {n} kernel launches, not 1")
    rounds = k9_rounds_check(c["label"], kinds, base, u, mp, dev)
    return {"label": c["label"], "shards": c["S"], "cap": c["cap"], "partials": c["B"],
            "active": int(u[2].sum()), "max_probes": mp, "unplaced": int(still.sum()),
            "rounds": rounds, "cluster": sharded_kernels.probe_merge_cluster()}


# K8's edge-case lanes: every dtype and kind, a count lane of ones (None)
K8_EDGE_LANES = [("sum", np.float64), ("sum", np.float32), ("count", None), ("min", np.float64),
                 ("max", np.float32), ("sum", np.int64), ("min", np.int32), ("max", np.uint64)]


def k8_edge_vals(rng, S, L, nan: bool = False) -> list:
    """[S, L] values of K8_EDGE_LANES (None for the count lane): floats
    with -0.0, +0.0 and infinities (NaN too if ``nan``), integers over a
    quarter of their range, uint64 over all of it."""
    out = []
    for _kind, dt in K8_EDGE_LANES:
        if dt is None:
            out.append(None)
        elif np.issubdtype(dt, np.floating):
            v = np.round(rng.normal(0, 1000, (S, L)), 2).astype(dt)
            pick = rng.random((S, L))
            v[pick < 0.05] = -0.0
            v[(pick >= 0.05) & (pick < 0.08)] = 0.0
            v[(pick >= 0.08) & (pick < 0.09)] = np.inf
            v[(pick >= 0.09) & (pick < 0.1)] = -np.inf
            if nan:
                v[(pick >= 0.1) & (pick < 0.11)] = np.nan
            out.append(v)
        elif dt == np.uint64:
            out.append(rng.integers(0, 2**64 - 1, (S, L), dtype=np.uint64))
        else:
            info = np.iinfo(dt)
            out.append(rng.integers(info.min // 4, info.max // 4, (S, L)).astype(dt))
    return out


K8_BLOCK_ROWS = 8192  # csrc/sharded_agg.cu SR_BLOCK_ROWS: one block sorts a shard this small
K8_POSITIONS = 13  # the bin's 4 bytes, the key's 8, the shard


def _k8_digit_bytes(key: np.ndarray, b32: np.ndarray) -> np.ndarray:
    """[n, 12] digit values of live rows: the bin's 4 bytes (of bin ^
    INT32_MIN) and the key's 8 (of key ^ INT64_MIN), least significant
    first."""
    kd = key.view(np.uint64) ^ np.uint64(1 << 63)
    bd = b32.view(np.uint32) ^ np.uint32(1 << 31)
    return np.concatenate([bd.view(np.uint8).reshape(-1, 4), kd.view(np.uint8).reshape(-1, 8)],
                          axis=1)


def sort_reduce_plan(key: torch.Tensor, bins: torch.Tensor, valid, bin_offset: int = 0,
                     n_valid=None) -> dict:
    """What K8 should do on the card for these ``[S, L]`` rows, a model of
    csrc/sharded_agg.cu's choice that the library's own report is held to:
    ``path`` "block" (every shard's live rows sorted by one block in
    shared memory; ``block_passes`` per shard, the digit positions that
    vary within it) or "onesweep" (``passes`` launches, one per digit
    position that varies across all live rows, of K8_POSITIONS at several
    shards, 12 at one), its kernel ``launches``, ``memsets``, the live rows
    (``shard_live`` per shard) and whether it reads the digit counts back
    (``synced``: more than K8_BLOCK_ROWS rows a shard)."""
    S, L = key.shape
    n_valid = S * L if n_valid is None else int(n_valid)
    k = key.cpu().numpy()
    b32 = (bins.cpu().numpy().astype(np.int64) - int(bin_offset)).astype(np.int32)
    live = np.arange(S * L).reshape(S, L) < n_valid
    if valid is not None:
        live &= valid.cpu().numpy()
    per_shard = live.sum(axis=1)
    synced = L > K8_BLOCK_ROWS
    plan = {"live": int(per_shard.sum()), "max_live": int(per_shard.max()), "synced": synced,
            "shard_live": [int(n) for n in per_shard]}
    if plan["max_live"] <= K8_BLOCK_ROWS:
        plan["block_passes"] = [
            int((np.ptp(_k8_digit_bytes(k[s][live[s]], b32[s][live[s]]), axis=0) > 0).sum())
            if per_shard[s] > 1 else 0 for s in range(S)]
        return dict(plan, path="block", passes=0, skipped=0, launches=3, memsets=int(synced))
    digits = _k8_digit_bytes(k[live], b32[live])
    if S > 1:
        digits = np.concatenate([digits, np.nonzero(live)[0][:, None].astype(np.uint8)], axis=1)
    passes = int((np.ptp(digits, axis=0) > 0).sum())
    # the compaction's two, the passes, the runs' count and scan, the
    # reduce and the long-run walk; the header's memset and the statuses'
    return dict(plan, path="onesweep", passes=passes, skipped=digits.shape[1] - passes,
                launches=6 + passes, memsets=2, block_passes=[-1] * S)


def k8_library_matches_plan() -> None:
    """The library's read-back threshold and digit positions are the
    plan's: no pinned buffer up to K8_BLOCK_ROWS rows a shard, one count
    per digit value of each position past it."""
    lib = sharded_kernels.build_library()
    got = [lib.arroyo_agg_sort_reduce_hist_bytes(1, n) for n in (K8_BLOCK_ROWS,
                                                                 K8_BLOCK_ROWS + 1)]
    if got != [0, K8_POSITIONS * 256 * 4]:
        raise AssertionError(f"K8's library reads back {got} bytes at {K8_BLOCK_ROWS} and "
                             f"{K8_BLOCK_ROWS + 1} rows a shard; the plan models "
                             f"{[0, K8_POSITIONS * 256 * 4]}")


def k8_check_report(what: str, plan: dict, launched: int, S: int, dev) -> dict:
    """The library's account of the K8 call just made (its counter's
    ``launched``, ``sort_reduce_last`` and the kernels' per-shard report)
    held equal to ``plan``; returns the library's numbers."""
    last = sharded_kernels.sort_reduce_last()
    shards = sharded_kernels.sort_reduce_shards(S, dev)
    got = {"path": "onesweep" if last["onesweep"] else "block", "launches": launched,
           "passes": last["passes"], "skipped": last["skipped"], "memsets": last["memsets"],
           "synced": bool(last["synced"]), "shard_live": shards["live"],
           "block_passes": shards["block_passes"], "live": sum(shards["live"]),
           "max_live": max(shards["live"])}
    wrong = {k: (v, plan[k]) for k, v in got.items() if v != plan[k]}
    if last["launches"] != launched:
        wrong["last.launches"] = (last["launches"], launched)
    if last["synced"] and (last["live"], last["max_live"]) != (got["live"], got["max_live"]):
        wrong["read-back live"] = ((last["live"], last["max_live"]),
                                   (got["live"], got["max_live"]))
    if wrong:
        raise AssertionError(f"K8 {what}: the library and the plan differ (library, plan): "
                             f"{wrong}")
    return dict(got, read_back_wait_us=last["wait_ns"] / 1e3)


def sort_reduce_edge_cases(rng) -> list:
    """K8's edge cases, each a dict of [S, L] numpy inputs (key, bins,
    valid or None, vals over K8_EDGE_LANES), bin_offset, n_valid and what
    ``sort_reduce_plan`` must say of it (``expect``): both
    of the kernel's paths (one block per shard, with and without reading
    the digit counts back, and the onesweep passes), a hot run walked by a
    block on each, the padding run's cases, and the bins' and keys' digit
    edges."""
    i64, i32 = np.iinfo(np.int64), np.iinfo(np.int32)

    def keys(S, L, n_keys, hot=0.0):
        ids = rng.integers(0, n_keys, (S, L))
        if hot:
            ids = np.where(rng.random((S, L)) < hot, n_keys, ids)
        return hash_columns([ids.reshape(-1).astype(np.int64)]).view(np.int64).reshape(S, L)

    def case(label, S, L, *, n_keys=50, hot=0.0, valid_frac=1.0, bins=(0, 3), expect=None,
             **kw):
        c = {"label": label, "key": keys(S, L, n_keys, hot),
             "bins": rng.integers(bins[0], bins[1], (S, L)).astype(np.int32),
             "valid": rng.random((S, L)) < valid_frac if valid_frac < 1.0 else None,
             "vals": k8_edge_vals(rng, S, L, kw.pop("nan", False)), "bin_offset": 0,
             "n_valid": None, "expect": expect or {}}
        c.update(kw)
        return c

    cases = []
    c = case("a shard of all-invalid rows", 4, 1000, valid_frac=0.7, expect={"path": "block"})
    c["valid"][2] = False
    cases.append(c)
    c = case("a shard with no invalid row", 2, 1000, valid_frac=0.6)
    c["valid"][0] = True
    cases.append(c)
    for label, frac in (("with invalid rows", 0.8), ("and no invalid row", 1.0)):
        c = case(f"valid (INT64_MAX, INT32_MAX) rows {label}", 2, 600, valid_frac=frac)
        c["key"][:, 10:15] = i64.max
        c["bins"][:, 10:15] = i32.max
        if c["valid"] is not None:
            c["valid"][:, 10:15] = True
        cases.append(c)
    cases.append(case("a hot run of ~6,000 rows, one block", 1, 8192, hot=0.75, nan=True,
                      expect={"path": "block", "synced": False, "launches": 3}))
    cases.append(case("a hot run of ~6,000 rows, onesweep", 1, 12_000, hot=0.5, nan=True,
                      bins=(7, 8), expect={"path": "onesweep", "passes": 8, "skipped": 4,
                                           "launches": 14}))
    c = case("an empty shard beside full ones", 3, 3000, valid_frac=0.5)
    c["valid"][:] = True
    c["valid"][1] = False
    cases.append(c)
    c = case("a shard with one live row", 4, 500, valid_frac=0.5)
    c["valid"][3] = False
    c["valid"][3, 77] = True
    cases.append(c)
    # bins as int64 around the offset: b - offset at and near both int32
    # limits, and past them (the int32 cast wraps)
    c = case("bin_offset near the int32 limits", 2, 800, valid_frac=0.9)
    off = -(1 << 40) + 12345
    rel = rng.choice(np.array([i32.min, i32.min + 1, -1, 0, i32.max - 1, i32.max,
                               i32.max + 3, i32.min - 2], np.int64), (2, 800))
    c["bins"], c["bin_offset"] = rel + off, off
    cases.append(c)
    cases.append(case("n_valid cutting inside a shard", 4, 700, valid_frac=0.9,
                      n_valid=2 * 700 + 333))
    cases.append(case("past 8192 rows a shard, every shard in one block", 4, 20_000,
                      valid_frac=0.3, n_keys=3000,
                      expect={"path": "block", "synced": True, "launches": 3}))
    cases.append(case("onesweep over 8 shards with a hot run", 8, 12_000, valid_frac=0.8,
                      n_keys=20_000, hot=0.2, expect={"path": "onesweep", "skipped": 3,
                                                      "passes": 10, "launches": 16}))
    cases.append(case("onesweep, bins over 600 values and negative", 2, 10_000,
                      n_keys=4000, bins=(-300, 300),
                      expect={"path": "onesweep", "passes": 13, "skipped": 0}))
    c = case("onesweep, keys equal but the top byte", 1, 9000, bins=(5, 6),
             expect={"path": "onesweep", "passes": 1, "skipped": 11, "launches": 7})
    c["key"] = (rng.integers(0, 256, (1, 9000)).astype(np.uint64) << np.uint64(56)
                | np.uint64(0x00ABCDEF01234567)).view(np.int64)
    cases.append(c)
    c = case("every row invalid, past 8192 rows a shard", 2, 9000, valid_frac=0.5,
             expect={"path": "block", "synced": True, "live": 0, "launches": 3})
    c["valid"][:] = False
    cases.append(c)
    return cases


def k8_case_tensors(c: dict, dev) -> tuple:
    """A sort_reduce_edge_cases case as the K8 wrapper's arguments on dev:
    (kinds, key, bins, valid, vals, bin_offset, n_valid)."""
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return ([k for k, _ in K8_EDGE_LANES], t(c["key"]), t(c["bins"]), t(c["valid"]),
            [t(v) for v in c["vals"]], c["bin_offset"], c["n_valid"])


def check_sort_reduce_case(c: dict, dev) -> dict:
    """K8 against its plain version on the card, exactly, on one edge case;
    the library's account of the call (launches, path, passes, live rows
    and passes per shard) equals sort_reduce_plan's."""
    args = k8_case_tensors(c, dev)
    plan = sort_reduce_plan(*args[1:4], *args[5:])
    before = sharded_kernels.sort_reduce_kernel_launches()
    got = sharded_kernels.agg_sort_reduce(*args)
    launched = sharded_kernels.sort_reduce_kernel_launches() - before
    report = k8_check_report(c["label"], plan, launched, c["key"].shape[0], dev)
    want = sharded_kernels.agg_sort_reduce_plain(*args)
    # exact, as lane_err holds K1: a float sum of +inf and -inf (or of a
    # NaN) is NaN on both, but the card writes its canonical NaN and the
    # plain version (adding on the host) the host's
    require_same(f"agg_sort_reduce {c['label']}", got[:3], want[:3])
    for (kind, _dt), g, w in zip(K8_EDGE_LANES, got[3], want[3]):
        lane_err(g, w, f"agg_sort_reduce {c['label']}: {kind}")
    torch.cuda.synchronize()
    return {"label": c["label"], "rows": list(c["key"].shape), **{
        k: report[k] for k in ("path", "passes", "skipped", "launches", "memsets", "live",
                               "max_live", "synced", "block_passes")}}


def sharded_bytes(kinds_lanes, S, L, M, dc, cap, E, n) -> dict:
    """Bytes each kernel must move at one step's shapes: each input read
    once, each output written once, counted for this run's data (``n``).
    A row array costs its 1-byte flag (valid, active, still or occupied)
    for every row and the rest of the row (key, bin, lanes) only for the
    rows the flag marks: padding and inactive partials cost one byte."""
    lane_b = sum(torch.tensor([], dtype=dt).element_size() for _k, dt in kinds_lanes)
    pay = 8 + 4 + lane_b  # key, bin, lanes
    return {
        # valid flags and valid rows in; active flags and segments out
        "agg_sort_reduce": S * M + n["merged_valid"] * pay + S * M + n["segments"] * pay,
        # active flags in, still flags out, each active partial read; its
        # slot: a claim reads the occupancy and writes the entry, a match
        # reads the entry and writes its lanes
        "agg_probe_merge": (2 * S * M + n["segments"] * pay + n["claims"] * (pay + 2)
                            + n["matches"] * (pay + 1 + lane_b)),
        # flags in, each active partial read; out, what the contract
        # writes: every send slot (key, bin, flag and lanes, the fill
        # included) and every local row of the owner order
        "shard_exchange": S * L + n["local_active"] * pay + (S * S * dc + S * L) * (pay + 1),
        # the flag-only figure, beside it so that earlier readings stay
        # comparable: a padding slot or row costs its flag alone
        "shard_exchange_flag_only": S * L + S * S * dc + S * L + 2 * n["local_active"] * pay,
        # still flags in; each still-active partial read and appended; the
        # fill and overflow counters read and written
        "shard_spill": S * M + 2 * n["still"] * pay + S * 16,
        # every slot's occupancy, the occupied slots' bins, the emitted
        # entries' key and lanes; out flags, emitted rows, totals, and the
        # freed entries' occupancy
        "shard_extract": (S * cap + n["occupied"] * 4 + n["emitted"] * (8 + lane_b) + S * E
                          + n["emitted"] * pay + S * 4 + n["freed"]),
    }


K8_BLOCK_KERNELS = ("sr_count", "sr_compact", "sr_block")
K8_ONESWEEP_KERNELS = ("sr_count", "sr_compact", "sr_sweep", "sr_run_count", "sr_run_scan",
                       "sr_reduce", "sr_walk_long")


def k8_launch_report(call, plan: dict, timing: dict, what: str, S: int, dev) -> dict:
    """One K8 call's account from the library (``k8_check_report``: its
    launches, path, passes, memsets, live rows and passes per shard), held
    to sort_reduce_plan's and its launches to the trace's (each kernel's
    launches per call rounded: a trace can drop a launch, never add one);
    with ``ms``: the call's device time from each kernel's mean launch in
    ``timing``'s trace times its launches, memsets and read-back copies by
    the library's count."""
    before = sharded_kernels.sort_reduce_kernel_launches()
    call()
    torch.cuda.synchronize()
    n = sharded_kernels.sort_reduce_kernel_launches() - before
    report = k8_check_report(what, plan, n, S, dev)
    ops, us = timing["device_ops_per_call"], timing["device_us_per_call"]
    trace = sum(max(1, round(c)) for name, c in ops.items()
                if not name.startswith(("Memset", "Memcpy")))
    if trace > n:
        raise AssertionError(f"K8 at {what}: {n} kernel launches a call, {trace} in the trace")
    path = report["path"]
    count = {k: 1 for k in (K8_BLOCK_KERNELS if path == "block" else K8_ONESWEEP_KERNELS)}
    if path == "onesweep":
        count["sr_sweep"] = report["passes"]
    ms = 0.0
    for name, t in us.items():
        per_launch = t / max(1, round(ops[name]))
        if name.startswith("Memset"):
            times = report["memsets"]
        elif name.startswith("Memcpy"):
            times = int(report["synced"])
        else:
            kernel = name.split("(")[0].split("<")[0].replace("void ", "")
            if kernel not in count:
                raise AssertionError(f"K8 at {what}: {name} in the trace is none of its kernels")
            times = count[kernel]
        ms += per_launch * times / 1e3
    return {"ms": ms, "kernel_launches_per_call": n, "trace_kernel_launches_per_call": trace,
            **{k: report[k] for k in ("path", "passes", "skipped", "memsets", "synced", "live",
                                      "max_live", "block_passes", "read_back_wait_us")}}


# a call's kernels by name, as the trace names them, and launches a call
K10_KERNELS = {"ex_count": 1, "ex_scatter": 1}
K9_KERNELS = {"pm_cluster": 1}
K9_COLD_BYTES = 64 << 20  # more than the H100's 50 MB L2
K10_SPILL_KERNELS = {"compact::compact_table": 1}


def library_launch_report(call, counter, timing: dict, kernels: dict, what: str) -> dict:
    """One call's kernel launches by the library's own counter (the
    difference of ``counter()`` across it), held to ``kernels`` (name ->
    launches a call) and to the trace's (a trace can drop a launch, never
    add one); the call's device time: each kernel's mean launch in
    ``timing``'s trace times its launches a call (CUDA events' time where
    the trace held no device time)."""
    before = counter()
    call()
    torch.cuda.synchronize()
    n = counter() - before
    if n != sum(kernels.values()):
        raise AssertionError(f"{what}: {n} kernel launches a call, expected {kernels}")
    ops, us = timing["device_ops_per_call"], timing["device_us_per_call"]
    trace = sum(max(1, round(c)) for c in ops.values())
    if trace > n:
        raise AssertionError(f"{what}: {n} kernel launches a call, {trace} in the trace")
    ms = 0.0
    for name, t in us.items():
        kernel = name.split("(")[0].split("<")[0].replace("void ", "")
        if kernel not in kernels:
            raise AssertionError(f"{what}: {name} in the trace is none of its kernels")
        ms += t / max(1, round(ops[name])) * kernels[kernel] / 1e3
    if timing["method"] == "events":
        ms = timing["device_ms"]
    return {"ms": ms, "kernel_launches_per_call": n, "trace_kernel_launches_per_call": trace}


def time_fresh(fn, make_inputs, reps: int) -> dict:
    """Device ms per call of a kernel that changes its inputs: each call
    gets inputs made before the timed region (profiler device time of the
    calls alone, and CUDA events around each)."""
    inputs = [make_inputs() for _ in range(reps + 1)]
    fn(*inputs.pop())
    times = []
    for _ in range(reps):
        args = inputs.pop()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    prof, ops, whole = trace_calls(fn, reps, make_inputs)
    by_name = device_us_per_call(prof, reps)
    out = {"call_ms": statistics.median(times), "device_kernels": sorted(by_name),
           "device_us_per_call": by_name, "device_ops_per_call": ops, "trace_whole": whole}
    if by_name:
        out.update(device_ms=sum(by_name.values()) / 1e3, method="profiler")
    else:
        out.update(device_ms=statistics.median(times), method="events")
    return out


def time_sharded(rng, dev, label, S, cap, L, dc, lanes, n_keys, valid_frac, reps,
                 k9_rounds: bool = False, k9_cold_l2: bool = False) -> dict:
    """Every sharded kernel at one step's shapes: the kernel, its plain
    version, the byte bound; K9, K10's spill and K11 on fresh copies of the
    state they change. K11 is held to its plain version in every mode at
    this table first; with ``k9_rounds`` K9's reported rounds are held to
    its plain version at the merged step; with ``k9_cold_l2`` K9 is timed
    again, each call right after a write of K9_COLD_BYTES of scratch (more
    than the 50 MB L2), as the real step meets it after the exchange."""
    kinds = [k for k, _ in lanes]
    table = empty_table(S, cap, lanes, dev)
    spill = empty_spill(S, 2048, lanes, dev)
    # a table already holding one step's groups, then the step being timed
    for step in range(2):
        key, bins, valid, vals = mesh_rows(rng, S, L, int(L * valid_frac), lanes, n_keys, dev,
                                           bins_range=(step, step + 2))
        u = sharded_kernels.agg_sort_reduce(kinds, key, bins, valid, vals)
        ex = sharded_kernels.shard_exchange(kinds, *u, dc)
        recv = S * dc
        for s_t, m_t in zip((ex.s_key, ex.s_bin, ex.s_valid, *ex.s_accs),
                            (ex.m_key, ex.m_bin, ex.m_valid, *ex.m_accs)):
            all_to_all(s_t, out=m_t[:, :recv])
        c = sharded_kernels.agg_sort_reduce(kinds, ex.m_key, ex.m_bin, ex.m_valid, ex.m_accs)
        if step == 0:
            still = sharded_kernels.agg_probe_merge(kinds, table, *c, 64)
    M = ex.m_key.shape[1]
    E = min(8192, cap)
    segments = int(c[2].sum())
    occupied = int(table[2].sum())
    merged = clone_nested(table)
    still = sharded_kernels.agg_probe_merge(kinds, merged, *c, 64)
    claims = int(merged[2].sum()) - occupied
    rounds = (k9_rounds_check(f"{label}'s merged step", kinds, table, c, 64, dev) if k9_rounds
              else None)
    modes = check_k11_modes(label, table, 0, 1, 1, 8192)
    # the timed extract emits [0, 1) and frees below 1: every freed entry
    # is an emitted one, at most E per shard
    emitted = int((table[2] & (table[1] < 1)).sum(dim=1).clamp(max=E).sum())
    counts = {"merged_valid": int(ex.m_valid.sum()), "segments": segments,
              "local_active": int(u[2].sum()), "still": int(still.sum()),
              "claims": claims, "matches": segments - int(still.sum()) - claims,
              "occupied": occupied, "emitted": emitted, "freed": emitted}
    nbytes = sharded_bytes(lanes, S, L, M, dc, cap, E, counts)
    t = {}

    def row(name, k, p, **extra):
        t[name] = {"ms": k["device_ms"], "plain_ms": p["device_ms"], "library_ms": None,
                   "library": "none: no single PyTorch call computes it",
                   "method": k["method"], "call_ms": k["call_ms"], "plain_call_ms": p["call_ms"],
                   "kernel_names": k["device_kernels"],
                   "trace_whole": k["trace_whole"] and p["trace_whole"],
                   "bound_ms": nbytes[name] / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                   "bytes": nbytes[name], **extra}

    log(f"sharded: time {label}: {counts}")
    merged_call = lambda: sharded_kernels.agg_sort_reduce(kinds, ex.m_key, ex.m_bin,  # noqa: E731
                                                          ex.m_valid, ex.m_accs)
    local_call = lambda: sharded_kernels.agg_sort_reduce(kinds, key, bins, valid, vals)  # noqa: E731
    merged_k, local_k = measure(merged_call, reps), measure(local_call, reps)
    merged_r = k8_launch_report(merged_call, sort_reduce_plan(ex.m_key, ex.m_bin, ex.m_valid),
                                merged_k, f"{label} merged", S, dev)
    local_r = k8_launch_report(local_call, sort_reduce_plan(key, bins, valid), local_k,
                               f"{label} local", S, dev)
    row("agg_sort_reduce", dict(merged_k, device_ms=merged_r["ms"]),
        measure(lambda: sharded_kernels.agg_sort_reduce_plain(kinds, ex.m_key, ex.m_bin,
                                                              ex.m_valid, ex.m_accs), reps),
        rows=[S, M], local_ms=local_r["ms"], local_rows=[S, L],
        us_per_call=merged_k["device_us_per_call"],
        local_us_per_call=local_k["device_us_per_call"], calls=merged_r, local_calls=local_r)
    ex_call = lambda: sharded_kernels.shard_exchange(kinds, *u, dc)  # noqa: E731
    ex_k = measure(ex_call, reps)
    ex_r = library_launch_report(ex_call, sharded_kernels.exchange_kernel_launches, ex_k,
                                 K10_KERNELS, f"K10 at {label}")
    row("shard_exchange", dict(ex_k, device_ms=ex_r["ms"]),
        measure(lambda: sharded_kernels.shard_exchange_plain(kinds, *u, dc), reps),
        rows=[S, L], dest_cap=dc, us_per_call=ex_k["device_us_per_call"], **ex_r,
        bound_flag_only_ms=nbytes["shard_exchange_flag_only"] / HBM_BYTES_PER_S * 1e3,
        bytes_flag_only=nbytes["shard_exchange_flag_only"])
    mk_table = lambda: (clone_nested(table), )
    pm_call = lambda tb: sharded_kernels.agg_probe_merge(kinds, tb, *c, 64)  # noqa: E731
    pm_k = time_fresh(pm_call, mk_table, reps)
    pm_r = library_launch_report(lambda: pm_call(*mk_table()),
                                 sharded_kernels.probe_merge_kernel_launches, pm_k, K9_KERNELS,
                                 f"K9 at {label}")
    row("agg_probe_merge", dict(pm_k, device_ms=pm_r["ms"]),
        time_fresh(lambda tb: sharded_kernels.agg_probe_merge_plain(kinds, tb, *c, 64), mk_table,
                   max(2, reps // 10)),
        partials=[S, M], active=segments, claims=claims, table=[S, cap], rounds=rounds,
        us_per_call=pm_k["device_us_per_call"], cluster=sharded_kernels.probe_merge_cluster(),
        **pm_r)
    if k9_cold_l2:
        scratch = torch.empty(K9_COLD_BYTES, dtype=torch.uint8, device=dev)
        cold = time_fresh(lambda tb: (scratch.fill_(1), pm_call(tb)), mk_table, reps)
        k9_us = [v for n, v in cold["device_us_per_call"].items() if n.startswith("pm_cluster")]
        t["agg_probe_merge"]["cold_l2"] = {
            "ms": sum(k9_us) / 1e3 if k9_us else None, "scratch_bytes": K9_COLD_BYTES,
            "method": cold["method"], "us_per_call": cold["device_us_per_call"]}
        del scratch
    mk_spill = lambda: (clone_nested(spill), )
    sp_state = sharded_kernels.spill_scratch(S, M, dev)
    sp_call = lambda sp: sharded_kernels.shard_spill(kinds, c[0], c[1], c[3], still, sp,  # noqa: E731
                                                     sp_state)
    sp_k = time_fresh(sp_call, mk_spill, reps)
    sp_r = library_launch_report(lambda: sp_call(*mk_spill()),
                                 sharded_kernels.spill_kernel_launches, sp_k, K10_SPILL_KERNELS,
                                 f"K10's spill at {label}")
    row("shard_spill", dict(sp_k, device_ms=sp_r["ms"]),
        time_fresh(lambda sp: sharded_kernels.shard_spill_plain(kinds, c[0], c[1], c[3], still,
                                                                sp), mk_spill, reps),
        rows=[S, M], still=int(still.sum()), us_per_call=sp_k["device_us_per_call"], **sp_r)
    row("shard_extract",
        time_fresh(lambda tb: sharded_kernels.shard_extract(tb, 0, 1, 1, 8192), mk_table, reps),
        time_fresh(lambda tb: sharded_kernels.shard_extract_plain(tb, 0, 1, 1, 8192), mk_table,
                   reps),
        table=[S, cap], emit_cap=E, emitted=emitted, modes=modes,
        kernel_launches_per_call=modes["default"]["kernel_launches_per_call"])
    if k9_rounds:
        # where K11's time goes, freeing nothing: the rows past the emitting
        # ones as zeros, as none (emit_cap below the emitting slots), and an
        # empty range (every row a non-emitting slot's)
        i32min = hash_kernels.I32_MIN
        t["shard_extract"]["variants_ms"] = {
            what: measure(lambda: sharded_kernels.shard_extract(table, lo, hi, i32min, e, zt),
                          reps)["device_ms"]
            for what, lo, hi, e, zt in (("default", 0, 1, 8192, False),
                                        ("zero_tail", 0, 1, 8192, True),
                                        ("emit_cap 256", 0, 1, 256, False),
                                        ("empty range", 5, 5, 8192, False))}
    t["counts"] = counts
    return t


def sharded_phase(dev) -> dict:
    """K8-K11 against their plain versions on the card, exactly, at q7m's
    shapes, at a deployment state and on edge cases; then timed."""
    rng = np.random.default_rng(20261017)
    cases, checks = sharded_cases(rng, dev)
    log("sharded: K8 edge cases")
    k8_library_matches_plan()
    k8_cases = [check_sort_reduce_case(c, dev) for c in sort_reduce_edge_cases(rng)]
    log("sharded: K10 and K9 edge cases")
    for S, L in ((1, 1), (8, 8192), (32, 1025)):
        words = build_library_words(S, L)
        if words != int(np.prod(sharded_kernels.exchange_scratch(S, L)["counts"][0])):
            raise AssertionError(f"K10's counts scratch at {S} x {L}: the library wants {words}")
    for B in (1, 16, 17, 139264):
        got = sharded_kernels.build_library().arroyo_agg_probe_merge_list_len(B)
        if got != sharded_kernels.probe_merge_scratch(1, B, 1)["list"][0][2]:
            raise AssertionError(f"K9's list for {B} partials: the library wants {got}")
    for S, M in ((1, 1), (8, 139264), (3, 8199), (32, 1000)):
        got = sharded_kernels.build_library().arroyo_shard_spill_scratch_bytes(S, M)
        if got != sharded_kernels.spill_scratch_bytes(S, M):
            raise AssertionError(f"K10's spill state at {S} x {M}: the library wants {got}")
    log("sharded: K10's spill edge cases")
    spill_checked = [check_spill_case(c, dev) for c in spill_cases(rng)]
    k10_cases = [check_exchange_case(c, dev) for c in exchange_cases(rng)]
    k9_cases = [check_probe_case(c, dev) for c in probe_cases(rng, hot=4096, hot_shards=(1, 32))]
    timing = {
        "q7m": time_sharded(rng, dev, "q7m fused", MESH_N, 65536, 8192,
                            BENCH_BATCH // (MESH_N // 2), Q7M_LANES, 60000, 0.94, TIMING_REPS,
                            k9_rounds=True, k9_cold_l2=True),
        # bench.py --mesh-ab's shape: 8 shards, table 8192, batch capacity
        # 2048 (a quarter of it valid: 4096-row source batches over 8 shards)
        "mesh_ab": time_sharded(rng, dev, "mesh_ab", MESH_N, MESH_AB["device.table-capacity"],
                                MESH_AB["device.batch-capacity"],
                                MESH_AB["device.batch-capacity"] // (MESH_N // 2), MESH_AB_LANES,
                                MESH_AB_KEYS, MESH_AB_BATCH / MESH_N
                                / MESH_AB["device.batch-capacity"], TIMING_REPS, k9_rounds=True),
        "deployment": time_sharded(rng, dev, "deployment", MESH_N, 1 << 20, 65536, 16384,
                                   DEPLOY_LANES, 1 << 22, 1.0, 3),
    }
    info = {"phase": "sharded",
            "cases_checked": len(cases) + len(k8_cases) + len(k10_cases) + len(k9_cases)
            + len(spill_checked),
            "max_abs_err": 0.0, "cases": cases, "k8_cases": k8_cases, "k10_cases": k10_cases,
            "spill_cases": spill_checked,
            "k9_cases": k9_cases, "shapes_checked": checks, "timing": timing}
    emit(info)
    return info


# ---------------------------------------------------------------- hash_agg (B9)

HASH_SOURCE = "arroyo_tpu_torch/csrc/hash_agg.cu"
# the kernels of the single-device table's path: K8, K9 and K11 at one shard
# (q7's tumbling closes), K12 and K13 (q5's hop windows)
HASH_Q7_KERNELS = ("agg_sort_reduce", "agg_probe_merge", "shard_extract")
HASH_HOP_KERNELS = ("shard_extract", "hash_scan_walk", "hash_free")
HASH_PATH_KERNELS = HASH_Q7_KERNELS + HASH_HOP_KERNELS
# q7 through the table at bench.py's table, batch and emit sizes
Q7_HASH = dict(cap=65536, batch_cap=BENCH_BATCH, max_probes=64, emit_cap=8192)
# q5's hop windows through the table: a 5-bin scan holds ~1600 entries, more
# than emit_cap, so most windows' reads fall back from the packed scan (K11)
# to K12's walk of the table (before the walk: 32 chunks of emit_cap slots);
# a 65536-event batch opens ~33 bins before the first of them closes
HOP_HASH = dict(cap=32768, batch_cap=BENCH_BATCH, max_probes=64, emit_cap=1024)
HOP_EVENTS = Q7_EVENTS // 4  # 250 windows
# a deployment state: 4,194,304 entries x (8 + 4 + 1 + 5 x 8) B = 222 MB
HASH_DEPLOY = dict(cap=1 << 22, batch_cap=1 << 20, max_probes=64, emit_cap=8192)
HASH_DEPLOY_LANES = DEPLOY_LANES  # 4 int64 lanes and a float64 sum


# the table reads' cases (K11 in each mode, K12 in both), shared with
# tests/test_torch_table_reads.py: every lane dtype, floats holding quiet
# NaNs with payloads and both zeros
TABLE_READ_LANES = [("sum", np.int32), ("sum", np.int64), ("max", np.uint64),
                    ("min", np.float32), ("sum", np.float64)]
TABLE_READ_CAP = 512


def table_lane(rng, dt, shape) -> np.ndarray:
    dt = np.dtype(dt)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, shape, dtype=dt, endpoint=True)
    v = np.round(rng.normal(0, 100, shape), 3).astype(dt)
    bits = v.view(np.uint32 if dt.itemsize == 4 else np.uint64)
    quiet = (0x7FC00000, 0x3FFFFF) if dt.itemsize == 4 else (0x7FF8000000000000, (1 << 51) - 1)
    pick = rng.random(shape)
    payload = rng.integers(0, quiet[1], shape, dtype=np.int64, endpoint=True)
    nan = (np.uint64(quiet[0]) | payload.astype(np.uint64)).astype(bits.dtype)
    bits[pick < 0.05] = nan[pick < 0.05]
    bits[(pick >= 0.05) & (pick < 0.1)] |= bits.dtype.type(1 << (8 * dt.itemsize - 1))  # sign
    v[(pick >= 0.1) & (pick < 0.15)] = -0.0
    v[(pick >= 0.15) & (pick < 0.2)] = 0.0
    return v


def table_arrays(rng, S, cap, occupied=0.6, n_bins=4, emitting=None,
                 lanes=TABLE_READ_LANES) -> list:
    """An [S, cap] table as numpy arrays [keys int64, bins int32, occ bool,
    [lanes]]: a share ``occupied`` of the slots occupied, bins in [0,
    n_bins), every slot holding a key, bin and lanes (the stale ones of a
    freed slot). ``emitting = (lo, hi, m)``: exactly m occupied slots of
    each shard have a bin in [lo, hi)."""
    keys = table_lane(rng, np.int64, (S, cap))
    bins = rng.integers(0, n_bins, (S, cap)).astype(np.int32)
    occ = rng.random((S, cap)) < occupied
    if emitting is not None:
        lo, hi, m = emitting
        bins[occ & (bins >= lo) & (bins < hi)] = hi
        for s in range(S):
            pick = rng.choice(cap, m, replace=False)
            occ[s, pick] = True
            bins[s, pick] = rng.integers(lo, hi, m)
    return [keys, bins, occ, [table_lane(rng, dt, (S, cap)) for _k, dt in lanes]]


def table_read_cases(rng, S: int) -> list:
    """K11's cases at S shards of TABLE_READ_CAP slots (and a 4-tile and a
    sub-run table): one read (emit_lo, emit_hi, free_below, emit_cap) of a
    fresh table each."""
    cap = TABLE_READ_CAP
    t = lambda **kw: table_arrays(rng, S, cap, **kw)  # noqa: E731
    return [
        dict(label="E below total (drain rounds)", table=t(occupied=0.7), read=(0, 3, 2, 64)),
        dict(label="E equal to total", table=t(emitting=(1, 3, 64)), read=(1, 3, 2, 64)),
        dict(label="E above total", table=t(occupied=0.3), read=(1, 2, 1, cap)),
        dict(label="free_below inside the range", table=t(), read=(0, 4, 2, cap)),
        dict(label="free_below above the range", table=t(), read=(1, 2, 3, cap)),
        dict(label="free_below below the range", table=t(), read=(2, 4, 1, cap)),
        dict(label="empty range (frees only)", table=t(), read=(3, 3, 3, 64)),
        dict(label="every slot emitting", table=t(occupied=1.0), read=(0, 4, 0, cap)),
        dict(label="every slot emitting, E below", table=t(occupied=1.0), read=(0, 4, 4, 100)),
        dict(label="emit_cap above cap", table=t(occupied=0.4), read=(0, 2, 1, 2 * cap)),
        dict(label="fill rows across tiles", read=(0, 1, 1, 9000),
             table=table_arrays(rng, S, 16384, occupied=0.5)),
        dict(label="8 slots a shard", table=table_arrays(rng, S, 8), read=(0, 2, 1, 8)),
    ]


def walk_cases(rng) -> list:
    """K12's walk cases (one shard): the reference's chunk loop at an
    emit_cap dividing cap and one not dividing it, an empty range, every
    slot in range, and more than one tile."""
    part = table_arrays(rng, 1, 4096)
    full = table_arrays(rng, 1, 4096, occupied=1.0)
    big = table_arrays(rng, 1, 16384, occupied=0.5)
    return [dict(label=f"{what}, emit_cap {e}", table=tb, lo=lo, hi=hi, emit_cap=e)
            for what, tb, lo, hi in (("part of the range", part, 1, 3),
                                     ("empty range", part, 2, 2),
                                     ("every slot in range", full, 0, 4),
                                     ("4 tiles", big, 0, 2))
            for e in (1024, 1000)]


def torch_table(arrays, dev, one_shard: bool = False):
    """A table_arrays table as torch tensors on ``dev`` ([cap] each with
    one_shard, else [S, cap]), copies: the reads free in place."""
    keys, bins, occ, lanes = arrays
    t = lambda a: torch.from_numpy(np.array(a[0] if one_shard else a)).to(dev)  # noqa: E731
    return (t(keys), t(bins), t(occ), [t(a) for a in lanes])


def check_k11_modes(label: str, table, lo: int, hi: int, below: int, emit_cap: int) -> dict:
    """K11 in each mode on a clone of ``table`` ([S, cap]) against its plain
    version on another clone, every output and the occupancy exact: the
    default mode freeing below ``below``, zero_tail freeing below it (B9's
    extract, with an overflow counter) and zero_tail freeing nothing (B9's
    scan_packed). Each call's kernel launches come from the library."""
    S = table[0].shape[0]
    out = {"label": label, "shards": S, "cap": table[0].shape[1], "emit_cap": emit_cap,
           "read": [lo, hi, below]}
    for mode, zt, fb in (("default", False, below), ("zero_tail", True, below),
                         ("zero_tail scan", True, hash_kernels.I32_MIN)):
        oflow = (torch.arange(S, dtype=torch.int32, device=table[0].device) + 5) if zt else None
        tk, tp = clone_nested(table), clone_nested(table)
        before = sharded_kernels.extract_kernel_launches()
        got = sharded_kernels.shard_extract(tk, lo, hi, fb, emit_cap, zt, oflow)
        torch.cuda.synchronize()
        n = sharded_kernels.extract_kernel_launches() - before
        want = sharded_kernels.shard_extract_plain(tp, lo, hi, fb, emit_cap, zt, oflow)
        require_same(f"shard_extract ({mode}) at {label}", [*extracted(got), tk[2]],
                     [*extracted(want), tp[2]])
        if n != 1:
            raise AssertionError(f"shard_extract ({mode}) at {label}: {n} kernel launches")
        out[mode] = {"emitting": int(got.total.sum()), "kernel_launches_per_call": n,
                     "freed": int(table[2].sum()) - int(tk[2].sum())}
    return out


def check_k12(label: str, table, lo: int, hi: int, emit_cap: int) -> dict:
    """K12 on a one-shard table ([cap] tensors): the walk against its plain
    version (count and rows), every chunk of the one-chunk mode against its
    plain version, and the walk against the chunks' valid rows concatenated
    (the reference's loop over ``scan``, here on the card), exactly."""
    cap = table[0].shape[0]
    n = int((table[2] & (table[1] >= lo) & (table[1] < hi)).sum())
    got = hash_kernels.hash_scan_walk(table, lo, hi, n)
    want = hash_kernels.hash_scan_walk_plain(table, lo, hi, n)
    require_same(f"hash_scan_walk at {label}", [got.count, got.key, got.bin, got.accs],
                 [want.count, want.key, want.bin, want.accs])
    parts = []
    for chunk in range(0, cap, emit_cap):
        c = hash_kernels.hash_scan_chunk(table, lo, hi, chunk, emit_cap)
        require_same(f"hash_scan_chunk at {label}", extracted(c),
                     extracted(hash_kernels.hash_scan_chunk_plain(table, lo, hi, chunk,
                                                                  emit_cap)))
        v = c.valid[0]
        parts.append([c.key[0][v], c.bin[0][v]] + [sharded_kernels.bits(a[0])[v] for a in c.accs])
    loop = [torch.cat(p) for p in zip(*parts)]
    require_same(f"hash_scan_walk against the chunk loop at {label}",
                 [got.key, got.bin, [sharded_kernels.bits(a) for a in got.accs]],
                 [loop[0], loop[1], loop[2:]])
    torch.cuda.synchronize()
    return {"label": label, "cap": cap, "emit_cap": emit_cap, "rows": n, "chunks": len(parts)}


def table_read_phase(dev) -> dict:
    """K11 in every mode and K12 in both on the shared edge cases (every
    lane dtype, NaN payloads, -0.0), at 1 and 8 shards for K11."""
    rng = np.random.default_rng(20261019)
    out = []
    for S in (1, 8):
        for c in table_read_cases(rng, S):
            out.append(check_k11_modes(f"{c['label']}, {S} shards", torch_table(c["table"], dev),
                                       *c["read"]))
    for c in walk_cases(rng):
        out.append(check_k12(c["label"], torch_table(c["table"], dev, one_shard=True), c["lo"],
                             c["hi"], c["emit_cap"]))
    info = {"phase": "table_reads", "cases_checked": len(out), "cases": out}
    emit(info)
    return info


def k9_rounds_check(what: str, kinds, table, u, max_probes: int, dev) -> dict:
    """K9 on a clone of ``table``, then the rounds it reports per shard
    (``sharded_kernels.probe_merge_rounds``) held to its plain version: the
    partials still active after r rounds (max_probes = r) equal the
    reported count at the start of round r, for every r the kernel ran and
    one more."""
    S = table[0].shape[0]
    sharded_kernels.agg_probe_merge(kinds, clone_nested(table), *u, max_probes)
    rep = sharded_kernels.probe_merge_rounds(S, dev)
    for r in range(max(rep["rounds"]) + 1):
        still = sharded_kernels.agg_probe_merge_plain(kinds, clone_nested(table), *u, r)
        want = still.sum(dim=1).tolist()
        got = [a[min(r, len(a) - 1)] for a in rep["active"]]
        if got != want:
            raise AssertionError(f"K9's rounds at {what}: round {r} reports {got} active, "
                                 f"the plain version leaves {want}")
    rounds = rep["rounds"]
    return {"rounds": rounds, "active": rep["active"], "max_rounds": max(rounds),
            "mean_rounds": statistics.fmean(rounds)}


def hash_launch_counts() -> dict:
    return {**sharded_kernels.launch_counts(), **hash_kernels.launch_counts()}


def reset_hash_launch_counts() -> None:
    sharded_kernels.reset_launch_counts()
    hash_kernels.reset_launch_counts()


def bid_batches(events: int, bin_width: int) -> list:
    """q7's bids per source batch of BENCH_BATCH events, from the port's
    generator: (auction key hash uint64, auction, price, absolute bin, the
    batch's largest event time)."""
    b = nexmark_columns(events, ["bid.auction", "bid.price"], 1000)
    out = []
    for lo in range(0, events, BENCH_BATCH):
        sl = slice(lo, lo + BENCH_BATCH)
        m = b["bid"][sl]
        auc = b["bid.auction"][sl][m]
        ts = b[TIMESTAMP_FIELD][sl]
        out.append((hash_columns([auc]), auc, b["bid.price"][sl][m], ts[m] // bin_width,
                    int(ts.max())))
    return out


def drive_tumbling(agg, batches, lanes_of) -> tuple[int, list]:
    """The table as a tumbling window's store: each batch updates it, and
    every 10 s window the stream has passed closes through extract_start;
    a close's rows are read back after the next update (pipelined as the
    window operator pipelines them). Returns (base bin, closes)."""
    from arroyo_tpu_torch.ops.aggregate import ReadyHandle

    base = int(batches[0][3].min())
    closed_below, pending, closes = 0, [], []
    for keys, auc, price, bins_abs, wm in batches:
        agg.update(keys, (bins_abs - base).astype(np.int32), lanes_of(auc, price))
        closes += [h.result() for h in pending]
        pending = []
        below = wm // WIDTH - base
        if below > closed_below:
            pending.append(agg.extract_start(closed_below, below, below) if agg.backend == "jax"
                           else ReadyHandle(agg.extract(closed_below, below, below)))
            closed_below = below
    closes += [h.result() for h in pending]
    closes.append(agg.extract(closed_below, 1 << 30, 1 << 30))
    torch.cuda.synchronize()
    return base, closes


def q7_windows(base: int, closes: list, auction_of: dict) -> dict:
    """(window_start, auction) -> (max, count) of the closes' rows; raises
    on a window emitted twice."""
    got = {}
    for k, b, (mx, cnt) in closes:
        for kk, bb, m, c in zip(k.tolist(), b.tolist(), mx.tolist(), cnt.tolist()):
            w = ((bb + base) * WIDTH, auction_of[kk])
            if w in got:
                raise AssertionError(f"hash_agg: window {w} emitted twice")
            got[w] = (m, c)
    return got


def drive_hop(agg, batches, finish: bool = True) -> list:
    """The table as a hop window's store (q5: 10 s windows every 2 s over
    2 s bins): each closing window is one scan_range of its 5 bins,
    combined by key, then the bins behind the next window are freed.
    Returns [(window start bin, keys, counts)]; with ``finish`` False the
    windows still open at the end stay in the table."""
    from arroyo_tpu_torch.ops.aggregate import combine_by_key

    nb = WIDTH // SLIDE
    base = int(batches[0][3].min())
    nxt, top, out = None, 0, []

    def close_through(last):
        nonlocal nxt
        while nxt <= last:
            k, _b, accs = agg.scan_range(nxt, nxt + nb)
            k, (cnt,) = combine_by_key(("count",), k, accs)
            out.append((nxt + base, k, cnt))
            nxt += 1
            agg.free_bins_below(nxt)

    for keys, _auc, _price, bins_abs, wm in batches:
        rel = (bins_abs - base).astype(np.int32)
        agg.update(keys, rel, [np.ones(len(keys), dtype=np.int64)])
        top = max(top, int(rel.max()))
        if nxt is None:
            nxt = int(rel.min()) - nb + 1
        close_through((wm - WIDTH) // SLIDE - base)
    if finish:
        close_through(top)
    torch.cuda.synchronize()
    return out


class ChunkLoopAggregator(DeviceHashAggregator):
    """A DeviceHashAggregator whose scan_range reads as it did before K12's
    walk: past emit_cap rows, one K12 chunk and one host fetch per emit_cap
    slots of the table (the reference's loop, aggregate.py:752-762). The
    hop drive's "before" beside the walk, on the same card."""

    def scan_range(self, emit_lo, emit_hi):
        from arroyo_tpu_torch.ops import prefetch

        packed = hash_kernels.scan_packed(self._ops, self.state, emit_lo, emit_hi, self.emit_cap)
        k, b, accs, total = self._unpack(prefetch.HostFetch(packed.packed).result())
        if total <= self.emit_cap:
            return combine_by_key_bin(self.acc_kinds, k, b, accs)
        parts = []
        for chunk in range(0, self.cap, self.emit_cap):
            out = self._ops.scan_chunk(self.state[:4], emit_lo, emit_hi, chunk, self.emit_cap)
            k, b, v, accs, _t = sharded_kernels.unpack_extracted(
                prefetch.HostFetch(out.packed).result(), 1, self.emit_cap, self.acc_dtypes)
            v = v[0]
            if v.any():
                parts.append([k[0][v], b[0][v]] + [a[0][v] for a in accs])
        cat = [np.concatenate(p) for p in zip(*parts)]
        return combine_by_key_bin(self.acc_kinds, cat[0].view(np.uint64), cat[1], cat[2:])


@contextlib.contextmanager
def counted_fetches():
    """While open, every HostFetch result the port reads is counted in the
    list it yields ([n])."""
    from arroyo_tpu_torch.ops import prefetch

    real, n = prefetch.HostFetch, [0]

    class Counted(real):
        def result(self):
            n[0] += 1
            return super().result()

    prefetch.HostFetch = Counted
    try:
        yield n
    finally:
        prefetch.HostFetch = real


def hop_drive_ab(dev, batches, auction_of, want) -> dict:
    """The hop drive unchecked, wall to wall, with scan_range through K12's
    walk and through the chunk loop it replaced (ChunkLoopAggregator), in
    the order loop, walk, walk, loop: per drive its wall, events/s, K11,
    K12 (walk, chunk) and K13 launches and the host fetches it read."""
    out = {"walk": [], "chunk loop": []}
    for name in ("chunk loop", "walk", "walk", "chunk loop"):
        cls = DeviceHashAggregator if name == "walk" else ChunkLoopAggregator
        agg = cls(("count",), (np.int64,), backend="jax", device=dev, **HOP_HASH)
        reset_hash_launch_counts()
        torch.cuda.synchronize()
        with counted_fetches() as fetches:
            t0 = time.perf_counter()
            res = drive_hop(agg, batches)
            wall = time.perf_counter() - t0
        n = check_hop(res, auction_of, want)
        got = hash_launch_counts()
        scans = len(res)
        fallbacks = got["hash_scan_walk"] + got["hash_scan_chunk"] // -(-HOP_HASH["cap"]
                                                                         // HOP_HASH["emit_cap"])
        out[name].append({
            "wall_s": wall, "events_per_s": HOP_EVENTS / wall, "rows": n, "scans": scans,
            "falling_back_scans": fallbacks, "host_fetches": fetches[0],
            "host_fetches_per_falling_back_scan": (fetches[0] - scans) / max(fallbacks, 1) + 1,
            "launches": {k: got[k] for k in ("shard_extract", "hash_scan_walk",
                                             "hash_scan_chunk", "hash_free", "agg_sort_reduce",
                                             "agg_probe_merge")}})
    return out


def check_hop(out: list, auction_of: dict, want: dict) -> int:
    got = {}
    for wb, k, cnt in out:
        for kk, c in zip(k.tolist(), cnt.tolist()):
            w = (wb * SLIDE, auction_of[kk])
            if w in got:
                raise AssertionError(f"hash_agg hop: window {w} emitted twice")
            got[w] = c
    if got != want:
        diff = next(iter(set(got.items()) ^ set(want.items())), None)
        raise AssertionError(f"hash_agg hop parity failure: {len(got)} vs {len(want)}; {diff}")
    return len(got)


def extracted(out) -> list:
    """The parts of a packed extract buffer (its alignment padding is not
    written)."""
    return [out.key, out.bin, out.valid, out.accs, out.total] + (
        [] if out.oflow is None else [out.oflow])


def checked_ops(checks: dict, rounds: list = None) -> hash_kernels.Ops:
    """B9's functions with every kernel held against its plain version on
    the same inputs, exactly (stateful ones on clones of the table and
    the overflow counter); the kernels' outputs carry on. ``checks``
    counts the comparisons per kernel; ``rounds``, when given, takes what
    each K9 call reports of its rounds (``probe_merge_rounds``)."""
    P = hash_kernels.PLAIN

    def note(name):
        checks[name] = checks.get(name, 0) + 1

    def sort_reduce(kinds, key, bins, valid, vals, off=0, n_valid=None):
        got = sharded_kernels.agg_sort_reduce(kinds, key, bins, valid, vals, off, n_valid)
        require_same("agg_sort_reduce", got, P.sort_reduce(kinds, key, bins, valid, vals, off,
                                                           n_valid))
        note("agg_sort_reduce")
        return got

    def probe_merge(kinds, table, u_key, u_bin, active, u_accs, max_probes, oflow=None):
        tp, op = clone_nested(table), None if oflow is None else oflow.clone()
        still = sharded_kernels.agg_probe_merge(kinds, table, u_key, u_bin, active, u_accs,
                                                max_probes, oflow)
        if rounds is not None:
            rounds.append(sharded_kernels.probe_merge_rounds(1, u_key.device))
        still_p = P.probe_merge(kinds, tp, u_key, u_bin, active, u_accs, max_probes, op)
        require_same("agg_probe_merge", [still, *table[:3], table[3]] + ([oflow] if op is not None else []),
                     [still_p, *tp[:3], tp[3]] + ([op] if op is not None else []))
        note("agg_probe_merge")
        return still

    def extract(table, lo, hi, below, emit_cap, zero_tail=False, oflow=None):
        tp = clone_nested(table)
        got = sharded_kernels.shard_extract(table, lo, hi, below, emit_cap, zero_tail, oflow)
        want = P.extract(tp, lo, hi, below, emit_cap, zero_tail, oflow)
        require_same("shard_extract (one shard)", [*extracted(got), table[2]],
                     [*extracted(want), tp[2]])
        note("shard_extract")
        return got

    def scan_chunk(table, lo, hi, chunk, emit_cap):
        got = hash_kernels.hash_scan_chunk(table, lo, hi, chunk, emit_cap)
        require_same("hash_scan_chunk", extracted(got),
                     extracted(P.scan_chunk(table, lo, hi, chunk, emit_cap)))
        note("hash_scan_chunk")
        return got

    def scan_walk(table, lo, hi, total):
        got = hash_kernels.hash_scan_walk(table, lo, hi, total)
        want = P.scan_walk(table, lo, hi, total)
        require_same("hash_scan_walk", [got.count, got.key, got.bin, got.accs],
                     [want.count, want.key, want.bin, want.accs])
        note("hash_scan_walk")
        return got

    def free(table, below):
        occ_p = table[2].clone()
        hash_kernels.hash_free(table, below)
        P.free((table[0], table[1], occ_p, table[3]), below)
        require_same("hash_free", [table[2]], [occ_p])
        note("hash_free")

    return hash_kernels.Ops(sort_reduce, probe_merge, extract, scan_chunk, scan_walk, free)


def make_hash_agg(kinds, dtypes, sizes, dev, ops=None, backend="jax"):
    """A DeviceHashAggregator on ``dev`` (backend "numpy": the host store),
    running ``ops`` (hash_kernels.KERNELS unless given)."""
    agg = DeviceHashAggregator(kinds, dtypes, backend=backend,
                               **({"device": dev} if backend == "jax" else {}), **sizes)
    if ops is not None:
        agg._ops = ops
    return agg


def same_rows(label: str, got, want) -> None:
    """Two (keys, bins, accs) results equal: dtypes and bytes, in order."""
    (kg, bg, ag), (kw, bw, aw) = got, want
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    require_same(label, [t(kg), t(bg)] + [t(a) for a in ag], [t(kw), t(bw)] + [t(a) for a in aw])


def hash_edge_cases(dev, checks: dict) -> list:
    """The table's edge cases, every kernel checked against its plain
    version; the results against the host store (dicts: the two emit in
    different orders) or as each case expects."""
    rng = np.random.default_rng(20261017)
    ops = checked_ops(checks)
    out = []

    def both(kinds, dtypes, sizes):
        return (make_hash_agg(kinds, dtypes, sizes, dev, ops), make_hash_agg(kinds, dtypes, sizes, dev,
                                                                   backend="numpy"))

    def as_dict(k, b, accs):
        return {(int(x), int(y)): tuple(a[i].tobytes() for a in accs)
                for i, (x, y) in enumerate(zip(k.tolist(), b.tolist()))}

    def agree(label, a, o, *args, method="extract"):
        got, want = getattr(a, method)(*args), getattr(o, method)(*args)
        if as_dict(*got) != as_dict(*want):
            raise AssertionError(f"hash_agg {label}: the table's {method} differs from the "
                                 f"host store's")
        return len(got[0])

    one = lambda n: [np.ones(n, dtype=np.int64)]  # noqa: E731
    # 1. overflow: 200 groups into 64 slots, 8 probes, raises at the extract
    a = make_hash_agg(("count",), (np.int64,), dict(cap=64, batch_cap=256, max_probes=8, emit_cap=64),
                 dev, ops)
    a.update(np.arange(200, dtype=np.uint64), np.zeros(200, np.int32), one(200))
    try:
        a.extract(0, 1, 1)
        raise AssertionError("hash_agg overflow: the extract did not raise")
    except RuntimeError as e:
        if "overflow" not in str(e):
            raise
    out.append({"label": "overflow raises at extract", "overflow": int(a.state[4][0])})
    # 2. emit_cap chunking: 500 groups drained in rounds of 64
    a, o = both(("count",), (np.int64,), dict(cap=2048, batch_cap=512, max_probes=64, emit_cap=64))
    for x in (a, o):
        x.update(np.arange(500, dtype=np.uint64), np.zeros(500, np.int32), one(500))
    out.append({"label": "emit_cap chunking", "rows": agree("chunking", a, o, 0, 1, 1)})
    # 3. emit_cap 48 on cap 64: scans of 40 (packed) and 60 entries (K12 chunks)
    a, o = both(("count",), (np.int64,), dict(cap=64, batch_cap=64, max_probes=64, emit_cap=48))
    for x in (a, o):
        x.update(np.arange(40, dtype=np.uint64), np.zeros(40, np.int32), one(40))
    n40 = agree("emit 48 of 64", a, o, 0, 1, method="scan_range")
    for x in (a, o):
        x.update(np.arange(40, 60, dtype=np.uint64), np.zeros(20, np.int32), one(20))
    n60 = agree("emit 48 of 64", a, o, 0, 1, method="scan_range")
    a.free_bins_below(1)
    if n40 != 40 or n60 != 60 or len(a.scan_range(0, 1)[0]):
        raise AssertionError(f"hash_agg emit 48 of 64: {n40}, {n60}")
    out.append({"label": "emit_cap 48 on cap 64", "rows": [n40, n60]})
    # 4. probe holes after frees: interleaved updates and closes
    a, o = both(("count",), (np.int64,), dict(cap=256, batch_cap=128, max_probes=256, emit_cap=64))
    emitted = 0
    for step in range(30):
        keys = rng.integers(0, 40, 100).astype(np.uint64)
        bins = rng.integers(step // 3, step // 3 + 3, 100).astype(np.int32)
        for x in (a, o):
            x.update(keys, bins, one(100))
        if step % 3 == 2:
            emitted += agree("probe holes", a, o, 0, step // 3 + 1, step // 3 + 1)
    emitted += agree("probe holes", a, o, 0, 1 << 30, 1 << 30)
    out.append({"label": "probe holes after frees", "rows": emitted})
    # 5. key INT64_MAX in bin INT32_MAX, a uint64 lane, NaN and -0.0 under min/max
    kinds = ("count", "max", "min", "max", "sum")
    dts = (np.int64, np.uint64, np.float64, np.float32, np.float64)
    a, o = both(kinds, dts, dict(cap=1024, batch_cap=256, max_probes=64, emit_cap=128))
    for step in range(4):
        n = 300
        keys = rng.integers(0, 90, n).astype(np.uint64)
        keys[:7] = np.uint64(np.iinfo(np.int64).max)
        bins = rng.integers(0, 3, n).astype(np.int32)
        bins[:7] = np.iinfo(np.int32).max
        vals = [np.ones(n, np.int64), (rng.integers(-9, 9, n).astype(np.int64) << 60).view(np.uint64)]
        for dt in (np.float64, np.float32):
            v = np.round(rng.normal(0, 10, n), 1).astype(dt)
            pick = rng.random(n)
            v[pick < 0.1] = -0.0
            v[(pick >= 0.1) & (pick < 0.2)] = 0.0
            v[(pick >= 0.2) & (pick < 0.21)] = np.nan
            vals.append(v)
        vals.append(np.round(rng.normal(0, 10, n), 2))
        for x in (a, o):
            x.update(keys, bins, vals)
    snap = a.snapshot()
    if as_dict(*snap)[(np.iinfo(np.int64).max, np.iinfo(np.int32).max)][0] != \
            np.int64(28).tobytes():
        raise AssertionError("hash_agg: key INT64_MAX in bin INT32_MAX lost rows")
    # the host store's float min/max follow Python's min/max (NaN and -0.0
    # in arrival order) and it sums in another order: the table's float
    # lanes are held to the plain versions above; against the host store
    # the count and uint64 lanes exactly, the sum within rtol 1e-12
    got, want = a.scan_range(0, 3), o.scan_range(0, 3)
    gd, wd = as_dict(*got), as_dict(*want)
    if set(gd) != set(wd) or any(gd[k][:2] != wd[k][:2] for k in gd):
        raise AssertionError("hash_agg: the count or uint64 lane differs from the host store")
    gs = dict(zip(zip(got[0].tolist(), got[1].tolist()), got[2][4].tolist()))
    ws = dict(zip(zip(want[0].tolist(), want[1].tolist()), want[2][4].tolist()))
    if any(abs(gs[k] - ws[k]) > 1e-12 * max(abs(ws[k]), 1.0) for k in gs):
        raise AssertionError("hash_agg: the float sum lane differs from the host store")
    out.append({"label": "INT64_MAX key in INT32_MAX bin, uint64 lane, NaN / -0.0",
                "entries": len(snap[0])})
    # 6. restore / snapshot round trips: a fresh table from the snapshot
    b2 = make_hash_agg(kinds, dts, dict(cap=1024, batch_cap=256, max_probes=64, emit_cap=128), dev, ops)
    b2.restore(*snap)
    if as_dict(*b2.snapshot()) != as_dict(*snap):
        raise AssertionError("hash_agg: restore then snapshot does not round-trip")
    o2 = make_hash_agg(kinds, dts, {}, dev, backend="numpy")
    o2.restore(*o.snapshot())
    same_rows("host store restore", o2.snapshot(), o.snapshot())
    out.append({"label": "restore / snapshot round trips", "entries": len(snap[0])})
    # 7. a hot key of ~6,000 rows a batch with float sums, NaN and -0.0 in
    # min/max: K8 at one shard reduces it by a warp from shared memory
    # (batch_cap 8192) and by a block after the onesweep passes (16384,
    # 12,000 rows)
    for batch_cap, n in ((8192, 8192), (16384, 12_000)):
        hk = ("sum", "sum", "min", "max", "count")
        hd = (np.float64, np.float32, np.float64, np.float32, np.int64)
        ha, ho = both(hk, hd, dict(cap=4096, batch_cap=batch_cap, max_probes=64, emit_cap=4096))
        for step in range(2):
            keys = np.where(rng.random(n) < 0.7, 12345, rng.integers(0, 500, n)).astype(np.uint64)
            bins = rng.integers(step, step + 2, n).astype(np.int32)
            vals = [np.round(rng.normal(0, 1e3, n), 3),
                    np.round(rng.normal(0, 1e3, n), 3).astype(np.float32)]
            for dt in (np.float64, np.float32):
                v = np.round(rng.normal(0, 10, n), 1).astype(dt)
                pick = rng.random(n)
                v[pick < 0.1] = -0.0
                v[(pick >= 0.1) & (pick < 0.2)] = 0.0
                v[(pick >= 0.2) & (pick < 0.201)] = np.nan
                vals.append(v)
            vals.append(np.ones(n, np.int64))
            for x in (ha, ho):
                x.update(keys, bins, vals)
        got, want = ha.scan_range(0, 3), ho.scan_range(0, 3)
        gd, wd = as_dict(*got), as_dict(*want)
        if set(gd) != set(wd) or any(gd[k][4] != wd[k][4] for k in gd):
            raise AssertionError(f"hash_agg hot run (batch {batch_cap}): the count lane "
                                 f"differs from the host store")
        out.append({"label": f"a hot key of ~{int(0.7 * n)} rows, float sums, batch {batch_cap}",
                    "entries": len(gd)})
    torch.cuda.synchronize()
    return out


def free_edge_cases(dev) -> dict:
    """K13 (``hash_kernels.free_below``, the kernel on its two arrays)
    against its plain version, exactly, one kernel a call by the library's
    counter: caps of 1, 15, 16, 17 and 4,096 + 5 (a word past the last
    multiple of 16 slots), q7's 65,536, an occupancy view offset by one
    byte (and bins by one int: no 16-byte access), nothing to free (an
    empty table, no bin below), everything freed, and below at the int32
    limits."""
    rng = np.random.default_rng(20261018)
    i32 = np.iinfo(np.int32)
    out = {}

    def case(label, occ, bins, below, offset=0):
        occ_t = torch.zeros(len(occ) + offset, dtype=torch.bool, device=dev)[offset:]
        bins_t = torch.zeros(len(bins) + offset, dtype=torch.int32, device=dev)[offset:]
        occ_t.copy_(torch.from_numpy(occ))
        bins_t.copy_(torch.from_numpy(bins))
        want = occ_t.clone()
        hash_kernels.free_below_plain(bins_t, want, below)
        before = hash_kernels.free_kernel_launches()
        hash_kernels.free_below(bins_t, occ_t, below)
        n = hash_kernels.free_kernel_launches() - before
        torch.cuda.synchronize()
        require_same(f"hash_free {label}", [occ_t, bins_t], [want, torch.from_numpy(bins).to(dev)])
        if n != 1:
            raise AssertionError(f"hash_free {label}: {n} kernel launches in one call")
        out[label] = {"cap": len(occ), "occupied": int(occ.sum()),
                      "freed": int(occ.sum()) - int(want.sum())}

    for cap in (1, 15, 16, 17, 4096 + 5, 65536):
        occ = rng.random(cap) < 0.6
        occ[[0, -1]] = True
        bins = rng.integers(-3, 4, cap).astype(np.int32)
        bins[[0, -1]] = -1
        case(f"cap {cap}", occ, bins, 0)
        case(f"cap {cap}, occupancy and bins offset", occ, bins, 0, offset=1)
        case(f"cap {cap}, below INT32_MIN", occ, bins, int(i32.min))
        case(f"cap {cap}, below INT32_MAX", occ, bins, int(i32.max))
        case(f"cap {cap}, all freed", occ, bins, 4)
    sparse = np.zeros(65536, bool)
    sparse[rng.integers(0, 65536, 300)] = True
    case("empty table", np.zeros(65536, bool), rng.integers(-3, 4, 65536).astype(np.int32), 4)
    case("sparse, no bin below", sparse, rng.integers(0, 4, 65536).astype(np.int32), 0)
    case("bins at the int32 limits", rng.random(65536) < 0.5,
         rng.choice(np.array([i32.min, -1, 0, i32.max], np.int32), 65536), 0)
    return out


def hash_deployment(dev, checks: dict) -> dict:
    """The deployment state, every kernel checked: 8 batches of 1,048,576
    rows, Zipf(1.2) keys over 16 bins; then a close, a scan and a free."""
    rng = np.random.default_rng(20261018)
    kinds = [k for k, _ in HASH_DEPLOY_LANES]
    dts = [NP_DT[d] for _, d in HASH_DEPLOY_LANES]
    agg = make_hash_agg(kinds, dts, HASH_DEPLOY, dev, checked_ops(checks))
    B = HASH_DEPLOY["batch_cap"]
    for _step in range(8):
        ids = (rng.zipf(1.2, B) - 1) % (1 << 22)
        keys = hash_columns([ids.astype(np.int64)])
        bins = rng.integers(0, 16, B).astype(np.int32)
        vals = [rng.integers(-(1 << 20), 1 << 20, B).astype(np.int64) if d != np.float64
                else np.round(rng.normal(0, 1000, B), 2) for d in dts]
        vals[1] = np.ones(B, np.int64)
        agg.update(keys, bins, vals)
    occupied = int(agg.state[2].sum())
    k12 = check_k12("the deployment table", agg.state[:4], 2, 4, HASH_DEPLOY["emit_cap"])
    walk = walk_timing(agg.state[:4], 2, 4, HASH_DEPLOY["emit_cap"], HASH_DEPLOY_LANES,
                       "the deployment table, bins [2, 4)")
    k, _b, _a = agg.extract(0, 2, 2)
    scanned = len(agg.scan_range(2, 4)[0])
    agg.free_bins_below(4)
    torch.cuda.synchronize()
    return {"cap": HASH_DEPLOY["cap"], "rows_per_batch": B, "batches": 8,
            "occupied": occupied, "closed_rows": len(k), "scanned_rows": scanned,
            "occupied_after": int(agg.state[2].sum()), "overflow": int(agg.state[4][0]),
            "k12_checked": k12, "walk_timing": walk}


def hash_bytes(lanes, L, n: dict, cap: int, E: int) -> dict:
    """Bytes each of the table's kernels must move at one step's shapes,
    counted for this run's data (``n``), each input read once and each
    output written once; a padding row or inactive partial costs its
    1-byte flag (K8 at one shard takes n_valid, not a flag array)."""
    lane_b = sum(torch.tensor([], dtype=dt).element_size() for _k, dt in lanes)
    pay = 8 + 4 + lane_b
    return {
        "agg_sort_reduce": n["rows"] * pay + L + n["segments"] * pay,
        "agg_probe_merge": (2 * L + n["segments"] * pay + n["claims"] * (pay + 2)
                            + n["matches"] * (pay + 1 + lane_b) + 8),
        # every slot's occupancy, the occupied slots' bins, the emitted
        # entries' key and lanes; E rows and flags out, totals, the frees
        "extract": cap + n["occupied"] * 4 + n["emitted"] * (8 + lane_b) + E * (pay + 1)
                   + 8 + n["emitted"],
        "scan_packed": cap + n["occupied"] * 4 + n["scanned"] * (8 + lane_b) + E * (pay + 1) + 8,
        # E slots read (key, bin, flag, lanes) and E rows written
        "hash_scan_chunk": 2 * E * (pay + 1),
        # every slot's occupancy, the occupied slots' bins, the valid ones'
        # key and lanes; their rows and the count written
        "hash_scan_walk": cap + n["occupied"] * 4 + n["walked"] * (8 + lane_b + pay) + 8,
        # every slot's occupancy, the occupied slots' bins read, the freed
        # ones' bytes written
        "hash_free": cap + n["occupied"] * 4 + n["freed"],
    }


def q7_table_at_drive_state(dev, n_batches: int):
    """A Q7_HASH table built as drive_tumbling builds it from the first
    ``n_batches`` of q7's batches (each update, then the close of every
    window the watermark passed): (table, the batches, base bin)."""
    batches = bid_batches((n_batches + 1) * BENCH_BATCH, WIDTH)
    agg = make_hash_agg(("max", "count"), (np.int64, np.int64), Q7_HASH, dev)
    base = int(batches[0][3].min())
    closed_below = 0
    for keys, _auc, price, bins_abs, wm in batches[:n_batches]:
        agg.update(keys, (bins_abs - base).astype(np.int32), [price, np.ones(len(keys), np.int64)])
        below = wm // WIDTH - base
        if below > closed_below:
            agg.extract(closed_below, below, below)
            closed_below = below
    torch.cuda.synchronize()
    return agg, batches, base


def time_hash(dev) -> dict:
    """The table's kernels at q7's shape, at a state the q7 drive reaches
    (65536 slots, the stream's first five batches updated and their passed
    windows closed, as drive_tumbling does), timing the sixth batch's step
    and reads; K12's walk at the hop drive's state (the path's shape): each
    against its plain version and a library yardstick where one PyTorch
    call computes the same function, beside the byte bound. K9's rounds at
    this state are held to its plain version."""
    lanes = [("max", torch.int64), ("count", torch.int64)]
    kinds = [k for k, _ in lanes]
    agg, batches, base = q7_table_at_drive_state(dev, 5)
    keys, _auc, price, bins_abs, _wm = batches[5]
    m = len(keys)
    L = Q7_HASH["batch_cap"]
    pad = lambda a, dt: torch.from_numpy(np.concatenate([a.astype(dt), np.zeros(L - m, dt)])).to(dev)  # noqa: E731
    key = pad(keys.view(np.int64), np.int64)[None]
    bins = pad((bins_abs - base).astype(np.int32), np.int32)[None]
    vals = [pad(price, np.int64)[None], pad(np.ones(m, np.int64), np.int64)[None]]
    table = hash_kernels._rows(agg.state[:4])
    oflow = agg.state[4]
    u = sharded_kernels.agg_sort_reduce(kinds, key, bins, None, vals, 0, m)
    occupied = int(table[2].sum())
    merged = clone_nested(table)
    still = sharded_kernels.agg_probe_merge(kinds, merged, *u, 64, oflow.clone())
    rounds = k9_rounds_check("B9's q7 step at the drive's state", kinds, table, u, 64, dev)
    segments = int(u[2].sum())
    claims = int(merged[2].sum()) - occupied
    lo = int((bins_abs - base).min())
    E = Q7_HASH["emit_cap"]
    emit = table[2] & (table[1] >= lo) & (table[1] < lo + 1)
    counts = {"rows": m, "segments": segments, "claims": claims,
              "matches": segments - claims - int(still.sum()), "unplaced": int(still.sum()),
              "occupied": occupied, "emitted": min(int(emit.sum()), E),
              "scanned": min(int(emit.sum()), E), "walked": int(emit.sum()),
              "freed": int((table[2] & (table[1] < lo + 1)).sum())}
    nbytes = hash_bytes(lanes, L, counts, Q7_HASH["cap"], E)
    log(f"hash_agg: time at the drive's state: {counts}, K9 rounds {rounds['rounds']}")
    modes = check_k11_modes("B9's q7 step", table, lo, lo + 1, lo + 1, E)
    t = {}

    def row(name, k, p, lib=None, library="none: no single PyTorch call computes it",
            bytes_of=None, **extra):
        t[name] = {"ms": k["device_ms"], "plain_ms": p["device_ms"],
                   "library_ms": None if lib is None else lib["device_ms"], "library": library,
                   "method": k["method"], "call_ms": k["call_ms"], "plain_call_ms": p["call_ms"],
                   "kernel_names": k["device_kernels"],
                   "trace_whole": (k["trace_whole"] and p["trace_whole"]
                                   and (lib is None or lib["trace_whole"])),
                   "bound_ms": (bytes_of or nbytes[name]) / HBM_BYTES_PER_S * 1e3,
                   "bound_by": "bytes", "bytes": bytes_of or nbytes[name], **extra}

    P = hash_kernels.PLAIN
    log("hash_agg: time")
    k8_call = lambda: sharded_kernels.agg_sort_reduce(kinds, key, bins, None, vals, 0, m)  # noqa: E731
    k8 = measure(k8_call)
    k8_r = k8_launch_report(k8_call, sort_reduce_plan(key, bins, None, 0, m), k8,
                            "B9's q7 step", 1, dev)
    row("agg_sort_reduce", dict(k8, device_ms=k8_r["ms"]),
        measure(lambda: P.sort_reduce(kinds, key, bins, None, vals, 0, m)),
        rows=[1, L], valid=m, us_per_call=k8["device_us_per_call"], calls=k8_r)
    fresh = lambda: (clone_nested(table), oflow.clone())  # noqa: E731
    pm_call = lambda tb, of: sharded_kernels.agg_probe_merge(kinds, tb, *u, 64, of)  # noqa: E731
    pm_k = time_fresh(pm_call, fresh, TIMING_REPS)
    pm_r = library_launch_report(lambda: pm_call(*fresh()),
                                 sharded_kernels.probe_merge_kernel_launches, pm_k, K9_KERNELS,
                                 "K9 at B9's q7 step")
    row("agg_probe_merge", dict(pm_k, device_ms=pm_r["ms"]),
        time_fresh(lambda tb, of: P.probe_merge(kinds, tb, *u, 64, of), fresh, 5),
        partials=[1, L], active=segments, claims=claims, table=[1, Q7_HASH["cap"]],
        rounds=rounds, us_per_call=pm_k["device_us_per_call"],
        cluster=sharded_kernels.probe_merge_cluster(), **pm_r)

    def nonzero_close(tb):
        sel = torch.nonzero(tb[2][0] & (tb[1][0] >= lo) & (tb[1][0] < lo + 1)).squeeze(1)[:E]
        return [tb[0][0][sel], tb[1][0][sel]] + [a[0][sel] for a in tb[3]]

    row("extract",
        time_fresh(lambda tb, of: sharded_kernels.shard_extract(tb, lo, lo + 1, lo + 1, E, True, of),
                   fresh, TIMING_REPS),
        time_fresh(lambda tb, of: P.extract(tb, lo, lo + 1, lo + 1, E, True, of), fresh,
                   TIMING_REPS),
        time_fresh(lambda tb, of: nonzero_close(tb), fresh, TIMING_REPS),
        library="torch.nonzero of the emit mask, then one index per array (no frees)",
        emit_cap=E, emitted=counts["emitted"], modes=modes)
    i32min = hash_kernels.I32_MIN
    row("scan_packed",
        measure(lambda: sharded_kernels.shard_extract(table, lo, lo + 1, i32min, E, True, oflow)),
        measure(lambda: P.extract(table, lo, lo + 1, i32min, E, True, oflow)),
        measure(lambda: nonzero_close(table)),
        library="torch.nonzero of the emit mask, then one index per array", emit_cap=E)
    t1 = agg.state[:4]
    n1 = counts["walked"]
    t["k12_checked_q7"] = check_k12("q7's table at the drive's state", t1, lo - 2, lo + 2, 1024)
    row("hash_scan_walk_q7",
        measure(lambda: hash_kernels.hash_scan_walk(t1, lo, lo + 1, n1)),
        measure(lambda: P.scan_walk(t1, lo, lo + 1, n1)),
        measure(lambda: walk_library(t1, lo, lo + 1)),
        library="torch.nonzero of the valid mask, then one index per array",
        bytes_of=nbytes["hash_scan_walk"], rows=n1)
    row("hash_scan_chunk",
        measure(lambda: hash_kernels.hash_scan_chunk(t1, lo, lo + 1, 0, E)),
        measure(lambda: P.scan_chunk(t1, lo, lo + 1, 0, E)),
        measure(lambda: [t1[0][:E], t1[1][:E], t1[2][:E] & (t1[1][:E] >= lo)
                         & (t1[1][:E] < lo + 1)] + [a[:E] for a in t1[3]]),
        library="slice of each array and the mask", emit_cap=E)
    fresh1 = lambda: (t1[0], t1[1], t1[2].clone(), t1[3])  # noqa: E731
    free_call = lambda *tb: hash_kernels.hash_free(tb, lo + 1)  # noqa: E731
    free_k = time_fresh(free_call, fresh1, TIMING_REPS)
    row("hash_free", free_k,
        time_fresh(lambda *tb: P.free(tb, lo + 1), fresh1, TIMING_REPS),
        time_fresh(lambda *tb: tb[2].logical_and_(tb[1] >= lo + 1), fresh1, TIMING_REPS),
        library="occ &= bins >= below", cap=Q7_HASH["cap"], freed=counts["freed"],
        occupied=occupied,
        **library_launch_report(lambda: free_call(*fresh1()), hash_kernels.free_kernel_launches,
                                free_k, K13_KERNELS, "K13 at q7's table"))
    t["hash_free_hop"] = time_free_at_hop_cap(dev)
    t["hash_scan_walk"] = time_walk_at_hop_state(dev)
    t["counts"] = counts
    return t


K13_KERNELS = {"free_words": 1}


def time_free_at_hop_cap(dev) -> dict:
    """K13 at the hop drive's table size (32,768 slots), on a table like
    the one its frees meet (its 5 open bins' ~1,600 entries occupied, the
    oldest bin freed), against its plain version and the bound."""
    rng = np.random.default_rng(20261019)
    cap = HOP_HASH["cap"]
    occ = torch.zeros(cap, dtype=torch.bool)
    occ[torch.from_numpy(rng.choice(cap, 1600, replace=False))] = True
    bins = torch.from_numpy(rng.integers(0, 5, cap).astype(np.int32)).to(dev)
    occ = occ.to(dev)
    fresh = lambda: (bins, occ.clone())  # noqa: E731
    k = time_fresh(lambda b, o: hash_kernels.free_below(b, o, 1), fresh, TIMING_REPS)
    p = time_fresh(lambda b, o: hash_kernels.free_below_plain(b, o, 1), fresh, TIMING_REPS)
    occupied = int(occ.sum())
    freed = int((occ & (bins < 1)).sum())
    nbytes = cap + occupied * 4 + freed
    return {"ms": k["device_ms"], "plain_ms": p["device_ms"], "call_ms": k["call_ms"],
            "method": k["method"], "cap": cap, "occupied": occupied, "freed": freed,
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def walk_library(table, lo, hi):
    """One PyTorch yardstick of the walk: the valid slots' indices, then
    one index per array (no count in a packed buffer)."""
    sel = torch.nonzero(table[2] & (table[1] >= lo) & (table[1] < hi)).squeeze(1)
    return [table[0][sel], table[1][sel]] + [a[sel] for a in table[3]]


def walk_timing(table, lo: int, hi: int, emit_cap: int, lanes, label: str) -> dict:
    """K12's walk on a one-shard table against its plain version and
    walk_library, beside the chunk loop it replaced (every chunk's launch
    and the concatenation of their valid rows, on the device), and the
    byte bound of this run's data."""
    P = hash_kernels.PLAIN
    cap = table[0].shape[0]
    occupied = int(table[2].sum())
    n = int((table[2] & (table[1] >= lo) & (table[1] < hi)).sum())
    nbytes = hash_bytes(lanes, 1, {"rows": 0, "segments": 0, "claims": 0, "matches": 0,
                                   "occupied": occupied, "emitted": 0, "scanned": 0,
                                   "walked": n, "freed": 0}, cap, emit_cap)["hash_scan_walk"]

    def chunk_loop():
        return [hash_kernels.hash_scan_chunk(table, lo, hi, chunk, emit_cap)
                for chunk in range(0, cap, emit_cap)]

    k = measure(lambda: hash_kernels.hash_scan_walk(table, lo, hi, n))
    p = measure(lambda: P.scan_walk(table, lo, hi, n))
    lib = measure(lambda: walk_library(table, lo, hi))
    loop = measure(chunk_loop, reps=5)
    return {"ms": k["device_ms"], "plain_ms": p["device_ms"], "library_ms": lib["device_ms"],
            "library": "torch.nonzero of the valid mask, then one index per array",
            "method": k["method"], "call_ms": k["call_ms"], "plain_call_ms": p["call_ms"],
            "kernel_names": k["device_kernels"],
            "trace_whole": k["trace_whole"] and p["trace_whole"] and lib["trace_whole"],
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "bytes": nbytes,
            "where": label, "cap": cap, "occupied": occupied, "rows": n,
            "chunk_loop": {"emit_cap": emit_cap, "launches": -(-cap // emit_cap),
                           "ms": loop["device_ms"], "call_ms": loop["call_ms"]}}


def time_walk_at_hop_state(dev) -> dict:
    """K12's walk at the hop drive's state (the path's shape): the first
    four batches of the hop stream through the table, their passed windows
    closed and freed; then the next window's 5-bin read."""
    agg = make_hash_agg(("count",), (np.int64,), HOP_HASH, dev)
    drive_hop(agg, bid_batches(4 * BENCH_BATCH, SLIDE), finish=False)
    table = agg.state[:4]
    lo = int(table[1][table[2]].min())
    hi = lo + WIDTH // SLIDE
    checked = check_k12("the hop drive's state", table, lo, hi, HOP_HASH["emit_cap"])
    # the launch's fixed cost: the same walk over a range no slot is in
    empty = measure(lambda: hash_kernels.hash_scan_walk(table, 1 << 30, 1 << 30, 0))
    return dict(walk_timing(table, lo, hi, HOP_HASH["emit_cap"], [("count", torch.int64)],
                            "the hop drive's state, its next window"), checked=checked,
                empty_range_ms=empty["device_ms"])


def hash_agg_phase(dev) -> dict:
    """B9's path on the card: q7's 2,000,000 events through the table
    (MAX(price), COUNT per auction and 10 s window, closes through
    extract_start) exactly against oracle_q7 and the host store; the same
    stream's float64 SUM and MIN of price (K9 reporting its rounds each
    step), and q5's hop windows (500,000 events) through scan_range and
    free_bins_below exactly against oracle_q5, both with every kernel
    checked against its plain version. Launch counts are zeroed just
    before the q7 drive (K8, K9, K11) and the hop drive (K11, K12's walk,
    K13) and read just after each. Then the hop drive unchecked, through
    the walk and through the chunk loop it replaced; the deployment state
    (K12's walk and every chunk checked there) and the edge cases, every
    kernel checked; the table reads' shared edge cases; then timed."""
    int_batches = bid_batches(Q7_EVENTS, WIDTH)
    hop_batches = bid_batches(HOP_EVENTS, SLIDE)
    auction_of = {}
    for keys, auc, *_r in int_batches:
        auction_of.update(zip(keys.tolist(), auc.tolist()))
    want_q7, want_q5 = oracle_q7(Q7_EVENTS), oracle_q5(HOP_EVENTS)
    checks: dict = {}
    ints = lambda auc, price: [price, np.ones(len(auc), np.int64)]  # noqa: E731
    flts = lambda auc, price: [price.astype(np.float64)] * 2  # noqa: E731

    def launched(label, path):
        got = hash_launch_counts()
        unlaunched = [k for k in path if got[k] == 0]
        if unlaunched:
            raise AssertionError(f"hash_agg {label} ran without launching {unlaunched}: {got}")
        return got

    reset_hash_launch_counts()
    k8_calls: list = []
    q7_ops = hash_kernels.KERNELS._replace(sort_reduce=K8Recorder(k8_calls))
    t0 = time.perf_counter()
    base, closes = drive_tumbling(make_hash_agg(("max", "count"), (np.int64, np.int64),
                                                Q7_HASH, dev, q7_ops), int_batches, ints)
    wall_int = time.perf_counter() - t0
    launches = {"q7": launched("q7", HASH_Q7_KERNELS)}
    k8_q7 = k8_call_summary(k8_calls, launches["q7"]["agg_sort_reduce"])
    got = q7_windows(base, closes, auction_of)
    if got != want_q7:
        raise AssertionError(f"hash_agg: q7 parity failure: {len(got)} windows vs {len(want_q7)}")
    k9_rounds: list = []
    t0 = time.perf_counter()
    fbase, fcloses = drive_tumbling(make_hash_agg(("sum", "min"), (np.float64, np.float64), Q7_HASH,
                                             dev, checked_ops(checks, k9_rounds)), int_batches,
                                    flts)
    wall_float = time.perf_counter() - t0
    hop_checks: dict = {}
    reset_hash_launch_counts()
    free_before = hash_kernels.free_kernel_launches()
    t0 = time.perf_counter()
    hop = drive_hop(make_hash_agg(("count",), (np.int64,), HOP_HASH, dev, checked_ops(hop_checks)),
                    hop_batches)
    wall_hop = time.perf_counter() - t0
    launches["q5 hop"] = launched("q5 hop", HASH_HOP_KERNELS)
    free_kernels = hash_kernels.free_kernel_launches() - free_before
    if free_kernels != launches["q5 hop"]["hash_free"]:
        raise AssertionError(f"hash_agg q5 hop: K13 made {free_kernels} kernel launches in "
                             f"{launches['q5 hop']['hash_free']} calls")
    if any(hop_checks.get(k) != launches["q5 hop"][k] for k in HASH_HOP_KERNELS):
        raise AssertionError(f"hash_agg q5 hop: checks {hop_checks} vs launches {launches}")
    for k, c in hop_checks.items():
        checks[k] = checks.get(k, 0) + c
    n_hop = check_hop(hop, auction_of, want_q5)
    # the host store, and the float run against plain sums of the same rows
    t0 = time.perf_counter()
    hbase, hcloses = drive_tumbling(make_hash_agg(("max", "count"), (np.int64, np.int64), Q7_HASH, dev,
                                             backend="numpy"), int_batches, ints)
    wall_host = time.perf_counter() - t0
    if q7_windows(hbase, hcloses, auction_of) != got:
        raise AssertionError("hash_agg: the table's windows differ from the host store's")
    fsum = {}
    for k, b, (sm, mn) in fcloses:
        fsum.update(zip(zip(k.tolist(), b.tolist()), sm.tolist()))
    if len(fsum) != len(got):
        raise AssertionError(f"hash_agg float run: {len(fsum)} windows vs {len(got)}")
    log("hash_agg: the hop drive unchecked, walk against the chunk loop")
    hop_ab = hop_drive_ab(dev, hop_batches, auction_of, want_q5)
    log("hash_agg: deployment state")
    deploy = hash_deployment(dev, checks)
    log("hash_agg: edge cases")
    cases = hash_edge_cases(dev, checks)
    free_cases = free_edge_cases(dev)
    missing = [k for k in HASH_PATH_KERNELS if not checks.get(k)]
    if missing:
        raise AssertionError(f"hash_agg: {missing} never checked against the plain version")
    info = {"phase": "hash_agg", "events": Q7_EVENTS, "windows": len(got),
            "hop_events": HOP_EVENTS, "hop_rows": n_hop, "launches": launches,
            "wall_s": {"q7 int": wall_int, "q7 float, checked": wall_float,
                       "q5 hop, checked": wall_hop, "q7 host store": wall_host},
            "events_per_s_q7_int": Q7_EVENTS / wall_int, "k8_calls_q7": k8_q7,
            "checks": checks,
            "checks_q5_hop": hop_checks,
            "sizes": {"q7": Q7_HASH, "hop": HOP_HASH, "deployment": HASH_DEPLOY},
            "deployment": deploy, "cases": cases, "free_cases": free_cases,
            "free_kernels_q5_hop": free_kernels,
            "hop_drive_unchecked": hop_ab,
            "k9_rounds_q7_drive": {
                "steps": len(k9_rounds), "rounds": [r["rounds"][0] for r in k9_rounds],
                "mean_rounds": statistics.fmean(r["rounds"][0] for r in k9_rounds),
                "max_rounds": max(r["rounds"][0] for r in k9_rounds),
                "unplaced": sum(r["active"][0][-1] for r in k9_rounds),
                "active": [r["active"][0] for r in k9_rounds]},
            "max_abs_err": 0.0, "timing": time_hash(dev)}
    emit(info)
    return info


def run_q7_host() -> dict:
    """q7c (chaining on, bench.py's sizes) with the window on the host
    store ("backend": "numpy"): exact against oracle_q7; K4 runs on the
    card, the window's state and close on the host."""
    def build(rows, events):
        g = build_q7(rows, events)
        g.nodes["agg"].config["backend"] = "numpy"
        return g

    info = run_chained("q7_host", build, Q7_EVENTS, oracle_q7, check_q7,
                       path_kernels=("segment_fused",))
    on_card = [k for k in WINDOW_KERNELS if info["launches"][k]]
    if on_card:
        raise AssertionError(f"q7_host launched the device window's kernels {on_card}")
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default="chip_smoke_out",
                    help="directory for chip_smoke.json and the build logs")
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run after probe and build (a short "
                         "check); such a run prints no result line")
    args = ap.parse_args(argv)
    out_dir = args.out_dir
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda")
    res = {}
    log("probe")
    smi, res["probe"] = probe()
    log("build")
    res["build"] = build(out_dir)
    plans: dict = {}

    def seg_build():
        info, plans["nexmark"] = segment_build(out_dir)
        return info

    phases = {
        "q7": run_q7,
        "segment_build": seg_build,
        "q7c": lambda: run_chained("q7c", build_q7, Q7_EVENTS, oracle_q7, check_q7),
        "q5": lambda: run_chained("q5", build_q5, Q5_EVENTS, oracle_q5, check_q5),
        "q8c": run_q8c,
        "qu": run_qu,
        "qu_ttl": lambda: run_qu_ttl(dev),
        "qs": run_qs,
        "kernels": lambda: kernel_phase(dev),
        "segment": lambda: segment_phase(plans.get("nexmark") or nexmark_plans()),
        "join": lambda: join_phase(dev),
        "gather": lambda: gather_phase(dev),
        "q7m": run_q7m,
        "q5m": run_q5m,
        "mesh_ab": run_mesh_ab,
        "table_reads": lambda: table_read_phase(dev),
        "sharded": lambda: sharded_phase(dev),
        "hash_agg": lambda: hash_agg_phase(dev),
        "q7_host": run_q7_host,
        "segment_sweep": segment_sweep,
    }
    only = args.only.split(",") if args.only else [p for p in phases if p != "segment_sweep"]
    unknown = sorted(set(only) - set(phases))
    if unknown:
        raise SystemExit(f"unknown phases {unknown}; the phases are {list(phases)}")
    for name, fn in phases.items():
        if name in only:
            log(name)
            res[name] = fn()
    log("done")
    if args.only:
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
            json.dump(res, f, indent=1)
        return 0
    res["summary"] = rows = kernel_rows(res)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(res, f, indent=1)
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def kernel_rows(res: dict) -> list:
    """The {"kernels": [...]} line: one row per kernel, its launches on its
    main path's run, its time at that path's shape."""
    q7t = res["kernels"]["timing"]["q7"]
    rows = []
    # K2's row: the close's mode (read-and-clear) at k = 1, its launches
    # summed over both modes; each mode and the launch floor beside it
    for name, key in (("slot_scatter_combine", "slot_scatter_combine"),
                      ("slot_region_read_pack", "slot_region_read_pack_clear_k1"),
                      ("slot_region_clear", "slot_region_clear_k1")):
        t = q7t[key]
        launches = res["q7"]["launches"][name]
        if name == "slot_region_read_pack":
            launches += res["q7"]["launches"]["slot_region_read_pack_clear"]
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES[name], "launches": launches,
                     "max_abs_err": res["kernels"]["max_abs_err"][name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    runs = ("q7", "q7c", "q5")
    k2 = rows[1]
    k2["modes"] = {
        mode: {f"k{k}": {f: q7t[f"{key}_k{k}"][f] for f in ("ms", "plain_ms", "library_ms",
                                                              "bound_ms", "call_ms")}
               for k in (1, 16)}
              | {"launches": {r: res[r]["launches"][count] for r in runs}}
        for mode, key, count in (("read_clear", "slot_region_read_pack_clear",
                                  "slot_region_read_pack_clear"),
                                 ("read", "slot_region_read_pack", "slot_region_read_pack"))}
    k2["launch_floor_ms"] = {f"k{k}": q7t[f"launch_floor_k{k}"]["ms"] for k in (1, 16)}
    k2["read_clear_cases"] = len(res["kernels"]["read_clear_cases"])
    k3 = rows[2]
    k3["launches_by_run"] = {r: res[r]["launches"]["slot_region_clear"] for r in runs}
    if not any(k3["launches_by_run"].values()):
        k3["main_path"] = ("none: no run here reaches SlotAggregator._clear_bins (free_bins_below, "
                           "or expired bins outside a close's range); held against its plain "
                           "version in the kernels phase")
    k3["launch_floor_ms"] = k2["launch_floor_ms"]["k1"]
    # K1's float sums (K5 in range mode, then the walks) at the deployment
    # shape and qu's, with the chain floor of the longest run beside the bound
    rows[0]["float_sums"] = {
        shape: {k: res["kernels"]["timing"][shape]["slot_scatter_combine"][k]
                for k in ("ms", "plain_ms", "library_ms", "bound_ms", "chain_floor_ms",
                          "longest_run")}
        for shape in ("deployment", "qu")}
    rows[0]["float_sums"]["qu"]["launches"] = res["qu"]["launches"]["slot_scatter_combine"]
    segp = res["segment"]
    st = segp["timing_q7"]
    rows.append({"name": "segment_fused", "route": "triton", "source": SEGMENT_SOURCE,
                 "replaces": REPLACES["segment_fused"], "includes": "B1 splitmix64 key hash "
                 "(arroyo_tpu/engine/segment.py:242-278)",
                 "launches": res["q7c"]["launches"]["segment_fused"],
                 "max_abs_err": segp["max_abs_err"], "ms": st["ms"], "plain_ms": st["plain_ms"],
                 "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
                 "library_ms": st["library_ms"], "call_ms": st["call_ms"],
                 "triton_launches": res["q7c"]["launches"]["segment_fused_kernels"],
                 "block": st["block"], "num_warps": st["num_warps"],
                 "edge_cases": sorted(segp["edge_cases"]),
                 "q7c_copies": res["q7c"]["profiled_run"]["copies_by_kind"]})
    jt = res["join"]["timing"]["q8 window"]
    for name in ("join_sort_pairs", "join_search_bounds"):
        t = jt[name]
        rows.append({"name": name, "route": "cuda", "source": JOIN_SOURCE,
                     "replaces": REPLACES[name], "launches": res["q8c"]["launches"][name],
                     "max_abs_err": res["join"]["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    k5 = rows[-2]
    k5["kernel_launches_per_call"] = jt["join_sort_pairs"]["kernel_launches_per_call"]
    dep = res["join"]["timing"]["deployment window"]["join_sort_pairs"]
    k5["deployment_window"] = {k: dep[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                   "kernel_launches_per_call", "r_cap")}
    k5["range_mode"] = {shape: {k: res["kernels"]["timing"][shape]["join_sort_pairs_range"][k]
                                for k in ("ms", "plain_ms", "library_ms", "bound_ms", "cap")}
                        for shape in ("deployment", "qu")}
    k6 = rows[-1]
    dep = res["join"]["timing"]["deployment window"]["join_search_bounds"]
    k6["deployment_window"] = {k: dep[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                   "l_cap", "r_cap")}
    t = res["gather"]["timing"]["qu"]
    dep = res["gather"]["timing"]["deployment"]
    rows.append({"name": "slot_gather", "route": "cuda", "source": SOURCE,
                 "replaces": REPLACES["slot_gather"], "launches": res["qu"]["launches"]["slot_gather"],
                 "max_abs_err": res["gather"]["max_abs_err"], "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 "library_ms": t["library_ms"], "call_ms": t["call_ms"],
                 "qu_library_kernels": res["qu"]["library_kernels"]["slot_gather"],
                 "read_slots_host_ms": t["read_slots_host_ms"],
                 "edge_cases": len(res["gather"]["edge_cases"]),
                 "qu_copies": res["qu"]["profiled_run"]["copies_by_kind"],
                 "deployment": {k: dep[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                    "call_ms",
                                                    "read_slots_host_ms",
                                                    "read_slots_breakdown_ms")}})
    st = res["sharded"]["timing"]["q7m"]
    ha = res["hash_agg"]
    ht = ha["timing"]
    for name in SHARDED_KERNELS:
        t = st[name]
        row = {"name": name, "route": "cuda", "source": SHARDED_SOURCE,
               "replaces": REPLACES[name],
               "launches": res["q7m"]["fused"]["launches"][name],
               "max_abs_err": res["sharded"]["max_abs_err"], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        if name in HASH_Q7_KERNELS:
            # the single-device table's path (B9) runs it at one shard too
            h = ht["extract" if name == "shard_extract" else name]
            row["hash_agg"] = {"replaces": "arroyo_tpu/ops/aggregate.py:308",
                               "launches": ha["launches"]["q7"][name], "ms": h["ms"],
                               "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
                               "library_ms": h["library_ms"]}
        if name == "shard_extract":
            row["kernel_launches_per_call"] = t["kernel_launches_per_call"]
            row["hash_agg"]["scan_packed"] = {k: ht["scan_packed"][k] for k in
                                              ("ms", "plain_ms", "bound_ms", "library_ms")}
            row["hash_agg"]["hop_launches"] = ha["launches"]["q5 hop"][name]
            row["q5m_launches"] = res["q5m"]["fused"]["launches"][name]
        if name in ("agg_probe_merge", "shard_exchange"):
            # kernels a call by the library's count; mesh_ab's shape and the
            # deployment state beside q7m's
            row["kernel_launches_per_call"] = t["kernel_launches_per_call"]
            for shape in ("mesh_ab", "deployment"):
                o = res["sharded"]["timing"][shape][name]
                row[shape] = {k: o[k] for k in ("ms", "plain_ms", "bound_ms",
                                                "kernel_launches_per_call")}
            row["mesh_ab"]["launches"] = res["mesh_ab"]["fused"]["launches"][name]
        if name == "shard_spill":
            row["kernel_launches_per_call"] = t["kernel_launches_per_call"]
            row["edge_cases"] = len(res["sharded"]["spill_cases"])
            row["q7m_kernels_per_call"] = res["q7m"]["fused"]["spill_kernels_per_call"]
            row["mesh_ab"] = {k: res["sharded"]["timing"]["mesh_ab"][name][k]
                              for k in ("ms", "plain_ms", "bound_ms")}
        if name == "shard_exchange":
            row["bound_flag_only_ms"] = t["bound_flag_only_ms"]
            for shape in ("mesh_ab", "deployment"):
                row[shape]["bound_flag_only_ms"] = res["sharded"]["timing"][shape][name][
                    "bound_flag_only_ms"]
            row["edge_cases"] = len(res["sharded"]["k10_cases"])
        if name == "agg_probe_merge":
            # at q7m's merged step: as timed, after a 64 MB write, and in
            # the real q7m fused run (its trace's time over its launches)
            real = [v for n, v in res["q7m"]["fused"].get("profiled_run", {}).get(
                "device_us_by_name", {}).items() if n.startswith("pm_cluster")]
            row["l2"] = {"warm_ms": t["ms"], "cold_ms": t["cold_l2"]["ms"],
                         "real_q7m_fused_ms": (sum(real) / 1e3 / row["launches"]
                                               if real and row["launches"] else None)}
            row["cluster"] = t["cluster"]
            row["edge_cases"] = len(res["sharded"]["k9_cases"])
            row["hash_agg"]["cluster"] = ht[name]["cluster"]
            row["hash_agg"]["kernel_launches_per_call"] = ht[name]["kernel_launches_per_call"]
            row["rounds_q7m_merged_step"] = t["rounds"]
            row["hash_agg"]["rounds_at_drive_state"] = ht[name]["rounds"]
            row["hash_agg"]["rounds_q7_drive"] = {
                k: ha["k9_rounds_q7_drive"][k] for k in ("steps", "mean_rounds", "max_rounds",
                                                         "unplaced")}
        if name == "agg_sort_reduce":
            # the merged step's call, the local step's, the deployment
            # state's, and B9's: path, passes and kernel launches a call
            dt = res["sharded"]["timing"]["deployment"][name]
            row.update(merged_step=t["calls"], local_step={"ms": t["local_ms"], **t["local_calls"]},
                       deployment={"ms": dt["ms"], "plain_ms": dt["plain_ms"],
                                   "bound_ms": dt["bound_ms"], "local_ms": dt["local_ms"],
                                   "merged_step": dt["calls"], "local_step": dt["local_calls"]},
                       q7m_calls=res["q7m"]["fused"]["k8_calls"])
            row["hash_agg"]["calls"] = ht[name]["calls"]
            row["hash_agg"]["q7_calls"] = ha["k8_calls_q7"]
        rows.append(row)
    for name in ("hash_scan_walk", "hash_free"):
        t = ht[name]
        rows.append({"name": name, "route": "cuda", "source": HASH_SOURCE,
                     "replaces": REPLACES[name], "launches": ha["launches"]["q5 hop"][name],
                     "max_abs_err": ha["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    k13 = rows[-1]
    k13.update(call_ms=ht["hash_free"]["call_ms"],
               kernel_launches_per_call=ht["hash_free"]["kernel_launches_per_call"],
               hop_library_kernels=ha["free_kernels_q5_hop"], edge_cases=len(ha["free_cases"]),
               hop_cap={k: ht["hash_free_hop"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                             "call_ms")})
    # K12: the walk is its path's mode; the one-chunk mode (the reference's
    # scan, one launch per chunk) no longer runs on the path
    k12 = rows[-2]
    c = ht["hash_scan_chunk"]
    k12["chunk_loop_at_hop_state"] = ht["hash_scan_walk"]["chunk_loop"]
    k12["one_chunk_mode"] = {"name": "hash_scan_chunk", "replaces": REPLACES["hash_scan_chunk"],
                             "launches": ha["launches"]["q5 hop"]["hash_scan_chunk"],
                             **{k: c[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")}}
    dw = ha["deployment"]["walk_timing"]
    k12["deployment"] = {k: dw[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "rows",
                                            "chunk_loop")}
    k12["hop_drive_unchecked"] = {
        mode: [{k: r[k] for k in ("wall_s", "events_per_s", "falling_back_scans",
                                  "host_fetches", "host_fetches_per_falling_back_scan")}
               | {"k12_launches": r["launches"]["hash_scan_walk"]
                  + r["launches"]["hash_scan_chunk"]} for r in runs]
        for mode, runs in ha["hop_drive_unchecked"].items()}
    return rows


if __name__ == "__main__":
    sys.exit(main())
