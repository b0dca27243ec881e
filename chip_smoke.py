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
              sm_90a, one nvcc per source, and the native host library
              (cpp/arroyo_host.cc, one g++ into arroyo_tpu_torch/build/),
              all started together;
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
              state, float32 subnormals in values and state, which K1 reads
              and writes as the zero of their sign as XLA does, int32 and
              int64 slots), at q7's shape, at qu's (its
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
              values, all at an odd row count; C4's and C10's plans under
              each float16 model (the program's compile-time constant:
              F16_WIDE, float16 in float32 rounded once an operation, and
              F16_NATIVE, XLA's code on an AVX512-FP16 host, its multiply-adds
              contracted); on its own edge cases (n = 0,
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
              "numpy"): exact parity, K4 on the card, no K1-K3;
22. checkpoint -- checkpoint and restore through the port's entry points
              (Engine.checkpoint_and_wait(1, then_stop=True), stop(), then
              Engine(restore_epoch=1).run_to_completion()), storage in a
              temporary directory the phase removes. Restore parity at
              bench.py's sizes for q7c, q5, q8c, qu, qs and q7m (fused and
              host): epoch 1 lands after half the source's batches (the
              source held at that poll by BarrierGate, then the trigger),
              its tables hold open state, the restored source starts at its
              offset, and the first run's rows and the restored run's
              together equal the oracle exactly. Then q7m checkpointed at 4
              shards and restored at 8; q7c with epochs 1 and 2, epoch 2's
              marker removed (latest_complete_checkpoint gives 1) or a table
              file of it cut in half (the fallback ladder quarantines 2 and
              gives 1), each restore from 1 equal to the oracle; and the
              deployment-size round trips (snapshot -> TableManager.checkpoint
              -> restore -> snapshot, equal per key) of the slot store
              (1,048,576 groups in 16,777,216 slots x 4 int64 lanes) and of
              the sharded phase's 440 MB mesh store half full (4,194,304
              groups, keys over the whole uint64 range as the key hashes
              are), each step timed, neither store losing a group. K2's
              read-alone mode must launch at each barrier once per 16 device
              regions the slot store holds there (q7c and qu: at least once;
              q5's open bin is spilled to the host store at bench.py's
              sizes), K1's merge mode at the restores of q7c and q5, by the
              kernels module's counters; K8-K10 at the mesh restores.
23. recovery -- crashes, bit rot, compaction and plan changes at bench.py's
              sizes, storage in a temporary directory the phase removes.
              Crash: q7c and q7m fused with worker:crash@barrier=2 on the
              window's subtask (arroyo_tpu_torch.faults) after epoch 1;
              epoch 2 holds state files and no marker, pick_restore_epoch
              gives 1, and a fresh engine's restore (K1's merge for q7c,
              K8-K10 for q7m, by the counters) with the first run's windows
              equals the oracle. Bit rot: q7c's epoch 2 written under
              storage.put:corrupt=truncate@match=table-; fsck_job finds
              FS005 on epoch 2 alone, pick_restore_epoch quarantines it and
              falls back to 1 (CHECKPOINT_QUARANTINED, RESTORE_FELL_BACK),
              the restore reaches the oracle, and so does one under a
              transient storage.get:fail_once (retried in place).
              Compaction: q7 with its window at parallelism 4, epoch 1, then
              Engine.compact(1) leaves one generation-1 file per table of
              agg; restores at 4 and 2 reach the oracle with K1's merge;
              the compaction torn after each of its three metadata writes
              (storage.put:fail@match=metadata-&after=N) restores to the
              oracle and a re-run finishes it. Plan gate: q7c's epoch 1
              restored under a 20 s window, and under a no-op filter
              without the evolution sidecar, is refused before any task
              starts, naming both plan hashes; with diff_plans's mapping
              written it reaches the oracle. fsck_job finds no error in any
              clean job. Each case's times print on the phase's line.
24. obs    -- the observability plane, profiling at its default (on), as
              in every phase: q7c at bench.py's setting exact with K4, K1
              and K2 launched, its Prometheus families those the JAX
              package exports for such a job, its row counters those the
              oracle implies, one segment build observation per padded
              shape; then q7c timed with the profiler on and off and with
              the native host library on and off, and q8c (whose join feeds
              a key sketch, after one untimed run) with the profiler on and
              off, twice each (OBS_REPS), alternating in an order that
              rotates each round, each exact
              (medians printed); q7c's profile-off runs twice a round (A/A:
              their ratio is the host's noise floor), and one more profiled
              q7c run times each profiler hook on each task thread.
              q7m fused: arroyo_mesh_exchange_rows_total equals the sharded
              store's count and the oracle's bids. q3 at the 1 MiB budget:
              the arroyo_spill_* series equal SpillStats. One checkpoint of
              q7c with its window at parallelism 4: every subtask's
              alignment, snapshot and ack spans, the Chrome trace written to
              <out-dir>/obs_chrome_trace.json, ``__sketch`` in the epoch and
              a restore ending with an uninterrupted run's hot keys. An
              injected crash mid-checkpoint: one OPERATOR_PANIC with its
              node, subtask, epoch and digest, and the job fails.
25. cluster -- the control plane and the cross-worker data plane at
              bench.py's sizes: SQL Nexmark q7 (2,000,000 events) and q8
              (500,000) POSTed to the port's ApiServer and run by
              ControllerServer(EmbeddedScheduler) over two engines in this
              process (controller.workers-per-job 2, parallelism 2), exact
              against oracle_sql, K4, K1, K2 (and K5, K6 for q8) launched,
              the windows' subtasks on both workers, both receiving rows
              over the data plane, coordinated checkpoints complete; q7
              through ControllerServer(ProcessScheduler): two `python -m
              arroyo_tpu_torch worker` processes with no device setting
              (under COUNTING_MAIN, which writes each process's launch
              counts), each holding a CUDA context while the job runs
              (nvidia-smi's compute apps), exact, each worker launching
              K4, K1 and K2, both workers' chains compiled with no
              SEGMENT_FALLBACK among the relayed events; again with one
              worker killed after the first complete checkpoint (restarts
              >= 1, exact, the restored set's two workers held to the same
              launches); then `python -m arroyo_tpu_torch run <smoke
              family>.sql --parallelism 2` as a subprocess, its output the
              family's golden, its K1 and K2 launched. Prints events/s
              beside the sql phase's single-engine q7, POST to Running, a
              worker's spawn to `started` and to its first heartbeat,
              barrier to complete for every complete epoch (the
              controller's trigger to durable; fails if one lacks either),
              kill to Running and to Finished.
26. deploy -- deployment at bench.py's sizes. (a) `python -m
              arroyo_tpu_torch node` as a subprocess with no device setting
              (under NODE_MAIN, which starts each worker it spawns under
              COUNTING_MAIN), the API and ControllerServer(NodeScheduler) in
              this process: SQL q7 (2,000,000 events, parallelism 2) POSTed
              to the REST API, the node's two worker processes each holding
              a CUDA context (nvidia-smi's compute apps) and launching K1
              and K2 (and K4, one Triton launch a call), exact against
              oracle_sql; the node live at GET /api/v1/nodes and its slots
              free after Finished. (b) `python -m arroyo_tpu_torch
              compile-service` as a subprocess, ``compiler.endpoint`` at it:
              a cpp UDF POSTed to the REST API (dollars_to_euros, price *
              908 / 1000 on int64) and built by g++ there; SQL q7 over
              MAX(dollars_to_euros(price)) at 2,000,000 events through the
              node's workers, which fetch the artifact, exact against a
              numpy oracle, K1 and K2 launched, the workers' relayed
              SEGMENT_COMPILED / SEGMENT_FALLBACK printed. (c) q7's bids
              written by the port's generator as JSON lines (2,000,000
              events, 8 files) and as an Avro OCF with deflate (500,000
              events: a cut of scale, the Avro codec being row-at-a-time
              Python); SQL q7 over each set through a filesystem source
              into a JSON filesystem sink partitioned by auction % 4 with
              exactly-once commits, checkpoints to an s3:// URL served by an
              in-process client (MemoryS3, multipart above 64 KiB): the
              source held at half its batches for epoch 1 and three
              quarters for epoch 2, whose barrier crashes the window
              (worker:crash@barrier=2); a fresh engine restores epoch 1 from
              the store, and the committed files then hold the oracle's
              rows, none twice, no partial file; then a parquet sink runs
              exact where pyarrow is importable and fails the job naming
              pyarrow where it is not. Prints the phase's seconds, node q7's
              events/s beside the cluster phase's process q7, POST to
              Running, spawn to `started`, POST to Finished and each file
              set's events/s.
27. connectors -- the network connectors: SQL q7 (500,000 events, a
              cut for the run's time limit; chaining on, batch 65536,
              parallelism 1) with its bids arriving over a NATS broker of
              this script's own (ChipNats: INFO, CONNECT, SUB, PUB, MSG,
              PING/PONG in this process; it writes one JSON message a bid,
              in chunks, only after the source's SUB, then half-closes so
              the source ends gracefully) and its rows leaving through the
              webhook sink to this script's own http.server (WEBHOOK_MAIN,
              a process of its own). Exact: the POSTed rows equal
              oracle_q7, none missing, none twice; every message
              delivered; on the GPU, the chain compiled with no fallback;
              K4, K1 and K2 launched (counts zeroed just before, read just
              after), K4 one Triton launch a call. Prints events/s, the
              run's wall, the rows, the launches, the device's idle share
              and the messages.
28. analysis -- the port's static analysis (ROADMAP A.10): `python -m
              arroyo_tpu_torch lint` over the package exits 0 ("lint
              clean"), and `check --json` on SQL q7, q5, q8 and q5 with an
              unaligned hop gives exactly ANALYSIS_CHECKS (exit code and
              diagnostics), all as subprocesses while SQL q7 (1,000,000
              events, a cut for the phase's time; parallelism 2) runs
              through ControllerServer(EmbeddedScheduler) over two engines
              joined by the data plane with the lock-order witness on
              (obs/lockorder.py, enabled before the controller is built):
              exact, K4, K1 and K2 launched, the witness's edges inside
              the static LR402 graph over arroyo_tpu_torch/ and its locks
              including the inboxes' and the coalescing sends'
              (ANALYSIS_LOCKS); then the same q7 under
              lock_contend:delay=1@match=TaskInbox, exact, the delay
              fired. Prints the edges, the acquisitions, both runs'
              events/s and the phase's seconds.
29. mesh_slots -- the key-sharded mesh over device slots
              (device.mesh-placement; each slot a contiguous run of shards
              on its card with its own stream, the exchange as cross-slot
              copies behind events): 8 shards over 4 slots on cuda:0. A
              store of q7m's shapes (8 x 8192 rows a step, dest_cap 16384,
              table 65536, q7m's lanes) fed three steps and two closes (each
              leaving bins open) with
              every K8, K10 exchange (2 source shards over 8 owners), K9,
              K10 spill and K11 call on each slot held byte for byte to its
              plain version, its state after each step and every close's
              rows byte-equal to a 1-slot store fed the same rows; the
              current device unchanged after a launch of each kernel on
              every slot's card; q7m at bench.py's sizes (2,000,000 events,
              8 shards) over the 4 slots, fused and on the host path, exact
              against oracle_q7, K4 and K8-K11 launched, the launches per
              slot (by stream); a snapshot at 4 slots restored at 1 and the
              reverse, exactly; the exchange's time and bytes per step at
              q7m's shapes beside the 1-slot transposing copy and their
              bound. Where the machine has two or more cards the same runs
              over distinct cards (peer copies); else one line says it did
              not run and why. q7m at one slot on cuda:0 runs in the same
              phase, before the placements and after them, and each
              placement's events/s stand beside the faster of the two as a
              ratio (q7m_vs_one_slot).

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
import functools
import json
import os
import queue
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

import arroyo_tpu_torch.config as tcfg
from arroyo_tpu_torch.batch import TIMESTAMP_FIELD, Batch, Schema
from arroyo_tpu_torch.connectors.nexmark import NexmarkSource
from arroyo_tpu_torch.engine import Engine, construct_operator, run_graph
from arroyo_tpu_torch.engine import segment as seg
from arroyo_tpu_torch.expr import BinOp, Col, Lit
from arroyo_tpu_torch.graph import EdgeType, Graph, Node, OpName
from arroyo_tpu_torch.obs.events import recorder
from arroyo_tpu_torch.hashing import hash_columns
from arroyo_tpu_torch.metrics import registry
from arroyo_tpu_torch.ops import (hash_kernels, join_kernels, join_probe, kernels,
                                  segment_kernel, sharded_kernels)
from arroyo_tpu_torch.ops.aggregate import DeviceHashAggregator, _identity, combine_by_key_bin
from arroyo_tpu_torch.operators.base import TableSpec
from arroyo_tpu_torch.ops.slot_agg import SlotAggregator
from arroyo_tpu_torch.parallel import (ShardedAggregator, all_to_all, exchange, make_mesh,
                                       sharded_agg)
from arroyo_tpu_torch import faults
from arroyo_tpu_torch.analysis.plan_diff import diff_plans
from arroyo_tpu_torch.faults import InjectedFault
from arroyo_tpu_torch.state.integrity import fsck_job, pick_restore_epoch
from arroyo_tpu_torch.state.tables import (TableManager, checkpoint_dir, compact_job,
                                           is_quarantined, latest_complete_checkpoint,
                                           read_job_checkpoint_metadata, write_evolution_mapping)
from arroyo_tpu_torch.types import TaskInfo

WIDTH = 10_000_000
SLIDE = 2_000_000
Q7_EVENTS = 2_000_000
Q5_EVENTS = Q7_EVENTS // 2  # bench.py runs q5 at events // 2
Q8_EVENTS = Q7_EVENTS // 4  # bench.py runs q8 at events // 4, queue 1 x batch
BENCH_BATCH = 65536

# Nexmark q7, q5 and q8 written as SQL (the sql phase plans them through the
# port's arroyo_tpu_torch.sql.plan_query). The source declares the generator's
# flattened columns by their dotted names; its options are numbers, as the
# nexmark connector reads them.
SQL_NEXMARK_SOURCE = """CREATE TABLE nexmark (
  "auction.id" BIGINT,
  "bid.auction" BIGINT,
  "bid.price" BIGINT,
  auction BOOLEAN,
  bid BOOLEAN
) WITH (
  connector = 'nexmark',
  event_count = {events},
  inter_event_micros = {inter_event},
  first_event_micros = 0,
  include_strings = false,
  type = 'source'
);
"""
SQL_Q7 = """CREATE TABLE q7_out (start TIMESTAMP, auction BIGINT, max_price BIGINT, bids BIGINT)
WITH (connector = 'single_file', path = '{out}', format = 'json', type = 'sink');
INSERT INTO q7_out
SELECT window.start AS start, auction, max_price, bids FROM (
  SELECT tumble(interval '10 seconds') AS window, "bid.auction" AS auction,
    max("bid.price") AS max_price, count(*) AS bids
  FROM nexmark WHERE bid GROUP BY window, auction) x;
"""
SQL_Q5 = """CREATE TABLE q5_out (start TIMESTAMP, auction BIGINT, bids BIGINT)
WITH (connector = 'single_file', path = '{out}', format = 'json', type = 'sink');
INSERT INTO q5_out
SELECT window.start AS start, auction, bids FROM (
  SELECT hop(interval '2 seconds', interval '10 seconds') AS window,
    "bid.auction" AS auction, count(*) AS bids
  FROM nexmark WHERE bid GROUP BY window, auction) x;
"""
SQL_Q8 = """CREATE TABLE q8_out (start TIMESTAMP, auction BIGINT, bids BIGINT)
WITH (connector = 'single_file', path = '{out}', format = 'json', type = 'sink');
INSERT INTO q8_out
SELECT A.window.start AS start, A.auction AS auction, B.bids AS bids FROM (
  SELECT tumble(interval '10 seconds') AS window, "auction.id" AS auction, count(*) AS n
  FROM nexmark WHERE auction GROUP BY window, auction) A
JOIN (
  SELECT tumble(interval '10 seconds') AS window, "bid.auction" AS auction,
    count(*) AS bids
  FROM nexmark WHERE bid GROUP BY window, auction) B
ON A.window = B.window AND A.auction = B.auction;
"""
SQL_INTER_EVENT = {"q7": 1000, "q5": 1000, "q8": 100}


def nexmark_sql(name: str, events: int, out: str) -> str:
    """The SQL text of Nexmark ``name`` (q7, q5, q8) over ``events`` events
    at bench.py's inter-event time, writing JSON lines to ``out``."""
    body = {"q7": SQL_Q7, "q5": SQL_Q5, "q8": SQL_Q8}[name]
    return (SQL_NEXMARK_SOURCE.format(events=int(events), inter_event=SQL_INTER_EVENT[name])
            + body.format(out=out))
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
TIMING_REPS = 20  # timed calls a measurement (30 before a cut for the run's time limit)
WARM_TRACE_S = 0.05  # device_trace: the profiler idles this long around the traced work
# the kernels q7c and q5 must launch (K1, K2 in its read-and-clear mode,
# K4); q8c's are K4, K5, K6. A destructive close launches no K3.
AGG_PATH_KERNELS = ("slot_scatter_combine", "slot_region_read_pack_clear", "segment_fused")
# every launch count of the device window's kernels (K1-K3, K2 by mode)
WINDOW_KERNELS = ("slot_scatter_combine", "slot_region_read_pack", "slot_region_read_pack_clear",
                  "slot_region_clear")
WATCHDOG_S = 1100  # dump every thread's stack and exit before the 1200 s limit
# every run's checkpoint storage (a drained source writes its "final"
# snapshot): a temporary directory main() makes and removes
STORAGE_ROOT = None
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
    """Every csrc/*.cu, one nvcc each, and the native host library (one
    g++), all started together."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    from arroyo_tpu_torch import native

    libs = (kernels.build_library, join_kernels.build_library, sharded_kernels.build_library,
            hash_kernels.build_library, native.lib)
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(b) for b in libs]:
            f.result()
    info = {"phase": "build", "seconds": time.perf_counter() - t0, "sources": {},
            "native": {k: native.build_info[k] for k in ("seconds", "cached", "path")}}
    for name, b in kernels.build_info.items():
        info["sources"][name] = {
            "nvcc_seconds": b["seconds"], "cached": b["cached"], "library": b["path"],
            "ptxas": [ln.strip() for ln in b["log"].splitlines()
                      if "registers" in ln or "spill" in ln]}
        with open(os.path.join(out_dir, f"{name}_build.log"), "w") as f:
            f.write(b["log"])
    emit(info)
    print(f"build: {info['seconds']:.3f} s, native host library {info['native']['seconds']:.3f} s "
          f"({'cached' if info['native']['cached'] else 'built'})", flush=True)
    return info


# ---------------------------------------------------------------- q7


def build_q7(rows: list, event_count: int, parallelism: int = 1, width: int = None,
             noop_filter: bool = False) -> Graph:
    """bench.py's q7: bids -> tumbling 10 s MAX(price) + COUNT per auction;
    ``parallelism`` subtasks of the window (each its own slot store). The
    recovery phase's plan edits: another window ``width``, and a VALUE node
    that also filters ``price >= 0`` (no bid is dropped)."""
    S = Schema.of([("x", "int64"), (TIMESTAMP_FIELD, "int64")])
    g = Graph()
    g.add_node(Node("src", OpName.SOURCE, {
        "connector": "nexmark", "event_count": event_count, "inter_event_micros": 1000,
        "first_event_micros": 0, "include_strings": False,
        "columns": ["bid.auction", "bid.price"]}, 1))
    filt = Col("bid")
    if noop_filter:
        filt = BinOp("and", filt, BinOp(">=", Col("bid.price"), Lit(0)))
    g.add_node(Node("bids", OpName.VALUE, {
        "projections": [("auction", Col("bid.auction")), ("price", Col("bid.price"))],
        "filter": filt}, 1))
    g.add_node(Node("wm", OpName.WATERMARK, {
        "expr": Col(TIMESTAMP_FIELD), "interval_micros": 1_000_000}, 1))
    g.add_node(Node("key", OpName.KEY, {"keys": [("auction", Col("auction"))]}, 1))
    g.add_node(Node("agg", OpName.TUMBLING_AGGREGATE, {
        "width_micros": width or WIDTH, "key_fields": ["auction"],
        "aggregates": [("max_price", "max", Col("price")), ("bids", "count", None)],
        "input_dtype_of": lambda e: np.dtype(np.int64)}, parallelism))
    g.add_node(Node("sink", OpName.SINK, {"connector": "vec", "rows": rows, "columnar": True}, 1))
    g.add_edge("src", "bids", EdgeType.FORWARD, S)
    g.add_edge("bids", "wm", EdgeType.FORWARD, S)
    g.add_edge("wm", "key", EdgeType.FORWARD, S)
    g.add_edge("key", "agg", EdgeType.SHUFFLE, S)
    g.add_edge("agg", "sink", EdgeType.FORWARD, S)
    return g


@functools.lru_cache(maxsize=2)
def oracle_q7(event_count: int) -> dict:
    """(window_start, auction) -> (max_price, count), numpy alone (computed
    once for each event count: the phases only read it)."""
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
    if STORAGE_ROOT is not None:
        tcfg.update({"checkpoint.storage-url": STORAGE_ROOT})
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


class BarrierGate(queue.Queue):
    """A source task's control queue that holds the source at its
    ``polls``-th poll (the nexmark source polls once before each batch) until
    a control message arrives: a checkpoint triggered once ``reached`` is set
    lands after exactly ``polls - 1`` batches, whatever the machine's speed.
    ``polls`` may name several polls, each held the same way
    (``reached_at[p]``), so each of several epochs lands at its own batch.
    Both packages' sources poll through ``get_nowait``."""

    def __init__(self, polls, timeout_s: float = 600.0):
        super().__init__()
        holds = (polls,) if isinstance(polls, int) else tuple(polls)
        self.polls = holds[0]
        self.timeout_s = timeout_s
        self.n = 0
        self.reached_at = {p: threading.Event() for p in holds}
        self.reached = self.reached_at[self.polls]

    def get_nowait(self):
        self.n += 1
        if self.n in self.reached_at:
            self.reached_at[self.n].set()
            return self.get(timeout=self.timeout_s)
        return super().get_nowait()


class _EverySet:
    """Events waited on together: ``wait`` is true once each is set."""

    def __init__(self, events: list):
        self.events = events

    def wait(self, timeout: float) -> bool:
        end = time.monotonic() + timeout
        return all(e.wait(max(0.0, end - time.monotonic())) for e in self.events)


class SourceGates:
    """A BarrierGate on each source task of one engine, all held at the
    same polls: a poll is reached (``reached``, ``reached_at[p]``) once
    every source has reached it."""

    def __init__(self, gates: list):
        self.gates = gates
        self.reached_at = {p: _EverySet([g.reached_at[p] for g in gates])
                           for p in gates[0].reached_at}
        self.reached = self.reached_at[gates[0].polls]


def gate_source(eng, polls) -> SourceGates:
    """Build ``eng`` (either package's Engine) and gate each of its source
    tasks (node ``src``, or a SQL plan's ``source_*``) at one poll, or at
    each of several."""
    if not eng.tasks:
        eng.build()
    gates = []
    for (node, _sub), task in eng.tasks.items():
        if node == "src" or node.startswith("source_"):
            gates.append(BarrierGate(polls))
            task.control_queue = gates[-1]
    if not gates:
        raise AssertionError(f"{eng.job_id}: no source task among {list(eng.tasks)}")
    return SourceGates(gates)


def run_gated_epochs(eng, holds, then_stop: bool = True, timeout: float = 600.0,
                     before_epoch=None) -> dict:
    """Start ``eng`` (either package's Engine) with its source held at each
    poll of ``holds``; at the i-th hold checkpoint epoch i + 1 and wait for
    it (the last with ``then_stop``), then stop and join. ``before_epoch(e)``
    runs just before epoch e's trigger. Returns each epoch's
    barrier-to-ack ms."""
    gate = gate_source(eng, holds)
    eng.start()
    acks = {}
    for i, p in enumerate(holds):
        if not gate.reached_at[p].wait(timeout):
            raise AssertionError(f"{eng.job_id}: the source never reached poll {p}")
        if before_epoch is not None:
            before_epoch(i + 1)
        t0 = time.perf_counter()
        res = eng.checkpoint_and_wait(i + 1, timeout=timeout,
                                      then_stop=then_stop and i == len(holds) - 1)
        acks[i + 1] = (time.perf_counter() - t0) * 1e3
        if not res:
            raise AssertionError(f"{eng.job_id}: epoch {i + 1} did not complete: {res!r}")
    eng.stop()
    eng.join(timeout=timeout)
    return acks


def window_node(eng, name: str = "agg") -> str:
    """The node of ``eng``'s (chained) graph that holds operator ``name``."""
    return next(n for n in eng.graph.nodes if name in n.split("+"))


def crash_at_last_barrier(eng, holds, timeout: float = 600.0) -> float:
    """Like run_gated_epochs, but the last epoch's barrier crashes a task (a
    ``worker:crash`` fault installed by the caller): the epochs before it
    complete, the last fails the job loudly (checkpoint_and_wait and join
    raise). Returns the ms from the last trigger to the failure."""
    gate = gate_source(eng, holds)
    eng.start()
    for i, p in enumerate(holds):
        if not gate.reached_at[p].wait(timeout):
            raise AssertionError(f"{eng.job_id}: the source never reached poll {p}")
        if i < len(holds) - 1:
            if not eng.checkpoint_and_wait(i + 1, timeout=timeout):
                raise AssertionError(f"{eng.job_id}: epoch {i + 1} did not complete")
            continue
        t0 = time.perf_counter()
        try:
            eng.checkpoint_and_wait(i + 1, timeout=timeout)
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
            crash_ms = (time.perf_counter() - t0) * 1e3
        else:
            raise AssertionError(f"{eng.job_id}: epoch {i + 1} completed through its crash")
    try:
        eng.join(timeout=timeout)
    except RuntimeError as e:
        if "injected" not in str(e):
            raise
    else:
        raise AssertionError(f"{eng.job_id}: the job ended cleanly after a crash")
    return crash_ms


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


@functools.lru_cache(maxsize=2)
def oracle_q5(event_count: int) -> dict:
    """(window_start, auction) -> count over sliding 10 s / 2 s windows
    (bench.py oracle_q5, vectorized): slide bin sb feeds the windows that
    start at sb, sb - 2 s, ..., sb - 8 s. Computed once for each event
    count: the phases only read it."""
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
    if not any(st.get("segment_compiled")
               for st in seg_metrics.get(chained[0], {}).get("per_subtask", {}).values()):
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


def oracle_sql(name: str, event_count: int) -> dict:
    """(window start micros, auction) -> the rest of the row, for the SQL
    texts of q7 (max_price, bids), q5 (bids) and q8 (bids of the auctions
    that opened in the window): numpy over the generated events."""
    if name == "q7":
        return oracle_q7(event_count)
    if name == "q5":
        return {k: (c,) for k, c in oracle_q5(event_count).items()}
    b = q8_events(event_count)
    w = (b[TIMESTAMP_FIELD] // WIDTH) * WIDTH

    def counts(mask, ids):
        uniq, c = np.unique(np.stack([w[mask], ids[mask]], axis=1), axis=0, return_counts=True)
        return {(int(u[0]), int(u[1])): int(n) for u, n in zip(uniq, c)}

    na = counts(b["auction"], b["auction.id"])
    nb = counts(b["bid"], b["bid.auction"])
    return {k: (nb[k],) for k in na.keys() & nb.keys()}


SQL_OUT_FIELDS = {"q7": ("max_price", "bids"), "q5": ("bids",), "q8": ("bids",)}


def check_sql_rows(name: str, lines: list, want: dict) -> int:
    """The sink's JSON lines of a SQL-planned q7, q5 or q8 held exactly to
    ``oracle_sql``: one row per (window, auction), each value equal.
    Returns the number of rows."""
    from arroyo_tpu_torch.formats.json_fmt import parse_iso_micros

    got: dict = {}
    starts: dict = {}  # a window start's text -> micros (a few hundred windows)
    for r in json.loads("[" + ",".join(lines) + "]"):
        s = r["start"]
        if s not in starts:
            starts[s] = parse_iso_micros(s)
        key = (starts[s], int(r["auction"]))
        if key in got:
            raise AssertionError(f"{name}: window {key} emitted twice")
        got[key] = tuple(int(r[f]) for f in SQL_OUT_FIELDS[name])
    if got != want:
        diff = next(iter(set(got.items()) ^ set(want.items())), None)
        raise AssertionError(f"{name} (SQL) parity failure: {len(got)} rows vs {len(want)}; "
                             f"first diff {diff}")
    return len(got)


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
            st = seg_metrics.get(node, {}).get("per_subtask", {}).get("0", {})
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


F64_MIN = float(np.finfo(np.float64).tiny)


def c9_columns(n: int, seed: int = 20261018) -> dict:
    """grid_columns with the float columns XLA's CPU compilation treats
    apart from numpy (C9): subnormals of both signs, values next to FLT_MIN
    and DBL_MIN on both sides, values whose products and quotients by the
    grid's literals land among the subnormals, +-0.0, NaN and +-inf, mixed
    into normal values; ``s64`` holds only subnormals and zeros (a
    watermark whose max is a subnormal)."""
    rng = np.random.default_rng(seed)
    cols = grid_columns(n, seed)

    def tiny(dt, m):
        lo = float(np.finfo(dt).smallest_subnormal)
        t = float(np.finfo(dt).tiny)
        sub = np.exp(rng.uniform(np.log(lo), np.log(t), m)) * rng.choice([-1.0, 1.0], m)
        near = t * (1 + rng.integers(-4, 5, m) * float(np.finfo(dt).eps))
        near *= rng.choice([-1.0, 1.0], m)
        scaled = t * rng.uniform(0.5, 2e3, m) * rng.choice([-1.0, 1.0], m)
        return np.concatenate([sub, near, scaled]).astype(dt)

    for name, dt, scale in (("f64", np.float64, 1e3), ("f32", np.float32, 50.0)):
        x = rng.normal(0, scale, n).astype(dt)
        t = tiny(dt, n)
        pick = rng.random(n) < 0.6
        x[pick] = t[rng.integers(0, len(t), int(pick.sum()))]
        edge = [np.nan, np.inf, -np.inf, 0.0, -0.0, np.finfo(dt).smallest_subnormal,
                -np.finfo(dt).smallest_subnormal, np.finfo(dt).tiny, -np.finfo(dt).tiny, 3.0,
                3e-306 if dt == np.float64 else 3e-36, -3e-306 if dt == np.float64 else -3e-36]
        x[:len(edge)] = edge
        cols[name] = x
    s = np.exp(rng.uniform(np.log(5e-324), np.log(F64_MIN), n)) * rng.choice([-1.0, 1.0], n)
    s[rng.random(n) < 0.2] = 0.0
    cols["s64"] = s
    return cols


def c9_expressions(E) -> list:
    """C9's expressions beside the grid's: products that underflow,
    divisions by float literals (XLA multiplies by the reciprocal),
    those quotients under an add or a subtract (a multiply then an add,
    which XLA contracts), ``x * bool`` both ways round, comparisons with
    zero and with each other, and conversions out of and into the
    subnormal range."""
    c, lit = E.Col, E.Lit
    out = []
    for x in ("f64", "f32", "i32"):
        out.append((f"{x} * 0.001", E.BinOp("*", c(x), lit(0.001))))
        for k in (3.0, 10.0, 0.1, 7.0, 2.0, -4.0) + ((3,) if x != "i32" else ()):
            out.append((f"{x} / {k}", E.BinOp("/", c(x), lit(k))))
        out.append((f"{x} / 3.0 + f64", E.BinOp("+", E.BinOp("/", c(x), lit(3.0)), c("f64"))))
        out.append((f"f64 - {x} / 10.0", E.BinOp("-", c("f64"), E.BinOp("/", c(x), lit(10.0)))))
        out.append((f"{x} * b", E.BinOp("*", c(x), c("b"))))
        out.append((f"b * {x}", E.BinOp("*", c("b"), c(x))))
    f = ("f64", "f32")
    for x in f:
        out.append((f"{x} * {x} + {x}", E.BinOp("+", E.BinOp("*", c(x), c(x)), c(x))))
        out.append((f"{x} - {x} * 2.5", E.BinOp("-", c(x), E.BinOp("*", c(x), lit(2.5)))))
        out.append((f"{x} * 2.5 - 1.0", E.BinOp("-", E.BinOp("*", c(x), lit(2.5)), lit(1.0))))
        for op in ("==", "!=", "<", ">=", ">"):
            out.append((f"{x} {op} 0.0", E.BinOp(op, c(x), lit(0.0))))
        out.append((f"{x} < s64", E.BinOp("<", c(x), c("s64"))))
        out.append((f"{x} + 0", E.BinOp("+", c(x), lit(0))))
        out.append((f"{x} * 1.0", E.BinOp("*", c(x), lit(1.0))))
        out.append((f"{x} * -1", E.BinOp("*", c(x), lit(-1))))
        out.append((f"{x} - 0.0", E.BinOp("-", c(x), lit(0.0))))
        out.append((f"0.0 - {x}", E.BinOp("-", lit(0.0), c(x))))
        out.append((f"{x} * 1e-300", E.BinOp("*", c(x), lit(1e-300))))
        out.append((f"case {x}", E.Case(((E.BinOp(">", c(x), lit(0.0)), c(x)),), E.Neg(c(x)))))
    out.append(("cast(f64 * 1e-10, float32)", E.Cast(E.BinOp("*", c("f64"), lit(1e-10)), "float32")))
    out.append(("s64 * 2.0", E.BinOp("*", c("s64"), lit(2.0))))
    return out


def c9_segment_plans(E) -> list:
    """(label, member configs, hoist) of the plans C9 is held on, over
    ``c9_columns``: the expression grid in the grid's own chunks (so K4's
    programs are the grid's: the dtypes and expressions are the same, only
    the data differ), C9's expressions in chunks of their own, each behind
    an in-trace filter; float keys (hashed after the flush), a watermark
    whose max is a subnormal, and a tumbling insert whose float64
    accumulator input converts a float32 product."""
    c, lit = E.Col, E.Lit
    plans = (expression_chunks(E, expression_grid(E), "c9 exprs")
             + expression_chunks(E, c9_expressions(E), "c9 own exprs"))
    plans.append(("c9 float keys", [
        ("value", {"projections": None, "filter": E.BinOp("!=", c("d32"), lit(0))}),
        ("watermark", {"expr": c("s64")}),
        ("key", {"keys": [("k1", c("f64")), ("k2", c("f32")),
                          ("k3", E.BinOp("*", c("f64"), lit(0.001)))]})], False))
    plans.append(("c9 tumbling insert", [
        ("value", {"projections": [("auction", c("i64")), ("price", c("f32")),
                                   (TIMESTAMP_FIELD, c(TIMESTAMP_FIELD))], "filter": None}),
        ("watermark", {"expr": c(TIMESTAMP_FIELD)}),
        ("key", {"keys": [("auction", c("auction")), ("p", c("price"))]}),
        ("tumbling_aggregate", {"width_micros": WIDTH, "key_fields": ["auction"],
                                "aggregates": [("s", "sum", E.BinOp("*", c("price"), lit(1e-3))),
                                               ("q", "max", E.BinOp("/", c("price"), lit(3.0)))],
                                "input_dtype_of": lambda e: np.dtype(np.float64)})], False))
    return plans


def expression_chunks(E, exprs: list, prefix: str, chunk: int = 48) -> list:
    """(label, member configs, hoist) plans that project ``exprs``, ``chunk``
    at a time, behind an in-trace filter and a float watermark."""
    c, lit = E.Col, E.Lit
    filt = E.BinOp(">", c("i32"), lit(-900))
    plans = []
    for k in range(0, len(exprs), chunk):
        part = exprs[k:k + chunk]
        proj = [(f"e{k + j}", e) for j, (_l, e) in enumerate(part)] + [("w", c("g64"))]
        plans.append((f"{prefix} {k}-{k + len(part) - 1}", [
            ("value", {"projections": proj, "filter": filt}),
            ("watermark", {"expr": c("w")})], False))
    return plans


def segment_grid(E) -> list:
    """(label, member configs, hoist) of every plan K4 is held on besides
    the nexmark ones: the expression grid in chunks of projections behind an
    in-trace filter and a float watermark, multi-column keys (with the
    filter hoisted), and a tumbling insert over negative timestamps."""
    c, lit = E.Col, E.Lit
    plans = expression_chunks(E, expression_grid(E), "exprs")
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
        if buf.dtype.kind == "u" and buf.itemsize > 1:
            buf = buf.view(f"i{buf.itemsize}")  # unsigned columns cross as their signed bits
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


def c9_plans() -> list:
    """C9's plans over ``c9_columns``: K4 held to its plain version (which
    tests/test_torch_segment.py holds to the JAX compiled segment) on
    subnormals, literal divisions, multiply-adds, ``x * bool`` and float
    keys."""
    from arroyo_tpu_torch import expr as E

    cb = Batch(c9_columns(GRID_N))
    return [(label, bind_plan(members, cb, hoist), cb) for label, members, hoist in c9_segment_plans(E)]


C4_UNSIGNED = ("u16", "u32", "u64")


def c4_columns(n: int, seed: int = 20261019) -> dict:
    """grid_columns with the dtypes of C4: uint16, uint32 and uint64 columns
    holding 0, 1, the type's max, its top bit and values past the signed
    range (``du16``/``du32``/``du64``: divisors with zeros), and a float16
    column with NaN, +-inf, +-0.0, subnormals, the largest finite values and
    values whose sums and products round in float16."""
    rng = np.random.default_rng(seed)
    cols = grid_columns(n, seed)
    for name, dt in (("u16", np.uint16), ("u32", np.uint32), ("u64", np.uint64)):
        info = np.iinfo(dt)
        bits = info.bits
        x = rng.integers(0, 1 << min(bits, 63), n, dtype=np.uint64)
        if bits == 64:
            x |= (rng.random(n) < 0.5).astype(np.uint64) << np.uint64(63)
        x = x.astype(dt)
        x[:8] = [0, 1, info.max, 1 << (bits - 1), (1 << (bits - 1)) - 1, 7, info.max - 6, 3]
        cols[name] = x
        d = rng.integers(0, 9, n).astype(dt)
        d[:8] = [0, 0, 1, info.max, 1 << (bits - 1), 3, 2, 0]
        cols["d" + name] = d
    h = (rng.normal(0, 40, n)).astype(np.float16)
    sub = rng.integers(1, 1024, n).astype(np.uint16) | (rng.integers(0, 2, n).astype(np.uint16) << 15)
    pick = rng.random(n) < 0.2
    h[pick] = sub[pick].view(np.float16)  # subnormals of both signs
    big = rng.random(n) < 0.05
    h[big] = rng.uniform(-65504, 65504, int(big.sum())).astype(np.float16)
    edge = [np.nan, np.inf, -np.inf, 0.0, -0.0, 65504.0, -65504.0, 0.5, -1.5, 2.5,
            np.float16(2.0 ** -24), -np.float16(2.0 ** -24), np.float16(6.1e-5), 2049.0, 3.0]
    h[:len(edge)] = np.array(edge, dtype=np.float16)
    # NaNs of other payloads and signs, a signalling one among them
    h[len(edge):len(edge) + 3] = np.array([0x7C01, 0xFE55, 0x7E01], dtype=np.uint16).view(np.float16)
    cols["f16"] = h
    return cols


def c4_expressions(E) -> list:
    """C4's expressions: every allowlisted binop of an unsigned or float16
    column with itself, its divisor column, the grid's signed and float
    columns and literals; neg, abs, floor, ceil, sqrt, not and every cast of
    each; floor division through extract_epoch and date_trunc_micros; CASE
    over them."""
    c, lit = E.Col, E.Lit
    out = []
    for x in C4_UNSIGNED + ("f16",):
        others = [(x, c(x)), ("i32", c("i32")), ("i64", c("i64")), ("f32", c("f32")),
                  ("f64", c("f64")), ("b", c("b")), ("int", lit(3)), ("float", lit(2.5)),
                  ("bool", lit(True))]
        if x != "f16":
            others.insert(1, ("d" + x, c("d" + x)))
        else:
            others += [("u16", c("u16")), ("u32", c("u32"))]
        for op in ("+", "-", "*", "/", "%", "==", "<", ">=", "and"):
            for yn, ye in others:
                if op in ("/", "%") and yn in ("b", "bool", x) and x != "f16":
                    continue  # divisors: the columns and literals holding zeros
                out.append((f"{x} {op} {yn}", E.BinOp(op, c(x), ye)))
                if op in ("-", "/", "<") and yn not in (x,):
                    out.append((f"{yn} {op} {x}", E.BinOp(op, ye, c(x))))
        for name in ("abs", "floor", "ceil", "sqrt") + (("extract_epoch",) if x != "u16" else ()):
            out.append((f"{name}({x})", E.Func(name, (c(x),))))
        out.append((f"date_trunc_micros(7, {x})", E.Func("date_trunc_micros", (lit(7), c(x)))))
        out.append((f"-{x}", E.Neg(c(x))))
        out.append((f"not {x}", E.Not(c(x))))
        for t in ("int32", "int64", "uint64", "float32", "float64", "bool"):
            out.append((f"cast({x}, {t})", E.Cast(c(x), t)))
    out.append(("f16 * f16 + f16", E.BinOp("+", E.BinOp("*", c("f16"), c("f16")), c("f16"))))
    out.append(("f16 / 3.0", E.BinOp("/", c("f16"), lit(3.0))))
    out.append(("f16 * 2.0 - 1.0", E.BinOp("-", E.BinOp("*", c("f16"), lit(2.0)), lit(1.0))))
    out.append(("cast(f64, float32) * f16", E.BinOp("*", E.Cast(c("f64"), "float32"), c("f16"))))
    out.append(("u64 * u64 + u64", E.BinOp("+", E.BinOp("*", c("u64"), c("u64")), c("u64"))))
    out.append(("case u32", E.Case(((E.BinOp("<", c("u32"), c("du32")), c("u16")),), c("u32"))))
    out.append(("case u64", E.Case(((c("b"), c("u64")),), c("du64"))))
    out.append(("case f16", E.Case(((E.BinOp(">", c("f16"), lit(0.0)), c("f16")),), E.Neg(c("f16")))))
    out.append(("case f16 f32", E.Case(((c("b"), c("f16")),), c("f32"))))
    return out


def c4_departing() -> set:
    """Labels of C4's expressions whose twin departs from numpy in dtype
    (a float16 column with a 32-bit integer is float16 in jax.numpy and
    float64 in numpy, for example): a segment projecting one fails its
    first-batch verification and runs interpreted, in both packages."""
    from arroyo_tpu_torch import expr as E

    cols = {k: np.ones_like(v) for k, v in c4_columns(64).items()}
    tv = {k: E.TVal(torch.from_numpy(np.ascontiguousarray(v).view(E.storage_dtype(v.dtype))),
                    v.dtype) for k, v in cols.items()}
    out = set()
    for label, e in c4_expressions(E):
        want = np.asarray(E.eval_expr(e, cols, 64)).dtype
        got = e.eval_torch(tv)
        if (got.dt if isinstance(got, E.TVal) else None) != want:
            out.add(label)
    return out


def c4_segment_plans(E) -> list:
    """(label, member configs, hoist) of the plans C4 is held on, over
    ``c4_columns``: C4's expressions in chunks behind an in-trace filter,
    keys of each C4 dtype (hashed), watermarks over uint16/32/64 (their
    max read unsigned; one filter keeps no row), and a tumbling insert whose float64
    average input casts a uint64 counter (the SQL family
    tumbling_aggregates' avg)."""
    c, lit = E.Col, E.Lit
    departs = c4_departing()
    exprs = c4_expressions(E)
    plans = (expression_chunks(E, [x for x in exprs if x[0] not in departs], "c4 exprs")
             + expression_chunks(E, [x for x in exprs if x[0] in departs], "c4 departs"))
    plans.append(("c4 keys", [
        ("value", {"projections": None, "filter": E.BinOp("!=", c("du32"), lit(0))}),
        ("watermark", {"expr": c(TIMESTAMP_FIELD)}),
        ("key", {"keys": [("k1", c("u16")), ("k2", c("u32")), ("k3", c("u64")),
                          ("k4", c("f16"))]})], False))
    for label, keep in (("c4 watermarks", E.BinOp("!=", c("du32"), lit(0))),
                        ("c4 watermarks, high u16 dropped", E.BinOp("<", c("u16"), lit(40000))),
                        ("c4 watermarks, no row", E.BinOp(">", c("u16"), c("u16")))):
        plans.append((label, [("value", {"projections": None, "filter": keep})]
                      + [("watermark", {"expr": e}) for e in
                         (c("u16"), c("u32"), c("u64"), E.BinOp("+", c("u64"), lit(1)))], False))
    plans.append(("c4 tumbling insert", [
        ("value", {"projections": [("counter", c("u64")), ("h", c("f16")),
                                   (TIMESTAMP_FIELD, c(TIMESTAMP_FIELD))], "filter": None}),
        ("watermark", {"expr": c(TIMESTAMP_FIELD)}),
        ("tumbling_aggregate", {"width_micros": WIDTH, "key_fields": [],
                                "aggregates": [("s", "sum", c("counter")),
                                               ("a", "avg", E.Cast(c("counter"), "float64")),
                                               ("m", "max", c("h"))],
                                "input_dtype_of": lambda e: np.dtype(np.float64)})], False))
    return plans


def c4_plans() -> list:
    """C4's plans over ``c4_columns``: K4 held to its plain version (which
    tests/test_torch_c4.py holds to the JAX compiled segment) on uint16,
    uint32 and uint64 arithmetic and float16."""
    from arroyo_tpu_torch import expr as E

    cb = Batch(c4_columns(GRID_N))
    return [(label, bind_plan(members, cb, hoist), cb) for label, members, hoist in c4_segment_plans(E)]


def c10_columns(n: int, seed: int = 20261020) -> dict:
    """c4_columns with two more float16 columns (``h2``, ``h3``: NaNs of
    both signs and payloads, +-inf, zeros, subnormals, values whose products
    and sums round in float16) for C10's multiply-adds and remainders, and
    float32 / float64 subnormals among the grid's edge values."""
    rng = np.random.default_rng(seed)
    cols = c4_columns(n, seed)
    for name in ("h2", "h3"):
        h = rng.normal(0, 30, n).astype(np.float16)
        sub = rng.integers(1, 1024, n).astype(np.uint16) | (rng.integers(0, 2, n).astype(np.uint16) << 15)
        pick = rng.random(n) < 0.1
        h[pick] = sub[pick].view(np.float16)
        h[rng.random(n) < 0.03] = 0.0
        edge = [1.5, np.nan, -2.0, np.inf, 0.0, 0.5, -np.inf, 3.0, 2049.0, -0.0, 1.0, 65504.0]
        h[:len(edge)] = np.roll(np.array(edge, dtype=np.float16), 3 if name == "h3" else 0)
        h[len(edge):len(edge) + 2] = np.array([0xFE33, 0x7C05], dtype=np.uint16).view(np.float16)
        cols[name] = h
    # subnormal float32 / float64 dividends of the remainders by powers of two
    cols["f32"][12:15] = np.array([1e-40, -1e-41, 3e-39], dtype=np.float32)
    cols["f64"][12:15] = [1e-310, -5e-320, 2e-308]
    return cols


def c10_expressions(E) -> list:
    """C10's expressions: float16 multiply-adds of every form XLA contracts
    on a host with AVX512-FP16 (e460 and its kin) and those it does not
    (a product of 2.0, a float16 product into a float32 add, e463's float32
    product; no product is an output, which XLA would read from memory
    instead of contracting), remainders and floor divisions by literal powers of two (e391)
    and by other divisors (floor division through date_trunc_micros), float32
    and float64 remainders by literal powers of two, 0 / 0, compares and
    conversions of float16 (e393)."""
    c, lit, B = E.Col, E.Lit, E.BinOp
    x, y, z = c("f16"), c("h2"), c("h3")
    return [
        ("x * y + z", B("+", B("*", x, y), z)),
        ("x * y - z", B("-", B("*", x, y), z)),
        ("z - x * y", B("-", z, B("*", x, y))),
        ("-(x * y) + z", B("+", E.Neg(B("*", x, y)), z)),
        ("x * 3.0 + z", B("+", B("*", x, lit(3.0)), z)),
        ("f32 * y32 - z32", B("-", B("*", c("f32"), E.Cast(y, "float32")), E.Cast(z, "float32"))),
        ("z32 - f32 * x32", B("-", E.Cast(z, "float32"), B("*", c("f32"), E.Cast(x, "float32")))),
        ("-(f64 * y64) + z64", B("+", E.Neg(B("*", c("f64"), E.Cast(y, "float64"))),
                                  E.Cast(z, "float64"))),
        ("x / 3.0 + z", B("+", B("/", x, lit(3.0)), z)),
        ("x * 2.0 - 1.0", B("-", B("*", x, lit(2.0)), lit(1.0))),
        ("x * y + f32", B("+", B("*", x, y), c("f32"))),
        ("cast(f64, float32) * x + z", B("+", B("*", E.Cast(c("f64"), "float32"), x), z)),
        ("x % True", B("%", x, lit(True))),
        ("x % 2.0", B("%", x, lit(2.0))),
        ("x % -4", B("%", x, lit(-4))),
        ("x % 0.5", B("%", x, lit(0.5))),
        ("x % 3.0", B("%", x, lit(3.0))),
        ("x % y", B("%", x, y)),
        ("date_trunc_micros(2, x)", E.Func("date_trunc_micros", (lit(2), x))),
        ("date_trunc_micros(4, f32)", E.Func("date_trunc_micros", (lit(4), c("f32")))),
        ("f32 % 1.0", B("%", c("f32"), lit(1.0))),
        ("f64 % 4.0", B("%", c("f64"), lit(4.0))),
        ("f32 % True", B("%", c("f32"), lit(True))),
        ("y / y", B("/", y, y)),
        ("x / 0.0", B("/", x, lit(0.0))),
        ("x == i32", B("==", x, c("i32"))),
        ("x < i64", B("<", x, c("i64"))),
        ("cast(x, float32)", E.Cast(x, "float32")),
        ("cast(x, float64)", E.Cast(x, "float64")),
        ("cast(x, int32)", E.Cast(x, "int32")),
    ]


def c10_segment_plans(E) -> list:
    """(label, member configs, hoist) of C10's plans over ``c10_columns``:
    its expressions in one chunk behind an in-trace filter."""
    return expression_chunks(E, c10_expressions(E), "c10 exprs")


def c10_plans() -> list:
    """C10's plans over ``c10_columns``, K4 held to its plain version under
    each float16 model (tests/test_torch_c10.py holds the plain version to
    the JAX compiled segment on each kind of host)."""
    from arroyo_tpu_torch import expr as E

    cb = Batch(c10_columns(GRID_N))
    return [(label, bind_plan(members, cb, hoist), cb) for label, members, hoist in c10_segment_plans(E)]


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
            u = f"u{gn.itemsize}"
            expr = next((repr(e) for st in plan.stages if st.kind == "value"
                         for n, e in (st.member.projections or ()) if n == name), "")
            raise AssertionError(f"segment {label}: {name} {expr} differs from the plain version "
                                 f"at {len(bad)} rows, first {bad[:3].tolist()}: kernel "
                                 f"{gn[bad[:3]].tolist()} {[hex(x) for x in gn.view(u)[bad[:3]]]} "
                                 f"plain {wn[bad[:3]].tolist()} "
                                 f"{[hex(x) for x in wn.view(u)[bad[:3]]]}")
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


def compare_segment(label, plan, batch, dev, f16_model=None) -> dict:
    """compare_k4 on a bound plan's staged inputs (CompiledSegment.execute's
    staging), the program under float16 model ``f16_model`` (None: the
    host's)."""
    prog = segment_kernel.SegmentProgram(plan, [np.asarray(batch[c]).dtype for c in plan.traced_in],
                                         f16_model)
    n, ins = staged_inputs(plan, batch, dev)
    return {**compare_k4(label, prog, n, ins), "source_lines": prog.source.count("\n"),
            "digest": prog.digest, "f16_model": prog.f16_model}


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


def float64_members(E) -> list:
    """A float64 expression plan over the grid's columns, the code XLA's
    CPU compilation shapes (C9): a product that may underflow, divisions by
    literals, a multiply-add, a comparison with zero."""
    c, lit = E.Col, E.Lit
    return [("value", {"projections": [
        ("p", E.BinOp("*", c("f64"), lit(0.001))),
        ("q", E.BinOp("/", c("f64"), lit(3.0))),
        ("r", E.BinOp("+", E.BinOp("/", c("f64"), lit(10.0)), c("g64"))),
        ("s", E.BinOp(">", c("f64"), lit(0.0))),
        ("w", c("g64"))], "filter": None}),
        ("watermark", {"expr": c("w")})]


def k4_timing(plan, batch: Batch, dev) -> dict:
    """K4 and its plain version timed at one bound plan, with the bytes
    bound (each input read once, each output written once)."""
    prog = segment_kernel.SegmentProgram(plan, [np.asarray(batch[c]).dtype for c in plan.traced_in])
    n, ins = staged_inputs(plan, batch, dev)
    k = measure(lambda: segment_kernel.segment_fused(prog, n, ins))
    p = measure(lambda: segment_kernel.segment_plain(prog, n, ins))
    P = ins[0].shape[0]
    in_bytes = sum(t.element_size() * P for t in ins)
    out_bytes = sum(np.dtype(prog.out_dtypes[o]).itemsize * P for o in plan.traced_out) + \
        (P if prog.has_mask else 0)
    return {"ms": k["device_ms"], "call_ms": k["call_ms"], "method": k["method"],
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


def segment_phase(nex_plans: list) -> dict:
    from arroyo_tpu_torch import expr as E

    dev = torch.device("cuda")
    checked = {}
    t0 = time.perf_counter()
    for label, plan, batch in nex_plans + grid_plans() + c9_plans():
        log(f"segment: check {label}")
        checked[label] = compare_segment(label, plan, batch, dev)
    # C4's and C10's plans under both float16 models (C10): a plan whose
    # source is the same under both is one Triton program, compiled once
    # (the model reaches a program only through its source: a plan whose
    # source is the same under both is one program and one plain
    # computation, checked once)
    f16_sources: dict = {}
    dts = lambda plan, batch: [np.asarray(batch[c]).dtype for c in plan.traced_in]  # noqa: E731
    for label, plan, batch in c4_plans() + c10_plans():
        for model in (E.F16_WIDE, E.F16_NATIVE):
            digest = segment_kernel.SegmentProgram(plan, dts(plan, batch), model).digest
            if digest in f16_sources.setdefault(label, set()):
                continue
            log(f"segment: check {label} ({model} float16)")
            checked[f"{label} [{model} float16]"] = compare_segment(label, plan, batch, dev, model)
            f16_sources[label].add(digest)
    log("segment: K4's edge cases")
    edge = k4_edge_cases(nex_plans, dev)
    check_s = time.perf_counter() - t0
    gb = Batch(grid_columns(GRID_N))
    timing = k4_timing(*nex_plans[0][1:], dev)  # q7's plan
    timing_f64 = k4_timing(bind_plan(float64_members(E), gb, hoist=False), gb, dev)
    info = {"phase": "segment", "plans_checked": len(checked), "check_seconds": check_s,
            "host_float16_model": E.host_float16_model(),
            "float16_plans_with_two_programs": sorted(k for k, v in f16_sources.items()
                                                      if len(v) == 2),
            "max_abs_err": 0.0, "checked": checked, "edge_cases": edge, "timing_q7": timing,
            "timing_float64": timing_f64}
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
    # float32 subnormals (XLA reads and writes them as the zero of their
    # sign): in state and values, +-0.0 beside them, and normal values whose
    # running sum cancels into the subnormal range; short runs and a long one
    add("float32 subnormals and -0.0", rng.permutation(np.concatenate(
        [np.repeat(np.arange(8), 3), np.full(L + 5, 8), np.full(4, 9)])), specials=False)
    pool = np.array([1e-40, -1e-40, 3e-39, -3e-39, -0.0, 0.0, 1.5e-38, -1.4e-38, 1.0],
                    dtype=np.float32)
    for (_k, dt), a, v in zip(lanes, cases[-1]["state"], cases[-1]["vals"]):
        if dt == np.float32:
            a[:4] = np.array([1e-40, -1e-40, 1.2e-38, -0.0], dtype=np.float32)
            a[9] = np.float32(-2e-40)  # slot 9 adds +-0.0 alone below
            v[:] = pool[rng.integers(0, len(pool), len(v))]
            v[cases[-1]["slots"] == 9] = rng.choice(np.array([-0.0, 0.0], np.float32), 4)
    # float64 subnormals (below DBL_MIN), which XLA on the CPU reads and
    # writes as the zero of their sign too (C8): the same shape of case
    add("float64 subnormals and -0.0", rng.permutation(np.concatenate(
        [np.repeat(np.arange(8), 3), np.full(L + 5, 8), np.full(4, 9)])), specials=False)
    pool = np.array([1e-310, -1e-310, 3e-309, -3e-309, -0.0, 0.0, 3e-308, -2.9e-308, 1.0])
    for (_k, dt), a, v in zip(lanes, cases[-1]["state"], cases[-1]["vals"]):
        if dt == np.float64:
            a[:4] = np.array([1e-310, -1e-310, 2.3e-308, -0.0])
            a[9] = -2e-310  # slot 9 adds +-0.0 alone below
            v[:] = pool[rng.integers(0, len(pool), len(v))]
            v[cases[-1]["slots"] == 9] = rng.choice(np.array([-0.0, 0.0]), 4)
    # float64 sums whose operands sit at csrc/float_flush.cuh's bound: 2^-970
    # (an exponent field of 53) and 2^-970 - 2^-1023 cancel to a subnormal,
    # so the fast pass must hand such runs to the exact pass
    add("float64 sums cancelling at the fast pass's bound", rng.permutation(np.concatenate(
        [np.repeat(np.arange(8), 3), np.full(L + 5, 8), np.full(4, 9)])), specials=False)
    pool = np.array([2.0 ** -970, -2.0 ** -970, 2.0 ** -970 - 2.0 ** -1023,
                     -(2.0 ** -970 - 2.0 ** -1023), 0.0, -0.0])
    for (_k, dt), a, v in zip(lanes, cases[-1]["state"], cases[-1]["vals"]):
        if dt == np.float64:
            a[:10] = pool[rng.integers(0, len(pool), 10)]
            v[:] = pool[rng.integers(0, len(pool), len(v))]
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
    """ns per add of one thread's chain of dependent adds, by dtype
    (csrc/slot_agg.cu add_chain_kernel: float64 bare __dadd_rn, float32
    add.rn.ftz.f32): a slot's run of float sums can go no faster (K1's chain
    floor)."""
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
    zero = [i for i, (k, dt) in enumerate(lanes) if k == "sum" and dt == torch.float64]
    if zero:
        # the same rows with each float64 sum's values and state 0: every
        # partial sum is exactly zero, and K1's fast pass stands
        zst, zvals = [a.clone() for a in st], list(vals)
        for i in zero:
            zst[i].zero_()
            zvals[i] = torch.zeros_like(vals[i])
        zplain = [a.clone() for a in zst]
        kernels.slot_scatter_combine(zst, kinds, slots, zvals)
        kernels.slot_scatter_combine_plain(zplain, kinds, slots, zvals)
        for i in zero:
            lane_err(zst[i], zplain[i], "K1 zero sums")
        out["slot_scatter_combine"]["zero_sums_ms"] = measure(
            lambda: kernels.slot_scatter_combine(zst, kinds, slots, zvals))["device_ms"]
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
    metrics = (registry.job_metrics(job).get(chained[0], {}).get("per_subtask", {})
               if chained else {})
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
    return sharded_kernels.build_library().arroyo_shard_exchange_counts_words(S, S, L)


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
            "rounds": rounds, "cluster": sharded_kernels.probe_merge_cluster(dev)}


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
    # float subnormals, which XLA on the CPU reads and writes as the zero of
    # their sign: in every float lane, with sums that cancel below
    # the smallest normal, on few keys so that runs are long
    c = case("float32 and float64 subnormals and -0.0", 2, 1000, n_keys=12)
    pools = {np.dtype(np.float64): np.array([1e-310, -1e-310, 3e-308, -2.9e-308, 5e-324,
                                             -0.0, 0.0, 1.0, 2.0 ** -970,
                                             -(2.0 ** -970 - 2.0 ** -1023)]),
             np.dtype(np.float32): np.array([1e-40, -1e-40, 3e-38, -2.9e-38, 1e-45, -0.0,
                                             0.0, 1.0], np.float32)}
    for (_k, dt), v in zip(K8_EDGE_LANES, c["vals"]):
        if dt is not None and np.dtype(dt) in pools:
            pool = pools[np.dtype(dt)]
            v[:] = pool[rng.integers(0, len(pool), v.shape)]
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
        us_per_call=pm_k["device_us_per_call"], cluster=sharded_kernels.probe_merge_cluster(dev),
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


# ---------------------------------------------------------------- mesh_slots

MESH_SLOTS = 4  # device slots of the mesh_slots phase (2 of q7m's 8 shards each)
MESH_SLOT_STEPS = 3
MESH_SLOT_LANES = Q7M_LANES


def plain_of(name: str, args: tuple, kw: dict):
    """The plain version's call for a sharded wrapper's call, on clones of
    what the wrapper changes in place; returns (want, clones)."""
    f = sharded_kernels
    if name == "agg_sort_reduce":
        kinds, key, bins, valid, vals = args[:5]
        return f.agg_sort_reduce_plain(kinds, key, bins, valid, vals, kw.get("bin_offset", 0),
                                       kw.get("n_valid")), None
    if name == "shard_exchange":
        return f.shard_exchange_plain(*args, n_dest=kw.get("n_dest")), None
    if name == "agg_probe_merge":
        kinds, table, *rest = args
        table_p = clone_nested(table)
        return f.agg_probe_merge_plain(kinds, table_p, *rest, **kw), table_p
    if name == "shard_spill":
        kinds, c_key, c_bin, c_accs, still, spill = args[:6]
        spill_p = clone_nested(spill)
        f.shard_spill_plain(kinds, c_key, c_bin, c_accs, still, spill_p)
        return None, spill_p
    table, *rest = args
    table_p = clone_nested(table)
    return f.shard_extract_plain(table_p, *rest, **kw), table_p


def require_slot_call(name: str, got, args: tuple, want, clones) -> None:
    """A sharded wrapper's outputs (and what it changed in place) against
    its plain version's, byte for byte."""
    if name == "agg_sort_reduce":
        require_same(name, got, want)
    elif name == "shard_exchange":
        recv = got.s_key.shape[1]  # the merged rows' head is the exchange's to fill
        require_same(f"{name} send", got[:4], want[:4])
        require_same(f"{name} kept", [t[:, recv:] for t in got[4:7]]
                     + [[t[:, recv:] for t in got.m_accs]],
                     [t[:, recv:] for t in want[4:7]] + [[t[:, recv:] for t in want.m_accs]])
    elif name == "agg_probe_merge":
        table = args[1]
        require_same(name, [got, *table[:3], table[3]], [want, *clones[:3], clones[3]])
    elif name == "shard_spill":
        require_same(name, args[5], clones)
    else:
        require_same(name, [got.key, got.bin, got.valid, got.accs, got.total, args[0][2]],
                     [want.key, want.bin, want.valid, want.accs, want.total, clones[2]])


class SlotCalls:
    """Stands in for a sharded wrapper (``sharded_kernels.<name>``, what
    ShardedAggregator calls) while ``slot_calls`` is open: each call is
    tallied by the slot it launched on (the current card and stream), the
    current device must be the same after it as before, and with ``check``
    the call is held byte for byte to its plain version on the same inputs,
    on the slot's stream. The wrapper counts its own launches as ever
    (``launches`` reads and writes the wrapped wrapper's)."""

    def __init__(self, name: str, wrapped, tally: dict, check: bool):
        self.name, self.wrapped, self.tally, self.check = name, wrapped, tally, check

    launches = property(lambda self: self.wrapped.launches,
                        lambda self, n: setattr(self.wrapped, "launches", n))

    def __call__(self, *args, **kw):
        card = torch.cuda.current_device()
        slot = (card, torch.cuda.current_stream().cuda_stream)
        want = clones = None
        if self.check:
            # the plain version first: K9, K10's spill and K11 change their
            # inputs in place
            want, clones = plain_of(self.name, args, kw)
        got = self.wrapped(*args, **kw)
        if torch.cuda.current_device() != card:
            raise AssertionError(f"{self.name} on card {card} left the thread on card "
                                 f"{torch.cuda.current_device()}")
        if self.check:
            require_slot_call(self.name, got, args, want, clones)
        per = self.tally.setdefault(slot, {})
        per[self.name] = per.get(self.name, 0) + 1
        return got


@contextlib.contextmanager
def slot_calls(check: bool):
    """While open, every K8-K11 call through ``sharded_kernels`` goes through
    ``SlotCalls``; yields the tally {(card, stream): {wrapper: calls}}."""
    tally: dict = {}
    saved = {n: getattr(sharded_kernels, n) for n in SHARDED_KERNELS}
    for n, f in saved.items():
        setattr(sharded_kernels, n, SlotCalls(n, f, tally, check))
    try:
        yield tally
    finally:
        for n, f in saved.items():
            setattr(sharded_kernels, n, f)


def per_slot(tally: dict, mesh, others=()) -> list:
    """The tally by the mesh's slots, in slot order; fails if a call ran on
    no slot of the mesh (nor on ``others``, the (card, stream) of stores
    beside it) or a slot missed a kernel."""
    keys = [(s.device.index, s.stream.cuda_stream) for s in mesh.slots]
    stray = set(tally) - set(keys) - set(others)
    if stray:
        raise AssertionError(f"sharded calls off the mesh's slots: {stray} (slots {keys})")
    out = []
    for k, s in zip(keys, mesh.slots):
        calls = tally.get(k, {})
        missing = [n for n in SHARDED_KERNELS if not calls.get(n)]
        if missing:
            raise AssertionError(f"slot {s.device}[{s.lo}:{s.hi}] launched no {missing}")
        out.append({"device": str(s.device), "shards": [s.lo, s.hi], "calls": calls})
    return out


def slot_store(placement: list):
    """A store of q7m's shapes over ``placement``'s slots: 8 shards,
    bench.py's table and batch capacity (so dest_cap 16384), emit and spill
    capacity and probes at their defaults."""
    mesh = make_mesh(MESH_N, placement[0], placement=placement)
    return ShardedAggregator(mesh, [k for k, _ in MESH_SLOT_LANES],
                             [NP_DT[dt] for _, dt in MESH_SLOT_LANES], cap=65536,
                             batch_cap=BENCH_BATCH, max_probes=64, emit_cap=8192,
                             spill_cap=2048)


def same_state(label: str, a, b) -> None:
    """Two stores' nine state arrays byte for byte (gathered in shard order)."""
    for i, (x, y) in enumerate(zip(a.state, b.state)):
        xs, ys = (x, y) if isinstance(x, tuple) else ((x,), (y,))
        for p, q in zip(xs, ys):
            if not same(p.to(q.device), q):
                raise AssertionError(f"{label}: state array {i} differs from the 1-slot store's")


def same_host_rows(label: str, got, want) -> None:
    (gk, gb, ga), (wk, wb, wa) = got, want
    if not (np.array_equal(gk, wk) and np.array_equal(gb, wb)
            and all(x.dtype == y.dtype and x.tobytes() == y.tobytes() for x, y in zip(ga, wa))):
        raise AssertionError(f"{label}: rows differ ({len(gk)} vs {len(wk)})")


def checked_slot_store(placement: list) -> tuple:
    """The store over ``placement`` and a 1-slot store fed the same rows:
    three host steps (K8 -> K10 -> the exchange -> K8 -> K9 -> K10's spill,
    every call on each slot held to its plain version), then two closes
    through K11; state and rows byte-equal to the 1-slot store's after
    each. Returns (report, the store, the 1-slot store)."""
    rng = np.random.default_rng(20261023)
    many, one = slot_store(placement), slot_store(["cuda:0"])
    caller = (torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
    L = BENCH_BATCH // MESH_N
    closes = []
    with slot_calls(check=True) as tally:
        for step in range(MESH_SLOT_STEPS):
            key, bins, valid, vals = mesh_rows(rng, MESH_N, L, int(L * 0.94), MESH_SLOT_LANES,
                                               60000, torch.device("cpu"),
                                               bins_range=(step, step + 3))
            host = (key.numpy(), bins.numpy(), valid.numpy(), [v.numpy() for v in vals])
            many.update_sharded(*host)
            one.update_sharded(*host)
            same_state(f"mesh_slots step {step}", many, one)
        # bin 0 emitted and freed, then bins 1-2 emitted and bin 1 freed:
        # bins 2-4 stay for the snapshots
        for lo, hi, fb in ((0, 1, 1), (1, 3, 2)):
            got = many.extract_all(lo, hi, fb)
            closes.append(len(got[0]))
            same_host_rows(f"mesh_slots close [{lo}, {hi})", got, one.extract_all(lo, hi, fb))
            same_state(f"mesh_slots after the close [{lo}, {hi})", many, one)
    torch.cuda.synchronize()
    report = {"steps": MESH_SLOT_STEPS, "rows_a_step": [MESH_N, L],
              "slots": per_slot(tally, many.mesh, others=[caller]), "close_rows": closes,
              "occupied": int(many.state[2].sum())}
    return report, many, one


def device_kept(placement: list) -> dict:
    """Each sharded wrapper launched on every slot's card by a thread on the
    first slot's card: the current device is that card after every launch,
    and the caller's again after."""
    out = {}
    home = torch.device(placement[0])
    kinds = [k for k, _ in MESH_SLOT_LANES]

    def kept(what: str, dev) -> None:
        if torch.cuda.current_device() != home.index:
            raise AssertionError(f"{what} on {dev} moved the thread from {home} to "
                                 f"cuda:{torch.cuda.current_device()}")

    for name in sorted({str(torch.device(p)) for p in placement}):
        dev = torch.device(name)
        before = torch.cuda.current_device()
        with torch.cuda.device(home):
            rows = mesh_rows(np.random.default_rng(5), 2, 256, 200, MESH_SLOT_LANES, 100, dev)
            table = empty_table(2, 1024, MESH_SLOT_LANES, dev)
            spill = empty_spill(2, 64, MESH_SLOT_LANES, dev)
            u = sharded_kernels.agg_sort_reduce(kinds, *rows)
            kept("agg_sort_reduce", dev)
            sharded_kernels.shard_exchange(kinds, *u, 64, n_dest=4)
            kept("shard_exchange", dev)
            still = sharded_kernels.agg_probe_merge(kinds, table, *u, 8)
            kept("agg_probe_merge", dev)
            sharded_kernels.shard_spill(kinds, u[0], u[1], u[3], still, spill,
                                        sharded_kernels.spill_scratch(2, 256, dev))
            kept("shard_spill", dev)
            sharded_kernels.shard_extract(table, 0, 5, 0, 512)
            kept("shard_extract", dev)
            torch.cuda.synchronize(dev)
        if torch.cuda.current_device() != before:
            raise AssertionError(f"the current device moved from {before}")
        out[name] = {"thread_on": str(home), "launched": list(SHARDED_KERNELS)}
    return out


def exchange_timing(placement: list) -> dict:
    """The exchange of one q7m step (8 shards, dest_cap 16384: key, bin,
    valid and q7m's three int64 lanes) over ``placement``'s slots beside the
    1-slot transposing copy, each timed by ``measure`` (the slots' streams
    joined back to the timing stream); bytes: each send buffer read once,
    each receive row written once."""
    S, dc = MESH_N, BENCH_BATCH // (MESH_N // 2)
    dts = [torch.int64, torch.int32, torch.bool] + [dt for _, dt in MESH_SLOT_LANES]
    dev0 = torch.device(placement[0])
    gen = torch.Generator(device="cpu").manual_seed(7)
    full = [torch.randint(0, 1 << 30, (S, S * dc), generator=gen).to(dt) for dt in dts]
    one_in = [x.to(dev0) for x in full]
    one_out = [torch.empty_like(x) for x in one_in]

    def one_slot():
        for x, y in zip(one_in, one_out):
            all_to_all(x, out=y)

    mesh = make_mesh(S, dev0, placement=placement)
    sends, recvs = [], []
    for sl in mesh.slots:
        with sl.ctx():
            sends.append([x[sl.lo:sl.hi].to(sl.device) for x in full])
            recvs.append([torch.empty((sl.n, S * dc + 8), dtype=x.dtype, device=sl.device)
                          for x in full])
    torch.cuda.synchronize()

    def slots():
        start = torch.cuda.current_stream(dev0).record_event()
        ready = []
        for sl in mesh.slots:
            sl.stream.wait_event(start)
            ready.append(sl.stream.record_event())
        exchange(mesh, sends, [[r[:, :S * dc] for r in rs] for rs in recvs], ready)
        for sl in mesh.slots:
            torch.cuda.current_stream(dev0).wait_event(sl.stream.record_event())

    slots()
    one_slot()
    torch.cuda.synchronize()
    for f in range(len(dts)):
        got = torch.cat([r[f][:, :S * dc].to(dev0) for r in recvs])
        if not same(got, one_out[f]):
            raise AssertionError(f"the slots' exchange of field {f} differs from the "
                                 f"transposing copy")
    nbytes = 2 * sum(x.numel() * x.element_size() for x in full)
    t1, tk = measure(one_slot), measure(slots)
    return {"bytes_per_step": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "one_slot": {k: t1[k] for k in ("device_ms", "call_ms", "method")},
            "slots": {k: tk[k] for k in ("device_ms", "call_ms", "method")},
            "copies_per_step": {"one_slot": len(dts), "slots": len(dts) * len(mesh.slots) ** 2}}


def snapshot_crossing(many, one, placement: list) -> dict:
    """The store over ``placement``'s snapshot restored into a 1-slot store,
    and the 1-slot store's into one over ``placement``: each restored
    store's snapshot is the one it was restored from, and the two restored
    stores' states are byte-equal."""
    snap_many, snap_one = many.snapshot(), one.snapshot()
    if not len(snap_many[0]):
        raise AssertionError("mesh_slots: the store to snapshot is empty")
    same_host_rows("mesh_slots snapshots", snap_many, snap_one)
    to_one, to_many = slot_store(["cuda:0"]), slot_store(placement)
    t0 = time.perf_counter()
    to_one.restore(*snap_many)
    to_many.restore(*snap_one)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same_host_rows("mesh_slots restored at 1 slot", sorted_state(*to_one.snapshot()),
                   sorted_state(*snap_many))
    same_host_rows(f"mesh_slots restored at {len(placement)} slots",
                   sorted_state(*to_many.snapshot()), sorted_state(*snap_one))
    same_state("mesh_slots restored stores", to_many, to_one)
    return {"rows": len(snap_many[0]), "both_restores_s": restore_s}


def q7m_over_slots(placement: list) -> dict:
    """q7m at bench.py's sizes (mesh_run: exact, K4 and K8-K11 launched,
    the ledger) with its 8 shards over ``placement``'s slots, fused then
    on the host path; each run's calls tallied per slot."""
    want = oracle_q7(Q7_EVENTS)
    extra = {"device.mesh-devices": MESH_N, "device.mesh-placement": placement}
    out = {}
    for fuse in (True, False):
        # the warm-up (K4's build for the mode's plan) outside the tally:
        # each run's store has streams of its own
        drive(build_q7, 2 * BENCH_BATCH, f"chip-smoke-q7m_slots-{fuse}-warm", chaining=True,
              extra={**extra, "segment.compile.mesh-fuse": fuse})
        with slot_calls(check=False) as tally:
            r = mesh_run("q7m_slots", build_q7, Q7_EVENTS, oracle_q7, check_q7, fuse, extra,
                         want=want, profile_it=False)
        streams = sorted(tally)
        if len(streams) != len(placement):
            raise AssertionError(f"q7m over {len(placement)} slots ran on {len(streams)} "
                                 f"streams: {tally}")
        r["launches_per_slot"] = [{"device": f"cuda:{c}", "calls": tally[(c, s)]}
                                  for c, s in streams]
        for calls in r["launches_per_slot"]:
            missing = [n for n in SHARDED_KERNELS if not calls["calls"].get(n)]
            if missing:
                raise AssertionError(f"q7m over slots: a slot launched no {missing}")
        r.pop("k8_calls", None)
        out["fused" if fuse else "host"] = r
    return out


def mesh_slots_on(placement: list) -> dict:
    log(f"mesh_slots: {placement}")
    t0 = time.perf_counter()
    checked, many, one = checked_slot_store(placement)
    info = {"placement": placement, "checked_store": checked,
            "device_kept": device_kept(placement),
            "snapshot": snapshot_crossing(many, one, placement),
            "exchange": exchange_timing(placement)}
    del many, one
    info["q7m"] = q7m_over_slots(placement)
    info["seconds"] = time.perf_counter() - t0
    return info


def mesh_slots_phase(card: str) -> dict:
    """The mesh over device slots: 8 shards over 4 slots on cuda:0, then
    over distinct cards where the machine has two or more, each placement's
    q7m beside q7m at one slot on cuda:0 in the same run, before the
    placements and after them (``q7m_vs_one_slot``: the ratio of events/s,
    fused and host, to the faster of the two 1-slot runs)."""
    info = {"phase": "mesh_slots", "card": card,
            "one_slot_q7m": [q7m_over_slots(["cuda:0"])],
            "one_card": mesh_slots_on(["cuda:0"] * MESH_SLOTS)}
    n = torch.cuda.device_count()
    if n >= 2:
        info["distinct_cards"] = mesh_slots_on([f"cuda:{i}" for i in range(min(n, MESH_SLOTS))])
    else:
        info["distinct_cards"] = None
        print(f"mesh_slots: distinct cards not run: this machine has {n} CUDA card "
              f"(torch.cuda.device_count()); the 4 slots shared cuda:0", flush=True)
    info["one_slot_q7m"].append(q7m_over_slots(["cuda:0"]))
    one = {m: max(r[m]["events_per_s"] for r in info["one_slot_q7m"]) for m in ("fused", "host")}
    for where in ("one_card", "distinct_cards"):
        sec = info[where]
        if sec is not None:
            sec["q7m_vs_one_slot"] = {m: sec["q7m"][m]["events_per_s"] / one[m]
                                      for m in ("fused", "host")}
            print(f"mesh_slots: q7m over {sec['placement']} at "
                  f"{sec['q7m_vs_one_slot']} of one slot's events/s [{card}]", flush=True)
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
        cluster=sharded_kernels.probe_merge_cluster(dev), **pm_r)

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


# ---------------------------------------------------------------- checkpoint


CKPT_LANES = [("sum", np.int64), ("count", np.int64), ("min", np.int64), ("max", np.int64)]


def epoch_bytes(url: str, job: str, epoch: int) -> dict:
    """Files and bytes of one epoch's directory."""
    d = checkpoint_dir(url, job, epoch)
    sizes = [os.path.getsize(os.path.join(r, f)) for r, _d, fs in os.walk(d) for f in fs]
    return {"files": len(sizes), "bytes": int(sum(sizes))}


def restored_state(eng) -> tuple[dict, int]:
    """After build(): the source's restored offsets and the rows of open
    state the restore loaded into the operators' tables."""
    src = eng.tasks[("src", 0)].ctx.table_manager.global_keyed("s").data
    rows = sum(t.total_rows() for task in eng.tasks.values()
               for t in task.ctx.table_manager.expiring.values())
    return dict(src), rows


@contextlib.contextmanager
def slot_snapshots_recorded():
    """While open, every SlotAggregator.snapshot (a barrier's read of the
    slot store) appends what it read to the list it yields: its live bins,
    device regions and host-spilled groups."""
    log_: list = []
    wrapped = SlotAggregator.snapshot

    def snapshot(agg):
        d = agg.directory
        log_.append({"live_bins": len(d.live_bins()),
                     "regions": sum(len(r) for r in d.bin_regions.values()),
                     "spilled_groups": len(agg.spill)})
        return wrapped(agg)

    SlotAggregator.snapshot = snapshot
    try:
        yield log_
    finally:
        SlotAggregator.snapshot = wrapped


def checkpoint_first_run(build, events: int, job: str, url: str, polls: int,
                         epochs=(1,)) -> tuple[list, dict]:
    """The stream up to a barrier at the source's gated poll (after
    polls - 1 batches): checkpoint_and_wait of each epoch, the last with
    then_stop, then stop(). The launch counts are zeroed just before and
    read just after."""
    rows: list = []
    reset_all_launch_counts()
    eng = Engine(build(rows, events), job_id=job, storage_url=url)
    gate = gate_source(eng, polls)
    with slot_snapshots_recorded() as snaps:
        eng.start()
        if not gate.reached.wait(600):
            raise AssertionError(f"{job}: the source never reached poll {polls}")
        acks = {}
        for e in epochs:
            t0 = time.perf_counter()
            res = eng.checkpoint_and_wait(e, timeout=600, then_stop=e == epochs[-1])
            acks[e] = (time.perf_counter() - t0) * 1e3
            if not res:
                raise AssertionError(f"{job}: epoch {e} did not complete: {res!r}")
        eng.stop()
        eng.join(timeout=900)
    torch.cuda.synchronize()
    return rows, {"launches": all_launch_counts(), "snapshots": snaps, "barrier_to_ack_ms": acks,
                  "timeline": {e: eng.checkpoint_timeline(e) for e in epochs},
                  "written": {e: epoch_bytes(url, job, e) for e in epochs}}


def checkpoint_restore_run(build, events: int, job: str, url: str, epoch: int) -> tuple:
    """A fresh engine restored from ``epoch``, run to the end of the
    stream; counts zeroed just before and read just after."""
    rows: list = []
    reset_all_launch_counts()
    eng = Engine(build(rows, events), job_id=job, storage_url=url, restore_epoch=epoch)
    t0 = time.perf_counter()
    eng.build()
    build_ms = (time.perf_counter() - t0) * 1e3
    offsets, open_rows = restored_state(eng)
    t0 = time.perf_counter()
    eng.run_to_completion(timeout=900)
    torch.cuda.synchronize()
    return rows, {"launches": all_launch_counts(), "build_ms": build_ms,
                  "run_s": time.perf_counter() - t0, "offsets": offsets, "open_rows": open_rows}


def checkpoint_parity(name: str, build, events: int, oracle, check, table_capacity: int = 65536,
                      queue_mult: int = 2, extra: dict = None, first_extra: dict = None,
                      url_root: str = None) -> dict:
    """Restore parity at bench.py's sizes: epoch 1 mid-stream (after half
    the source's batches), then stop; a fresh engine restores it; the first
    run's rows and the restored run's together must equal the oracle
    exactly (nothing lost, nothing emitted twice). Epoch 1 must hold open
    state and the restored source start at its offset. ``first_extra``
    configures the first run alone (the resize: 4 shards, then 8)."""
    want = oracle(events)
    job, url = f"chip-smoke-ckpt-{name}", os.path.join(url_root, name)
    bench_config(True, queue_mult, table_capacity, {**(extra or {}), **(first_extra or {})})
    batch = int(tcfg.config().get("pipeline.source-batch-size"))
    polls = -(-events // batch) // 2 + 1
    rows1, first = checkpoint_first_run(build, events, job, url, polls)
    bench_config(True, queue_mult, table_capacity, extra)
    rows2, rest = checkpoint_restore_run(build, events, job, url, 1)
    check(rows1 + rows2, want)
    n1 = sum(b.num_rows for b in rows1)
    n2 = sum(b.num_rows for b in rows2)
    if not n2:
        raise AssertionError(f"{name}: the restored run emitted nothing after {n1} rows: "
                             f"the barrier did not land mid-stream")
    if rest["offsets"].get(0) != (polls - 1) * batch:
        raise AssertionError(f"{name}: the restored source starts at {rest['offsets']}, "
                             f"not at {(polls - 1) * batch}")
    if not rest["open_rows"]:
        raise AssertionError(f"{name}: epoch 1 held no open state")
    info = {"events": events, "barrier_after_rows": (polls - 1) * batch,
            "first_run_rows": n1, "restored_run_rows": n2,
            "barrier_to_ack_ms": first["barrier_to_ack_ms"][1],
            "timeline": first["timeline"][1], "written": first["written"][1],
            "restore_build_ms": rest["build_ms"], "restored_run_s": rest["run_s"],
            "open_rows": rest["open_rows"], "slot_snapshots": first["snapshots"],
            "first_launches": {k: v for k, v in first["launches"].items() if v},
            "restore_launches": {k: v for k, v in rest["launches"].items() if v}}
    log(f"checkpoint {name}: ack {info['barrier_to_ack_ms']:.1f} ms, "
        f"{info['written']['bytes']} B, {n1} + {n2} rows")
    return info


def merged_windows(runs: list, keys: tuple, values: tuple) -> dict:
    """The windows of several runs, keyed by the ``keys`` columns, a later
    run's rows winning (a restore from an earlier epoch emits again what
    followed it); a window emitted twice within one run raises."""
    got: dict = {}
    for rows in runs:
        seen: set = set()
        for b in rows:
            cols = [b[c].tolist() for c in keys + values]
            for row in zip(*cols):
                k, v = row[:len(keys)], row[len(keys):]
                if k in seen:
                    raise AssertionError(f"window {k} emitted twice in one run")
                seen.add(k)
                got[k] = v if len(v) > 1 else v[0]
    return got


def merged_q7(runs: list) -> dict:
    return merged_windows(runs, ("window_start", "auction"), ("max_price", "bids"))


def merged_q5(runs: list) -> dict:
    return merged_windows(runs, ("window_start", "auction"), ("bids",))


def merged_qs(runs: list) -> dict:
    return merged_windows(runs, ("window_start", "bidder"), ("bids", "spend"))


def torn_and_corrupt(url_root: str) -> dict:
    """q7c with epochs 1 and 2, then: epoch 2's marker removed (torn:
    latest_complete_checkpoint gives 1), or one of its table files cut in
    half (corrupt: the fallback ladder quarantines 2 and gives 1). Either
    way the restore from 1 merged with the first run equals the oracle."""
    want = oracle_q7(Q7_EVENTS)
    job, url = "chip-smoke-ckpt-torn", os.path.join(url_root, "torn")
    bench_config(True)
    polls = -(-Q7_EVENTS // BENCH_BATCH) // 3 + 1
    rows1, first = checkpoint_first_run(build_q7, Q7_EVENTS, job, url, polls, epochs=(1, 2))
    out = {"barrier_to_ack_ms": first["barrier_to_ack_ms"], "written": first["written"]}
    for case in ("torn", "corrupt"):
        u = os.path.join(url_root, case + "-copy")
        shutil.copytree(url, u)
        d2 = checkpoint_dir(u, job, 2)
        if case == "torn":
            os.remove(os.path.join(d2, "metadata.json"))
            epoch = latest_complete_checkpoint(u, job)
        else:
            table = next(os.path.join(r, f) for r, _d, fs in os.walk(d2) for f in sorted(fs)
                         if f.startswith("table-") and f.endswith((".npz", ".parquet")))
            with open(table, "rb") as f:
                data = f.read()
            with open(table, "wb") as f:
                f.write(data[: len(data) // 2])
            recorder.clear_job(job)
            epoch = pick_restore_epoch(u, job)
            if not is_quarantined(u, job, 2):
                raise AssertionError("the corrupt epoch 2 was not quarantined")
            out["events"] = [e["code"] for e in recorder.events(job)]
        if epoch != 1:
            raise AssertionError(f"{case}: the restore picked epoch {epoch}, not 1")
        rows2, rest = checkpoint_restore_run(build_q7, Q7_EVENTS, job, u, epoch)
        got = merged_q7([rows1, rows2])
        if got != want:
            diff = next(iter(set(got.items()) ^ set(want.items())), None)
            raise AssertionError(f"{case}: restored q7 differs from the oracle: first diff {diff}")
        out[case] = {"epoch": epoch, "restored_run_s": rest["run_s"],
                     "offsets": rest["offsets"], "windows": len(got)}
    return out


def sorted_state(keys, bins, accs) -> tuple:
    order = np.lexsort((keys.view(np.int64), bins))
    return keys[order], bins[order], [a[order] for a in accs]


def store_overflow(store) -> dict:
    """A sharded store's lost entries and spill residency (empty for the
    slot store, which spills to the host without loss)."""
    if not isinstance(store, ShardedAggregator):
        return {}
    return {"lost": int(store.state[4].sum()), "spilled": int(store.state[7].sum())}


def round_trip(label: str, store, make_store, kinds, url_root: str) -> dict:
    """A deployment-size store: snapshot -> the "t" table ->
    TableManager.checkpoint -> TableManager.restore -> a fresh store's
    restore -> snapshot, equal per (key, bin) to the first, each step timed."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    keys, bins, accs = store.snapshot()
    torch.cuda.synchronize()
    snap_ms = (time.perf_counter() - t0) * 1e3
    cols = {TIMESTAMP_FIELD: bins.astype(np.int64) * WIDTH, "_key": keys}
    cols.update({f"__acc_{i}": a for i, a in enumerate(accs)})
    ti = TaskInfo(f"chip-smoke-deploy-{label}", "agg", "tumbling_aggregate", 0, 1)
    tm = TableManager(ti, os.path.join(url_root, "deploy-" + label))
    tm.expiring_time_key("t").replace_all([Batch(cols)])
    t0 = time.perf_counter()
    meta = tm.checkpoint(1, None)
    write_ms = (time.perf_counter() - t0) * 1e3
    written = sum(fm["len"] for fm in meta["files"]) + meta["sidecar"]["len"]
    tm2 = TableManager(ti, tm.storage_url)
    t0 = time.perf_counter()
    tm2.restore(1, [TableSpec("t", "expiring_time_key")])
    b = Batch.concat(tm2.expiring_time_key("t").all_batches())
    read_ms = (time.perf_counter() - t0) * 1e3
    fresh = make_store()
    reset_all_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.restore(b.keys, (b.timestamps // WIDTH).astype(np.int32),
                  [b[f"__acc_{i}"] for i in range(len(kinds))])
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in all_launch_counts().items() if v}
    want = sorted_state(keys, bins, accs)
    got = sorted_state(*fresh.snapshot())
    if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
            and all(np.array_equal(x.view(np.int64), y.view(np.int64))
                    for x, y in zip(got[2], want[2]))):
        gk = {(int(b), int(k)) for k, b in zip(got[0].view(np.int64), got[1])}
        wk = {(int(b), int(k)) for k, b in zip(want[0].view(np.int64), want[1])}
        lanes = ([int((x.view(np.int64) != y.view(np.int64)).sum()) for x, y in zip(got[2], want[2])]
                 if len(got[0]) == len(want[0]) else None)
        raise AssertionError(
            f"{label}: the restored store's snapshot differs from the first: {len(got[0])} "
            f"groups against {len(want[0])}, {len(wk - gk)} missing, {len(gk - wk)} extra, "
            f"lanes differing {lanes}, overflow {store_overflow(store)} / "
            f"{store_overflow(fresh)}")
    info = {"groups": len(keys), "snapshot_ms": snap_ms, "mb_written": written / 1e6,
            "write_ms": write_ms, "read_ms": read_ms, "restore_ms": restore_ms,
            "restore_launches": launches}
    log(f"checkpoint {label}: {info}")
    return info


def deployment_round_trips(dev, url_root: str, slot_cap: int = 1 << 24, n: int = 1 << 20,
                           mesh_cap: int = 1 << 20) -> dict:
    """The slot store at the gather phase's deployment state (n = 1,048,576
    groups in 16,777,216 slots x 4 int64 lanes) and the mesh store at the
    sharded phase's (8 shards x 1,048,576 entries, 4 int64 lanes and a
    float64 sum, 440 MB) half full, each round-tripped. The mesh store's
    keys span the whole uint64 range, as the key hashes do: the owner of a
    key is its range of that space, so keys below 2^63 alone would fill
    four of the eight shards to the brim."""
    rng = np.random.default_rng(20261017)
    kinds = tuple(k for k, _d in CKPT_LANES)
    dtypes = tuple(d for _k, d in CKPT_LANES)

    def slot_store():
        return SlotAggregator(kinds, dtypes, cap=slot_cap, batch_cap=BENCH_BATCH, region_size=2048,
                              device=dev)

    store = slot_store()
    keys = np.unique(rng.integers(0, 2**63, n + n // 8, dtype=np.int64))[:n].astype(np.uint64)
    bins = rng.integers(0, 4, n).astype(np.int32)
    store.update(keys, bins, [rng.integers(-10**9, 10**9, n).astype(np.int64) for _ in kinds])
    reset_all_launch_counts()
    slot = round_trip("slot", store, slot_store, kinds, url_root)
    k2_read = kernels.launch_counts()  # the snapshots of round_trip: K2 read-alone
    slot["k1_merge_launches"] = slot["restore_launches"].get("slot_scatter_combine_merge", 0)
    slot["k2_read_launches"] = k2_read["slot_region_read_pack"]
    del store
    mkinds = tuple(k for k, _d in DEPLOY_LANES)
    mdtypes = tuple(NP_DT[d] for _k, d in DEPLOY_LANES)

    def mesh_store():
        return ShardedAggregator(make_mesh(MESH_N, dev), mkinds, mdtypes, cap=mesh_cap,
                                 batch_cap=BENCH_BATCH, max_probes=64, emit_cap=8192,
                                 spill_cap=16384)

    mstore = mesh_store()
    m = MESH_N * mesh_cap // 2  # 4,194,304 groups: the table half full
    mkeys = rng.permutation(np.unique(rng.integers(0, 2**64 - 1, m + m // 8, dtype=np.uint64,
                                                   endpoint=True)))[:m]
    mbins = rng.integers(0, 4, m).astype(np.int32)
    mvals = [rng.integers(-10**9, 10**9, m).astype(d) if d != np.float64
             else rng.normal(0, 1e6, m) for d in mdtypes]
    mstore.update(mkeys, mbins, mvals)
    filled = store_overflow(mstore)
    if filled["lost"]:
        raise AssertionError(f"the mesh store lost entries while it was filled: {filled}")
    mesh = round_trip("mesh", mstore, mesh_store, mkinds, url_root)
    mesh["fill"] = filled
    state_bytes = sum(t.numel() * t.element_size() for t in
                      [*mstore.state[:3], *mstore.state[3]])
    mesh["state_mb"] = state_bytes / 1e6
    return {"slot": slot, "mesh": mesh}


CKPT_RUNS = {
    "q7c": lambda root: checkpoint_parity("q7c", build_q7, Q7_EVENTS, oracle_q7, check_q7,
                                          url_root=root),
    "q5": lambda root: checkpoint_parity("q5", build_q5, Q5_EVENTS, oracle_q5, check_q5,
                                         url_root=root),
    "q8c": lambda root: checkpoint_parity("q8c", build_q8, Q8_EVENTS, oracle_q8, check_q8,
                                          queue_mult=1, url_root=root),
    "qu": lambda root: checkpoint_parity("qu", build_qu, QU_EVENTS, oracle_qu, check_qu,
                                         table_capacity=QU_CAP, url_root=root),
    "qs": lambda root: checkpoint_parity("qs", build_qs, QS_EVENTS, oracle_qs, check_qs,
                                         url_root=root),
    "q7m fused": lambda root: checkpoint_parity(
        "q7m-fused", build_q7, Q7_EVENTS, oracle_q7, check_q7, url_root=root,
        extra={"device.mesh-devices": MESH_N, "segment.compile.mesh-fuse": True}),
    "q7m host": lambda root: checkpoint_parity(
        "q7m-host", build_q7, Q7_EVENTS, oracle_q7, check_q7, url_root=root,
        extra={"device.mesh-devices": MESH_N, "segment.compile.mesh-fuse": False}),
    "q7m resize 4 -> 8": lambda root: checkpoint_parity(
        "q7m-resize", build_q7, Q7_EVENTS, oracle_q7, check_q7, url_root=root,
        extra={"device.mesh-devices": MESH_N, "segment.compile.mesh-fuse": True},
        first_extra={"device.mesh-devices": 4}),
}


def checkpoint_phase(dev) -> dict:
    """Checkpoint and restore on the card (see the module docstring). K2's
    read-alone mode must launch at every barrier whose slot store holds
    device regions (q7c and qu among them), K1's merge mode at the
    restores of q7c and q5, and K8-K10 at the mesh restores, each by the
    kernels' counters."""
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        runs = {}
        for name, fn in CKPT_RUNS.items():
            log(f"checkpoint: {name}")
            runs[name] = fn(root)
        emit({"phase": "checkpoint runs", "runs": runs})
        # a barrier's snapshot reads the slot store's device regions with
        # K2's read-alone mode, at most 16 a launch; groups the store spilled
        # to the host (q5: a 65536-row batch spans 33 two-second bins, the
        # 65536-slot table 32 regions) come from the host, without a launch
        for name, r in runs.items():
            want_k2 = sum(-(-snap["regions"] // kernels.MAX_BASES) for snap in r["slot_snapshots"])
            got_k2 = r["first_launches"].get("slot_region_read_pack", 0)
            if got_k2 != want_k2:
                raise AssertionError(f"{name}: {got_k2} K2 read launches at the barrier for "
                                     f"the snapshots {r['slot_snapshots']}")
        for name in ("q7c", "qu"):
            if not runs[name]["first_launches"].get("slot_region_read_pack"):
                raise AssertionError(f"{name}: the barrier's snapshot launched no K2 read: "
                                     f"{runs[name]['first_launches']}")
        for name in ("q7c", "q5"):
            if not runs[name]["restore_launches"].get("slot_scatter_combine_merge"):
                raise AssertionError(f"{name}: the restore launched no K1 merge: "
                                     f"{runs[name]['restore_launches']}")
        for name in ("q7m fused", "q7m host", "q7m resize 4 -> 8"):
            missing = [k for k in ("agg_sort_reduce", "agg_probe_merge", "shard_exchange")
                       if not runs[name]["restore_launches"].get(k)]
            if missing:
                raise AssertionError(f"{name}: the restore did not launch {missing}")
        log("checkpoint: torn and corrupt epochs")
        torn = torn_and_corrupt(root)
        log("checkpoint: deployment-size round trips")
        deploy = deployment_round_trips(dev, root)
        if not (deploy["slot"]["k1_merge_launches"] and deploy["slot"]["k2_read_launches"]):
            raise AssertionError(f"the slot store's round trip launched no K1 merge or K2 "
                                 f"read: {deploy['slot']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    info = {"phase": "checkpoint", "runs": runs, "torn_and_corrupt": torn, "deployment": deploy,
            "k2_read_launches": {n: runs[n]["first_launches"].get("slot_region_read_pack", 0)
                                 for n in ("q7c", "q5", "qu")},
            "q5_spilled_groups_at_barrier": runs["q5"]["slot_snapshots"][0]["spilled_groups"],
            "k1_merge_launches": {n: runs[n]["restore_launches"].get("slot_scatter_combine_merge", 0)
                                  for n in ("q7c", "q5", "qu")}}
    emit({"phase": "checkpoint",
          "runs": {n: {k: r[k] for k in ("barrier_to_ack_ms", "written", "restore_build_ms",
                                         "restored_run_s", "first_run_rows", "restored_run_rows")}
                   for n, r in runs.items()},
          "torn_and_corrupt": torn, "deployment": deploy,
          "k2_read_launches": info["k2_read_launches"],
          "k1_merge_launches": info["k1_merge_launches"]})
    return info


# ---------------------------------------------------------------- recovery


def recovery_holds(events: int, parts: int = 3) -> tuple:
    """The polls at which a recovery case's epochs land: after 1/3 and 2/3
    of the source's batches."""
    n = -(-events // int(tcfg.config().get("pipeline.source-batch-size")))
    return tuple(n * k // parts + 1 for k in range(1, parts))


def no_fsck_errors(url: str, job: str) -> float:
    """fsck_job over a job that must be clean; returns its ms."""
    t0 = time.perf_counter()
    errors = [d.to_dict() for d in fsck_job(url, job) if str(d.severity) == "error"]
    ms = (time.perf_counter() - t0) * 1e3
    if errors:
        raise AssertionError(f"fsck_job of {job}: {errors}")
    return ms


def recovery_crash(root: str) -> dict:
    """q7c and q7m fused with worker:crash@barrier=2 on the window's
    subtask: epoch 1 completes, epoch 2 has state files and no marker, the
    job fails; pick_restore_epoch gives 1 and a fresh engine restored from
    it finishes the stream (the runs' windows, the restored run's winning,
    equal the oracle). The restore launches K1's merge (q7c) or K8-K10
    (q7m)."""
    want = oracle_q7(Q7_EVENTS)
    out = {}
    for name, extra, path in (
            ("q7c", {}, ("slot_scatter_combine_merge",)),
            ("q7m fused", {"device.mesh-devices": MESH_N, "segment.compile.mesh-fuse": True},
             ("agg_sort_reduce", "agg_probe_merge", "shard_exchange"))):
        job = f"chip-smoke-crash-{name.replace(' ', '-')}"
        url = os.path.join(root, job)
        bench_config(True, extra=extra)
        rows1: list = []
        eng = Engine(build_q7(rows1, Q7_EVENTS), job_id=job, storage_url=url)
        eng.build()
        faults.install(f"worker:crash@barrier=2&node={window_node(eng)}&subtask=0")
        try:
            crash_ms = crash_at_last_barrier(eng, recovery_holds(Q7_EVENTS))
        finally:
            faults.clear()
        t0 = time.perf_counter()
        written = epoch_bytes(url, job, 2)
        if not written["files"] or read_job_checkpoint_metadata(url, job, 2) is not None:
            raise AssertionError(f"{name}: epoch 2 after the crash holds {written} and its "
                                 f"marker is {read_job_checkpoint_metadata(url, job, 2)}")
        epoch = pick_restore_epoch(url, job)
        if epoch != 1:
            raise AssertionError(f"{name}: the restore picked epoch {epoch}, not 1")
        rows2, rest = checkpoint_restore_run(build_q7, Q7_EVENTS, job, url, epoch)
        wall_s = time.perf_counter() - t0
        got = merged_q7([rows1, rows2])
        if got != want:
            diff = next(iter(set(got.items()) ^ set(want.items())), None)
            raise AssertionError(f"{name}: restored q7 differs from the oracle: first diff {diff}")
        missing = [k for k in path if not rest["launches"].get(k)]
        if missing:
            raise AssertionError(f"{name}: the restore did not launch {missing}")
        out[name] = {"crash_detected_ms": crash_ms, "crash_to_restored_rows_s": wall_s,
                     "epoch2_written": written, "restore_build_ms": rest["build_ms"],
                     "restored_run_s": rest["run_s"], "windows": len(got),
                     "restore_launches": {k: rest["launches"][k] for k in path},
                     "fsck_ms": no_fsck_errors(url, job)}
    return out


def recovery_bit_rot(root: str) -> dict:
    """q7c with epoch 2 written under storage.put:corrupt=truncate on its
    table files: fsck_job reports FS005 errors on epoch 2 and none on 1;
    pick_restore_epoch quarantines 2, falls back to 1 (the two events) and
    the restore reaches the oracle; a restore under a transient
    storage.get:fail_once recovers in place through the retry layer."""
    want = oracle_q7(Q7_EVENTS)
    job = "chip-smoke-bitrot"
    url = os.path.join(root, job)
    bench_config(True)
    rows1: list = []
    eng = Engine(build_q7(rows1, Q7_EVENTS), job_id=job, storage_url=url)

    def corrupt_epoch_2(e):
        if e == 2:
            faults.install("storage.put:corrupt=truncate@match=table-")

    try:
        run_gated_epochs(eng, recovery_holds(Q7_EVENTS), before_epoch=corrupt_epoch_2)
    finally:
        faults.clear()
    t0 = time.perf_counter()
    diags = fsck_job(url, job)
    fsck_ms = (time.perf_counter() - t0) * 1e3
    errors = {(d.rule_id, d.site.rsplit("/", 1)[1]) for d in diags if str(d.severity) == "error"}
    if not errors or {r for r, _s in errors} != {"FS005"} or \
            {s for _r, s in errors} != {"checkpoint-0000002"}:
        raise AssertionError(f"bit rot: fsck_job found {sorted(errors)}, not FS005 on epoch 2 "
                             f"alone")
    recorder.clear_job(job)
    t0 = time.perf_counter()
    epoch = pick_restore_epoch(url, job)
    codes = [e["code"] for e in recorder.events(job)]
    if epoch != 1 or not is_quarantined(url, job, 2) or \
            codes != ["CHECKPOINT_QUARANTINED", "RESTORE_FELL_BACK"]:
        raise AssertionError(f"bit rot: picked {epoch}, events {codes}")
    rows2, rest = checkpoint_restore_run(build_q7, Q7_EVENTS, job, url, epoch)
    fallback_s = time.perf_counter() - t0
    got = merged_q7([rows1, rows2])
    if got != want:
        raise AssertionError("bit rot: the fallback restore differs from the oracle")
    bench_config(True)
    inj = faults.install("storage.get:fail_once@match=table-")
    try:
        rows3, again = checkpoint_restore_run(build_q7, Q7_EVENTS, job, url, 1)
        fired = list(inj.fired_log)
    finally:
        faults.clear()
    if len(fired) != 1 or merged_q7([rows1, rows3]) != want:
        raise AssertionError(f"bit rot: the restore under a transient read fault fired "
                             f"{fired} and reached the oracle: "
                             f"{merged_q7([rows1, rows3]) == want}")
    if not (rest["launches"].get("slot_scatter_combine_merge")
            and again["launches"].get("slot_scatter_combine_merge")):
        raise AssertionError("bit rot: a restore launched no K1 merge")
    return {"fsck_ms": fsck_ms, "fsck_errors": sorted(errors), "events": codes,
            "fallback_restore_s": fallback_s, "restore_build_ms": rest["build_ms"],
            "transient_read_fault": {"fired": len(fired), "restore_build_ms": again["build_ms"],
                                     "restored_run_s": again["run_s"]}}


def agg_table_files(url: str, job: str, epoch: int = 1) -> list:
    d = os.path.join(checkpoint_dir(url, job, epoch), "operator-agg")
    return sorted(f for f in os.listdir(d) if f.startswith("table-"))


def compacted_files() -> list:
    """The window's compacted tables: its key-skew sketch (the profiler's),
    its late-data marks and its rows (parquet where pyarrow is importable,
    else npz)."""
    from arroyo_tpu_torch.state.tables import _checkpoint_format

    return ["table-__sketch-compacted-g1.bin", "table-e-compacted-g1.bin",
            f"table-t-compacted-g1.{_checkpoint_format()}"]


def recovery_compaction(root: str) -> dict:
    """q7 with its window at parallelism 4 (four slot stores on the card),
    epoch 1, then Engine.compact(1): one generation-1 file per table of
    agg. Restores at 4 and at 2 reach the oracle with K1's merge launched.
    The compaction torn after each of its three metadata writes restores
    to the oracle too, and a re-run finishes the cleanup."""
    want = oracle_q7(Q7_EVENTS)
    job = "chip-smoke-compact"
    url = os.path.join(root, job)
    build4 = lambda rows, events: build_q7(rows, events, parallelism=4)  # noqa: E731
    bench_config(True)
    rows1: list = []
    eng = Engine(build4(rows1, Q7_EVENTS), job_id=job, storage_url=url)
    run_gated_epochs(eng, recovery_holds(Q7_EVENTS, 2))
    base = os.path.join(root, job + "-uncompacted")
    shutil.copytree(url, base)
    before = epoch_bytes(url, job, 1)
    n_files = len(agg_table_files(url, job))
    t0 = time.perf_counter()
    removed = eng.compact(1)
    compact_ms = (time.perf_counter() - t0) * 1e3
    if agg_table_files(url, job) != compacted_files() or n_files != 12:
        raise AssertionError(f"compaction left {agg_table_files(url, job)} of {n_files} files")
    out = {"compact_ms": compact_ms, "files_removed": removed, "agg_files_before": n_files,
           "epoch_before": before, "epoch_after": epoch_bytes(url, job, 1),
           "fsck_ms": no_fsck_errors(url, job), "restores": {}, "torn": {}}
    for p in (4, 2):
        bench_config(True)
        rows2, rest = checkpoint_restore_run(
            lambda rows, events, _p=p: build_q7(rows, events, parallelism=_p),
            Q7_EVENTS, job, url, 1)
        check_q7(rows1 + rows2, want)
        if not rest["launches"].get("slot_scatter_combine_merge"):
            raise AssertionError(f"compaction: the restore at {p} launched no K1 merge")
        out["restores"][p] = {"build_ms": rest["build_ms"], "run_s": rest["run_s"],
                              "k1_merge_launches": rest["launches"]["slot_scatter_combine_merge"]}
    for tear in (1, 2, 3):
        u = os.path.join(root, f"{job}-torn-{tear}")
        shutil.copytree(base, u)
        faults.install(f"storage.put:fail@match=metadata-&after={tear}")
        try:
            compact_job(u, job, 1)
        except InjectedFault:
            pass
        else:
            raise AssertionError(f"the compaction torn after write {tear} did not fail")
        finally:
            faults.clear()
        bench_config(True)
        rows2, rest = checkpoint_restore_run(build4, Q7_EVENTS, job, u, 1)
        check_q7(rows1 + rows2, want)
        if not rest["launches"].get("slot_scatter_combine_merge"):
            raise AssertionError(f"torn compaction {tear}: the restore launched no K1 merge")
        compact_job(u, job, 1)
        if agg_table_files(u, job) != compacted_files():
            raise AssertionError(f"a re-run after tear {tear} left {agg_table_files(u, job)}")
        out["torn"][tear] = {"restore_build_ms": rest["build_ms"], "run_s": rest["run_s"],
                             "fsck_ms": no_fsck_errors(u, job)}
    return out


def recovery_plan_gate(root: str) -> dict:
    """q7c's epoch 1 restored under changed graphs: a 20 s window is refused
    (a RuntimeError naming both hashes) before any task starts; a no-op
    filter added to the VALUE node is refused without the evolution
    sidecar, and with diff_plans's mapping written (the window carried) the
    restore reaches the oracle."""
    want = oracle_q7(Q7_EVENTS)
    job = "chip-smoke-evolve"
    url = os.path.join(root, job)
    bench_config(True)
    rows1: list = []
    run_gated_epochs(Engine(build_q7(rows1, Q7_EVENTS), job_id=job, storage_url=url),
                     recovery_holds(Q7_EVENTS, 2))
    old_hash = read_job_checkpoint_metadata(url, job, 1)["plan_hash"]
    out = {"plan_hash": old_hash, "refused": {}}
    for label, kw in (("20 s window", {"width": 2 * WIDTH}),
                      ("no-op filter without a mapping", {"noop_filter": True})):
        eng = Engine(build_q7([], Q7_EVENTS, **kw), job_id=job, storage_url=url, restore_epoch=1)
        t0 = time.perf_counter()
        try:
            eng.build()
        except RuntimeError as e:
            if old_hash not in str(e) or eng.plan_hash not in str(e):
                raise AssertionError(f"{label}: the refusal names neither hash: {e}")
        else:
            raise AssertionError(f"{label}: the restore was not refused")
        if any(t.thread is not None for t in eng.tasks.values()):
            raise AssertionError(f"{label}: a task started before the refusal")
        out["refused"][label] = {"new_hash": eng.plan_hash,
                                 "refused_in_ms": (time.perf_counter() - t0) * 1e3}
    diff = diff_plans(build_q7([], Q7_EVENTS), build_q7([], Q7_EVENTS, noop_filter=True))
    actions = {c.node_id: c.action for c in diff.classifications}
    if actions.get("agg") != "carried" or diff.rejected:
        raise AssertionError(f"diff_plans: {actions}, diagnostics {diff.diagnostics}")
    write_evolution_mapping(url, job, 1, diff.mapping)
    bench_config(True)
    rows2, rest = checkpoint_restore_run(
        lambda rows, events: build_q7(rows, events, noop_filter=True), Q7_EVENTS, job, url, 1)
    check_q7(rows1 + rows2, want)
    out.update(classifications=actions, restore_build_ms=rest["build_ms"],
               restored_run_s=rest["run_s"],
               k1_merge_launches=rest["launches"].get("slot_scatter_combine_merge", 0),
               fsck_ms=no_fsck_errors(url, job))
    return out


def recovery_phase(card: str) -> dict:
    """Recovery on the card at bench.py's sizes (see the module docstring):
    a crash at the worst spot, bit rot, compaction and its tears, the plan
    gate; fsck_job over every clean job; storage in a temporary directory
    the phase removes. ``card``: nvidia-smi's name and power limit, printed
    beside the phase's times."""
    root = tempfile.mkdtemp(prefix="chip_smoke_recovery_")
    try:
        log("recovery: crash at barrier 2")
        crash = recovery_crash(root)
        log("recovery: bit rot")
        rot = recovery_bit_rot(root)
        log("recovery: compaction")
        comp = recovery_compaction(root)
        log("recovery: plan gate")
        gate = recovery_plan_gate(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        faults.clear()
    info = {"phase": "recovery", "card": card, "crash": crash, "bit_rot": rot,
            "compaction": comp, "plan_gate": gate}
    emit(info)
    return info


# ---------------------------------------------------------------- sql

SQL_EVENTS = {"q7": Q7_EVENTS, "q5": Q5_EVENTS, "q8": Q8_EVENTS}
SQL_HAND_BUILT = {"q7": "q7c", "q5": "q5", "q8": "q8c"}
SQL_PATH_KERNELS = {"q7": AGG_PATH_KERNELS, "q5": AGG_PATH_KERNELS,
                    "q8": AGG_PATH_KERNELS + ("join_sort_pairs", "join_search_bounds")}
SMOKE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "smoke")
def smoke_families() -> list:
    return sorted(os.path.splitext(f)[0] for f in os.listdir(os.path.join(SMOKE_DIR, "queries"))
                  if f.endswith(".sql"))


def smoke_sql(name: str, out: str) -> str:
    with open(os.path.join(SMOKE_DIR, "queries", f"{name}.sql")) as f:
        sql = f.read()
    return sql.replace("$input_dir", os.path.join(SMOKE_DIR, "inputs")).replace("$output_path", out)


def register_smoke_udafs() -> None:
    """The smoke suite's UDAFs and its async UDF (tests/smoke/udfs.py's p90,
    val_range and double_negative, which register into the JAX package) in
    the port's registry."""
    from arroyo_tpu_torch.udf import register_udaf, register_udf

    register_udf("double_negative", lambda c: -2 * int(c), return_dtype="int64",
                 is_async=True, max_concurrency=16, ordered=True)

    register_udaf("p90", lambda v: float(np.percentile(np.asarray(v, dtype=np.float64), 90)),
                  return_dtype="float64")
    register_udaf("val_range", lambda v: int(np.asarray(v).max() - np.asarray(v).min()),
                  return_dtype="int64")


# the families whose sinks write debezium envelopes (tests/smoke/generate.py's
# UPDATING; tests/test_torch_sql_smoke_a.py holds the copy to it)
SMOKE_UPDATING = {
    "updating_aggregate", "spill_keyspace", "filter_updating_aggregates",
    "updating_inner_join", "updating_left_join", "updating_right_join",
    "updating_full_join", "updating_inner_join_with_updating",
    "debezium_pass_through", "debezium_agg", "null_comparisons",
}


def smoke_canon(row: dict) -> str:
    """A row's canonical form for an order-insensitive multiset compare,
    floats rounded to 6 places (tests/test_smoke.py's ``canon``)."""
    return json.dumps({k: round(v, 6) if isinstance(v, float) else v
                       for k, v in sorted(row.items())}, sort_keys=True)


def smoke_merge_debezium(lines: list) -> list:
    """Apply debezium retract/append envelopes to a multiset
    (tests/test_smoke.py's ``merge_debezium``)."""
    counts: dict = {}
    rows: dict = {}

    def add(row: dict, n: int) -> None:
        key = smoke_canon(row)
        counts[key] = counts.get(key, 0) + n
        if n > 0:
            rows[key] = row
        if counts[key] == 0:
            del counts[key]

    for obj in lines:
        op = obj.get("op")
        if op is None:
            add(obj, 1)
        elif op in ("c", "r"):
            add(obj["after"], 1)
        elif op == "d":
            if smoke_canon(obj["before"]) not in counts:
                raise AssertionError(f"retract of unseen row: {obj['before']}")
            add(obj["before"], -1)
        elif op == "u":
            add(obj["before"], -1)
            add(obj["after"], 1)
    return [rows[k] for k, n in counts.items() for _ in range(n)]


def smoke_check(name: str, out: str) -> None:
    """The family's output against its golden, compared as
    tests/test_smoke.py's ``assert_outputs`` compares them: every file the
    sink wrote, debezium envelopes merged for the updating families, rows
    as a multiset of canonical forms."""
    import glob

    with open(os.path.join(SMOKE_DIR, "golden", f"{name}.json")) as f:
        golden = [json.loads(line) for line in f if line.strip()]
    got = []
    for path in sorted(glob.glob(out) + glob.glob(out + ".*")):
        with open(path) as f:
            got.extend(json.loads(line) for line in f if line.strip())
    if name in SMOKE_UPDATING:
        got = smoke_merge_debezium(got)
    got_c = sorted(smoke_canon(r) for r in got)
    want_c = sorted(smoke_canon(r) for r in golden)
    if got_c != want_c:
        raise AssertionError(
            f"{name}: output mismatch ({len(got_c)} rows vs {len(want_c)} golden)\n"
            f"extra:   {[r for r in got_c if r not in want_c][:5]}\n"
            f"missing: {[r for r in want_c if r not in got_c][:5]}")


def check_sql_path(what: str, job: str, eng, launches: dict, path_kernels) -> tuple:
    """A SQL-planned run's checks: its chains ran compiled (SEGMENT_COMPILED,
    no SEGMENT_FALLBACK), every kernel of its path launched, K4 one Triton
    launch a call. Returns the two events' lists."""
    compiled = recorder.events(job, "SEGMENT_COMPILED")
    fallbacks = recorder.events(job, "SEGMENT_FALLBACK")
    if not compiled or fallbacks:
        raise AssertionError(f"{what}: chains {[n for n in eng.graph.nodes if '+' in n]}, "
                             f"compiled {len(compiled)}, fallbacks "
                             f"{[e['message'] for e in fallbacks]}")
    unlaunched = [k for k in path_kernels if launches[k] == 0]
    if unlaunched:
        raise AssertionError(f"{what} ran without launching {unlaunched}: {launches}")
    check_k4_one_launch(what, launches)
    return compiled, fallbacks


def sql_query_run(name: str, root: str) -> dict:
    """Nexmark ``name`` written as SQL: planned by the port's plan_query,
    run at bench.py's sizes (chaining on, batch 65536, parallelism 1) into
    a single_file JSON sink, held exactly to ``oracle_sql``. One run, under
    the CUDA-activity trace that gives the device's idle share (the run is
    host-bound: its wall moves a few percent with the trace). Counts zeroed
    just before it and read just after: K4 and every kernel of the path
    must launch, the chains must run compiled."""
    from arroyo_tpu_torch.sql import plan_query

    events = SQL_EVENTS[name]
    want = oracle_sql(name, events)
    bench_config(chaining=True, queue_mult=1 if name == "q8" else 2)
    out = os.path.join(root, f"{name}.json")
    t0 = time.perf_counter()
    g = plan_query(nexmark_sql(name, events, out)).graph
    plan_ms = (time.perf_counter() - t0) * 1e3
    job = f"chip-smoke-sql-{name}"
    recorder.clear_job(job)
    ran = {}

    def run():
        reset_all_launch_counts()
        t0 = time.perf_counter()
        ran["eng"] = run_graph(g, job_id=job, timeout=900)
        torch.cuda.synchronize()
        ran["wall"] = time.perf_counter() - t0
        ran["launches"] = all_launch_counts()

    prof = device_trace(run, warm_device)
    eng, wall, launches = ran["eng"], ran["wall"], ran["launches"]
    if eng.device.type != "cuda":
        raise RuntimeError(f"{job} ran on {eng.device}, not on the GPU")
    with open(out) as f:
        n_rows = check_sql_rows(name, f.read().splitlines(), want)
    compiled, fallbacks = check_sql_path(f"sql {name}", job, eng, launches,
                                         SQL_PATH_KERNELS[name])
    by_name = device_us_by_name(prof)
    busy_s = sum(by_name.values()) / 1e6 if by_name else None  # None: not measured
    return {"events": events, "plan_ms": plan_ms, "wall_s": wall, "events_per_s": events / wall,
            "rows": n_rows, "chains": [n for n in eng.graph.nodes if "+" in n],
            "segment_compiled": len(compiled), "segment_fallback": len(fallbacks),
            "launches": {k: launches[k] for k in SQL_PATH_KERNELS[name]},
            "k4_triton_launches": launches["segment_fused_kernels"],
            "device_busy_s": busy_s,
            "device_idle_share": None if busy_s is None else 1.0 - busy_s / wall,
            "device_us_by_name": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10])}


def sql_smoke_phase(root: str) -> dict:
    """The smoke families through the port on the card: each planned by the
    port, run at parallelism 1 with chaining on (the windows, joins and
    updating aggregates on the card) and held to tests/smoke/golden/, the
    operators the 10 families of ROADMAP A.5 need (the updating join,
    window functions, UNNEST, the async UDF) among them."""
    from arroyo_tpu_torch.sql import plan_query

    register_smoke_udafs()
    out = {"passed": {}}
    for name in smoke_families():
        tcfg.reset()
        tcfg.update({"checkpoint.storage-url": os.path.join(root, "smoke-ckpt"),
                     "pipeline.chaining.enabled": True})
        path = os.path.join(root, f"smoke-{name}.json")
        g = plan_query(smoke_sql(name, path)).graph
        job = f"chip-smoke-family-{name}"
        t0 = time.perf_counter()
        eng = run_graph(g, job_id=job, timeout=120)
        if eng.device.type != "cuda":
            raise RuntimeError(f"smoke {name} ran on {eng.device}, not on the GPU")
        wall = time.perf_counter() - t0
        smoke_check(name, path)
        with open(path) as f:
            out["passed"][name] = {"lines": sum(1 for line in f if line.strip()),
                                   "wall_s": wall}
    if len(out["passed"]) != len(smoke_families()):
        raise AssertionError(f"smoke families unaccounted for: {out}")
    return out


def sql_phase(card: str, res: dict) -> dict:
    """The SQL front end on the card: Nexmark q7, q5 and q8 written as SQL
    (beside the hand-built q7c, q5 and q8c of this call, where they ran)
    and the smoke families. ``card``: nvidia-smi's name and power limit."""
    root = tempfile.mkdtemp(prefix="chip_smoke_sql_")
    try:
        queries = {}
        for name in ("q7", "q5", "q8"):
            log(f"sql: {name}")
            q = sql_query_run(name, root)
            hand = res.get(SQL_HAND_BUILT[name])
            q["hand_built"] = None if hand is None else {
                "phase": SQL_HAND_BUILT[name], "events_per_s": hand["events_per_s"]}
            queries[name] = q
        log("sql: smoke families")
        smoke = sql_smoke_phase(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    info = {"phase": "sql", "card": card, "queries": queries,
            "smoke_passed": len(smoke["passed"]), "smoke": smoke["passed"]}
    emit(info)
    for name, q in queries.items():
        print(f"sql {name}: plan {q['plan_ms']:.1f} ms, run {q['wall_s']:.3f} s, "
              f"{q['events_per_s']:.0f} events/s (hand-built "
              f"{(q['hand_built'] or {}).get('events_per_s', 'not run')}), idle "
              f"{q['device_idle_share']}, launches {q['launches']}, "
              f"SEGMENT_COMPILED {q['segment_compiled']}, SEGMENT_FALLBACK "
              f"{q['segment_fallback']} [{card}]", flush=True)
    return info


# ---------------------------------------------------------------- cluster

# The control plane and the cross-worker data plane on the card: SQL
# Nexmark submitted over the port's REST API, run by its controller over two
# workers (two engines in this process, then two worker processes, each
# with its own CUDA context), coordinated checkpoints, a worker killed and
# the job recovered, and the CLI's `run`.
# periodic checkpoints: a few in each exact run (each snapshots the sink's
# buffered lines too), and every 200 ms in the crash run, whose first
# complete one triggers the kill
CLUSTER_CKPT_MS = 500
CLUSTER_CRASH_CKPT_MS = 200
# bench.py's q7 size: at 1,000,000 events a worker can finish before the
# first complete checkpoint, and there is then none to kill
CLUSTER_CRASH_EVENTS = Q7_EVENTS
CLUSTER_CLI_FAMILY = "grouped_aggregates"
CLUSTER_WORKERS = 2


def cluster_config(extra: dict = None, interval_ms: int = None) -> dict:
    """bench.py's sizes (bench_config with chaining on) and the controller's
    keys, in this process's config; returns the same settings as the port's
    environment variables, which the worker subprocesses read."""
    keys = {"controller.workers-per-job": CLUSTER_WORKERS,
            "checkpoint.interval-ms": interval_ms or CLUSTER_CKPT_MS, **(extra or {})}
    bench_config(chaining=True, extra=keys)
    env = {"pipeline.source-batch-size": BENCH_BATCH, "device.batch-capacity": BENCH_BATCH,
           "worker.queue-size": 2 * BENCH_BATCH, "device.table-capacity": 65536,
           "device.region-size": 2048, "pipeline.chaining.enabled": "true",
           "checkpoint.storage-url": STORAGE_ROOT}
    return {"ARROYO_TPU_TORCH__" + "__".join(p.upper().replace("-", "_")
                                             for p in k.split(".")): str(v)
            for k, v in env.items()}


def http_json(method: str, url: str, body: dict = None) -> dict:
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def sink_lines(out: str) -> list:
    """Every line the single_file sink wrote: ``out`` and its subtasks'
    ``out.<i>`` files."""
    import glob

    lines = []
    for p in sorted(glob.glob(out) + glob.glob(out + ".*")):
        with open(p) as f:
            lines += [ln for ln in f.read().splitlines() if ln.strip()]
    return lines


def timed_database():
    """The port's Database with the time of every job state change."""
    from arroyo_tpu_torch.controller import Database

    class TimedDatabase(Database):
        def __init__(self):
            super().__init__()
            self.state_times: list = []  # (job, state, perf_counter)

        def update_job(self, jid, **fields):
            if "state" in fields:
                self.state_times.append((jid, fields["state"], time.perf_counter()))
            super().update_job(jid, **fields)

        def first(self, jid, state, after=0.0):
            return next((t for j, s, t in self.state_times
                         if j == jid and s == state and t >= after), None)

        def states(self, jid):
            return [s for j, s, _ in self.state_times if j == jid]

    return TimedDatabase()


@contextlib.contextmanager
def epoch_clock():
    """Each coordinated epoch's trigger and durable times (perf_counter) as
    the port's JobController reaches them, for every job meanwhile: {job:
    {"trigger": {epoch: [t, ...]}, "durable": {epoch: t}}}. The controller
    runs in this process under both schedulers. A restored set triggers the
    epoch numbers after its restore epoch again, so every trigger is kept.
    (The epoch traces the controller persists hold the newest 32 epochs of
    a job only, and none of an epoch that the recorder evicted before it
    became durable.)"""
    from arroyo_tpu_torch.controller.controller import JobController

    orig_trigger, orig_durable = JobController._trigger_checkpoint, JobController._epoch_durable
    clock: dict = {}

    def of(job):
        return clock.setdefault(job, {"trigger": {}, "durable": {}})

    def trigger(self, epoch, then_stop=False):
        of(self.job_id)["trigger"].setdefault(epoch, []).append(time.perf_counter())
        return orig_trigger(self, epoch, then_stop=then_stop)

    def durable(self, epoch):
        of(self.job_id)["durable"].setdefault(epoch, time.perf_counter())
        return orig_durable(self, epoch)

    JobController._trigger_checkpoint, JobController._epoch_durable = trigger, durable
    try:
        yield clock
    finally:
        JobController._trigger_checkpoint, JobController._epoch_durable = (orig_trigger,
                                                                          orig_durable)


def epoch_durable_ms(clock: dict, job: str, epochs: list) -> dict:
    """Trigger to job marker durable, in ms, for every epoch of ``epochs``
    (those recorded complete), from the last trigger of its number before
    it became durable. Fails if one of them lacks either time."""
    times = clock.get(job, {"trigger": {}, "durable": {}})
    out, missing = {}, []
    for e in epochs:
        done = times["durable"].get(e)
        trig = [t for t in times["trigger"].get(e, []) if done is not None and t <= done]
        if not trig:
            missing.append(e)
            continue
        out[str(e)] = (done - max(trig)) * 1e3
    if missing or not epochs:
        raise AssertionError(f"{job}: complete epochs {epochs}, of which {missing} have no "
                             f"trigger before their durable marker")
    return out


# The cluster phase's subprocesses run the port's `python -m
# arroyo_tpu_torch ...` through runpy under this wrapper, which writes the
# process's kernel launch counts (all_launch_counts' keys) to
# <first argument>.<pid> when a worker reports "finished" (the controller
# kills a finished worker's process) and when the process exits. A process
# starts at 0, so they are its main path's. A killed process writes none.
COUNTING_MAIN = r"""
import atexit, json, os, runpy, sys

path = sys.argv.pop(1)


def dump():
    from arroyo_tpu_torch.ops import (hash_kernels, join_kernels, kernels, segment_kernel,
                                      sharded_kernels)

    counts = {**kernels.launch_counts(), **segment_kernel.launch_counts(),
              "segment_fused_kernels": segment_kernel.segment_fused.kernel_launches,
              **join_kernels.launch_counts(), **sharded_kernels.launch_counts(),
              **hash_kernels.launch_counts()}
    with open(f"{path}.{os.getpid()}", "w") as f:
        json.dump(counts, f)


class Stdout:
    def __init__(self, real):
        self.real = real

    def write(self, text):
        if '"event": "finished"' in text:
            dump()
        return self.real.write(text)

    def __getattr__(self, name):
        return getattr(self.real, name)


sys.stdout = Stdout(sys.stdout)
atexit.register(dump)
sys.argv[0] = "arroyo_tpu_torch"
runpy.run_module("arroyo_tpu_torch", run_name="__main__", alter_sys=True)
"""


def counting_command(cmd: list, path: str) -> list:
    """``python -m arroyo_tpu_torch <args>`` under COUNTING_MAIN."""
    if cmd[:3] != [sys.executable, "-m", "arroyo_tpu_torch"]:
        raise AssertionError(f"not the port's entry point: {cmd[:3]}")
    return [sys.executable, "-c", COUNTING_MAIN, path, *cmd[3:]]


def counted_launches(path: str) -> dict:
    """pid -> the launch counts that each process under COUNTING_MAIN wrote."""
    import glob

    out = {}
    for p in glob.glob(path + ".*"):
        with open(p) as f:
            out[int(p.rsplit(".", 1)[1])] = json.load(f)
    return out


class CountingSubprocess:
    """The scheduler module's ``subprocess``, whose Popen starts each worker
    under COUNTING_MAIN."""

    def __init__(self, path: str):
        self.path = path

    def __getattr__(self, name):
        return getattr(subprocess, name)

    def Popen(self, cmd, **kw):
        return subprocess.Popen(counting_command(cmd, self.path), **kw)


def gpu_compute_apps() -> list:
    """nvidia-smi's compute apps, one (pid, used memory in MiB, name) a CUDA
    context. In a container whose nvidia-smi cannot see the processes' ids
    it gives every process as pid 1 ("/process_api"), so the lines are
    counted as well as matched by pid."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory,process_name",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=30, check=True).stdout
    apps = []
    for ln in out.strip().splitlines():
        parts = [p.strip() for p in ln.split(",")]
        if len(parts) == 3 and parts[0].isdigit():
            apps.append((int(parts[0]), parts[1], parts[2]))
    return apps


class CountingInbox:
    """Wraps a task inbox behind a data-plane receiver: counts the rows each
    worker receives over the data plane."""

    def __init__(self, inbox, counts: dict, worker: int):
        self.inbox, self.counts, self.worker = inbox, counts, worker

    def put(self, input_index, item):
        if isinstance(item, Batch):
            self.counts[self.worker] = self.counts.get(self.worker, 0) + item.num_rows
        self.inbox.put(input_index, item)


@contextlib.contextmanager
def counted_data_plane(counts: dict):
    """Every NetworkManager made meanwhile counts the rows delivered to its
    worker's inboxes (keyed by its listening port)."""
    from arroyo_tpu_torch.engine import network

    orig = network.NetworkManager.register_receiver

    def register(self, quad, inbox, input_index):
        orig(self, quad, CountingInbox(inbox, counts, self.port), input_index)

    network.NetworkManager.register_receiver = register
    try:
        yield
    finally:
        network.NetworkManager.register_receiver = orig


def cluster_embedded(name: str, root: str) -> dict:
    """SQL ``name`` POSTed to the port's ApiServer, run by
    ControllerServer(EmbeddedScheduler) over two engines in this process
    that exchange rows over the data plane; exact against oracle_sql."""
    from arroyo_tpu_torch.api import ApiServer
    from arroyo_tpu_torch.controller import ControllerServer
    from arroyo_tpu_torch.controller.scheduler import EmbeddedScheduler

    events = SQL_EVENTS[name]
    want = oracle_sql(name, events)
    cluster_config({"worker.queue-size": (1 if name == "q8" else 2) * BENCH_BATCH})
    out = os.path.join(root, f"embedded-{name}.json")
    db = timed_database()
    api = ApiServer(db, port=0).start()

    class RecordingScheduler(EmbeddedScheduler):
        """Keeps every worker set it starts (the controller drops its
        handles once the job ends)."""

        sets: list = []

        def start_workers(self, *a, **kw):
            handles = super().start_workers(*a, **kw)
            self.sets.append(handles)
            return handles

    sched = RecordingScheduler()
    ctl = ControllerServer(db, sched).start()
    dp_rows: dict = {}
    try:
        with counted_data_plane(dp_rows), epoch_clock() as clock:
            reset_all_launch_counts()
            t0 = time.perf_counter()
            created = http_json("POST", f"http://127.0.0.1:{api.port}/api/v1/pipelines",
                                {"name": f"cluster-{name}",
                                 "query": nexmark_sql(name, events, out), "parallelism": 2})
            jid = created["job_id"]
            state = ctl.wait_for_state(jid, "Finished", "Failed", timeout=600)
            wall = time.perf_counter() - t0
            launches = all_launch_counts()
        job = db.get_job(jid)
        if state != "Finished":
            raise AssertionError(f"cluster embedded {name}: {state}: {job.get('failure_message')}")
        engines = [h.engine for h in sched.sets[-1]] if sched.sets else []
        if len(engines) != CLUSTER_WORKERS or any(e.device.type != "cuda" for e in engines):
            raise AssertionError(f"cluster embedded {name}: workers "
                                 f"{[str(e.device) for e in engines]}")
        n_rows = check_sql_rows(name, sink_lines(out), want)
        unlaunched = [k for k in SQL_PATH_KERNELS[name] if launches[k] == 0]
        if unlaunched:
            raise AssertionError(f"cluster embedded {name} launched no {unlaunched}: {launches}")
        windows = {w: sorted(f"{n}/{s}" for (n, s) in e.tasks if "tumbling_aggregate" in n)
                   for w, e in enumerate(engines)}
        if not all(windows.values()):
            raise AssertionError(f"cluster embedded {name}: window subtasks by worker {windows}")
        received = {w: dp_rows.get(e.network.port, 0) for w, e in enumerate(engines)}
        if not all(received.values()):
            raise AssertionError(f"cluster embedded {name}: data-plane rows by worker {received}")
        complete = [c["epoch"] for c in db.list_checkpoints(jid) if c["state"] == "complete"]
        if not complete:
            raise AssertionError(f"cluster embedded {name}: no checkpoint completed")
        t_run = db.first(jid, "Running", t0)
        check_k4_one_launch(f"cluster embedded {name}", launches)
        return {"events": events, "rows": n_rows, "wall_s": wall, "events_per_s": events / wall,
                "post_to_running_ms": (t_run - t0) * 1e3, "states": db.states(jid),
                "launches": {k: launches[k] for k in SQL_PATH_KERNELS[name]},
                "window_subtasks_by_worker": windows, "data_plane_rows_by_worker": received,
                "checkpoints_complete": complete,
                "barrier_to_complete_ms": epoch_durable_ms(clock, jid, complete)}
    finally:
        ctl.stop()
        api.stop()


def timed_worker_handle():
    """The port's ProcessWorkerHandle, stamping its spawn, its "started"
    event and its first heartbeat (perf_counter)."""
    from arroyo_tpu_torch.controller import scheduler

    class TimedHandle(scheduler.ProcessWorkerHandle):
        def __init__(self, *a, **kw):
            self.t_spawn, self.t_started, self.t_heartbeat = time.perf_counter(), None, None
            super().__init__(*a, **kw)

        def _read_stdout(self):
            real, handle = self.proc.stdout, self

            class Tap:
                def __iter__(self):
                    for line in real:
                        now = time.perf_counter()
                        if handle.t_started is None and '"started"' in line:
                            handle.t_started = now
                        if handle.t_heartbeat is None and '"heartbeat"' in line:
                            handle.t_heartbeat = now
                        yield line

            self.proc.stdout = Tap()
            super()._read_stdout()

    return scheduler, TimedHandle


def check_worker_launches(what: str, counts: dict, pids: list, path_kernels) -> dict:
    """Every process of ``pids`` wrote its launch counts and launched every
    kernel of ``path_kernels``, K4 one Triton launch a call; returns them
    by pid, the path's kernels only."""
    got = {}
    for pid in pids:
        c = counts.get(pid)
        if c is None:
            raise AssertionError(f"{what}: worker {pid} wrote no launch counts "
                                 f"(those written: {sorted(counts)})")
        unlaunched = [k for k in path_kernels if c[k] == 0]
        if unlaunched:
            raise AssertionError(f"{what}: worker {pid} launched no {unlaunched}: {c}")
        check_k4_one_launch(f"{what} worker {pid}", c)
        got[str(pid)] = {k: c[k] for k in path_kernels}
    return got


def check_relayed_segments(what: str, db, jid: str) -> dict:
    """The workers' relayed events: every subtask of the job's compiled
    chains (both workers' share) reported SEGMENT_COMPILED, none
    SEGMENT_FALLBACK."""
    events = db.list_events(jid, limit=100_000)
    compiled = sorted({f"{e['node']}/{e['subtask']}" for e in events
                       if e["code"] == "SEGMENT_COMPILED"})
    fallbacks = [e["message"] for e in events if e["code"] == "SEGMENT_FALLBACK"]
    if fallbacks or len({c.rsplit("/", 1)[1] for c in compiled}) < CLUSTER_WORKERS:
        raise AssertionError(f"{what}: SEGMENT_COMPILED by subtask {compiled}, "
                             f"SEGMENT_FALLBACK {fallbacks}")
    return {"segment_compiled": compiled, "segment_fallback": len(fallbacks)}


def cluster_process_run(name: str, root: str, events: int, crash: bool) -> dict:
    """SQL ``name`` at ``events`` through ControllerServer(ProcessScheduler):
    two `python -m arroyo_tpu_torch worker` processes (under COUNTING_MAIN)
    with no device setting, so each takes cuda; exact against oracle_sql.
    Each worker that ran to its end must have launched every kernel of the
    path, and the chains of both workers' subtasks compiled with no
    fallback. Without ``crash``, nvidia-smi must list one more compute app
    for each worker while the job runs. With ``crash``, one worker is
    killed right after the first complete checkpoint and the job must
    recover (restarts >= 1) and finish exact; then the restored set's two
    workers are held to the launch counts."""
    from arroyo_tpu_torch.controller import ControllerServer

    want = oracle_sql(name, events)
    env = cluster_config(interval_ms=CLUSTER_CRASH_CKPT_MS if crash else CLUSTER_CKPT_MS)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    scheduler, handle_cls = timed_worker_handle()
    orig_handle, orig_subprocess = scheduler.ProcessWorkerHandle, scheduler.subprocess
    tag = f"process-{name}-{'crash' if crash else 'exact'}"
    counts_path = os.path.join(root, f"{tag}-launches")
    scheduler.ProcessWorkerHandle = handle_cls
    scheduler.subprocess = CountingSubprocess(counts_path)
    out = os.path.join(root, f"{tag}.json")
    db = timed_database()
    ctl = ControllerServer(db, scheduler.ProcessScheduler()).start()
    baseline = gpu_compute_apps()  # this process's own context
    seen: dict = {}  # pid -> MiB, worker pids nvidia-smi listed
    most: list = []  # the longest list of compute apps seen while Running
    killed = {}
    try:
        with epoch_clock() as clock:
            t0 = time.perf_counter()
            pid = db.create_pipeline(f"cluster-{name}", nexmark_sql(name, events, out), 2)
            jid = db.create_job(pid)
            first_handles = last_handles = None
            deadline = time.monotonic() + 600
            while time.monotonic() < deadline:
                job = db.get_job(jid)
                state = job["state"]
                jc = ctl.jobs.get(jid)
                handles = [h for h in (jc.handles if jc is not None else None) or []
                           if h is not None]
                if state == "Running" and handles:
                    if len(handles) == CLUSTER_WORKERS:  # a worker that ended drops out
                        first_handles = first_handles or handles
                        last_handles = handles
                    pids = {h.proc.pid for h in handles}
                    if not pids <= set(seen) and len(most) < len(baseline) + CLUSTER_WORKERS:
                        apps = gpu_compute_apps()
                        seen.update({p: m for p, m, _ in apps if p in pids})
                        if len(apps) > len(most):
                            most = apps
                    if crash and not killed and any(
                            c["state"] == "complete" for c in db.list_checkpoints(jid)):
                        victim = handles[1]
                        killed = {"pid": victim.proc.pid, "t": time.perf_counter(),
                                  "epochs_complete": [c["epoch"]
                                                      for c in db.list_checkpoints(jid)
                                                      if c["state"] == "complete"]}
                        victim.proc.kill()
                if state in ("Finished", "Failed", "Stopped"):
                    break
                time.sleep(0.02)
            wall = time.perf_counter() - t0
        job = db.get_job(jid)
        if job["state"] != "Finished":
            raise AssertionError(f"cluster process {name}: {job['state']}: "
                                 f"{job.get('failure_message')}")
        n_rows = check_sql_rows(name, sink_lines(out), want)
        if first_handles is None or len(first_handles) != CLUSTER_WORKERS \
                or len(last_handles) != CLUSTER_WORKERS:
            raise AssertionError(f"cluster process {name}: worker sets {first_handles}, "
                                 f"{last_handles}")
        for h in last_handles:  # they have reported "finished"; their counts follow
            h.proc.wait(timeout=60)
        worker_pids = [h.proc.pid for h in first_handles]
        ran_to_end = [h.proc.pid for h in last_handles]
        info = {"events": events, "rows": n_rows, "wall_s": wall, "events_per_s": events / wall,
                "post_to_running_ms": (db.first(jid, "Running", t0) - t0) * 1e3,
                "states": db.states(jid), "restarts": int(job["restarts"] or 0),
                "worker_pids": worker_pids, "gpu_mib_by_pid": {str(p): seen.get(p)
                                                              for p in worker_pids},
                "spawn_to_started_s": [None if h.t_started is None else h.t_started - h.t_spawn
                                       for h in first_handles],
                "spawn_to_first_heartbeat_s": [
                    None if h.t_heartbeat is None else h.t_heartbeat - h.t_spawn
                    for h in first_handles],
                "launches_by_worker": check_worker_launches(
                    f"cluster process {name}", counted_launches(counts_path), ran_to_end,
                    SQL_PATH_KERNELS[name]),
                **check_relayed_segments(f"cluster process {name}", db, jid)}
        complete = [c["epoch"] for c in db.list_checkpoints(jid) if c["state"] == "complete"]
        info["checkpoints_complete"] = complete
        info["barrier_to_complete_ms"] = epoch_durable_ms(clock, jid, complete)
        # each worker holds a CUDA context: listed by its pid, or, where
        # nvidia-smi cannot name pids, one more compute app for each
        info["compute_apps"] = {"before": baseline, "while_running": most}
        info["all_workers_on_gpu"] = (all(p in seen for p in worker_pids)
                                      or len(most) >= len(baseline) + CLUSTER_WORKERS)
        if crash:
            if not killed:
                raise AssertionError(f"cluster process {name}: the job finished before a "
                                     f"checkpoint completed; no worker was killed")
            if info["restarts"] < 1 or killed["pid"] in ran_to_end:
                raise AssertionError(f"cluster process {name}: killed worker {killed['pid']}, "
                                     f"restarts {info['restarts']}, last set {ran_to_end}")
            t_run = db.first(jid, "Running", killed["t"])
            info["crash"] = {"killed_pid": killed["pid"],
                             "after_epochs": killed["epochs_complete"],
                             "restored_set_pids": ran_to_end,
                             "kill_to_running_ms": None if t_run is None
                             else (t_run - killed["t"]) * 1e3,
                             "kill_to_finished_s": db.first(jid, "Finished", killed["t"])
                             - killed["t"]}
        elif not info["all_workers_on_gpu"]:
            raise AssertionError(f"cluster process {name}: nvidia-smi never listed both "
                                 f"workers as compute apps while the job ran: {info['compute_apps']}, "
                                 f"pids {worker_pids}")
        return info
    finally:
        ctl.stop()
        scheduler.ProcessWorkerHandle, scheduler.subprocess = orig_handle, orig_subprocess
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cluster_cli(root: str) -> dict:
    """`python -m arroyo_tpu_torch run <family>.sql --parallelism 2` as a
    subprocess (under COUNTING_MAIN; no device setting: the card), its
    output held to the family's golden. Its 400 rows make batches below
    segment.compile.min-rows, so its window's K1 and K2 must launch and K4
    need not."""
    name = CLUSTER_CLI_FAMILY
    out = os.path.join(root, f"cli-{name}.json")
    sql_path = os.path.join(root, f"cli-{name}.sql")
    counts_path = os.path.join(root, "cli-launches")
    with open(sql_path, "w") as f:
        f.write(smoke_sql(name, out))
    env = {k: v for k, v in os.environ.items() if not k.startswith("ARROYO_TPU_TORCH__")}
    env["ARROYO_TPU_TORCH__CHECKPOINT__STORAGE_URL"] = STORAGE_ROOT
    t0 = time.perf_counter()
    proc = subprocess.run(counting_command([sys.executable, "-m", "arroyo_tpu_torch", "run",
                                            sql_path, "--parallelism", "2", "--timeout", "300"],
                                           counts_path),
                          cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                          capture_output=True, text=True, timeout=400)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli run exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    smoke_check(name, out)
    counts = counted_launches(counts_path)
    if len(counts) != 1:
        raise AssertionError(f"cli run: launch counts from processes {sorted(counts)}")
    launches = check_worker_launches("cli run", counts, list(counts), AGG_PATH_KERNELS[:2])
    (pid, c), = counts.items()
    return {"family": name, "rc": proc.returncode, "wall_s": wall,
            "lines": len(sink_lines(out)),
            "launches": {**launches[str(pid)], "segment_fused": c["segment_fused"]},
            "stderr_tail": proc.stderr[-400:]}


def cluster_phase(card: str, res: dict) -> dict:
    """The control plane and the data plane on the card; ``card``:
    nvidia-smi's name and power limit."""
    root = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    try:
        log("cluster: embedded q7")
        emb = {"q7": cluster_embedded("q7", root)}
        log("cluster: embedded q8")
        emb["q8"] = cluster_embedded("q8", root)
        log("cluster: process q7")
        proc = cluster_process_run("q7", root, SQL_EVENTS["q7"], crash=False)
        log("cluster: process q7, one worker killed")
        crash = cluster_process_run("q7", root, CLUSTER_CRASH_EVENTS, crash=True)
        log("cluster: cli run")
        cli = cluster_cli(root)
    finally:
        tcfg.reset()
        shutil.rmtree(root, ignore_errors=True)
    single = ((res.get("sql") or {}).get("queries") or {}).get("q7") or {}
    info = {"phase": "cluster", "card": card, "embedded": emb, "process": proc,
            "process_crash": crash, "cli": cli,
            "single_engine_sql_q7_events_per_s": single.get("events_per_s")}
    emit(info)
    print(f"cluster embedded q7: {emb['q7']['events_per_s']:.0f} events/s, q8 "
          f"{emb['q8']['events_per_s']:.0f}; process q7 {proc['events_per_s']:.0f} events/s "
          f"(single-engine SQL q7 of this call: {info['single_engine_sql_q7_events_per_s']}); "
          f"POST to Running {emb['q7']['post_to_running_ms']:.1f} ms embedded, "
          f"{proc['post_to_running_ms']:.1f} ms process; worker spawn to started "
          f"{proc['spawn_to_started_s']} s, to first heartbeat "
          f"{proc['spawn_to_first_heartbeat_s']} s; barrier to complete (ms) embedded q7 "
          f"{emb['q7']['barrier_to_complete_ms']}, process q7 {proc['barrier_to_complete_ms']}; "
          f"kill to Running {crash['crash']['kill_to_running_ms']} ms, kill to Finished "
          f"{crash['crash']['kill_to_finished_s']:.3f} s (restarts {crash['restarts']}); "
          f"compute apps before / while running {proc['compute_apps']}; "
          f"launches embedded q7 {emb['q7']['launches']}, q8 {emb['q8']['launches']}, "
          f"process q7 by worker {proc['launches_by_worker']}, restored set "
          f"{crash['launches_by_worker']}, cli run {cli['launches']} [{card}]", flush=True)
    return info


# ---------------------------------------------------------------- deploy

# Deployment on the card: a node daemon spawning the workers, a C++ UDF
# built once by the compile service and fetched by every worker, files in
# and out in the formats the JAX package reads and writes, and checkpoints
# in an object store.
DEPLOY_EVENTS = Q7_EVENTS  # (a), (b), and (c)'s JSON-lines files
DEPLOY_JSON_FILES = 8
# (c)'s Avro OCF at a quarter of bench.py's q7 size: a cut of scale, as the
# Avro codec is row-at-a-time Python in both packages
DEPLOY_AVRO_EVENTS = 500_000
DEPLOY_NODE_SLOTS = CLUSTER_WORKERS
# S3's multipart path for every state file above 64 KiB (in-process client)
DEPLOY_MULTIPART_BYTES = 64 * 1024
CPP_DOLLARS_TO_EUROS = r"""
#include <cstdint>
extern "C" void dollars_to_euros(int64_t n, const int64_t* price, int64_t* out) {
  for (int64_t i = 0; i < n; i++) out[i] = price[i] * 908 / 1000;
}
"""
SQL_Q7_EUROS = """CREATE TABLE q7e_out (start TIMESTAMP, auction BIGINT, max_euros BIGINT, bids BIGINT)
WITH (connector = 'single_file', path = '{out}', format = 'json', type = 'sink');
INSERT INTO q7e_out
SELECT window.start AS start, auction, max_euros, bids FROM (
  SELECT tumble(interval '10 seconds') AS window, "bid.auction" AS auction,
    max(dollars_to_euros("bid.price")) AS max_euros, count(*) AS bids
  FROM nexmark WHERE bid GROUP BY window, auction) x;
"""
# q7 over a filesystem source of the bids, into a partitioned filesystem sink
SQL_Q7_FILES = """CREATE TABLE bids (auction BIGINT, price BIGINT, ts TIMESTAMP)
WITH (connector = 'filesystem', path = '{src}', format = '{fmt}', type = 'source',
      event_time_field = 'ts');
CREATE TABLE q7f_out (start TIMESTAMP, auction BIGINT, max_price BIGINT, bids BIGINT, shard BIGINT)
WITH (connector = 'filesystem', path = '{out}', format = '{out_fmt}', type = 'sink');
INSERT INTO q7f_out
SELECT window.start AS start, auction, max_price, bids, auction % 4 AS shard FROM (
  SELECT tumble(interval '10 seconds') AS window, auction, max(price) AS max_price,
    count(*) AS bids
  FROM bids GROUP BY window, auction) x;
"""
SQL_OUT_FIELDS["q7e"] = ("max_euros", "bids")
AVRO_BIDS = {"type": "record", "name": "bid", "fields": [
    {"name": "auction", "type": "long"}, {"name": "price", "type": "long"},
    {"name": "ts", "type": {"type": "long", "logicalType": "timestamp-micros"}}]}

# The node daemon runs the port's `python -m arroyo_tpu_torch node` through
# runpy under this wrapper, which starts each worker it spawns under
# COUNTING_MAIN (its second argument) writing to <first argument>.<pid>.
NODE_MAIN = r"""
import runpy, subprocess, sys

path, counting = sys.argv.pop(1), sys.argv.pop(1)
from arroyo_tpu_torch.controller import scheduler


class Counting:
    def __getattr__(self, name):
        return getattr(subprocess, name)

    def Popen(self, cmd, **kw):
        return subprocess.Popen([sys.executable, "-c", counting, path, *cmd[3:]], **kw)


scheduler.subprocess = Counting()
sys.argv[0] = "arroyo_tpu_torch"
runpy.run_module("arroyo_tpu_torch", run_name="__main__", alter_sys=True)
"""


def oracle_q7_euros(event_count: int) -> dict:
    """q7 with its max over dollars_to_euros(price) (price * 908 / 1000 on
    int64, truncating): the function rises with the price, so the max's
    image is the image of the max."""
    return {k: (m * 908 // 1000, c) for k, (m, c) in oracle_q7(event_count).items()}


class MemoryS3:
    """An in-process S3 client (the calls state/storage.py makes, multipart
    included) behind ``storage.set_s3_client``: the object store of the
    files phase, with no network."""

    def __init__(self):
        self.objects: dict = {}
        self.uploads: dict = {}
        self.multipart_completed = 0
        self.parts = 0
        self.lock = threading.Lock()

    def put_object(self, Bucket, Key, Body):
        with self.lock:
            self.objects[(Bucket, Key)] = bytes(Body)

    def get_object(self, Bucket, Key):
        import io

        with self.lock:
            if (Bucket, Key) not in self.objects:
                raise KeyError(Key)
            return {"Body": io.BytesIO(self.objects[(Bucket, Key)])}

    def head_object(self, Bucket, Key):
        with self.lock:
            if (Bucket, Key) not in self.objects:
                raise KeyError(Key)
        return {}

    def delete_object(self, Bucket, Key):
        with self.lock:
            self.objects.pop((Bucket, Key), None)

    def list_objects_v2(self, Bucket, Prefix="", Delimiter=None, MaxKeys=1000,
                        ContinuationToken=None):
        with self.lock:
            keys = sorted(k for b, k in self.objects if b == Bucket and k.startswith(Prefix))
        contents, prefixes = [], set()
        for k in keys:
            rest = k[len(Prefix):]
            if Delimiter and Delimiter in rest:
                prefixes.add(Prefix + rest.split(Delimiter)[0] + Delimiter)
            else:
                contents.append({"Key": k})
        return {"Contents": contents[:MaxKeys],
                "CommonPrefixes": [{"Prefix": p} for p in sorted(prefixes)],
                "KeyCount": min(len(contents) + len(prefixes), MaxKeys)}

    def create_multipart_upload(self, Bucket, Key):
        with self.lock:
            uid = f"up-{len(self.uploads)}-{self.multipart_completed}"
            self.uploads[uid] = {}
        return {"UploadId": uid}

    def upload_part(self, Bucket, Key, UploadId, PartNumber, Body):
        with self.lock:
            self.uploads[UploadId][PartNumber] = bytes(Body)
            self.parts += 1
        return {"ETag": f"etag-{PartNumber}"}

    def complete_multipart_upload(self, Bucket, Key, UploadId, MultipartUpload):
        with self.lock:
            parts = self.uploads.pop(UploadId)
            self.objects[(Bucket, Key)] = b"".join(parts[p["PartNumber"]]
                                                   for p in MultipartUpload["Parts"])
            self.multipart_completed += 1

    def abort_multipart_upload(self, Bucket, Key, UploadId):
        with self.lock:
            self.uploads.pop(UploadId, None)


def start_daemon(cmd: list, env: dict, first: str) -> tuple:
    """A `python -m arroyo_tpu_torch` daemon subprocess (node or
    compile-service): waits for its first stderr line, which must start with
    ``first``, then drains the rest in a thread. Returns (proc, that line,
    the drained lines)."""
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                            stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    line = proc.stderr.readline()
    if not line.startswith(first):
        proc.kill()
        rest = proc.stderr.read()
        raise AssertionError(f"{cmd[3:5]}: first line {line!r}, then {rest[-3000:]}")
    tail: list = []

    def drain():
        for ln in proc.stderr:
            tail.append(ln)
            del tail[:-200]

    threading.Thread(target=drain, daemon=True).start()
    return proc, line, tail


def stop_daemon(proc, tail: list, what: str) -> int:
    """SIGINT (the daemons' clean stop: the node kills its workers), then a
    kill after 30 s. Returns the exit code."""
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
            raise AssertionError(f"{what} ignored SIGINT: {''.join(tail)[-2000:]}")
    return proc.returncode


def timed_node_handle():
    """The port's NodeWorkerHandle, stamping the placement call (spawn) and
    the worker's first "started" event as the controller polls it."""
    from arroyo_tpu_torch.controller import scheduler

    class TimedNodeHandle(scheduler.NodeWorkerHandle):
        spawned: list = []

        def __init__(self, *a, **kw):
            self.t_spawn, self.t_started = time.perf_counter(), None
            super().__init__(*a, **kw)
            get, handle = self._get, self

            def stamped(url, *ga, **gk):
                r = get(url, *ga, **gk)
                if handle.t_started is None and any(
                        e.get("event") == "started" for e in r.get("events", ())):
                    handle.t_started = time.perf_counter()
                return r

            self._get = stamped
            TimedNodeHandle.spawned.append(self)

    return scheduler, TimedNodeHandle


def deploy_node_run(name: str, sql: str, want: dict, api_base: str, db, node_addr: str,
                    counts_path: str, out: str, need_k4: bool = True) -> dict:
    """SQL ``name`` POSTed to the REST API and run by the controller's node
    scheduler over the node daemon's two worker processes (each under
    COUNTING_MAIN, no device setting: the card). Exact against ``want``;
    each worker launches K1 and K2, and K4 (one Triton launch a call) where
    ``need_k4``, and holds a CUDA context while the job runs; the node is live at GET
    /api/v1/nodes and its slots are free after Finished."""
    from arroyo_tpu_torch.controller.node import _get

    scheduler, handle_cls = timed_node_handle()
    orig = scheduler.NodeWorkerHandle
    scheduler.NodeWorkerHandle = handle_cls
    handle_cls.spawned = []
    before = set(counted_launches(counts_path))
    baseline = gpu_compute_apps()
    most: list = []
    try:
        with epoch_clock() as clock:
            t0 = time.perf_counter()
            created = http_json("POST", f"{api_base}/api/v1/pipelines",
                                {"name": f"deploy-{name}", "query": sql, "parallelism": 2})
            jid = created["job_id"]
            deadline = time.monotonic() + 600
            while time.monotonic() < deadline:
                state = db.get_job(jid)["state"]
                if state == "Running" and len(most) < len(baseline) + CLUSTER_WORKERS:
                    apps = gpu_compute_apps()
                    if len(apps) > len(most):
                        most = apps
                if state in ("Finished", "Failed", "Stopped"):
                    break
                time.sleep(0.05)
            wall = time.perf_counter() - t0
        job = db.get_job(jid)
        if job["state"] != "Finished":
            raise AssertionError(f"deploy node {name}: {job['state']}: "
                                 f"{job.get('failure_message')}")
        n_rows = check_sql_rows(name, sink_lines(out), want)
        nodes = _get(f"{api_base}/api/v1/nodes")["nodes"]
        live = [n for n in nodes if time.time() - float(n["last_heartbeat"]) < 10.0]
        if len(live) != 1:
            raise AssertionError(f"deploy node {name}: nodes {nodes}")
        status = wait_for(lambda: (lambda st: st if st["used"] == 0 else None)(
            _get(f"{node_addr}/status")), 60, f"deploy node {name}: the node's slots free")
        handles = handle_cls.spawned
        if len(handles) != CLUSTER_WORKERS:
            raise AssertionError(f"deploy node {name}: {len(handles)} placements")
        counts = {p: c for p, c in wait_for(
            lambda: (lambda c: c if len(set(c) - before) >= CLUSTER_WORKERS else None)(
                counted_launches(counts_path)), 60,
            f"deploy node {name}: the workers' launch counts").items() if p not in before}
        path = [k for k in AGG_PATH_KERNELS if need_k4 or k != "segment_fused"]
        launches = check_worker_launches(f"deploy node {name}", counts, sorted(counts), path)
        for p, c in counts.items():
            launches[str(p)]["segment_fused"] = c["segment_fused"]
            check_k4_one_launch(f"deploy node {name} worker {p}", c)
        events = db.list_events(jid, limit=100_000)
        segs = {code: sorted({f"{e['node']}/{e['subtask']}" for e in events
                              if e["code"] == code})
                for code in ("SEGMENT_COMPILED", "SEGMENT_FALLBACK")}
        info = {"events": DEPLOY_EVENTS, "rows": n_rows, "wall_s": wall,
                "events_per_s": DEPLOY_EVENTS / wall,
                "post_to_running_ms": (db.first(jid, "Running", t0) - t0) * 1e3,
                "post_to_finished_s": db.first(jid, "Finished", t0) - t0,
                "spawn_to_started_s": [None if h.t_started is None else h.t_started - h.t_spawn
                                       for h in handles],
                "states": db.states(jid), "node": {"id": live[0]["id"],
                                                   "slots": live[0]["slots"],
                                                   "status_after": status},
                "launches_by_worker": launches, "segments": segs,
                "segment_fallback_messages": [e["message"] for e in events
                                              if e["code"] == "SEGMENT_FALLBACK"][:4],
                "compute_apps": {"before": baseline, "while_running": most},
                "workers_on_gpu": len(most) >= len(baseline) + CLUSTER_WORKERS}
        complete = [c["epoch"] for c in db.list_checkpoints(jid) if c["state"] == "complete"]
        info["checkpoints_complete"] = complete
        if complete:
            info["barrier_to_complete_ms"] = epoch_durable_ms(clock, jid, complete)
        if not info["workers_on_gpu"]:
            raise AssertionError(f"deploy node {name}: nvidia-smi never listed both workers "
                                 f"as compute apps: {info['compute_apps']}")
        return info
    finally:
        scheduler.NodeWorkerHandle = orig


def wait_for(pred, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.1)
    raise AssertionError(f"timed out: {what}")


def deploy_cluster(root: str) -> dict:
    """(a) and (b): the node daemon and the compile service as subprocesses,
    the API and the controller (node scheduler) in this process."""
    from arroyo_tpu_torch.api import ApiServer
    from arroyo_tpu_torch.controller import ControllerServer
    from arroyo_tpu_torch.controller.scheduler import NodeScheduler
    from arroyo_tpu_torch.udf import drop_udf, lookup_udf

    env_extra = cluster_config(interval_ms=CLUSTER_CKPT_MS)
    env = {k: v for k, v in os.environ.items() if not k.startswith("ARROYO_TPU_TORCH__")}
    env.update(env_extra)  # sizes and storage; no device setting: the card
    counts_path = os.path.join(root, "node-launches")
    db = timed_database()
    api = ApiServer(db, port=0).start()
    api_base = f"http://127.0.0.1:{api.port}"
    ctl = ControllerServer(db, NodeScheduler(db)).start()
    node = svc = None
    node_tail = svc_tail = []
    out: dict = {}
    try:
        t0 = time.perf_counter()
        node, line, node_tail = start_daemon(
            [sys.executable, "-c", NODE_MAIN, counts_path, COUNTING_MAIN, "node",
             "--controller", api_base, "--slots", str(DEPLOY_NODE_SLOTS), "--host", "127.0.0.1"],
            env, "node ")
        out["node_start_s"] = time.perf_counter() - t0
        node_addr = f"http://127.0.0.1:{int(line.split(':')[1].split()[0])}"
        log("deploy: (a) node q7")
        q7_out = os.path.join(root, "node-q7.json")
        out["node_q7"] = deploy_node_run("q7", nexmark_sql("q7", DEPLOY_EVENTS, q7_out),
                                         oracle_sql("q7", DEPLOY_EVENTS), api_base, db,
                                         node_addr, counts_path, q7_out)
        log("deploy: (b) compile service, cpp UDF")
        t0 = time.perf_counter()
        svc, line, svc_tail = start_daemon(
            [sys.executable, "-m", "arroyo_tpu_torch", "compile-service", "--host", "127.0.0.1",
             "--port", "0", "--artifacts-url", os.path.join(root, "udf-artifacts")],
            env, "compile service on :")
        endpoint = f"http://127.0.0.1:{int(line.split(':')[1].split()[0])}"
        tcfg.update({"compiler.endpoint": endpoint})
        t1 = time.perf_counter()
        created = http_json("POST", f"{api_base}/api/v1/udfs", {
            "name": "dollars_to_euros", "language": "cpp", "source": CPP_DOLLARS_TO_EUROS,
            "arg_dtypes": ["int64"], "return_dtype": "int64"})
        udf_ms = (time.perf_counter() - t1) * 1e3
        artifact = created.get("artifact_url") or ""
        if not artifact.startswith(os.path.join(root, "udf-artifacts")):
            raise AssertionError(f"deploy: the cpp UDF's artifact {created}")
        fn = lookup_udf("dollars_to_euros").fn
        probe_prices = np.array([0, 1, 999, 1000, 123_456_789], dtype=np.int64)
        if fn(probe_prices).tolist() != (probe_prices * 908 // 1000).tolist():
            raise AssertionError("deploy: dollars_to_euros gives the wrong values here")
        e_out = os.path.join(root, "node-q7e.json")
        sql = SQL_NEXMARK_SOURCE.format(events=DEPLOY_EVENTS,
                                        inter_event=SQL_INTER_EVENT["q7"]) + SQL_Q7_EUROS.format(
            out=e_out)
        out["udf"] = {"compile_service_start_s": t1 - t0, "create_ms": udf_ms,
                      "artifact": os.path.basename(artifact),
                      **deploy_node_run("q7e", sql, oracle_q7_euros(DEPLOY_EVENTS), api_base, db,
                                        node_addr, counts_path, e_out, need_k4=False)}
        drop_udf("dollars_to_euros")
    finally:
        tcfg.update({"compiler.endpoint": None})
        ctl.stop()
        rcs = {}
        if svc is not None:
            rcs["compile_service"] = stop_daemon(svc, svc_tail, "compile-service")
        if node is not None:
            rcs["node"] = stop_daemon(node, node_tail, "node")
        api.stop()
    out["daemon_exit_codes"] = rcs
    if any(rcs.values()):
        raise AssertionError(f"deploy: daemons exited {rcs}: node {''.join(node_tail)[-1500:]} "
                             f"compile service {''.join(svc_tail)[-1500:]}")
    return out


def bids_columns(event_count: int) -> dict:
    """The bids of the port's generator at bench.py's q7 setting: auction,
    price and the event time (micros)."""
    b = NexmarkSource({"event_count": event_count, "inter_event_micros": 1000,
                       "first_event_micros": 0, "include_strings": False,
                       "columns": ["bid.auction", "bid.price"]})._generate(
        np.arange(event_count, dtype=np.int64))
    bid = b["bid"]
    return {"auction": b["bid.auction"][bid], "price": b["bid.price"][bid],
            "ts": b[TIMESTAMP_FIELD][bid]}


def write_bid_files(root: str) -> dict:
    """q7's bids as JSON lines (DEPLOY_EVENTS, DEPLOY_JSON_FILES files) and
    as one Avro OCF with the deflate codec (DEPLOY_AVRO_EVENTS). Returns
    each set's directory, rows, files and write seconds."""
    from arroyo_tpu_torch.formats import avro_fmt

    out = {}
    t0 = time.perf_counter()
    cols = bids_columns(DEPLOY_EVENTS)
    jdir = os.path.join(root, "bids-json")
    os.makedirs(jdir)
    n = len(cols["auction"])
    bounds = np.linspace(0, n, DEPLOY_JSON_FILES + 1).astype(np.int64)
    for i in range(DEPLOY_JSON_FILES):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        with open(os.path.join(jdir, f"bids-{i:02d}.json"), "w") as f:
            f.write("".join(f'{{"auction":{a},"price":{p},"ts":{t}}}\n' for a, p, t in zip(
                cols["auction"][lo:hi].tolist(), cols["price"][lo:hi].tolist(),
                cols["ts"][lo:hi].tolist())))
    out["json"] = {"dir": jdir, "events": DEPLOY_EVENTS, "rows": n, "files": DEPLOY_JSON_FILES,
                   "batches": int(sum(-(-int(bounds[i + 1] - bounds[i]) // BENCH_BATCH)
                                      for i in range(DEPLOY_JSON_FILES))),
                   "write_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    a = bids_columns(DEPLOY_AVRO_EVENTS)
    adir = os.path.join(root, "bids-avro")
    os.makedirs(adir)
    schema = avro_fmt.AvroSchema(json.dumps(AVRO_BIDS))
    rows = [{"auction": x, "price": y, "ts": z} for x, y, z in zip(
        a["auction"].tolist(), a["price"].tolist(), a["ts"].tolist())]
    with open(os.path.join(adir, "bids.avro"), "wb") as f:
        f.write(avro_fmt.write_ocf(schema, rows, codec="deflate"))
    out["avro"] = {"dir": adir, "events": DEPLOY_AVRO_EVENTS, "rows": len(rows), "files": 1,
                   "batches": -(-len(rows) // BENCH_BATCH), "write_s": time.perf_counter() - t0}
    return out


def committed_rows(out_dir: str) -> tuple:
    """The sink's committed part files, read back as JSON lines: (lines,
    files, stray temporary files)."""
    lines, files, tmp = [], [], []
    for r, _d, fs in os.walk(out_dir):
        for f in sorted(fs):
            p = os.path.join(r, f)
            if f.endswith(".tmp"):
                tmp.append(p)
                continue
            files.append(os.path.relpath(p, out_dir))
            with open(p) as fh:
                lines += [ln for ln in fh.read().splitlines() if ln.strip()]
    return lines, sorted(files), tmp


def files_graph(src: str, fmt: str, out: str, out_fmt: str = "json"):
    """SQL q7 over a filesystem source of the bids into a filesystem sink
    partitioned by ``shard`` (auction % 4): the plan's sink takes the
    partition field as a list, as the Python API gives it."""
    from arroyo_tpu_torch.sql import plan_query

    g = plan_query(SQL_Q7_FILES.format(src=src, fmt=fmt, out=out, out_fmt=out_fmt)).graph
    sink = next(n for n in g.nodes.values() if n.op.value == "sink")
    sink.config["partition_fields"] = ["shard"]
    return g


def files_crash_restore(src: dict, fmt: str, root: str, s3) -> dict:
    """q7 over ``src``'s files into the partitioned JSON sink, checkpoints
    to an s3:// URL in ``s3``: the source held at half its batches for
    epoch 1 and at three quarters for epoch 2, whose barrier crashes the
    window (worker:crash@barrier=2); a fresh engine restores epoch 1 from
    the store and finishes. The committed files hold the oracle's rows,
    none twice, and no partial file."""
    from arroyo_tpu_torch.state.tables import (latest_complete_checkpoint,
                                               read_job_checkpoint_metadata)

    url = "s3://chip-smoke/checkpoints"
    job = f"deploy-files-{fmt}"
    out = os.path.join(root, f"out-{fmt}")
    want = oracle_sql("q7", src["events"])
    nb = src["batches"]
    parts_before = s3.multipart_completed
    reset_all_launch_counts()
    t0 = time.perf_counter()
    eng = Engine(files_graph(src["dir"], fmt, out), job_id=job, storage_url=url)
    eng.build()
    node = next(n for n in eng.graph.nodes if "tumbling" in n)
    faults.install(f"worker:crash@barrier=2&node={node}&subtask=0")
    try:
        crash_at_last_barrier(eng, (nb // 2 + 1, nb * 3 // 4 + 1))
    finally:
        faults.clear()
    first_s = time.perf_counter() - t0
    if read_job_checkpoint_metadata(url, job, 1) is None \
            or read_job_checkpoint_metadata(url, job, 2) is not None \
            or latest_complete_checkpoint(url, job) != 1:
        raise AssertionError(f"deploy files {fmt}: epoch 1 incomplete or epoch 2 complete")
    committed_after_crash = committed_rows(out)[1]
    t1 = time.perf_counter()
    eng2 = Engine(files_graph(src["dir"], fmt, out), job_id=job, storage_url=url,
                  restore_epoch=1)
    eng2.run_to_completion(timeout=900)
    restored_s = time.perf_counter() - t1
    launches = all_launch_counts()
    lines, files, tmp = committed_rows(out)
    if tmp:
        raise AssertionError(f"deploy files {fmt}: partial files left {tmp}")
    n_rows = check_sql_rows("q7", lines, want)
    shards = sorted({f.split(os.sep)[0] for f in files})
    if shards != [f"shard={i}" for i in range(4)]:
        raise AssertionError(f"deploy files {fmt}: partitions {shards}")
    unlaunched = [k for k in AGG_PATH_KERNELS if launches[k] == 0]
    if unlaunched:
        raise AssertionError(f"deploy files {fmt} launched no {unlaunched}: {launches}")
    objects = [k for b, k in s3.objects if k.startswith(f"checkpoints/{job}/")]
    return {"events": src["events"], "rows_in": src["rows"], "rows_out": n_rows,
            "files_in": src["files"], "files_committed": len(files),
            "files_committed_before_crash": len(committed_after_crash),
            "first_run_s": first_s, "restored_run_s": restored_s,
            "events_per_s": src["events"] * 1.25 / (first_s + restored_s),
            "s3_objects": len(objects), "multipart_uploads": s3.multipart_completed - parts_before,
            "launches": {k: launches[k] for k in AGG_PATH_KERNELS}}


def parquet_sink_case(src: dict, root: str) -> dict:
    """A parquet filesystem sink: where pyarrow is missing it fails the job
    with the JAX package's message (pyarrow is imported where the part file
    is written); where present, its files hold the oracle's rows."""
    from arroyo_tpu_torch.state.tables import _parquet_available

    out = os.path.join(root, "out-parquet")
    g = files_graph(src["dir"], "avro", out, out_fmt="parquet")
    if not _parquet_available():
        try:
            Engine(g, job_id="deploy-parquet").run_to_completion(timeout=300)
        except Exception as e:  # noqa: BLE001 - the job's failure is the expected outcome
            msg = str(e)
            if "ModuleNotFoundError" not in msg or "pyarrow" not in msg:
                raise
            return {"pyarrow": False, "failed_with": msg.strip().splitlines()[-1][:200]}
        raise AssertionError("deploy: a parquet sink ran without pyarrow")
    import pyarrow.parquet as pq

    Engine(g, job_id="deploy-parquet").run_to_completion(timeout=300)
    rows = []
    for r, _d, fs in os.walk(out):
        for f in fs:
            rows += pq.ParquetFile(os.path.join(r, f)).read().to_pylist()
    from arroyo_tpu_torch.formats.json_fmt import format_iso_micros

    lines = [json.dumps({**r, "start": r["start"] if isinstance(r["start"], str)
                         else format_iso_micros(int(r["start"]))}) for r in rows]
    return {"pyarrow": True, "rows": check_sql_rows("q7", lines,
                                                    oracle_sql("q7", src["events"]))}


def deploy_files(root: str) -> dict:
    """(c): the bids as JSON-lines and Avro files, SQL q7 over each through a
    filesystem source into a partitioned exactly-once filesystem sink,
    checkpoints in an in-process S3 store with multipart, a crash after
    epoch 1 restored from the store; then a parquet sink."""
    from arroyo_tpu_torch.state import storage

    bench_config(chaining=True)
    tcfg.update({"storage.multipart-threshold-bytes": DEPLOY_MULTIPART_BYTES,
                 "storage.multipart-part-size-bytes": DEPLOY_MULTIPART_BYTES})
    s3 = MemoryS3()
    storage.set_s3_client(s3)
    try:
        log("deploy: (c) writing the bid files")
        srcs = write_bid_files(root)
        out = {"written": {k: {kk: vv for kk, vv in v.items() if kk != "dir"}
                           for k, v in srcs.items()}}
        for fmt in ("json", "avro"):
            log(f"deploy: (c) q7 over {fmt} files, crash and restore from s3://")
            out[fmt] = files_crash_restore(srcs[fmt], fmt, root, s3)
        log("deploy: (c) parquet sink")
        out["parquet_sink"] = parquet_sink_case(srcs["avro"], root)
    finally:
        storage.set_s3_client(None)
        tcfg.reset()
    return out


def deploy_phase(card: str, res: dict) -> dict:
    """Deployment on the card: (a) the node daemon, (b) a native C++ UDF
    through the compile service, (c) files and an object store."""
    root = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    t0 = time.perf_counter()
    try:
        cluster = deploy_cluster(root)
        files = deploy_files(root)
    finally:
        tcfg.reset()
        shutil.rmtree(root, ignore_errors=True)
    proc = ((res.get("cluster") or {}).get("process") or {})
    info = {"phase": "deploy", "card": card, "seconds": time.perf_counter() - t0,
            **cluster, "files": files,
            "cluster_process_q7_events_per_s": proc.get("events_per_s")}
    emit(info)
    a, b = cluster["node_q7"], cluster["udf"]
    print(f"deploy: {info['seconds']:.1f} s; node q7 {a['events_per_s']:.0f} events/s (process "
          f"q7 of this call: {info['cluster_process_q7_events_per_s']}), POST to Running "
          f"{a['post_to_running_ms']:.1f} ms, spawn to started {a['spawn_to_started_s']} s, "
          f"POST to Finished {a['post_to_finished_s']:.3f} s, launches {a['launches_by_worker']}, "
          f"SEGMENT_COMPILED {a['segments']['SEGMENT_COMPILED']}; udf q7 "
          f"{b['events_per_s']:.0f} events/s, create {b['create_ms']:.1f} ms, POST to Running "
          f"{b['post_to_running_ms']:.1f} ms, POST to Finished {b['post_to_finished_s']:.3f} s, "
          f"launches {b['launches_by_worker']}, segments {b['segments']}, fallback "
          f"{b['segment_fallback_messages']}; files json {files['json']['events_per_s']:.0f} "
          f"events/s (first {files['json']['first_run_s']:.2f} s, restored "
          f"{files['json']['restored_run_s']:.2f} s, {files['json']['multipart_uploads']} "
          f"multipart puts), avro {files['avro']['events_per_s']:.0f} events/s, parquet sink "
          f"{files['parquet_sink']} [{card}]", flush=True)
    return info


# ---------------------------------------------------------------- connectors

# SQL Nexmark q7 with its bids arriving over a NATS broker of this script's
# own (one JSON message each, as the deploy phase writes them to files) and
# its rows leaving through the webhook sink to this script's own http.server.
# The broker and the receiver are stand-ins with no network, as MemoryS3 is
# for the object store.
# a quarter of bench.py's q7 size: a cut of depth for the whole run's time
# limit (the phase's host-bound run took 88 s at 2,000,000 events late in a
# whole run, and 55 s at 1,000,000 on a slow host with the analysis phase)
CONNECTORS_EVENTS = Q7_EVENTS // 4
NATS_SUBJECT = "bids"
NATS_CHUNK_MESSAGES = 16384  # messages a sendall
NATS_DRAIN_S = 60  # the longest the broker waits for the client to close
SQL_Q7_NATS = """CREATE TABLE bids (auction BIGINT, price BIGINT, ts TIMESTAMP)
WITH (connector = 'nats', servers = 'nats://127.0.0.1:{port}', subject = '{subject}',
      format = 'json', type = 'source', event_time_field = 'ts');
CREATE TABLE q7n_out (start TIMESTAMP, auction BIGINT, max_price BIGINT, bids BIGINT)
WITH (connector = 'webhook', endpoint = '{endpoint}', format = 'json', type = 'sink');
INSERT INTO q7n_out
SELECT window.start AS start, auction, max_price, bids FROM (
  SELECT tumble(interval '10 seconds') AS window, auction, max(price) AS max_price,
    count(*) AS bids
  FROM bids GROUP BY window, auction) x;
"""


def nats_bid_chunks(cols: dict, subject: str, sid: str) -> list:
    """The bids as core-NATS MSG frames for subscription ``sid``, cut into
    chunks of NATS_CHUNK_MESSAGES whole messages: [(bytes, messages)]."""
    payloads = [f'{{"auction":{a},"price":{p},"ts":{t}}}' for a, p, t in zip(
        cols["auction"].tolist(), cols["price"].tolist(), cols["ts"].tolist())]
    head = f"MSG {subject} {sid} "
    chunks = []
    for lo in range(0, len(payloads), NATS_CHUNK_MESSAGES):
        part = payloads[lo:lo + NATS_CHUNK_MESSAGES]
        chunks.append(("".join(f"{head}{len(p)}\r\n{p}\r\n" for p in part).encode(), len(part)))
    return chunks


class ChipNats(threading.Thread):
    """A minimal in-process core-NATS server for one subscriber: INFO,
    CONNECT, PING/PONG, SUB, PUB and MSG. Once a SUB on its subject arrives
    (and not before), it writes the prepared MSG chunks with one sendall
    each, counting the messages, then ends its side of the connection: the
    source reads every message, ends gracefully and every window closes. A
    PUB is counted and dropped. Whatever goes wrong is kept in ``error`` for
    the caller to raise."""

    INFO = b'INFO {"server_id":"chip-smoke","version":"2.10.0","max_payload":1048576}\r\n'

    def __init__(self, subject: str, chunks: list, sid: str = "1"):
        super().__init__(daemon=True, name="chip-nats")
        self.srv = socket.create_server(("127.0.0.1", 0))
        self.port = self.srv.getsockname()[1]
        self.subject, self.sid, self.chunks = subject, sid, chunks
        self.messages = sum(n for _b, n in chunks)
        self.delivered = 0
        self.published = 0
        self.subscribed_at = None
        self.closed_at = None
        self.drained_at = None
        self.error = None

    def run(self):
        try:
            conn, _ = self.srv.accept()
        except OSError:
            return  # closed before any client came
        try:
            with conn:
                self._serve(conn)
        except Exception as e:  # noqa: BLE001 - the caller raises it
            self.error = f"{type(e).__name__}: {e}"

    def _serve(self, conn):
        conn.sendall(self.INFO)
        buf = b""
        while self.subscribed_at is None:
            while b"\r\n" not in buf:
                chunk = conn.recv(65536)
                if not chunk:
                    raise ConnectionError("the subscriber left before its SUB")
                buf += chunk
            line, buf = buf.split(b"\r\n", 1)
            if line == b"PING":
                conn.sendall(b"PONG\r\n")
            elif line.startswith(b"SUB "):
                parts = line.decode().split(" ")
                if parts[1] != self.subject or parts[-1] != self.sid:
                    raise ValueError(f"SUB {parts[1:]}: the frames are for subject "
                                     f"{self.subject!r}, sid {self.sid!r}")
                self.subscribed_at = time.perf_counter()
            elif line.startswith(b"PUB "):
                n = int(line.split(b" ")[-1])
                while len(buf) < n + 2:
                    buf += conn.recv(65536)
                buf = buf[n + 2:]
                self.published += 1
            elif not line.startswith((b"CONNECT ", b"PONG", b"UNSUB ")):
                raise ValueError(f"unexpected client op {line[:64]!r}")
        for data, n in self.chunks:
            conn.sendall(data)
            self.delivered += n
        self.closed_at = time.perf_counter()
        # FIN after the last message; then read what the client still sends
        # (its keepalive PINGs) until it closes: a socket closed with unread
        # bytes sends a reset, which can discard the client's unread tail
        conn.shutdown(socket.SHUT_WR)
        conn.settimeout(NATS_DRAIN_S)
        while conn.recv(65536):
            pass
        self.drained_at = time.perf_counter()

    def close(self):
        self.srv.close()


# The webhook's receiving end: http.server in a process of its own (its
# request handling would otherwise take the interpreter lock from the
# pipeline's threads), writing each body as a line of the file it is given
# (JSON holds no raw newline) and, when its standard input closes, the count
# of POSTs on its standard output.
WEBHOOK_MAIN = r"""
import sys, threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

out = open(sys.argv[1], "wb", buffering=1 << 20)
lock = threading.Lock()
posts = 0


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True  # each response goes out as it is written

    def log_message(self, *a):
        pass

    def do_POST(self):
        global posts
        body = self.rfile.read(int(self.headers["Content-Length"]))
        with lock:
            out.write(body + b"\n")
            posts += 1
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()


srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
srv.daemon_threads = True
print(srv.server_address[1], flush=True)


def stop():
    sys.stdin.read()
    srv.shutdown()


threading.Thread(target=stop, daemon=True).start()
srv.serve_forever()
with lock:
    out.close()
    print(posts, flush=True)
"""


class WebhookReceiver:
    """This script's own http.server (WEBHOOK_MAIN, HTTP/1.1, kept-alive
    connections, pipelined requests answered in order, TCP_NODELAY) in a
    process of its own: it keeps the body of every POST, answering 200.
    ``close()`` stops it and returns the bodies, as text lines."""

    def __init__(self, root: str):
        self.path = os.path.join(root, "webhook-bodies")
        self.proc = subprocess.Popen([sys.executable, "-c", WEBHOOK_MAIN, self.path],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        self.endpoint = f"http://127.0.0.1:{int(self.proc.stdout.readline())}/q7"

    def close(self) -> list:
        self.proc.stdin.close()
        try:
            posts = int(self.proc.stdout.readline() or -1)
            self.proc.wait(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        with open(self.path) as f:
            lines = f.read().splitlines()
        if posts != len(lines) or self.proc.returncode != 0:
            raise AssertionError(f"webhook receiver: {posts} POSTs, {len(lines)} bodies, "
                                 f"exit {self.proc.returncode}")
        return lines


def nats_q7_run(events: int, job: str, device=None, trace=None) -> dict:
    """SQL q7 over ChipNats into the webhook sink, planned by the port's
    plan_query, chaining on, batch 65536, parallelism 1 (bench_config):
    the bids' frames are made first (set-up), then the job runs (under
    ``trace(run, warm)`` where given). Returns the run's wall, the engine,
    the launch counts read just after it, the webhook's lines and the
    broker's counts; the caller checks them."""
    from arroyo_tpu_torch.sql import plan_query

    t0 = time.perf_counter()
    chunks = nats_bid_chunks(bids_columns(events), NATS_SUBJECT, "1")
    setup_s = time.perf_counter() - t0
    root = tempfile.mkdtemp(prefix="chip_smoke_connectors_")
    broker = ChipNats(NATS_SUBJECT, chunks)
    hook = WebhookReceiver(root)
    broker.start()
    lines = None
    try:
        bench_config(chaining=True)
        g = plan_query(SQL_Q7_NATS.format(port=broker.port, subject=NATS_SUBJECT,
                                          endpoint=hook.endpoint)).graph
        recorder.clear_job(job)
        ran = {}

        def run():
            reset_all_launch_counts()
            t0 = time.perf_counter()
            ran["eng"] = run_graph(g, job_id=job, timeout=900,
                                   **({} if device is None else {"device": device}))
            if ran["eng"].device.type == "cuda":
                torch.cuda.synchronize()
            ran["wall"] = time.perf_counter() - t0
            ran["launches"] = all_launch_counts()

        prof = run() if trace is None else trace(run, warm_device)
        broker.join(timeout=NATS_DRAIN_S)
    finally:
        broker.close()
        try:
            lines = hook.close()
        finally:
            shutil.rmtree(root, ignore_errors=True)
    if broker.error is not None or broker.delivered != broker.messages:
        raise AssertionError(f"{job}: the broker delivered {broker.delivered} of "
                             f"{broker.messages} messages (error: {broker.error})")
    return {**ran, "prof": prof, "setup_s": setup_s, "messages": broker.messages,
            "delivered": broker.delivered, "published": broker.published,
            "lines": lines,
            "stream_s": (None if broker.closed_at is None
                         else broker.closed_at - broker.subscribed_at),
            "drain_s": (None if broker.drained_at is None
                        else broker.drained_at - broker.closed_at)}


def connectors_phase(card: str) -> dict:
    """The network connectors on the card: SQL q7 over a NATS broker into a
    webhook at CONNECTORS_EVENTS. Exact: the webhook's rows equal
    oracle_q7, none missing, none twice; every message delivered; the run
    on the GPU, its chain compiled with no fallback; K4, K1 and K2 (its
    read-and-clear mode) launched, counts zeroed just before the run and
    read just after, K4 one Triton launch a call. One run, under the
    CUDA-activity trace that gives the device's idle share."""
    events = CONNECTORS_EVENTS
    want = oracle_q7(events)
    job = "chip-smoke-connectors-q7"
    r = nats_q7_run(events, job, trace=device_trace)
    eng, wall, launches = r["eng"], r["wall"], r["launches"]
    if eng.device.type != "cuda":
        raise RuntimeError(f"{job} ran on {eng.device}, not on the GPU")
    n_rows = check_sql_rows("q7", r["lines"], want)
    compiled, fallbacks = check_sql_path("connectors", job, eng, launches, AGG_PATH_KERNELS)
    by_name = device_us_by_name(r["prof"])
    busy_s = sum(by_name.values()) / 1e6 if by_name else None  # None: not measured
    info = {"phase": "connectors", "card": card, "events": events,
            "messages": r["messages"], "delivered": r["delivered"], "rows": n_rows,
            "webhook_posts": len(r["lines"]), "setup_s": r["setup_s"], "wall_s": wall,
            "events_per_s": events / wall, "stream_s": r["stream_s"], "drain_s": r["drain_s"],
            "chains": [n for n in eng.graph.nodes if "+" in n],
            "segment_compiled": len(compiled), "segment_fallback": len(fallbacks),
            "launches": {k: launches[k] for k in AGG_PATH_KERNELS},
            "k4_triton_launches": launches["segment_fused_kernels"],
            "device_busy_s": busy_s,
            "device_idle_share": None if busy_s is None else 1.0 - busy_s / wall}
    emit(info)
    print(f"connectors: SQL q7 over NATS into a webhook, {events} events, {r['messages']} "
          f"messages delivered, {n_rows} rows posted, run {wall:.3f} s, "
          f"{info['events_per_s']:.0f} events/s, idle {info['device_idle_share']}, launches "
          f"{info['launches']} [{card}]", flush=True)
    return info


# ---------------------------------------------------------------- analysis

# `python -m arroyo_tpu_torch check --json` on these SQL texts: its exit code
# and exactly these diagnostics (tests/test_torch_analysis.py holds this copy
# to both packages' check_sql, since the card has no JAX). q5_unaligned is
# q5 with a 3 s slide, which does not divide its 10 s width.
ANALYSIS_CHECKS = {
    "q7": (0, []),
    "q5": (0, []),
    "q8": (0, []),
    "q5_unaligned": (1, [{
        "rule": "AR002", "severity": "error", "site": "agg_4_sliding_aggregate",
        "message": "hop(slide=3s, width=10s) is unaligned: the slide must be a positive "
                   "divisor of the width",
        "hint": "use a width that is a multiple of the slide, e.g. hop(interval '3 "
                "seconds', interval '9 seconds')"}]),
}
# the witness's q7 over two embedded workers, and the same under the
# lock_contend plan: half bench.py's q7, a cut of depth for the phase's time
ANALYSIS_EVENTS = Q7_EVENTS // 2
CONTEND_PLAN = "lock_contend:delay=1@match=TaskInbox"
# locks the witness's run must take: the inboxes and the coalescing sends
ANALYSIS_LOCKS = ("TaskInbox._lock", "_SendBuffer._lock", "NetworkManager._out_lock")


def analysis_sql(name: str, out: str) -> str:
    if name == "q5_unaligned":
        return nexmark_sql("q5", Q5_EVENTS, out).replace("hop(interval '2 seconds'",
                                                          "hop(interval '3 seconds'")
    return nexmark_sql(name, SQL_EVENTS[name], out)


def analysis_cli_start(root: str) -> dict:
    """`python -m arroyo_tpu_torch lint` over the package and `check --json`
    on each ANALYSIS_CHECKS text, as subprocesses (CPU work, run beside the
    witness's q7)."""
    here = os.path.dirname(os.path.abspath(__file__))
    cli = [sys.executable, "-m", "arroyo_tpu_torch"]
    runs = {"lint": cli + ["lint"]}
    for name in ANALYSIS_CHECKS:
        path = os.path.join(root, f"{name}.sql")
        with open(path, "w") as f:
            f.write(analysis_sql(name, os.path.join(root, f"{name}.json")))
        runs[name] = cli + ["check", "--json", path]
    return {name: (time.perf_counter(),
                   subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
            for name, cmd in runs.items()}


def analysis_cli_finish(procs: dict, timeout: float = 300.0) -> dict:
    """Each subprocess's exit code and seconds, held to lint's 0 and to the
    pinned checks (the caller kills any still running)."""
    out = {}
    for name, (t0, p) in procs.items():
        stdout, stderr = p.communicate(timeout=timeout)
        secs = time.perf_counter() - t0
        if name == "lint":
            if p.returncode != 0 or "lint clean" not in stdout:
                raise AssertionError(f"analysis: lint exited {p.returncode}:\n{stdout}"
                                     f"{stderr[-2000:]}")
            out[name] = {"rc": p.returncode, "s": secs}
            continue
        rc, diags = ANALYSIS_CHECKS[name]
        try:
            got = json.loads(stdout)
        except ValueError as e:
            raise AssertionError(f"analysis: check {name} printed no JSON ({e}): "
                                 f"{stdout[-500:]}{stderr[-2000:]}") from e
        if p.returncode != rc or got != diags:
            raise AssertionError(f"analysis: check {name} exited {p.returncode} with "
                                 f"{got}, want {rc} with {diags}")
        out[name] = {"rc": p.returncode, "diagnostics": len(got), "s": secs}
    return out


def witness_q7(events: int, root: str, job: str, plan: str = None, device=None) -> dict:
    """SQL q7 (parallelism 2) run by ControllerServer(EmbeddedScheduler)
    over two engines in this process joined by the data plane, bench.py's
    sizes, exact against oracle_sql. With ``plan`` None the lock-order
    witness is on from before the controller is built: its edges must lie
    in the static LR402 graph over the package and its locks include
    ANALYSIS_LOCKS; else the fault plan is installed instead (every lock
    it names instrumented) and must have fired. On the card K4, K1 and K2
    launch (counts zeroed just before the job, read just after)."""
    from arroyo_tpu_torch.analysis import static_lock_graph_package
    from arroyo_tpu_torch.controller import ControllerServer, Database
    from arroyo_tpu_torch.controller.scheduler import EmbeddedScheduler
    from arroyo_tpu_torch.obs import lockorder

    cluster_config({} if device is None else {"device.torch-device": str(device)})
    out = os.path.join(root, f"{job}.json")
    want = oracle_sql("q7", events)
    if plan is None:
        lockorder.enable(reset=True)
    else:
        inj = faults.install(plan)
    try:
        db = Database()
        ctl = ControllerServer(db, EmbeddedScheduler()).start()
        try:
            reset_all_launch_counts()
            t0 = time.perf_counter()
            jid = db.create_job(db.create_pipeline(job, nexmark_sql("q7", events, out), 2))
            state = ctl.wait_for_state(jid, "Finished", "Failed", timeout=600)
            wall = time.perf_counter() - t0
            launches = all_launch_counts()
        finally:
            ctl.stop()
        if state != "Finished":
            raise AssertionError(f"{job}: {state}: {db.get_job(jid).get('failure_message')}")
        edges, taken = lockorder.edges(), lockorder.acquisitions()
        hits = None if plan is None else sum(s.hits for s in inj.specs)
    finally:
        lockorder.disable()
        lockorder.reset()
        faults.clear()
    n_rows = check_sql_rows("q7", sink_lines(out), want)
    info = {"events": events, "rows": n_rows, "wall_s": wall, "events_per_s": events / wall,
            "launches": {k: launches[k] for k in AGG_PATH_KERNELS}}
    if torch.device(device or "cuda").type == "cuda":
        unlaunched = [k for k in AGG_PATH_KERNELS if launches[k] == 0]
        if unlaunched:
            raise AssertionError(f"{job} launched no {unlaunched}: {launches}")
    if plan is not None:
        if not hits:
            raise AssertionError(f"{job}: {plan} never fired")
        return {**info, "plan": plan, "fault_hits": hits}
    static = set(static_lock_graph_package())
    unexplained = sorted(e for e in edges if e not in static)
    if unexplained:
        raise AssertionError(f"{job}: witness edges missing from the static lock graph: "
                             f"{unexplained}")
    untaken = [n for n in ANALYSIS_LOCKS if not taken.get(n)]
    if untaken:
        raise AssertionError(f"{job}: the run took no {untaken}; taken: {taken}")
    return {**info, "edges": sorted(edges), "static_edges": len(static),
            "acquisitions": dict(sorted(taken.items()))}


def analysis_phase(card: str) -> dict:
    """The port's static analysis on the card's machine: the lint and the
    pinned checks as CLI subprocesses beside the witness's q7, then q7
    under the lock_contend plan (see the module docstring's item 28)."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_analysis_")
    try:
        procs = analysis_cli_start(root)
        try:
            wit = witness_q7(ANALYSIS_EVENTS, root, "chip-smoke-analysis-witness")
            cli = analysis_cli_finish(procs)
        finally:
            for _t0, p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        contend = witness_q7(ANALYSIS_EVENTS, root, "chip-smoke-analysis-contend",
                             plan=CONTEND_PLAN)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    info = {"phase": "analysis", "card": card, "cli": cli, "witness": wit,
            "contend": contend, "seconds": time.perf_counter() - t0}
    emit(info)
    print(f"analysis: lint clean in {cli['lint']['s']:.1f} s; check q7/q5/q8/q5_unaligned "
          f"exit {[cli[n]['rc'] for n in ANALYSIS_CHECKS]}; witness q7 over two workers "
          f"{wit['events_per_s']:.0f} events/s, edges {wit['edges']} (static graph "
          f"{wit['static_edges']} edges), acquisitions {wit['acquisitions']}; q7 under "
          f"{CONTEND_PLAN} {contend['events_per_s']:.0f} events/s, {contend['fault_hits']} "
          f"delays; launches {wit['launches']} / {contend['launches']}; phase "
          f"{info['seconds']:.1f} s [{card}]", flush=True)
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
    global STORAGE_ROOT
    STORAGE_ROOT = tempfile.mkdtemp(prefix="chip_smoke_storage_")
    try:
        return run_phases(args, out_dir)
    finally:
        shutil.rmtree(STORAGE_ROOT, ignore_errors=True)


# ---------------------------------------------------------------- updating

# Nexmark q3, "local item suggestion": auctions of category 10 joined to
# their sellers in OR, ID or CA. Planned through the port's plan_query it
# is an updating inner join (JoinWithExpiration) of two subqueries over the
# nexmark source; the sink writes debezium envelopes. At half bench.py's q7
# size: a cut of depth for the whole run's time limit.
Q3_EVENTS = 1_000_000
Q3_SPILL_BUDGET = 1 << 20  # bytes: the side stores' floor passes it early
Q3_PATH_KERNELS = ("segment_fused",)  # the auctions chain compiles (K4)
SQL_Q3 = """CREATE TABLE nexmark (
  "person.id" BIGINT,
  "person.name" TEXT,
  "person.city" TEXT,
  "person.state" TEXT,
  "auction.id" BIGINT,
  "auction.seller" BIGINT,
  "auction.category" BIGINT,
  person BOOLEAN,
  auction BOOLEAN
) WITH (
  connector = 'nexmark',
  event_count = {events},
  inter_event_micros = 1000,
  first_event_micros = 0,
  include_strings = true,
  type = 'source'
);
CREATE TABLE q3_out (name TEXT, city TEXT, state TEXT, id BIGINT)
WITH (connector = 'single_file', path = '{out}', format = 'debezium_json', type = 'sink');
INSERT INTO q3_out
SELECT P.name, P.city, P.state, A.id
FROM (SELECT "auction.id" AS id, "auction.seller" AS seller, "auction.category" AS category
      FROM nexmark WHERE auction) A
JOIN (SELECT "person.id" AS id, "person.name" AS name, "person.city" AS city,
             "person.state" AS state
      FROM nexmark WHERE person) P
ON A.seller = P.id
WHERE A.category = 10 AND (P.state = 'OR' OR P.state = 'ID' OR P.state = 'CA');
"""


def nexmark_q3_sql(events: int, out: str) -> str:
    return SQL_Q3.format(events=int(events), out=out)


def oracle_q3(events: int) -> dict:
    """(name, city, state, auction id) -> count: numpy over the generated
    persons and auctions (only their event numbers are generated), the
    persons of OR, ID and CA joined to the auctions of category 10 by
    seller."""
    from collections import Counter

    n = np.arange(events, dtype=np.int64)
    off = n % 50
    nums = n[off < 4]  # 1 person and 3 auctions in every 50 events
    src = NexmarkSource({"event_count": events, "inter_event_micros": 1000,
                         "first_event_micros": 0, "include_strings": True,
                         "columns": ["person.id", "person.name", "person.city", "person.state",
                                     "auction.id", "auction.seller", "auction.category"]})
    c = src._generate(nums).columns
    pm = c["person"] & np.isin(c["person.state"].astype(str), ["OR", "ID", "CA"])
    people = dict(zip(c["person.id"][pm].tolist(),
                      zip(c["person.name"][pm].tolist(), c["person.city"][pm].tolist(),
                          c["person.state"][pm].tolist())))
    am = c["auction"] & (c["auction.category"] == 10)
    want: Counter = Counter()
    for aid, seller in zip(c["auction.id"][am].tolist(), c["auction.seller"][am].tolist()):
        p = people.get(seller)
        if p is not None:
            want[(*p, aid)] += 1
    return dict(want)


def check_q3_lines(lines: list, want: dict) -> int:
    """The sink's debezium lines held exactly to ``oracle_q3``: every line a
    create (``c``, no ``before``) of one joined row, the multiset equal."""
    from collections import Counter

    got: Counter = Counter()
    for line in lines:
        env = json.loads(line)
        if env.get("op") != "c" or env.get("before") is not None:
            raise AssertionError(f"q3: a line that is not a create: {line}")
        a = env["after"]
        got[(a["name"], a["city"], a["state"], a["id"])] += 1
    if dict(got) != want:
        diff = next(iter(set(got.items()) ^ set(want.items())), None)
        raise AssertionError(f"q3 parity failure: {sum(got.values())} rows vs "
                             f"{sum(want.values())}; first diff {diff}")
    return sum(got.values())


def q3_config(spill: bool) -> None:
    bench_config(chaining=True, extra={"state.spill.enabled": spill,
                                       "state.spill.budget-bytes": Q3_SPILL_BUDGET})


def q3_join(eng):
    """(node, operator) of ``eng``'s updating join."""
    for (node, sub), task in eng.tasks.items():
        if sub == 0 and "join_" in node and hasattr(task.operator, "stores"):
            return node, task.operator
    raise AssertionError(f"no updating join among {list(eng.tasks)}")


def q3_spill_stats(op) -> dict:
    st = op._annexes[0].stats  # one stats block, shared by both sides
    return {"runs_written": st.runs_written, "bytes_written": st.bytes_total,
            "probes": st.probes, "probes_that_promote": st.promotions,
            "files_probed": int(st.probe_files.sum), "compactions": st.compactions,
            "failures": st.failures,
            "runs_live": [len(a.runs) for a in op._annexes]}


def q3_lines(path: str) -> list:
    with open(path) as f:
        return [line for line in f.read().splitlines() if line.strip()]


def q3_run(root: str, spill: bool, want: dict) -> dict:
    """One run of q3 through the port's plan_query and run_graph on the
    card; counts zeroed just before it and read just after."""
    from arroyo_tpu_torch.sql import plan_query

    q3_config(spill)
    out = os.path.join(root, f"q3-{'spill' if spill else 'resident'}.json")
    job = f"chip-smoke-q3-{'spill' if spill else 'resident'}"
    recorder.clear_job(job)
    g = plan_query(nexmark_q3_sql(Q3_EVENTS, out)).graph
    ran = {}

    def run():
        reset_all_launch_counts()
        t0 = time.perf_counter()
        ran["eng"] = run_graph(g, job_id=job, timeout=900)
        torch.cuda.synchronize()
        ran["wall"] = time.perf_counter() - t0
        ran["launches"] = all_launch_counts()

    prof = device_trace(run, warm_device)
    eng, wall, launches = ran["eng"], ran["wall"], ran["launches"]
    if eng.device.type != "cuda":
        raise RuntimeError(f"{job} ran on {eng.device}, not on the GPU")
    rows = check_q3_lines(q3_lines(out), want)
    unlaunched = [k for k in Q3_PATH_KERNELS if launches[k] == 0]
    if unlaunched:
        raise AssertionError(f"q3 ran without launching {unlaunched}: {launches}")
    node, op = q3_join(eng)
    by_name = device_us_by_name(prof)
    busy_s = sum(by_name.values()) / 1e6 if by_name else None
    info = {"events": Q3_EVENTS, "wall_s": wall, "events_per_s": Q3_EVENTS / wall,
            "rows": rows, "join_node": node,
            "side_store_bytes": {k: v[1] for k, v in op.state_sizes().items()},
            "launches": {"segment_fused (K4)": launches["segment_fused"],
                         "slot_scatter_combine (K1)": launches["slot_scatter_combine"]},
            "segment_compiled": len(recorder.events(job, "SEGMENT_COMPILED")),
            "device_busy_s": busy_s,
            "device_idle_share": None if busy_s is None else 1.0 - busy_s / wall}
    if spill:
        info["spill"] = q3_spill_stats(op)
        if not info["spill"]["runs_written"]:
            raise AssertionError(f"q3 with a {Q3_SPILL_BUDGET}-byte budget wrote no spill run: "
                                 f"{info['spill']}")
    return info


def q3_crash_restore(root: str, want: dict, events: int, batch: int, engine=Engine) -> dict:
    """q3 under the configuration in force (spilling on), ``events`` events
    in source batches of ``batch``: every source held at half its batches
    for epoch 1, at three quarters for epoch 2, whose barrier crashes the
    join; a fresh engine (``engine(graph, **kw)``) restores from epoch 1,
    whose manifests reference the spilled runs, and finishes: the rows are
    the oracle's."""
    from arroyo_tpu_torch.sql import plan_query

    job = "chip-smoke-q3-crash"
    url = os.path.join(root, job)
    out = os.path.join(root, "q3-crash.json")
    eng = engine(plan_query(nexmark_q3_sql(events, out)).graph, job_id=job, storage_url=url)
    eng.build()
    node, _op = q3_join(eng)
    nb = -(-events // batch)
    faults.install(f"worker:crash@barrier=2&node={node}&subtask=0")
    try:
        crash_at_last_barrier(eng, (nb // 2 + 1, nb * 3 // 4 + 1))
    finally:
        faults.clear()
    meta = read_job_checkpoint_metadata(url, job, 1)
    if meta is None or read_job_checkpoint_metadata(url, job, 2) is not None:
        raise AssertionError("q3: epoch 1 incomplete or epoch 2 completed")
    runs = q3_manifest_runs(url, job, 1, node)
    if not runs:
        raise AssertionError("q3: epoch 1's manifests reference no spilled run")
    missing = [r for r in runs if not os.path.exists(os.path.join(url, job, "spill",
                                                                  f"operator-{node}", r))]
    if missing:
        raise AssertionError(f"q3: runs the manifest references are missing: {missing}")
    t0 = time.perf_counter()
    eng2 = engine(plan_query(nexmark_q3_sql(events, out)).graph, job_id=job,
                  storage_url=url, restore_epoch=1)
    eng2.build()
    build_ms = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    eng2.run_to_completion(timeout=900)
    run_s = time.perf_counter() - t1
    rows = check_q3_lines(q3_lines(out), want)
    _n, op2 = q3_join(eng2)
    return {"epoch1_manifest_runs": len(runs), "restore_build_ms": build_ms,
            "restored_run_s": run_s, "crash_to_restored_rows_s": time.perf_counter() - t0,
            "rows": rows, "restored_spill": q3_spill_stats(op2)}


def q3_manifest_runs(url: str, job: str, epoch: int, node: str) -> list:
    """The run files the join's ``*__spill`` tables reference at ``epoch``
    (the checkpoint metadata's ``spill_runs``)."""
    d = os.path.join(checkpoint_dir(url, job, epoch), f"operator-{node}")
    out = set()
    for fn in os.listdir(d):
        if fn.startswith("metadata-") and fn.endswith(".json"):
            with open(os.path.join(d, fn)) as f:
                meta = json.load(f)
            for fm in meta.get("files", ()):
                out.update(fm.get("spill_runs", ()))
    return sorted(out)


def updating_phase(card: str) -> dict:
    """Nexmark q3 planned by the port at 1,000,000 events on the card, three
    times: spilling off; spilling on with a 1 MiB budget (runs must be
    written); and spilling on with a crash at epoch 2 and a restore from
    epoch 1. Each time the rows are exactly the oracle's."""
    want = oracle_q3(Q3_EVENTS)
    root = tempfile.mkdtemp(prefix="chip_smoke_q3_")
    try:
        log("updating: q3, spilling off")
        resident = q3_run(root, False, want)
        log("updating: q3, spilling on")
        spilled = q3_run(root, True, want)
        log("updating: q3, crash and restore")
        q3_config(True)
        crash = q3_crash_restore(root, want, Q3_EVENTS, BENCH_BATCH)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    info = {"phase": "updating", "card": card, "oracle_rows": sum(want.values()),
            "resident": resident, "spill": spilled, "crash_restore": crash,
            "spill_slowdown": spilled["wall_s"] / resident["wall_s"]}
    emit(info)
    for name, q in (("resident", resident), ("spill", spilled)):
        print(f"updating q3 {name}: {q['events_per_s']:.0f} events/s, run {q['wall_s']:.3f} s, "
              f"{q['rows']} rows, idle {q['device_idle_share']}, launches {q['launches']}"
              + (f", spill {q['spill']}" if "spill" in q else "") + f" [{card}]", flush=True)
    print(f"updating q3 crash-restore: {crash['epoch1_manifest_runs']} runs in epoch 1's "
          f"manifests, restore build {crash['restore_build_ms']:.1f} ms, restored run "
          f"{crash['restored_run_s']:.3f} s, {crash['rows']} rows [{card}]", flush=True)
    return info


# ---------------------------------------------------------------- obs

# the series families the JAX package exports for a q7c job whose segment
# compiled afresh (tests/test_torch_metrics.py holds this set to both
# packages on the CPU): q7c's watermark is made inside its one chain, so no
# task merges one (no lag gauge), and no key boundary lies outside the
# chain (no sketch)
OBS_Q7C_FAMILIES = frozenset({
    "arroyo_events_total", "arroyo_segment_compile_seconds_bucket",
    "arroyo_segment_compile_seconds_count", "arroyo_segment_compile_seconds_sum",
    "arroyo_state_bytes", "arroyo_state_rows", "arroyo_worker_batches_recv",
    "arroyo_worker_batches_sent", "arroyo_worker_bytes_recv", "arroyo_worker_bytes_sent",
    "arroyo_worker_deserialization_errors", "arroyo_worker_emit_batch_rows_bucket",
    "arroyo_worker_emit_batch_rows_count", "arroyo_worker_emit_batch_rows_sum",
    "arroyo_worker_messages_recv", "arroyo_worker_messages_sent",
    "arroyo_worker_queue_transit_seconds_bucket", "arroyo_worker_queue_transit_seconds_count",
    "arroyo_worker_queue_transit_seconds_sum", "arroyo_worker_self_cpu_seconds",
    "arroyo_worker_self_time_seconds", "arroyo_worker_sink_event_latency_seconds_bucket",
    "arroyo_worker_sink_event_latency_seconds_count",
    "arroyo_worker_sink_event_latency_seconds_sum", "arroyo_worker_tx_queue_rem",
    "arroyo_worker_tx_queue_size"})
# timed q7c runs of each setting, alternating (host noise spans ~1.7x); four
# rounds put each of the four settings once in each place of the rotation
# rounds of the timed settings; 2, not 4, to keep the whole run inside its
# time limit on the slower of the card's hosts
OBS_REPS = 2
# what profile.enabled adds to a task thread: TaskProfiler's hooks and the
# key sketch's feed
PROFILE_HOOKS = (("obs.profile", "TaskProfiler", ("begin", "end", "source_tick", "source_reset",
                                                   "refresh", "checkpoint_sketch")),
                 ("obs.sketch", "KeySketch", ("observe",)))


def series_of(job: str) -> dict:
    """The job's Prometheus series: {line without its value: value}."""
    out = {}
    for line in registry.prometheus_text().splitlines():
        if not line.startswith("#") and f'job="{job}"' in line:
            key, val = line.rsplit(" ", 1)
            out[key] = float(val)
    return out


def obs_q7c_run(job: str, profile: bool, native_on: bool) -> dict:
    """q7c at bench.py's setting with the profiler and the native host
    library as given: exact against the oracle, K4, K1 and K2's
    read-and-clear mode launched."""
    reset_all_launch_counts()
    registry.clear_job(job)
    rows, wall, eng = drive(build_q7, Q7_EVENTS, job, chaining=True,
                            extra={"profile.enabled": profile, "native.enabled": native_on})
    launches = all_launch_counts()
    check_q7(rows, oracle_q7(Q7_EVENTS))
    unlaunched = [k for k in AGG_PATH_KERNELS if launches[k] == 0]
    if unlaunched:
        raise AssertionError(f"{job} ran without launching {unlaunched}: {launches}")
    return {"wall_s": wall, "events_per_s": Q7_EVENTS / wall, "eng": eng,
            "launches": {k: launches[k] for k in AGG_PATH_KERNELS}}


@contextlib.contextmanager
def timed_profile_hooks():
    """Wraps each of PROFILE_HOOKS in a timer while open; yields
    {thread name: {hook: [calls, seconds]}} (each call's two clock reads of
    the timer included)."""
    import importlib

    acc: dict = {}
    saved = []

    def wrap(name, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                d = time.perf_counter() - t0
                cell = acc.setdefault(threading.current_thread().name, {}).setdefault(
                    name, [0, 0.0])
                cell[0] += 1
                cell[1] += d
        return timed

    for mod, cls_name, names in PROFILE_HOOKS:
        cls = getattr(importlib.import_module(f"arroyo_tpu_torch.{mod}"), cls_name)
        for name in names:
            saved.append((cls, name, cls.__dict__[name]))
            setattr(cls, name, wrap(name, cls.__dict__[name]))
    try:
        yield acc
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def timer_cost_s(n: int = 100_000) -> float:
    """Seconds a call that the hook timer adds: a closure call and two
    clock reads around an empty function."""
    def f():
        return None

    def timed():
        t0 = time.perf_counter()
        try:
            return f()
        finally:
            time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        timed()
    return (time.perf_counter() - t0) / n


def obs_hook_cost() -> dict:
    """One more profiled q7c run (not one of the timed ones) with every
    profiler hook timed: seconds and calls per task thread and hook, and
    each thread's total less what the timer adds."""
    with timed_profile_hooks() as acc:
        r = obs_q7c_run("chip-smoke-obs-hooks", True, True)
    r.pop("eng")
    per_call = timer_cost_s()
    hook_s = {t: sum(s for _c, s in h.values()) for t, h in acc.items()}
    calls = {t: sum(c for c, _s in h.values()) for t, h in acc.items()}
    return {"wall_s": r["wall_s"], "threads": acc, "timer_s_per_call": per_call,
            "hook_s": hook_s,
            "hook_s_net": {t: hook_s[t] - calls[t] * per_call for t in acc}}


def obs_q8c_run(job: str, profile: bool) -> dict:
    """q8c at bench.py's setting with the profiler as given, exact: the join
    takes keyed input, so the profiled run feeds its key sketch."""
    registry.clear_job(job)
    rows, wall, _eng = drive(build_q8, Q8_EVENTS, job, chaining=True, queue_mult=1,
                             extra={"profile.enabled": profile})
    check_q8(rows, oracle_q8(Q8_EVENTS))
    out = {"wall_s": wall, "events_per_s": Q8_EVENTS / wall}
    if profile:
        jm = registry.job_metrics(job)
        out["sketch_total"] = {op: m.get("sketch_total") for op, m in jm.items()
                               if m.get("sketch_total")}
    return out


def obs_metrics_checks(job: str, eng) -> dict:
    """The profiled q7c run's exposition: every family the JAX package
    exports for such a job, the row counters the oracle implies, one build
    observation per padded shape K4 ran at, and the printed numbers."""
    fams = {k.split("{", 1)[0] for k in series_of(job)}
    if fams != OBS_Q7C_FAMILIES:
        raise AssertionError(f"obs: families {sorted(fams ^ OBS_Q7C_FAMILIES)} differ from the "
                             f"JAX package's for q7c")
    jm = registry.job_metrics(job)
    chain = next(n for n in eng.graph.nodes if "+" in n)
    counters = {op: {k: jm[op][f"arroyo_worker_messages_{k}"] for k in ("recv", "sent")}
                for op in jm}
    # the source sends every event; the chain takes them all in and, being
    # terminal (its sink is its last member), sends nothing on
    want = {"src": {"recv": 0, "sent": Q7_EVENTS}, chain: {"recv": Q7_EVENTS, "sent": 0}}
    if counters != want:
        raise AssertionError(f"obs: row counters {counters}, the oracle implies {want}")
    min_rows = int(tcfg.config().get("segment.compile.min-rows"))
    sizes = [min(BENCH_BATCH, Q7_EVENTS - lo) for lo in range(0, Q7_EVENTS, BENCH_BATCH)]
    shapes = sorted({seg._padded_size(n) for n in sizes if n >= min_rows})
    compiles, hits = registry.segment_compile_stats(job)
    if compiles != len(shapes):
        raise AssertionError(f"obs: {compiles} segment build observations for the padded "
                             f"shapes {shapes}")
    tm = registry.task(job, chain, 0)
    lat = tm.sink_event_latency
    compile_s = {k.split("{")[0]: v for k, v in series_of(job).items()
                 if k.startswith("arroyo_segment_compile_seconds_")}
    return {
        "families": len(fams), "row_counters": counters,
        "segment_compile": {"observations": compiles, "padded_shapes": shapes,
                            "cache_hits": hits,
                            "seconds_sum": compile_s.get("arroyo_segment_compile_seconds_sum")},
        "sink_latency_p50_s": lat.quantile_str(0.5, precision=3),
        "sink_latency_p99_s": lat.quantile_str(0.99, precision=3),
        "sink_latency_clamped": lat._quantile(0.99)[1],
        "watermark_lag_s": {op: jm[op]["watermark_lag_seconds"] for op in jm},
        "hot_keys": {op: jm[op].get("hot_keys") for op in jm},
        "busy_pct": {op: jm[op].get("busy_pct") for op in jm},
        "self_time_s": {op: jm[op].get("self_time") for op in jm},
        "queue_transit_p99_ms": {op: jm[op]["queue_transit_p99_ms"] for op in jm},
    }


def prom_value(job: str, family: str) -> dict:
    """operator -> the family's value for the job (one subtask each)."""
    out = {}
    for k, v in series_of(job).items():
        if k.startswith(family + "{"):
            op = k.split('operator="', 1)[1].split('"', 1)[0]
            out[op] = out.get(op, 0) + v
    return out


def obs_mesh_check() -> dict:
    """q7m fused: arroyo_mesh_exchange_rows_total equals the sharded
    store's exchange count and the bids the oracle counts."""
    job = "chip-smoke-obs-q7m"
    extra = {"device.mesh-devices": MESH_N, "segment.compile.mesh-fuse": True}
    reset_mesh_ledger()
    registry.clear_job(job)
    rows, wall, eng = drive(build_q7, Q7_EVENTS, job, chaining=True, extra=extra)
    want = oracle_q7(Q7_EVENTS)
    check_q7(rows, want)
    chain = next(n for n in eng.graph.nodes if "+" in n)
    stats = eng.tasks[(chain, 0)].operator.mesh_stats()
    exported = prom_value(job, "arroyo_mesh_exchange_rows_total")
    bids = sum(c for (_m, c) in want.values())
    ledger = mesh_ledger()
    if not (exported == {chain: stats["exchange_rows"]} and stats["exchange_rows"] == bids
            and ledger["segment"]["fused"] == ledger["aggregate"]["fused_steps"] > 0):
        raise AssertionError(f"obs q7m: exported {exported}, mesh_stats {stats}, {bids} bids, "
                             f"ledger {ledger}")
    return {"exchange_rows": exported[chain], "bids": bids, "ledger": ledger,
            "overflow_rows": prom_value(job, "arroyo_mesh_overflow_rows"), "wall_s": wall}


def obs_spill_check(root: str) -> dict:
    """q3 at the 1 MiB budget: arroyo_spill_bytes_total and the
    arroyo_spill_probe_files histogram agree with the annex's SpillStats."""
    want = oracle_q3(Q3_EVENTS)
    info = q3_run(root, True, want)
    job = "chip-smoke-q3-spill"
    node = info["join_node"]
    task = registry.task(job, node, 0)
    st = info["spill"]
    exported = prom_value(job, "arroyo_spill_bytes_total")
    probes = {k.split("{")[0]: v for k, v in series_of(job).items()
              if k.startswith("arroyo_spill_probe_files_") and f'operator="{node}"' in k}
    h = task.spill["probe_files"]
    if not (exported.get(node) == st["bytes_written"] == task.spill["bytes_total"]
            and probes.get("arroyo_spill_probe_files_count") == h.count
            and probes.get("arroyo_spill_probe_files_sum") == st["files_probed"] == h.sum):
        raise AssertionError(f"obs q3: exported {exported} / {probes}, SpillStats {st}")
    jm = registry.job_metrics(job)
    return {"spill_bytes_total": exported[node], "probe_files_count": h.count,
            "probe_files_sum": h.sum, "spill_stats": st, "events_per_s": info["events_per_s"],
            "hot_keys": {op: m.get("hot_keys") for op, m in jm.items() if m.get("hot_keys")},
            "state_rows": {op: m.get("state_rows") for op, m in jm.items() if m.get("state_rows")}}


def epoch_tables(url: str, job: str, epoch: int) -> list:
    """(operator dir / file, table) of every table file of the epoch, from
    the subtasks' sidecars."""
    d = checkpoint_dir(url, job, epoch)
    out = []
    for opd in sorted(x for x in os.listdir(d) if x.startswith("operator-")):
        for fn in sorted(os.listdir(os.path.join(d, opd))):
            if fn.startswith("metadata-"):
                with open(os.path.join(d, opd, fn)) as f:
                    out += [(f"{opd}/{fm['file']}", fm["table"]) for fm in json.load(f)["files"]]
    return out


def obs_checkpoint_check(out_dir: str) -> dict:
    """One checkpoint of q7c with its window at parallelism 4 (a keyed
    shuffle outside the chain, so both the chain and the window keep a
    sketch): the epoch's span tree has every subtask's alignment, snapshot
    and ack; the Chrome trace goes to the out-dir; ``__sketch`` is in the
    epoch; a restore from it ends with the hot keys of an uninterrupted
    run, and the rows are the oracle's."""
    from arroyo_tpu_torch.obs import trace as obs_trace

    want = oracle_q7(Q7_EVENTS)
    build4 = lambda rows, events: build_q7(rows, events, parallelism=4)  # noqa: E731
    whole = "chip-smoke-obs-whole"
    registry.clear_job(whole)
    rows_w, _wall, _eng = drive(build4, Q7_EVENTS, whole, chaining=True)
    check_q7(rows_w, want)

    def hot(job):
        return {op: m.get("hot_keys") for op, m in registry.job_metrics(job).items()
                if m.get("hot_keys")}

    want_hot = hot(whole)
    if not want_hot:
        raise AssertionError("obs: the parallelism-4 q7c kept no sketch")
    job = "chip-smoke-obs-ckpt"
    url = os.path.join(STORAGE_ROOT, job)
    bench_config(True)
    registry.clear_job(job)
    rows1: list = []
    eng = Engine(build4(rows1, Q7_EVENTS), job_id=job, storage_url=url)
    run_gated_epochs(eng, recovery_holds(Q7_EVENTS, 2))
    events = obs_trace.recorder.events(job, 1)
    by_task = {}
    for e in events:
        if e["node"] is not None:
            by_task.setdefault((e["node"], e["subtask"]), set()).add(e["event"])
    missing = {}
    for n, sub in eng.tasks:
        need = {"snapshot_start", "ack"} | (set() if n == "src" else {"align_start"})
        lack = need - by_task.get((n, sub), set())
        if lack:
            missing[f"{n}/{sub}"] = sorted(lack)
    if missing:
        raise AssertionError(f"obs: epoch 1's span tree lacks {missing}")
    chrome = obs_trace.chrome_trace(job, {1: events})
    path = os.path.join(out_dir, "obs_chrome_trace.json")
    with open(path, "w") as f:
        json.dump(chrome, f)
    sketch_files = [f for f, table in epoch_tables(url, job, 1) if table == "__sketch"]
    if not sketch_files:
        raise AssertionError("obs: epoch 1 holds no __sketch table")
    timeline = eng.checkpoint_timeline(1)  # before a new engine of the job clears its spans
    bench_config(True)
    registry.clear_job(job)
    rows2: list = []
    Engine(build4(rows2, Q7_EVENTS), job_id=job, storage_url=url,
           restore_epoch=1).run_to_completion(timeout=900)
    check_q7(rows1 + rows2, want)
    got_hot = hot(job)
    if got_hot != want_hot:
        raise AssertionError(f"obs: restored hot keys {got_hot} != uninterrupted {want_hot}")
    phases = obs_trace.phase_durations(events)
    return {"span_events": len(events), "tasks": len(eng.tasks), "chrome_trace": path,
            "chrome_events": len(chrome["traceEvents"]), "sketch_files": sorted(sketch_files),
            "hot_keys": got_hot, "phases_s": phases,
            "timeline": timeline,
            "report": obs_trace.timeline_report(job, 1, events).splitlines()[-1]}


def obs_panic_check() -> dict:
    """An injected operator exception mid-checkpoint: one OPERATOR_PANIC
    naming the node, the subtask, the epoch and a traceback digest, and the
    job fails."""
    job = "chip-smoke-obs-panic"
    bench_config(True)
    recorder.clear_job(job)
    eng = Engine(build_q7([], Q7_EVENTS // 4), job_id=job)
    eng.build()
    node = next(n for n in eng.graph.nodes if "+" in n)
    gate = gate_source(eng, 3)
    faults.install(f"worker:crash@barrier=1&node={node}&subtask=0")
    failed = None
    try:
        eng.start()
        if not gate.reached.wait(300):
            raise AssertionError("obs panic: the source never reached its gate")
        eng.trigger_checkpoint(1)
        try:
            eng.join(timeout=300)
        except RuntimeError as e:
            failed = str(e).splitlines()[-1]
    finally:
        faults.clear()
        eng.stop()
    panics = recorder.events(job, "OPERATOR_PANIC")
    if (failed is None or len(panics) != 1 or panics[0]["node"] != node
            or panics[0]["subtask"] != 0 or panics[0]["epoch"] != 1
            or len(panics[0]["data"].get("digest", "")) != 12):
        raise AssertionError(f"obs panic: failed {failed!r}, events {panics}")
    return {"job_failed": failed, "event": {k: panics[0][k] for k in
                                            ("code", "level", "node", "subtask", "epoch",
                                             "message", "data")}}


def obs_phase(card: str, out_dir: str) -> dict:
    """The observability plane on the card, profiling at its default (on)."""
    from arroyo_tpu_torch import native

    info = {"phase": "obs", "card": card}
    # the profiled q7c run whose exposition is checked: its segment builds
    # afresh, so each padded shape's first call is observed
    seg.segment_cache.clear()
    first = obs_q7c_run("chip-smoke-obs-q7c", True, True)
    info["metrics"] = obs_metrics_checks("chip-smoke-obs-q7c", first.pop("eng"))
    info["first_run"] = first
    # profile_off_aa repeats profile_off: the A/A pair's ratio is the noise
    # floor the on/off ratio is read against; the order rotates each round
    # so that no setting always follows the same one
    settings = [("profile_on", (True, True)), ("profile_off", (False, True)),
                ("native_off", (True, False)), ("profile_off_aa", (False, True))]
    runs = {k: [] for k, _ in settings}
    for rep in range(OBS_REPS):
        for name, (prof, nat) in settings[rep % 4:] + settings[:rep % 4]:
            r = obs_q7c_run(f"chip-smoke-obs-{name}-{rep}", prof, nat)
            r.pop("eng")
            runs[name].append(r)
    log("obs: profiler hooks timed")
    info["hook_cost"] = obs_hook_cost()
    # q8c: the profiler's cost where a sketch is fed (the join's keyed
    # input); one untimed run first builds q8c's segment shapes, and the
    # order alternates so that neither setting always runs first
    obs_q8c_run("chip-smoke-obs-q8c-warm", True)
    q8c_settings = [("q8c_profile_on", True), ("q8c_profile_off", False)]
    for rep in range(OBS_REPS):
        for name, prof in q8c_settings[rep % 2:] + q8c_settings[:rep % 2]:
            runs.setdefault(name, []).append(
                obs_q8c_run(f"chip-smoke-obs-{name}-{rep}", prof))
    eps = {k: [r["events_per_s"] for r in v] for k, v in runs.items()}
    info["q7c_runs"] = runs
    info["events_per_s"] = eps
    med = {k: statistics.median(v) for k, v in eps.items()}
    info["events_per_s_median"] = med
    info["profile_off_over_on"] = med["profile_off"] / med["profile_on"]
    info["profile_off_over_off_aa"] = med["profile_off"] / med["profile_off_aa"]
    info["native_on_over_off"] = med["profile_on"] / med["native_off"]
    info["q8c_profile_off_over_on"] = med["q8c_profile_off"] / med["q8c_profile_on"]
    log("obs: q7m fused")
    info["q7m"] = obs_mesh_check()
    log("obs: q3 spilling")
    root = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        info["q3"] = obs_spill_check(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("obs: checkpoint")
    info["checkpoint"] = obs_checkpoint_check(out_dir)
    log("obs: panic")
    info["panic"] = obs_panic_check()
    info["native_build"] = {k: native.build_info.get(k) for k in ("seconds", "cached", "path")}
    emit(info)
    m = info["metrics"]
    print(f"obs q7c events/s, medians of {OBS_REPS}: profile on {med['profile_on']}, off "
          f"{med['profile_off']} (off/on {info['profile_off_over_on']}); native off "
          f"{med['native_off']} (on/off {info['native_on_over_off']}); q8c profile on "
          f"{med['q8c_profile_on']}, off {med['q8c_profile_off']} (off/on "
          f"{info['q8c_profile_off_over_on']}); A/A profile off / off again "
          f"{info['profile_off_over_off_aa']} (off again {med['profile_off_aa']}); runs {eps} "
          f"[{card}]", flush=True)
    hc = info["hook_cost"]
    print(f"obs q7c profiler hooks, one timed run of {hc['wall_s']} s: seconds per task thread "
          f"{hc['hook_s']}, less the timer ({hc['timer_s_per_call']} s a call) "
          f"{hc['hook_s_net']}; median wall off - on "
          f"{Q7_EVENTS / med['profile_on'] - Q7_EVENTS / med['profile_off']} s; by hook "
          f"{hc['threads']} [{card}]", flush=True)
    print(f"obs q7c: sink latency p50 {m['sink_latency_p50_s']} s, p99 "
          f"{m['sink_latency_p99_s']} s (clamped: {m['sink_latency_clamped']}), watermark lag "
          f"{m['watermark_lag_s']}, hot keys {m['hot_keys']}, busy% {m['busy_pct']}, segment "
          f"builds {m['segment_compile']} [{card}]", flush=True)
    print(f"obs: q7m exchange rows {info['q7m']['exchange_rows']}; q3 spill bytes "
          f"{info['q3']['spill_bytes_total']}, probe files {info['q3']['probe_files_sum']} in "
          f"{info['q3']['probe_files_count']} probes; checkpoint spans "
          f"{info['checkpoint']['span_events']}, hot keys restored; panic "
          f"{info['panic']['event']['node']}/{info['panic']['event']['subtask']} [{card}]",
          flush=True)
    return info


def run_phases(args, out_dir: str) -> int:
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
        "mesh_slots": lambda: mesh_slots_phase(smi),
        "hash_agg": lambda: hash_agg_phase(dev),
        "q7_host": run_q7_host,
        "checkpoint": lambda: checkpoint_phase(dev),
        "recovery": lambda: recovery_phase(smi),
        "sql": lambda: sql_phase(smi, res),
        "updating": lambda: updating_phase(smi),
        "obs": lambda: obs_phase(smi, out_dir),
        "cluster": lambda: cluster_phase(smi, res),
        "deploy": lambda: deploy_phase(smi, res),
        "connectors": lambda: connectors_phase(smi),
        "analysis": lambda: analysis_phase(smi),
        "segment_sweep": segment_sweep,
    }
    only = args.only.split(",") if args.only else [p for p in phases if p != "segment_sweep"]
    unknown = sorted(set(only) - set(phases))
    if unknown:
        raise SystemExit(f"unknown phases {unknown}; the phases are {list(phases)}")
    seconds = {}
    for name, fn in phases.items():
        if name in only:
            log(name)
            t0 = time.perf_counter()
            res[name] = fn()
            seconds[name] = time.perf_counter() - t0
    log("done")
    res["phase_seconds"] = seconds
    print(f"phase seconds: {json.dumps(seconds)}", flush=True)
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
    ck = res["checkpoint"]
    rows[0]["checkpoint"] = {"merge_launches_at_restore": ck["k1_merge_launches"],
                             "deployment_restore": ck["deployment"]["slot"]["k1_merge_launches"]}
    rows[0]["note"] = ("C8 fixed: float64 subnormals flushed to the zero of their sign, "
                       "operands and results, as XLA on the CPU; edge case 'float64 "
                       "subnormals and -0.0'")
    rec = res["recovery"]
    rows[0]["recovery"] = {
        "merge_launches_at_restore": {
            "crash q7c": rec["crash"]["q7c"]["restore_launches"]["slot_scatter_combine_merge"],
            "evolved q7c": rec["plan_gate"]["k1_merge_launches"],
            **{f"compacted at {p}": r["k1_merge_launches"]
               for p, r in rec["compaction"]["restores"].items()}}}
    k2["checkpoint"] = {"read_launches_at_barrier": ck["k2_read_launches"],
                        "deployment_snapshots": ck["deployment"]["slot"]["k2_read_launches"]}
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
                          "zero_sums_ms", "longest_run")
                if k in res["kernels"]["timing"][shape]["slot_scatter_combine"]}
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
                 "q7c_copies": res["q7c"]["profiled_run"]["copies_by_kind"],
                 "float64_plan": {k: segp["timing_float64"][k] for k in
                                  ("rows", "ms", "plain_ms", "bound_ms", "call_ms")}})
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
        if name in ("agg_sort_reduce", "agg_probe_merge"):
            row["note"] = ("float32 and float64 subnormals flushed to the zero of their "
                           "sign in every add and compare, as XLA on the CPU")
        if name in rec["crash"]["q7m fused"]["restore_launches"]:
            row["launches_at_crash_restore"] = rec["crash"]["q7m fused"]["restore_launches"][name]
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


def threads_at_exit() -> str:
    """The threads still alive besides this one, counted by name (digits
    dropped) and the line each stands on."""
    frames = sys._current_frames()
    seen: dict = {}
    for t in threading.enumerate():
        if t is threading.current_thread():
            continue
        f = frames.get(t.ident)
        where = f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno} {f.f_code.co_name}" if f else "?"
        key = f"{t.name.rstrip('0123456789-_')} at {where}"
        seen[key] = seen.get(key, 0) + 1
    return "; ".join(f"{n} x {k}" for k, n in sorted(seen.items())) or "none"


if __name__ == "__main__":
    rc = main()
    # A whole run once aborted after printing its result (SIGABRT,
    # "terminate called without an active exception"): the interpreter's
    # teardown destroyed a C++ thread still joinable, or ended a daemon
    # thread inside a torch call. The script names the threads still alive
    # and leaves without that teardown; its files are closed and its
    # children done.
    faulthandler.cancel_dump_traceback_later()
    log(f"threads at exit: {threads_at_exit()}")
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
