#!/usr/bin/env python3
"""Smoke run of the PyTorch port (arroyo_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and the script exits
non-zero, printing no result):

1. probe   -- the card (nvidia-smi name and power limit), torch's CUDA
              version, the device capability (expect (9, 0)), nvcc's version;
2. build   -- the slot-aggregator kernels (arroyo_tpu_torch/csrc/slot_agg.cu)
              with nvcc for sm_90a;
3. q7      -- Nexmark q7 through the port's run_graph on the GPU at the size
              bench.py measures (2,000,000 events, batch 65536, table 65536,
              region 2048), held exactly against a closed-form oracle; each
              kernel's launch count over that run must be > 0. A second,
              profiled run gives the device's busy and idle share;
4. kernels -- every kernel against its plain PyTorch version on the card at
              q7's shape and at a deployment-size state (4,194,304 slots),
              hot and merge mode, k in {1, 2, 4, 8, 16} duplicated bases with
              and without clear, then timed beside its plain version, a
              PyTorch library yardstick and its bound (device time per call
              from a torch.profiler trace, and the per-call time bracketed
              by CUDA events, which adds the host's launch cost).

Then the {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Details go to <out-dir>/chip_smoke.json and
the nvcc/ptxas log to <out-dir>/slot_agg_build.log (``--out-dir``, default
chip_smoke_out/).

The script imports nothing of JAX or arroyo_tpu: the q7 oracle below is its
own copy over the port's generator.
"""

from __future__ import annotations

import argparse
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
from arroyo_tpu_torch.batch import TIMESTAMP_FIELD, Schema
from arroyo_tpu_torch.connectors.nexmark import NexmarkSource
from arroyo_tpu_torch.engine import run_graph
from arroyo_tpu_torch.expr import Col
from arroyo_tpu_torch.graph import EdgeType, Graph, Node, OpName
from arroyo_tpu_torch.ops import kernels
from arroyo_tpu_torch.ops.aggregate import _identity

WIDTH = 10_000_000
Q7_EVENTS = 2_000_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SOURCE = "arroyo_tpu_torch/csrc/slot_agg.cu"
REPLACES = {
    "slot_scatter_combine": "arroyo_tpu/ops/slot_agg.py:285",  # _build_slot_jax step / step_merge
    "slot_region_read_pack": "arroyo_tpu/ops/slot_agg.py:338",  # make_read_multi.go / _pack
    "slot_region_clear": "arroyo_tpu/ops/slot_agg.py:322",  # _clear / clear
}
SUM_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
NP_DT = {torch.int32: np.int32, torch.int64: np.int64,
         torch.float32: np.float32, torch.float64: np.float64}
TIMING_REPS = 30
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
    t0 = time.perf_counter()
    kernels.build_library()
    info = {"phase": "build", "seconds": time.perf_counter() - t0,
            "nvcc_seconds": kernels.build_info["seconds"],
            "cached": kernels.build_info["cached"], "library": kernels.build_info["path"],
            "ptxas": [ln.strip() for ln in kernels.build_info["log"].splitlines()
                      if "registers" in ln or "spill" in ln]}
    with open(os.path.join(out_dir, "slot_agg_build.log"), "w") as f:
        f.write(kernels.build_info["log"])
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


def drive_q7() -> tuple[list, float, object]:
    """One q7 run through the port's run_graph (default device: CUDA)."""
    tcfg.update({
        "pipeline.source-batch-size": 65536,
        "device.batch-capacity": 65536,
        "worker.queue-size": 131072,
        "device.table-capacity": 65536,
        "device.region-size": 2048,
    })
    rows: list = []
    g = build_q7(rows, Q7_EVENTS)
    t0 = time.perf_counter()
    eng = run_graph(g, job_id="chip-smoke-q7", timeout=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if eng.device.type != "cuda":
        raise RuntimeError(f"q7 ran on {eng.device}, not on the GPU")
    return rows, wall, eng


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
    unlaunched = [k for k, v in launches.items() if v == 0]
    if unlaunched:
        raise AssertionError(f"q7 ran without launching {unlaunched}: {launches}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rows_p, wall_p, _eng = drive_q7()
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


# ---------------------------------------------------------------- kernels


def device_us_by_name(prof) -> dict:
    """Device time (us) of every kernel and copy in a profiler trace."""
    return {e.key: e.self_device_time_total for e in prof.key_averages()
            if e.self_device_time_total > 0}


def measure(fn, reps: int = TIMING_REPS) -> dict:
    """``device_ms``: the device time of everything fn launches, per call,
    from a torch.profiler (CUPTI) trace of reps calls -- or, where the trace
    holds no device time, CUDA events around reps back-to-back calls over
    reps (``method`` says which); ``call_ms``: median of per-call CUDA-event
    brackets, i.e. the host's launch cost and the device time together.
    Two warm-up calls first."""
    from torch.profiler import ProfilerActivity, profile

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
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = device_us_by_name(prof)
    out = {"call_ms": statistics.median(times), "device_kernels": sorted(by_name)}
    if by_name:
        out.update(device_ms=sum(by_name.values()) / 1e3 / reps, method="profiler")
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


def lane_err(got, want, kind, abs_sum=None) -> float:
    """max |got - want|; raises unless integer and min/max lanes are exact
    (NaN positions and signed zeros included) and sum lanes are within
    SUM_RTOL * sum|v| per slot."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if not np.issubdtype(w.dtype, np.floating):
        if not np.array_equal(g, w):
            raise AssertionError(f"{kind} lane of {w.dtype} differs from the plain version")
        return 0.0
    nan = np.isnan(w)
    if not np.array_equal(np.isnan(g), nan):
        raise AssertionError(f"{kind} lane of {w.dtype}: NaN positions differ")
    g2, w2 = g[~nan].astype(np.float64), w[~nan].astype(np.float64)
    with np.errstate(invalid="ignore"):  # inf - inf where both hold an identity
        d = np.where(g2 == w2, 0.0, np.abs(g2 - w2))
    if kind in ("sum", "count") and abs_sum is not None:
        tol = SUM_RTOL[got.dtype] * abs_sum.cpu().numpy()[~nan]
        if not np.all(d <= tol):
            raise AssertionError(f"{kind} lane of {w.dtype}: |d| {d.max()} beyond tolerance")
    else:
        ib = np.int64 if w.dtype == np.float64 else np.int32
        if not np.array_equal(g[~nan].view(ib), w[~nan].view(ib)):
            raise AssertionError(f"{kind} lane of {w.dtype} differs from the plain version")
    return float(d.max()) if d.size else 0.0


def check_scatter(rng, lanes, cap, B, merge, dev) -> float:
    kinds = [k for k, _ in lanes]
    st_k = make_state(rng, lanes, cap, dev)
    st_p = [a.clone() for a in st_k]
    abs_sum = [a.abs().double() if a.dtype.is_floating_point else None for a in st_k]
    err = 0.0
    for idx_dt in (np.int32, np.int64):
        slots = zipf_slots(rng, B, cap, idx_dt).to(dev)
        vals = [None if (k == "count" and not merge) else
                torch.from_numpy(make_vals(rng, k, dt, B)).to(dev) for k, dt in lanes]
        kernels.slot_scatter_combine(st_k, kinds, slots, vals)
        kernels.slot_scatter_combine_plain(st_p, kinds, slots, vals)
        keep = slots < cap
        for a, v in zip(abs_sum, vals):
            if a is not None:
                add = (torch.ones(int(keep.sum()), dtype=torch.float64, device=dev)
                       if v is None else v[keep].abs().double())
                a.index_add_(0, slots[keep].long(), add)
    torch.cuda.synchronize()
    for (k, _dt), g, w, a in zip(lanes, st_k, st_p, abs_sum):
        err = max(err, lane_err(g, w, k, a))
    return err


def check_regions(rng, lanes, cap, R, dev) -> float:
    kinds = [k for k, _ in lanes]
    n_regions = cap // R
    for k in (1, 2, 4, 8, 16):
        real = [int(b) * R for b in rng.choice(n_regions, max(1, k - k // 4), replace=False)]
        bases = real + [real[0]] * (k - len(real))
        for do_clear in (False, True):
            st_k = make_state(rng, lanes, cap, dev)
            st_p = [a.clone() for a in st_k]
            ib, fb = kernels.slot_region_read_pack(st_k, bases, R)
            pib, pfb = kernels.slot_region_read_pack_plain(st_p, bases, R)
            if do_clear:
                kernels.slot_region_clear(st_k, kinds, bases, R)
                kernels.slot_region_clear_plain(st_p, kinds, bases, R)
            torch.cuda.synchronize()
            lane_err(ib, pib, "read")
            lane_err(fb, pfb, "read")
            for (kd, _dt), g, w in zip(lanes, st_k, st_p):
                lane_err(g, w, "clear")
    return 0.0


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
    v_lib = [torch.ones(len(s_lib), dtype=dt, device=dev) if v is None else v[keep]
             for (_k, dt), v in zip(lanes, vals)]

    def library_k1():
        for (k, _dt), a, v in zip(lanes, st, v_lib):
            if k in ("sum", "count"):
                a.index_add_(0, s_lib, v)
            else:
                a.scatter_reduce_(0, s_lib, v, "amin" if k == "min" else "amax")

    elem = [a.element_size() for a in st]
    touched = int(torch.unique(s_lib).numel())
    k1_bytes = (B * slots.element_size() + sum(B * e for e, v in zip(elem, vals) if v is not None)
                + 2 * touched * sum(elem))
    out = {"slot_scatter_combine": timed(
        lambda: kernels.slot_scatter_combine(st, kinds, slots, vals),
        lambda: kernels.slot_scatter_combine_plain(st, kinds, slots, vals),
        library_k1,
        library="one index_add_ / scatter_reduce_ per lane, on the in-range rows",
        bytes=k1_bytes, rows=B, touched_slots=touched)}
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
                torch.cat([a.index_select(0, idx).to(torch.int64) for a in ints]) if ints else None,
                torch.cat([a.index_select(0, idx).to(torch.float64) for a in flts]) if flts else None),
            library="index_select + cat per lane class",
            bytes=k * R * sum(elem) + n_out, k=k)
        idents = [_identity(kd, NP_DT[a.dtype]).item() for kd, a in zip(kinds, st)]
        out[f"slot_region_clear_k{k}"] = timed(
            lambda: kernels.slot_region_clear(st, kinds, bases, R),
            lambda: kernels.slot_region_clear_plain(st, kinds, bases, R),
            lambda: [a.index_fill_(0, idx, v) for a, v in zip(st, idents)],
            library="index_fill_ per lane", bytes=k * R * sum(elem), k=k)
    return out


def timed(kernel, plain, library_call, **extra) -> dict:
    """Kernel, plain version and library yardstick measured alike; ``ms``,
    ``plain_ms`` and ``library_ms`` are device times per call, the bound is
    the bytes moved (each input read once, each output written once) over
    the HBM rate."""
    k, p, lib = measure(kernel), measure(plain), measure(library_call)
    return {"ms": k["device_ms"], "plain_ms": p["device_ms"], "library_ms": lib["device_ms"],
            "method": k["method"], "call_ms": k["call_ms"], "plain_call_ms": p["call_ms"],
            "library_call_ms": lib["call_ms"], "kernel_names": k["device_kernels"],
            "bound_ms": extra["bytes"] / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", **extra}


def kernel_phase(dev) -> dict:
    rng = np.random.default_rng(20261017)
    shapes = {
        # q7: max(price), count, and the auction key riding as a max lane
        "q7": dict(lanes=[("max", torch.int64), ("count", torch.int64), ("max", torch.int64)],
                   cap=65536, B=65536, R=2048),
        # a deployment-size keyed state: 4,194,304 slots x 40 B = 168 MB
        "deployment": dict(lanes=[("sum", torch.float64), ("count", torch.int64),
                                  ("min", torch.int64), ("max", torch.float64),
                                  ("max", torch.int32), ("min", torch.float32)],
                           cap=1 << 22, B=65536, R=2048),
    }
    errs = {"slot_scatter_combine": 0.0, "slot_region_read_pack": 0.0, "slot_region_clear": 0.0}
    timing = {}
    for name, sh in shapes.items():
        log(f"kernels: check {name}")
        for merge in (False, True):
            e = check_scatter(rng, sh["lanes"], sh["cap"], sh["B"], merge, dev)
            errs["slot_scatter_combine"] = max(errs["slot_scatter_combine"], e)
        check_regions(rng, sh["lanes"], sh["cap"], sh["R"], dev)
        log(f"kernels: time {name}")
        timing[name] = time_kernels(rng, sh["lanes"], sh["cap"], sh["B"], sh["R"], dev)
    info = {"phase": "kernels", "max_abs_err": errs,
            "shapes": {n: {"cap": s["cap"], "B": s["B"], "R": s["R"],
                           "lanes": [[k, str(d).replace("torch.", "")] for k, d in s["lanes"]]}
                       for n, s in shapes.items()},
            "timing": timing}
    emit(info)
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default="chip_smoke_out",
                    help="directory for chip_smoke.json and the build log")
    out_dir = ap.parse_args(argv).out_dir
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    os.makedirs(out_dir, exist_ok=True)
    log("probe")
    smi, probe_info = probe()
    log("build")
    build_info = build(out_dir)
    log("q7")
    q7 = run_q7()
    log("kernels")
    kern = kernel_phase(torch.device("cuda"))
    log("done")
    q7t = kern["timing"]["q7"]
    rows = []
    for name, key in (("slot_scatter_combine", "slot_scatter_combine"),
                      ("slot_region_read_pack", "slot_region_read_pack_k1"),
                      ("slot_region_clear", "slot_region_clear_k1")):
        t = q7t[key]
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES[name], "launches": q7["launches"][name],
                     "max_abs_err": kern["max_abs_err"][name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"probe": probe_info, "build": build_info, "q7": q7, "kernels": kern,
                   "summary": rows}, f, indent=1)
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
