"""K7's and K13's blocks swept on one card, the measurement behind their
GATHER_THREADS and FREE_THREADS (PERF.md §6).

csrc/slot_agg.cu and csrc/hash_agg.cu are built as they ship but for the
block (``-DGATHER_THREADS=N``, ``-DFREE_THREADS=N``); each build is loaded
in turn as the port's library and called through the port's own wrappers,
first held to their plain versions, then timed as chip_smoke.py times
them (device time of 30 calls from a torch.profiler trace; K13 on a fresh
copy of the occupancy each call). The shipped build is timed beside them.
K7 runs at chip_smoke.py's qu shape and deployment state, K13 on q7's
table (65,536 slots, its 1,215 entries all freed), the hop drive's size,
an empty table, one with nothing to free and 4,194,304 slots.

    python3 tools/block_sweep.py [--out chiprun_out/block_sweep.json]

Run from the root of a checkout, on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from arroyo_tpu_torch.ops import hash_kernels, kernels  # noqa: E402

GATHER_BLOCKS = (64, 128, 256, 512)
FREE_BLOCKS = (64, 128, 256)


def build(name: str, macro: str, block: int) -> str:
    """csrc/<name>.cu as it ships but for ``-D<macro>=<block>``."""
    src = kernels._PKG / "csrc" / f"{name}.cu"
    so = kernels.BUILD_DIR / f"lib{name}_{macro}_{block}_{kernels.source_digest(src)}.so"
    if not so.exists():
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([kernels._find_nvcc(), *kernels.NVCC_FLAGS, f"-D{macro}={block}",
                               "-o", str(so), str(src)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc -D{macro}={block} {src} failed:\n{proc.stderr}")
    return str(so)


@contextlib.contextmanager
def loaded(name: str, so, bind):
    """The port's wrappers call the library at ``so`` (None: the shipped
    build) while the block is open."""
    if so is None:
        yield
        return
    shipped = kernels._libs.pop(name, None)
    lib = ctypes.CDLL(so)
    bind(lib)
    kernels._libs[name] = lib
    try:
        yield
    finally:
        kernels._libs.pop(name, None)
        if shipped is not None:
            kernels._libs[name] = shipped


def gather(builds, rng, dev) -> dict:
    qu_dt = [getattr(torch, d) for d in cs.qu_lanes()]
    out = {}
    for shape, (dts, cap, k) in {"qu": (qu_dt, cs.QU_CAP, cs.qu_touched_keys()),
                                 "deployment": ([torch.int64] * 4, 1 << 24, 1 << 20)}.items():
        st = cs.gather_state(rng, dts, cap, dev)
        slots = torch.from_numpy(rng.integers(0, cap, k).astype(np.int32)).to(dev)
        want = [w.view(torch.int64) for w in kernels.slot_gather_plain(st, slots)]
        res = {}
        for label, so in builds:
            with loaded("slot_agg", so, kernels._bind_slot_agg):
                got = [g.view(torch.int64) for g in kernels.slot_gather(st, slots)]
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"K7 built with {label} differs at {shape}")
                res[label] = cs.measure(lambda: kernels.slot_gather(st, slots))["device_ms"]
        out[shape] = {"k": k, "cap": cap, "ms": res}
        cs.log(f"block_sweep: K7 at {shape}: {res}")
    return out


def free(builds, rng, dev) -> dict:
    def table(cap, n_occ, n_bins, below):
        occ = torch.zeros(cap, dtype=torch.bool)
        occ[torch.from_numpy(rng.choice(cap, n_occ, replace=False))] = True
        bins = torch.from_numpy(rng.integers(0, n_bins, cap).astype(np.int32))
        return bins.to(dev), occ.to(dev), below

    out = {}
    for name, (bins, occ, below) in {
            "65536, 1215 occupied, all freed": table(65536, 1215, 1, 1),
            "32768, 1600 occupied, a fifth freed": table(32768, 1600, 5, 1),
            "65536, empty": table(65536, 0, 1, 1),
            "65536, 1215 occupied, none freed": table(65536, 1215, 1, 0),
            "4194304, 30% occupied, a quarter freed": table(1 << 22, 1258291, 4, 1)}.items():
        want = occ & (bins >= below)
        res = {}
        for label, so in builds:
            with loaded("hash_agg", so, hash_kernels._bind):
                o = occ.clone()
                hash_kernels.free_below(bins, o, below)
                torch.cuda.synchronize()
                if not torch.equal(o, want):
                    raise AssertionError(f"K13 built with {label} differs at {name}")
                res[label] = cs.time_fresh(lambda b, o: hash_kernels.free_below(b, o, below),
                                           lambda: (bins, occ.clone()), cs.TIMING_REPS)["device_ms"]
        out[name] = res
        cs.log(f"block_sweep: K13 at {name}: {res}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chip_smoke_out/block_sweep.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("block_sweep: no GPU", file=sys.stderr)
        return 2
    dev, rng = torch.device("cuda"), np.random.default_rng(20261017)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    jobs = [("slot_agg", "GATHER_THREADS", b) for b in GATHER_BLOCKS] + \
           [("hash_agg", "FREE_THREADS", b) for b in FREE_BLOCKS]
    with ThreadPoolExecutor(len(jobs)) as ex:
        sos = list(ex.map(lambda j: build(*j), jobs))
    kernels.build_library()
    hash_kernels.build_library()
    gb = [("shipped", None)] + [(f"{b} threads", so) for (_n, _m, b), so in zip(jobs, sos)
                                if _m == "GATHER_THREADS"]
    fb = [("shipped", None)] + [(f"{b} threads", so) for (_n, _m, b), so in zip(jobs, sos)
                                if _m == "FREE_THREADS"]
    res = {"card": smi, "gather_ms": gather(gb, rng, dev), "free_ms": free(fb, rng, dev)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
