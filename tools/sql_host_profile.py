"""Where the host's time goes in a SQL-planned Nexmark run on the card: the
run of chip_smoke.py's sql phase (the port's plan_query, bench.py's sizes,
a single_file JSON sink), or with ``q7nats`` its connectors phase (q7 over
chip_smoke's NATS broker into its webhook receiver), or with ``q7m`` and
``q7m_slots`` the hand-built q7 through the fused 8-shard mesh in one device
slot and in chip_smoke's 4 slots on cuda:0, sampled every few milliseconds
across all threads.

A sampling thread reads every other thread's stack (``sys._current_frames``)
at each tick and counts, per function, the samples where it is on top of a
stack ("self") and where it is anywhere on a stack ("inclusive"). Threads
parked in a wait (a queue get, a sleep, a lock) are counted apart, so the
shares are of the samples that were doing work. The sampler holds the
interpreter lock while it reads, so the run is somewhat slower than
unsampled.

usage: python3 tools/sql_host_profile.py [--queries q5,q7,q7nats,q7m,q7m_slots]
       [--interval-ms 2]
       [--out chiprun_out/sql_host_profile.json]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAITS = {"wait", "get", "sleep", "acquire", "_wait_for_tstate_lock", "join", "select",
         "poll", "synchronize"}


def label(code) -> str:
    return f"{os.path.relpath(code.co_filename, ROOT)}:{code.co_firstlineno} {code.co_name}"


def sample(stop: threading.Event, interval_s: float, out: dict) -> None:
    me = threading.get_ident()
    self_c, incl_c = Counter(), Counter()
    busy = waiting = 0
    while not stop.is_set():
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            if frame.f_code.co_name in WAITS:
                waiting += 1
                continue
            busy += 1
            self_c[label(frame.f_code)] += 1
            seen = set()
            f = frame
            while f is not None:
                lab = label(f.f_code)
                if lab not in seen:
                    seen.add(lab)
                    incl_c[lab] += 1
                f = f.f_back
        time.sleep(interval_s)
    out.update(busy=busy, waiting=waiting, self=self_c, inclusive=incl_c)


def report_of(res: dict, events: int, wall: float, card: str, name: str) -> dict:
    busy = max(res["busy"], 1)
    print(f"{name}: {wall} s, {res['busy']} busy samples [{card}]")
    for k, v in res["self"].most_common(12):
        print(f"  self {v / busy:.4f} {k}")
    return {"events": events, "wall_s": wall, "busy_samples": res["busy"],
            "waiting_samples": res["waiting"],
            "self_share": {k: v / busy for k, v in res["self"].most_common(25)},
            "inclusive_share": {k: v / busy for k, v in res["inclusive"].most_common(40)}}


def nats_profile(cs, interval_s: float, card: str) -> dict:
    """chip_smoke's connectors run sampled, after a 20,000-event run of the
    same plan (which compiles K4)."""
    cs.nats_q7_run(20_000, "sql-profile-q7nats-warm")
    res: dict = {}
    stop = threading.Event()
    th = threading.Thread(target=sample, args=(stop, interval_s, res))
    th.start()
    try:
        r = cs.nats_q7_run(cs.CONNECTORS_EVENTS, "sql-profile-q7nats")
    finally:
        stop.set()
        th.join()
    out = report_of(res, cs.CONNECTORS_EVENTS, r["wall"], card, "q7nats")
    out["stream_s"] = r["stream_s"]
    out["rows"] = len(r["lines"])
    return out


def mesh_profile(cs, interval_s: float, card: str, slots: int) -> dict:
    """q7 at bench.py's sizes through the fused 8-shard mesh over ``slots``
    slots on cuda:0, sampled, after a short run of the same setting (K4's
    build for its plan)."""
    extra = {"device.mesh-devices": cs.MESH_N, "segment.compile.mesh-fuse": True,
             "device.mesh-placement": ["cuda:0"] * slots}
    name = "q7m" if slots == 1 else "q7m_slots"
    cs.drive(cs.build_q7, 2 * cs.BENCH_BATCH, f"host-profile-{name}-warm", chaining=True,
             extra=extra)
    res: dict = {}
    stop = threading.Event()
    th = threading.Thread(target=sample, args=(stop, interval_s, res))
    th.start()
    try:
        rows, wall, _eng = cs.drive(cs.build_q7, cs.Q7_EVENTS, f"host-profile-{name}",
                                    chaining=True, extra=extra)
    finally:
        stop.set()
        th.join()
    cs.check_q7(rows, cs.oracle_q7(cs.Q7_EVENTS))
    return report_of(res, cs.Q7_EVENTS, wall, card, name)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", default="q5,q7")
    ap.add_argument("--interval-ms", type=float, default=2.0)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "sql_host_profile.json"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from arroyo_tpu_torch.engine import run_graph
    from arroyo_tpu_torch.sql import plan_query

    if not torch.cuda.is_available():
        print("sql_host_profile: no GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    report = {"card": card, "interval_ms": args.interval_ms, "queries": {}}
    root = tempfile.mkdtemp(prefix="sql_host_profile_")
    for name in args.queries.split(","):
        if name == "q7nats":
            report["queries"][name] = nats_profile(cs, args.interval_ms / 1e3, card)
            continue
        if name in ("q7m", "q7m_slots"):
            report["queries"][name] = mesh_profile(cs, args.interval_ms / 1e3, card,
                                                   1 if name == "q7m" else cs.MESH_SLOTS)
            continue
        events = cs.SQL_EVENTS[name]
        cs.bench_config(chaining=True, queue_mult=1 if name == "q8" else 2)
        # a first run compiles K4 for the plan; the sampled run reuses it
        for tag in ("warm", "sampled"):
            out = os.path.join(root, f"{name}-{tag}.json")
            g = plan_query(cs.nexmark_sql(name, events, out)).graph
            res: dict = {}
            stop = threading.Event()
            th = threading.Thread(target=sample, args=(stop, args.interval_ms / 1e3, res))
            if tag == "sampled":
                th.start()
            t0 = time.perf_counter()
            run_graph(g, job_id=f"sql-profile-{name}-{tag}", timeout=900)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if tag == "sampled":
                stop.set()
                th.join()
        report["queries"][name] = report_of(res, events, wall, card, name)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
