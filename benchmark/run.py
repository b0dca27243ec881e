#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in ``BENCHMARK.json`` and in
``benchmark/workloads/<cell>.json`` (its configuration, chips and traffic),
the configuration in ``benchmark/configs/<config>.json`` (the system's
settings, the query, the stream), the query in ``benchmark/queries/``, the
generator in ``benchmark/gen/``, each metric's reader in
``benchmark/metrics/<metric>.py`` and each kernel's bytes in
``benchmark/rooflines/<kernel>.py``.

A run: set-up (imports, the system's libraries from its caches, a bounded
warm-up job of the same graph and traffic, the measured job started), then
``--seconds`` of measured window, then the stream ends, every window result
is drained, and the results are compared with the plain reference over the
same events. The last line of standard output is the result as JSON; the
numbers compared, each beside its limit, are the last lines of standard
error.
"""

from __future__ import annotations

import time

_T_MAIN = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "arroyo_tpu")
JOB = "benchmark"
JOIN_TIMEOUT_S = 120.0


class NoChip(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def process_start() -> float:
    """This process's start on the ``perf_counter`` clock (to 10 ms), from
    its start tick and the uptime; the module's first line where /proc
    cannot tell."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age if 0 <= age < 600 else _T_MAIN
    except (OSError, ValueError, IndexError):
        return _T_MAIN


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spec(cell: str, root: Path = ROOT) -> dict:
    """The cell as BENCHMARK.json names it, with its workload and
    configuration files and the metrics that apply to it."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"no cell {cell!r} in BENCHMARK.json")
    work = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    for k in ("config", "traffic", "chips"):
        if work[k] != entry[k]:
            raise SystemExit(f"{cell}: workloads/{cell}.json says {k} {work[k]!r}, "
                             f"BENCHMARK.json {entry[k]!r}")
    conf = json.loads((BENCH / "configs" / f"{entry['config']}.json").read_text())

    def applies(m):
        return "workloads" not in m or cell in m["workloads"]

    return {"cell": cell, "entry": entry, "workload": work, "config": conf,
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run(cell: str, seed: int, seconds: float, trace: bool, device=None,
        overrides: dict = None, root: Path = ROOT, fault=None, control: str = None,
        stream_overrides: dict = None):
    """One run of ``cell``. ``device`` None runs on the cards and requires
    them; a test passes "cpu" (with smaller ``overrides`` of the system's
    settings and ``stream_overrides`` of the configuration's stream).
    ``fault(stage)``, for the tests, is called once the warm-up is done
    and may break the system underneath. ``control`` names one of the
    query's controls, whose rows replace the system's in the comparison
    (the system's own are compared too, into the record's
    ``system_checks``). Returns the result line, the compared numbers and
    the run's record."""
    t_start = process_start()
    spec = load_spec(cell, root)
    work, conf = spec["workload"], spec["config"]
    chips = int(spec["entry"]["chips"])
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(root))
    import system

    os.environ.update(system.cache_dirs(root))
    import torch

    on_cards = device is None
    if on_cards and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        raise NoChip(f"{cell} needs {chips} CUDA card(s); torch sees "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    cards = list(range(torch.cuda.device_count())) if on_cards else []
    kind = torch.cuda.get_device_name(0) if on_cards else "cpu"
    system.register_connectors()
    from arroyo_tpu_torch.engine.engine import Engine

    t_imported = time.perf_counter()

    from gen.feed import Feed

    query = load_module(BENCH / "queries" / f"{conf['query']}.py", f"benchmark_query_{conf['query']}")
    stream = {**conf["stream"], **(stream_overrides or {})}
    genmod = load_module(BENCH / "gen" / f"{stream['generator']}.py",
                         f"benchmark_gen_{stream['generator']}")
    settings = {**conf["settings"], **(overrides or {})}
    batch = int(settings["pipeline.source-batch-size"])
    rate = float(work.get("rate_events_per_s", 0.0))  # above 0: the open loop
    poll_s = float(work["poll_ms"]) / 1e3 if "poll_ms" in work else Feed.POLL_S
    width = int(conf["window_micros"])
    per_window = width // int(stream["inter_event_micros"])

    def generator():
        return genmod.make(seed, stream, query.COLUMNS)

    def graph(feed, arrivals):
        from gen.connector import SINK, SOURCE

        return query.build_graph({"connector": SOURCE, "feed": feed},
                                 {"connector": SINK, "arrivals": arrivals}, width)

    storage = tempfile.mkdtemp(prefix="benchmark-checkpoints-")
    checks: list = []
    record: dict = {"cell": cell, "seed": seed, "seconds": seconds, "traced": trace,
                    "chips": chips, "settings": settings, "workload": work, "config": conf,
                    "device_kind": kind}
    eng = None
    try:
        system.configure(settings, storage)
        # set-up: the same graph and traffic, bounded, once through
        warm = Feed(generator(), batch, rate, poll_s,
                    limit=int(work["warmup_events"]))
        warm.start()
        Engine(graph(warm, []), job_id=JOB + "-warmup", device=device).run_to_completion(
            JOIN_TIMEOUT_S)
        t_warm = time.perf_counter()
        if fault is not None:
            fault("setup")
        feed = Feed(generator(), batch, rate, poll_s)
        arrivals: list = []
        eng = Engine(graph(feed, arrivals), job_id=JOB, device=device)
        eng.start()
        capture = None
        if trace and on_cards:
            from devtrace import Capture

            capture = Capture(cards)
        t_go = feed.start()
        ws = t_go + float(work["lead_in_s"])
        if capture is not None:
            time.sleep(max(0.0, ws - 0.5 - time.perf_counter()))
            capture.start()
        time.sleep(max(0.0, ws - time.perf_counter()))
        before = {"launches": system.launch_counts(), "self": system.self_time(JOB),
                  "cpu": system.self_time(JOB, "self_cpu"), "mesh": system.mesh_counts()}
        ws, ws_ns = time.perf_counter(), time.time_ns()
        setup_s = ws - t_start
        record["setup_phases_s"] = {"imports": t_imported - t_start, "warmup": t_warm - t_imported,
                                    "job_start": t_go - t_warm, "lead_in": ws - t_go}
        we = ws + seconds
        interval = float(conf["checkpoint_interval_s"])
        epochs = []
        k = 0
        while ws + k * interval < we:
            time.sleep(max(0.0, ws + k * interval - time.perf_counter()))
            epochs.append(k + 1)
            eng.trigger_checkpoint(k + 1)
            k += 1
        time.sleep(max(0.0, we - time.perf_counter()))
        we, we_ns = time.perf_counter(), time.time_ns()
        after = {"launches": system.launch_counts(), "self": system.self_time(JOB),
                 "cpu": system.self_time(JOB, "self_cpu"), "mesh": system.mesh_counts()}
        raw_trace = capture.stop() if capture is not None else None
        if rate:
            # the windows due in the window close in the normal way: the
            # stream runs on, on schedule, until two more windows are due
            feed.finish(int((we - feed.t0) * rate) + 2 * per_window)
        else:
            feed.finish()
        eng.join(JOIN_TIMEOUT_S)
        t_drained = time.perf_counter()
        record["memory_peak_bytes"] = max(
            (torch.cuda.max_memory_allocated(d) for d in cards), default=0)
        record["checkpoints"] = {e: eng.checkpoint_timeline(e) for e in epochs}
        record["segment_events"] = system.segment_events(JOB)
        eng = None
        gc.collect()
        if on_cards:
            torch.cuda.empty_cache()
        events_total = feed.emissions[-1][1] if feed.emissions else 0
        record.update({
            "setup_s": setup_s, "window_s": we - ws,
            "events_in_window": feed.emitted_at(we) - feed.emitted_at(ws),
            "batches_in_window": sum(1 for t, _n in feed.emissions if ws <= t < we),
            "events_total": events_total,
            "launches": {k: after["launches"][k] - before["launches"].get(k, 0)
                         for k in after["launches"]},
            "self_time_s": {k: v - before["self"].get(k, 0.0) for k, v in after["self"].items()},
            "self_cpu_s": {k: v - before["cpu"].get(k, 0.0) for k, v in after["cpu"].items()},
            "mesh": {k: after["mesh"][k] - before["mesh"].get(k, 0) for k in after["mesh"]},
            "generator_lags_s": [lag for t, lag in feed.lags_s if ws <= t < we],
            "rate_events_per_s": rate,
        })
        if rate:
            record["latencies_s"] = query.latencies(feed, arrivals, width, ws, we)
            # events due but not yet emitted, at the window's start and end
            record["backlog_events"] = [(t - feed.t0) * rate - feed.emitted_at(t) for t in (ws, we)]
        if raw_trace is not None:
            from devtrace import reduce

            record["trace"] = reduce(raw_trace, ws_ns, we_ns, cards)
        # the reference, after the window and with the system's state freed
        cum = [0] + [n for _t, n in feed.emissions]
        all_bounds = list(zip(cum[:-1], cum[1:]))
        got = query.collect(arrivals)
        arrivals.clear()
        if control:
            own = query.compare(got, generator(), events_total, width, seed)
            record["system_checks"] = query.checks(own)
            got = query.control(control, generator(), events_total, width, all_bounds)
        cmp = query.compare(got, generator(), events_total, width, seed)
        if trace:  # the rooflines' shapes of work, for the traced run's readers
            bounds = [b for b, (t, _n) in zip(all_bounds, feed.emissions) if ws <= t < we]
            record["shape"] = query.shape(generator(), bounds, width)
        record["compare"] = cmp
        record["post_phases_s"] = {"drain": t_drained - we, "compare": time.perf_counter() - t_drained}
        compared = query.checks(cmp)
        checks += compared
        checks.append(("segment_fallbacks", record["segment_events"]["SEGMENT_FALLBACK"], 0))
        if int(settings.get("device.mesh-devices", 0)) > 1 and settings.get(
                "segment.compile.mesh-fuse", True):
            checks.append(("mesh_host_steps", record["mesh"].get("aggregate_host_steps", 0), 0))
        attempted = cmp["rows_total"]
        failed = sum(v for _k, v, _lim in compared)
    except Exception:  # a job that fails is reported as not correct, with its error
        print(traceback.format_exc(), file=sys.stderr)
        checks.append(("job_failed", 1, 0))
        attempted, failed = record.get("compare", {}).get("rows_total", 0), 1
        if eng is not None:
            eng.stop()
            try:
                eng.join(30.0)
            except Exception:  # already reported above
                pass
    finally:
        shutil.rmtree(storage, ignore_errors=True)

    metrics = read_metrics(spec, record, trace) if "events_in_window" in record else {}
    dev = {"platform": "gpu" if on_cards else "cpu",
           "kind": kind,
           "count": chips, "memory_peak_bytes": int(record.get("memory_peak_bytes", 0))}
    result = {"correct": all(v <= lim for _k, v, lim in checks) and bool(checks),
              "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
              "device": dev}
    if trace and "trace" in record:
        tr = record["trace"]
        dev["busy_s"] = sum(tr["busy_s"][c] for c in range(chips)) / chips
        dev["window_s"] = tr["window_s"]
        top = sorted(tr["device_s_by_name"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[n, s] for n, s in top],
                               "idle_gaps": tr["idle_gaps"][:10]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    record["result"] = result
    return result, checks, record


def read_metrics(spec: dict, record: dict, trace: bool) -> dict:
    """Each metric that applies to the cell, from its reader; a reader
    that finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in spec["per_layer"] if trace else spec["end_to_end"]:
        reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                             "benchmark_metric_" + m["name"].replace(".", "_"))
        v = reader.read(record)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", help="compare one of the query's controls in place of the "
                    "system's results (it has to come out not correct)")
    args = ap.parse_args()
    try:
        result, checks, record = run(args.workload, args.seed, args.seconds, bool(args.trace),
                                     control=args.control)
    except NoChip as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {bad}, which the system under test must "
              f"not import", file=sys.stderr)
        return 3
    for line in notes(record):
        print(line, file=sys.stderr)
    for k, v, lim in checks:
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def notes(record: dict) -> list:
    """The lines printed before the checks: the card and its power limit,
    the phases of set-up and after the window, each task's profiler self
    time (wall and thread CPU) in the window, the work's shape, what a
    tail was taken over, each card's own idle share, the profiler's launch
    count beside the library's, and in a control's run the system's own
    compared numbers."""
    from metrics._common import quantile

    out = [f"card: {power_limit()}" if record.get("chips") and
           record["result"]["device"]["platform"] == "gpu" else "card: none (cpu run)"]
    for key in ("setup_phases_s", "post_phases_s", "self_time_s", "self_cpu_s", "shape"):
        if record.get(key):
            out.append(f"{key}: {json.dumps(record[key])}")
    lat = record.get("latencies_s")
    if lat:
        out.append(f"result latency: median {quantile(lat, 0.5) * 1e3} ms over {len(lat)} windows")
    lags = record.get("generator_lags_s")
    if lags:
        out.append(f"generator lag: median {quantile(lags, 0.5) * 1e3} ms over {len(lags)} polls")
    for k, v, lim in record.get("system_checks", ()):
        out.append(f"system check {k} {v} limit {lim}")
    tr = record.get("trace")
    if tr:
        for c, b in sorted(tr["busy_s"].items()):
            out.append(f"card {c}: idle share {100.0 * (1 - b / tr['window_s'])} %")
        from metrics.kernel_roofline_share import rooflines

        ours = {k for mod in rooflines() for k in mod.KERNELS}
        traced = sum(c for k, c in tr["count_by_name"].items()
                     if k in ours or k.split("<", 1)[0] in ours)
        out.append(f"launches of the kernels with a roofline in the window: library "
                   f"{sum(record['launches'].values())} (every kernel), profiler {traced}")
    return out


if __name__ == "__main__":
    sys.exit(main())
