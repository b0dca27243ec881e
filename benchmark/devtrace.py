"""The device trace of a traced run: taken with torch.profiler (CUPTI), kept
as plain lists, and reduced to busy time, idle gaps and time by operation.

Times are the profiler's, in ns of the wall clock (``time.time_ns``), so
the harness clips them to its own window.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict

_TEMPLATE = re.compile(r"<([^<>]*)>")
_VALUE_ARGS = re.compile(r"^\s*(-?\d+|true|false)(\s*,\s*(-?\d+|true|false))*\s*$")


def short_name(name: str) -> str:
    """A kernel's name without its return type, parameters and template
    arguments that are types: ``void ns::k<4, int>(int*)`` -> ``ns::k``,
    ``void k<true, 3>(int*)`` -> ``k<true,3>``."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    s = name
    while True:
        t = _TEMPLATE.sub(lambda m: f"\x00{m.group(1).replace(' ', '')}\x01" if _VALUE_ARGS.match(m.group(1)) else "", s)
        if t == s:
            break
        s = t
    s = s.split("(", 1)[0].strip().replace("\x00", "<").replace("\x01", ">")
    if s.startswith("void "):
        s = s[5:]
    return s.split(" ")[-1] or name


class Capture:
    """The profiler around a window: ``start()`` before it, ``stop()``
    after it (the devices synchronised first)."""

    def __init__(self, devices):
        self.devices = list(devices)
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> dict:
        import torch

        for d in self.devices:
            torch.cuda.synchronize(d)
        time.sleep(0.05)
        self.prof.stop()
        device, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            if str(e.device_type()).endswith("CUDA"):
                device.append((e.device_index(), start, end, e.name()))
            else:
                host.append((e.start_thread_id(), start, end, e.name()))
        self.prof = None
        return {"device": device, "host": host}


def merged(intervals):
    """Sorted, overlapping intervals merged."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce(trace: dict, lo_ns: int, hi_ns: int, cards) -> dict:
    """Busy seconds a card (the union of its device operations inside the
    window), device seconds and count by operation name, host seconds by
    operation name, and the ten longest idle gaps between operations on
    each card, each labelled with the host operation and the CUDA runtime
    call that overlap it most (with the share of the gap they cover) and
    the device operation that ends it."""
    per_card = defaultdict(list)
    by_name = defaultdict(float)
    count = defaultdict(int)
    ops = []
    for dev, a, b, name in trace["device"]:
        a, b = max(a, lo_ns), min(b, hi_ns)
        if b <= a:
            continue
        per_card[dev].append((a, b))
        n = short_name(name)
        by_name[n] += (b - a) / 1e9
        count[n] += 1
        ops.append((dev, a, b, n))
    host_s = defaultdict(float)
    for _tid, a, b, name in trace["host"]:
        a, b = max(a, lo_ns), min(b, hi_ns)
        if b > a:
            host_s[name] += (b - a) / 1e9
    busy = {}
    gaps = []
    for card in cards:
        m = merged(per_card.get(card, []))
        busy[card] = sum(b - a for a, b in m) / 1e9
        edges = [lo_ns] + [x for iv in m for x in iv] + [hi_ns]
        for i in range(0, len(edges), 2):
            a, b = edges[i], edges[i + 1]
            if b > a:
                gaps.append((card, a, b))
    gaps.sort(key=lambda g: g[1] - g[2])
    top = gaps[:10]
    starts = sorted((a, dev, n) for dev, a, _b, n in ops)
    labels = []
    for card, a, b in top:
        ops, runtime = defaultdict(int), defaultdict(int)
        for _tid, ha, hb, name in trace["host"]:
            o = min(b, hb) - max(a, ha)
            if o > 0:
                (runtime if name.startswith("cuda") else ops)[name] += o
        parts = [(max(d, key=d.get), d[max(d, key=d.get)] / (b - a)) for d in (ops, runtime) if d]
        host = "; ".join(f"{name} over {100 * share:.0f}% of it" for name, share in parts
                         if share >= 0.01) or "no operation traced (Python between calls)"
        nxt = next((n for s, dev, n in starts if dev == card and s >= b), "the window's end")
        labels.append([f"card {card}: host {host}; then {nxt}", (b - a) / 1e9])
    top_host = dict(sorted(host_s.items(), key=lambda kv: -kv[1])[:30])
    return {"busy_s": busy, "window_s": (hi_ns - lo_ns) / 1e9,
            "device_s_by_name": dict(by_name), "count_by_name": dict(count),
            "idle_gaps": labels, "host_s_by_name": top_host}
