"""NEXMark q7 as the benchmark runs it: bids -> tumbling 10 s windows ->
MAX(price) and COUNT per auction.

``build_graph`` builds the job for the system under test (its modules are
imported inside it, so the reference below runs without them).
``reference`` is the plain NumPy computation of the same windows over the
same events; ``compare`` holds the system's results to it.
"""

from __future__ import annotations

import numpy as np

COLUMNS = ("bid.auction", "bid.price")  # what the generator makes for it
RESULT = ("window_start", "auction", "max_price", "bids")
MIN_PRICE = 100  # the generator's least price


def build_graph(source_cfg: dict, sink_cfg: dict, width_micros: int):
    """bids -> watermark (1 s of event time between emissions) -> key by
    auction -> shuffle -> tumbling window -> sink."""
    from arroyo_tpu_torch.batch import TIMESTAMP_FIELD, Schema
    from arroyo_tpu_torch.expr import Col
    from arroyo_tpu_torch.graph import EdgeType, Graph, Node, OpName

    S = Schema.of([("x", "int64"), (TIMESTAMP_FIELD, "int64")])
    g = Graph()
    g.add_node(Node("src", OpName.SOURCE, source_cfg, 1))
    g.add_node(Node("bids", OpName.VALUE, {
        "projections": [("auction", Col("bid.auction")), ("price", Col("bid.price"))],
        "filter": Col("bid")}, 1))
    g.add_node(Node("wm", OpName.WATERMARK, {
        "expr": Col(TIMESTAMP_FIELD), "interval_micros": 1_000_000}, 1))
    g.add_node(Node("key", OpName.KEY, {"keys": [("auction", Col("auction"))]}, 1))
    g.add_node(Node("agg", OpName.TUMBLING_AGGREGATE, {
        "width_micros": width_micros, "key_fields": ["auction"],
        "aggregates": [("max_price", "max", Col("price")), ("bids", "count", None)],
        "input_dtype_of": lambda e: np.dtype(np.int64)}, 1))
    g.add_node(Node("sink", OpName.SINK, sink_cfg, 1))
    for a, b, kind in (("src", "bids", EdgeType.FORWARD), ("bids", "wm", EdgeType.FORWARD),
                       ("wm", "key", EdgeType.FORWARD), ("key", "agg", EdgeType.SHUFFLE),
                       ("agg", "sink", EdgeType.FORWARD)):
        g.add_edge(a, b, kind, S)
    return g


def _windows(gen, lo: int, hi: int, width_micros: int) -> dict:
    """The windows of events [lo, hi), as sorted key arrays and values: one
    sort of (window, auction, price) packed into an int64 (the window
    relative to the first, 7 bits; the auction, 32; the price, 24), each
    group's MAX its run's last price."""
    ev = gen.events(lo, hi)
    bid = ev["bid"]
    w = ev["_timestamp"][bid] // width_micros
    if not len(w):
        return {k: np.empty(0, np.int64) for k in RESULT}
    w0 = int(w[0])
    au = ev["bid.auction"][bid]
    price = ev["bid.price"][bid] - MIN_PRICE
    if int(w[-1]) - w0 >= 1 << 7 or int(au.max()) >= 1 << 32 or int(price.max()) >= 1 << 24:
        raise ValueError("a chunk's windows, auctions or prices do not fit the packed sort key")
    key = ((w - w0) << 56) | (au << 24) | price
    key.sort()
    code = key >> 24
    start = np.flatnonzero(np.r_[True, code[1:] != code[:-1]])
    last = np.r_[start[1:], len(key)] - 1
    return {"window_start": ((code[start] >> 32) + w0) * width_micros,
            "auction": code[start] & 0xFFFFFFFF,
            "max_price": (key[last] & 0xFFFFFF) + MIN_PRICE,
            "bids": np.diff(np.r_[start, len(key)]).astype(np.int64)}


def reference(gen, n_events: int, width_micros: int, chunk_windows: int = 100) -> dict:
    """q7 over events [0, n_events), in chunks of whole windows (events of
    one window never straddle two chunks), rows sorted by window then
    auction. A window the stream ends inside holds the events it got."""
    per_window = width_micros // gen.inter_event_micros
    if per_window * gen.inter_event_micros != width_micros or gen.first_event_micros % width_micros:
        raise ValueError("the reference chunks by whole windows: the window must hold a whole "
                         "number of events and the stream start on a window boundary")
    step = per_window * chunk_windows
    parts = [_windows(gen, lo, min(lo + step, n_events), width_micros)
             for lo in range(0, n_events, step)]
    if not parts:
        return {k: np.empty(0, np.int64) for k in RESULT}
    return {k: np.concatenate([p[k] for p in parts]) for k in RESULT}


def _merge(parts: list) -> dict:
    """Rows of several results combined by (window, auction): MAX of the
    maxima, sum of the counts."""
    r = {k: np.concatenate([p[k] for p in parts]) for k in RESULT}
    order = np.lexsort((r["auction"], r["window_start"]))
    r = {k: v[order] for k, v in r.items()}
    ws, au = r["window_start"], r["auction"]
    start = np.flatnonzero(np.r_[True, (ws[1:] != ws[:-1]) | (au[1:] != au[:-1])])
    return {"window_start": ws[start], "auction": au[start],
            "max_price": np.maximum.reduceat(r["max_price"], start),
            "bids": np.add.reduceat(r["bids"], start)}


CONTROLS = ("at_least_once",)


def control(name: str, gen, n_events: int, width_micros: int, bounds: list) -> dict:
    """The reference put in the system's place with one of the
    configuration's guarantees broken. ``at_least_once``: one batch the
    source emitted (``bounds``: each batch's [first event, end)), the one in
    the middle of the run, delivered twice, as a source that restores an
    older offset would."""
    if name != "at_least_once":
        raise ValueError(f"no control {name!r} (have {CONTROLS})")
    lo, hi = bounds[len(bounds) // 2]
    return _merge([reference(gen, n_events, width_micros), _windows(gen, lo, hi, width_micros)])


def collect(arrivals: list) -> dict:
    """The system's result rows, as arrays in arrival order."""
    if not arrivals:
        return {k: np.empty(0, np.int64) for k in RESULT}
    return {k: np.concatenate([np.asarray(cols[k], dtype=np.int64) for _t, cols in arrivals])
            for k in RESULT}


def _bids_below(x: int) -> int:
    """Bids among event numbers [0, x): offsets 4-49 of every 50."""
    return (x // 50) * 46 + max(0, x % 50 - 4)


def _groups(gen, lo: int, hi: int, width_micros: int) -> int:
    """Distinct (window, auction) pairs among the bids of events [lo, hi)."""
    ev = gen.events(lo, hi)
    bid = ev["bid"]
    return len(np.unique(_codes(ev["_timestamp"][bid], ev["bid.auction"][bid], width_micros)))


def shape(gen, bounds: list, width_micros: int, samples: int = 16, window_samples: int = 2) -> dict:
    """The work of a window for the rooflines: its batches (``bounds``,
    each [first event, end)), events and bids; the (window, auction) groups
    the batches touch, summed over batches; the windows that close in it
    (their last event inside it) and their groups. Group counts are exact
    on up to ``samples`` batches and ``window_samples`` windows spread over
    the window, scaled to all of them."""
    if not bounds:
        return {}
    per_window = width_micros // gen.inter_event_micros
    n_lo, n_hi = bounds[0][0], bounds[-1][1]
    closing = list(range(n_lo // per_window, n_hi // per_window))  # window w ends at (w + 1) * per_window
    batch_groups = [_groups(gen, lo, hi, width_micros)
                    for lo, hi in bounds[:: max(1, len(bounds) // samples)][:samples]]
    window_groups = [_groups(gen, w * per_window, (w + 1) * per_window, width_micros)
                     for w in closing[:: max(1, len(closing) // window_samples)][:window_samples]]
    return {"batches": len(bounds), "events": n_hi - n_lo,
            "bids": sum(_bids_below(hi) - _bids_below(lo) for lo, hi in bounds),
            "batch_groups": sum(batch_groups) / len(batch_groups) * len(bounds),
            "windows_closed": len(closing),
            "close_groups": (sum(window_groups) / len(window_groups) * len(closing)
                             if window_groups else 0)}


def _codes(window_start, auction, width_micros: int) -> np.ndarray:
    """One sortable int64 a (window, auction) pair: window index, auction."""
    return (np.asarray(window_start) // width_micros) * (1 << 32) + np.asarray(auction)


def compare(got: dict, gen, n_events: int, width_micros: int, seed: int,
            samples: int = 2) -> dict:
    """The system's rows against the stream of events [0, n_events).

    Over every row: each (window, auction) emitted once, each window of
    the stream emitted, and each window's counts summing to its bids
    (``bids_miscounted``: the sum over windows of the gap). Over the first
    and the last window and ``samples`` more drawn from the seed: every row
    equal to the reference's, none missing, none extra."""
    per_window = width_micros // gen.inter_event_micros
    if per_window * gen.inter_event_micros != width_micros or gen.first_event_micros % width_micros:
        raise ValueError("windows must hold a whole number of events, the stream start on a boundary")
    first_w = gen.first_event_micros // width_micros
    n_windows = -(-n_events // per_window)
    code = _codes(got["window_start"], got["auction"], width_micros)
    order = np.argsort(code, kind="stable")
    code = code[order]
    g = {k: np.asarray(v)[order] for k, v in got.items()}
    dup = code[1:] == code[:-1]
    w_idx = (code >> 32) - first_w
    present = np.unique(w_idx)
    inside = (w_idx >= 0) & (w_idx < n_windows)
    got_bids = np.bincount(w_idx[inside], weights=g["bids"][inside], minlength=n_windows) \
        if n_windows else np.zeros(0)
    edges = np.minimum(np.arange(n_windows + 1, dtype=np.int64) * per_window, n_events)
    want_bids = np.diff([_bids_below(int(x)) for x in edges])
    out = {"rows_duplicated": int(dup.sum()),
           "windows_missing": int(n_windows - np.isin(np.arange(n_windows), present).sum()),
           "windows_extra": int(((present < 0) | (present >= n_windows)).sum()),
           "bids_miscounted": int(np.abs(got_bids - want_bids).sum())
           + int(g["bids"][~inside].sum())}
    rng = np.random.default_rng([seed & ((1 << 64) - 1), 0x71])
    pick = np.unique(np.r_[0, n_windows - 1, rng.choice(n_windows, min(samples, n_windows),
                                                          replace=False)]) if n_windows else []
    missing = extra = wrong = expected = 0
    for w in pick:
        lo = int(w) * per_window
        want = _windows(gen, lo, min(lo + per_window, n_events), width_micros)
        a, b = np.searchsorted(w_idx, [w, w + 1])
        gw = {k: v[a:b] for k, v in g.items()}
        keep = np.r_[True, gw["auction"][1:] != gw["auction"][:-1]] if b > a else np.zeros(0, bool)
        gw = {k: v[keep] for k, v in gw.items()}
        pos = np.searchsorted(gw["auction"], want["auction"])
        pos_c = np.minimum(pos, max(len(pos) and len(gw["auction"]) - 1, 0))
        found = (pos < len(gw["auction"])) & (gw["auction"][pos_c] == want["auction"]) \
            if len(gw["auction"]) else np.zeros(len(want["auction"]), bool)
        expected += len(want["auction"])
        missing += int((~found).sum())
        extra += len(gw["auction"]) - int(found.sum())
        wrong += int(((gw["max_price"][pos_c[found]] != want["max_price"][found])
                      | (gw["bids"][pos_c[found]] != want["bids"][found])).sum())
    out.update({"rows_missing": missing, "rows_extra": extra, "rows_wrong": wrong,
                "rows_expected": expected, "windows_compared": len(pick),
                "rows_total": int(len(code))})
    return out


CHECKED = ("rows_missing", "rows_extra", "rows_duplicated", "rows_wrong", "windows_missing",
           "windows_extra", "bids_miscounted")


def checks(cmp: dict) -> list:
    """The numbers ``compare`` gives that decide ``correct``, each with its
    limit: every one exact."""
    return [(k, cmp[k], 0) for k in CHECKED]


def latencies(feed, arrivals: list, width_micros: int, lo: float, hi: float) -> list:
    """For every window whose last event fell due at the open-loop
    generator in [lo, hi): the wall time its last result row reached the
    sink minus that due time (s)."""
    gen = feed.generator
    last = {}
    for t, cols in arrivals:
        for w in set(cols["window_start"].tolist()):
            if t > last.get(w, -1.0):
                last[w] = t
    out = []
    for w, t in last.items():
        due = feed.due_time((w + width_micros - gen.first_event_micros) // gen.inter_event_micros - 1)
        if lo <= due < hi:
            out.append(t - due)
    return out
