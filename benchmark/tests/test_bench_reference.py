"""The plain reference: against a row-by-row count on a small stream, and
against the system's CPU path on a tiny q7 and a tiny 8-shard q7m."""

import numpy as np
import pytest

from _cpu import cpu_run
from gen.nexmark import Nexmark
from run import BENCH, load_module

q7 = load_module(BENCH / "queries" / "q7.py", "benchmark_query_q7")
WIDTH = 10_000_000


def by_dict(gen, n):
    ev = gen.generate(np.arange(n, dtype=np.uint64))
    out = {}
    for b, ts, a, p in zip(ev["bid"], ev["_timestamp"], ev["bid.auction"], ev["bid.price"]):
        if b:
            k = (int(ts // WIDTH * WIDTH), int(a))
            m, c = out.get(k, (-1, 0))
            out[k] = (max(m, int(p)), c + 1)
    return out


@pytest.mark.parametrize("n", [0, 1, 9_999, 10_000, 45_678])
def test_reference_equals_a_row_by_row_count(n):
    gen = Nexmark(7)
    ref = q7.reference(gen, n, WIDTH, chunk_windows=2)
    got = {(w, a): (m, c) for w, a, m, c in zip(*(ref[k].tolist() for k in q7.RESULT))}
    assert got == by_dict(gen, n)
    assert list(zip(ref["window_start"], ref["auction"])) == sorted(got)


def test_compare_counts_each_kind_of_fault():
    gen, n = Nexmark(3), 95_000  # ten windows, the last one partial
    want = q7.reference(gen, n, WIDTH)
    assert q7.compare(want, gen, n, WIDTH, seed=1, samples=10) == {
        "rows_duplicated": 0, "windows_missing": 0, "windows_extra": 0, "bids_miscounted": 0,
        "rows_missing": 0, "rows_extra": 0, "rows_wrong": 0, "rows_expected": len(want["bids"]),
        "windows_compared": 10, "rows_total": len(want["bids"])}
    got = {k: v.copy() for k, v in want.items()}
    got["max_price"][0] += 1  # an answer altered
    last = np.flatnonzero(got["window_start"] == 9 * WIDTH)
    keep = np.ones(len(got["bids"]), bool)
    keep[last[:2]] = False  # two rows of the last window lost
    got = {k: np.r_[v[keep], v[3:4]] for k, v in got.items()}  # and a row emitted twice
    got = {k: np.r_[v, np.array([v[0] if k != "auction" else 10**9])] for k, v in got.items()}
    cmp = q7.compare(got, gen, n, WIDTH, seed=1, samples=10)
    assert (cmp["rows_wrong"], cmp["rows_missing"], cmp["rows_duplicated"], cmp["rows_extra"]) \
        == (1, 2, 1, 1)
    assert cmp["bids_miscounted"] > 0
    w3 = got["window_start"] != 3 * WIDTH  # a whole window never emitted
    cmp = q7.compare({k: v[w3] for k, v in got.items()}, gen, n, WIDTH, seed=1)
    assert cmp["windows_missing"] == 1


def test_bids_miscounted_counts_each_window():
    gen, n = Nexmark(3), 95_000
    want = q7.reference(gen, n, WIDTH)
    got = {k: v.copy() for k, v in want.items()}
    # one bid moved from a row of window 2 to a row of window 5: the total holds, two windows not
    got["bids"][np.flatnonzero(got["window_start"] == 2 * WIDTH)[0]] -= 1
    got["bids"][np.flatnonzero(got["window_start"] == 5 * WIDTH)[0]] += 1
    assert q7.compare(got, gen, n, WIDTH, seed=1, samples=0)["bids_miscounted"] == 2


def test_the_packed_sort_equals_a_lexsort_at_the_cells_spacing():
    gen = Nexmark(2**33 + 1, inter_event_micros=1)
    lo, hi = 9_900_000, 10_150_000  # across a window's end, at the cells' 1 us spacing
    got = q7._windows(gen, lo, hi, WIDTH)
    ev = gen.events(lo, hi)
    b = ev["bid"]
    ws, au, pr = ev["_timestamp"][b] // WIDTH * WIDTH, ev["bid.auction"][b], ev["bid.price"][b]
    o = np.lexsort((au, ws))
    ws, au, pr = ws[o], au[o], pr[o]
    start = np.flatnonzero(np.r_[True, (ws[1:] != ws[:-1]) | (au[1:] != au[:-1])])
    assert np.array_equal(got["window_start"], ws[start])
    assert np.array_equal(got["auction"], au[start])
    assert np.array_equal(got["max_price"], np.maximum.reduceat(pr, start))
    assert np.array_equal(got["bids"], np.diff(np.r_[start, len(ws)]))


def test_control_breaks_exactly_once():
    gen, n = Nexmark(3), 500_000
    bounds = [(i, min(i + 65536, n)) for i in range(0, n, 65536)]
    ctl = q7.control("at_least_once", gen, n, WIDTH, bounds)
    cmp = q7.compare(ctl, gen, n, WIDTH, seed=2, samples=3)
    lo, hi = bounds[len(bounds) // 2]  # the batch in the middle, delivered twice
    assert cmp["bids_miscounted"] == q7._bids_below(hi) - q7._bids_below(lo)
    assert cmp["rows_missing"] == cmp["rows_extra"] == cmp["rows_duplicated"] == 0


@pytest.mark.parametrize("cell", ["q7.hot", "q7m.hot"])
def test_reference_against_the_systems_cpu_path(cell):
    result, checks, record = cpu_run(cell, seed=2**31 + 11, seconds=1.0)
    assert result["correct"], result["checks"]
    assert record["compare"]["rows_total"] > 1000 and record["events_in_window"] > 0
    if cell.startswith("q7m."):
        assert record["mesh"]["aggregate_fused_steps"] > 0
