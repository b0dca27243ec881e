"""The load generator: deterministic in (seed, event number), another seed
another stream, and NEXMark's proportions, hot share and prices."""

import numpy as np

from gen.feed import Feed
from gen.nexmark import Nexmark

N = 200_000


def test_same_seed_same_events_in_any_order():
    a = Nexmark(2**31 + 7, columns=("bid.auction", "bid.price", "bid.bidder", "auction.id"))
    b = Nexmark(2**31 + 7, columns=a.columns)
    n = np.arange(N, dtype=np.uint64)
    whole = a.generate(n)
    perm = np.random.default_rng(0).permutation(N)
    part = b.generate(n[perm])
    for k, v in whole.items():
        assert np.array_equal(v[perm], part[k]), k


def test_another_seed_other_events():
    n = np.arange(N, dtype=np.uint64)
    a, b = Nexmark(1).generate(n), Nexmark(2).generate(n)
    assert np.array_equal(a["bid"], b["bid"])  # the event kinds are the model's, not the seed's
    assert np.mean(a["bid.price"][a["bid"]] == b["bid.price"][b["bid"]]) < 0.01
    assert not np.array_equal(a["bid.auction"], b["bid.auction"])


def test_proportions_hot_share_and_prices():
    n = np.arange(N, dtype=np.uint64)
    g = Nexmark(99, columns=("bid.auction", "bid.price", "auction.id", "person.id"))
    ev = g.generate(n)
    assert ev["person"].sum() * 50 == N and ev["auction"].sum() * 50 == 3 * N
    assert ev["bid"].sum() * 50 == 46 * N
    bid = ev["bid"]
    epoch = (n // 50).astype(np.int64)[bid]
    newest = 1000 + np.maximum(epoch * 3, 1) - 1
    au = ev["bid.auction"][bid]
    hot = (au > newest - 100) & (au <= newest)
    assert 0.89 < hot.mean() < 0.92  # 90% hot, and a cold draw lands among the newest at times
    assert (au >= 1000).all() and (au <= newest).all()
    price = ev["bid.price"][bid]
    assert price.min() >= 100 and price.max() < 100 + 9_999_900
    assert ev["_timestamp"][5] == 5000
    ids = ev["auction.id"][ev["auction"]]
    assert np.array_equal(ids, 1000 + np.arange(len(ids)))


def test_open_loop_feed_emits_what_fell_due(monkeypatch):
    import gen.feed

    clock = [100.0]
    monkeypatch.setattr(gen.feed.time, "perf_counter", lambda: clock[0])
    f = Feed(Nexmark(1), batch=1000, rate=1e6, poll_s=0.001)
    f.start()
    clock[0] += 0.0105 + 1e-9  # 10,500 events due
    assert f.take(0) == 1000  # at most a batch
    assert f.take(10_000) == 500
    assert f.take(10_500) == 0  # caught up: the next poll is a poll interval away
    clock[0] += 0.0005 + 1e-9
    assert f.take(10_500) == 0
    clock[0] += 0.0005 + 1e-9
    assert f.take(10_500) == 1000
    f.finish(11_600)
    clock[0] += 1.0
    assert f.take(11_500) == 100 and f.take(11_600) is None


def test_emitted_at_interpolates_between_batches():
    f = Feed(Nexmark(1), batch=10)
    f.emissions = [(1.0, 10), (2.0, 20), (4.0, 30)]
    assert f.emitted_at(0.5) == 0 and f.emitted_at(1.5) == 15 and f.emitted_at(3.0) == 25
    assert f.emitted_at(9.0) == 30
