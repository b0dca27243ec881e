"""The NEXMark event stream, in NumPy, as Arroyo's ``nexmark`` connector
generates it (its ``GeneratorConfig``): every event is a pure function of
``(seed, event number)``, so any batch of event numbers can be made alone,
in any order, by the load generator and again by the reference.

- Of every 50 consecutive event numbers, 1 is a person, 3 are auctions and
  46 are bids (offsets 0, 1-3 and 4-49 within the 50).
- Auction ids count up from 1000, three for every 50 events; a bid names
  one of the 100 newest auctions 90% of the time, and otherwise one drawn
  uniformly from every auction so far.
- A bid's price is 100 + r mod 9,999,900.
- Event n's time is ``first_event_micros + n * inter_event_micros``.

One splitmix64 draw of the event number, with the seed mixed into its key,
gives a bid its fields from disjoint bits: 16 for the hot choice, 24 for
the auction (one of the 100 newest, or one of all so far), 24 for the
price, each bit range mapped onto its range by a multiply and a shift. A
second draw gives the bidder. Only the columns a query names are made; the three
presence flags and the timestamp always are.
"""

from __future__ import annotations

import numpy as np

TIMESTAMP_FIELD = "_timestamp"
FIRST_PERSON_ID = 1000
FIRST_AUCTION_ID = 1000
PERSON_PROPORTION = 1
AUCTION_PROPORTION = 3
BID_PROPORTION = 46
TOTAL_PROPORTION = PERSON_PROPORTION + AUCTION_PROPORTION + BID_PROPORTION
HOT_AUCTIONS = 100  # the newest auctions that draw the hot share of bids
HOT_SHARE_PERCENT = 90
MIN_PRICE = 100
PRICE_SPAN = 9_999_900

COLUMNS = ("person.id", "auction.id", "bid.auction", "bid.bidder", "bid.price")

_GOLDEN = 0x9E3779B97F4A7C15
_M64 = (1 << 64) - 1
_U = np.uint64


def splitmix64(x: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer over a uint64 array, in place where it
    can (wrapping arithmetic)."""
    z = x + _U(_GOLDEN)
    t = np.empty_like(z)
    for shift, mult in ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB)):
        np.right_shift(z, _U(shift), out=t)
        np.bitwise_xor(z, t, out=z)
        np.multiply(z, _U(mult), out=z)
    np.right_shift(z, _U(31), out=t)
    np.bitwise_xor(z, t, out=z)
    return z


def _mix(v: int) -> int:
    """splitmix64 of one Python integer, taken modulo 2**64."""
    return int(splitmix64(np.array([v & _M64], dtype=np.uint64))[0])


def _scaled(bits: np.ndarray, width: int, span) -> np.ndarray:
    """``width``-bit draws mapped onto [0, span) by a multiply and a shift."""
    return ((bits * span) >> _U(width)).astype(np.int64)


class Nexmark:
    """The stream of one seed. ``events(lo, hi)`` makes the events with
    numbers [lo, hi), ``generate(numbers)`` those of any array of event
    numbers, each as a dict of columns."""

    def __init__(self, seed: int, inter_event_micros: int = 1000,
                 first_event_micros: int = 0, columns=("bid.auction", "bid.price")):
        unknown = set(columns) - set(COLUMNS)
        if unknown:
            raise ValueError(f"the generator makes no column {sorted(unknown)} (it makes {COLUMNS})")
        self.seed = int(seed)
        self.inter_event_micros = int(inter_event_micros)
        self.first_event_micros = int(first_event_micros)
        self.columns = tuple(columns)
        base = _mix(self.seed)
        self._keys = [_U(_mix(base ^ (s * _GOLDEN))) for s in (1, 2)]

    def events(self, lo: int, hi: int) -> dict:
        return self.generate(np.arange(lo, hi, dtype=np.int64))

    def generate(self, numbers: np.ndarray) -> dict:
        n = np.asarray(numbers).astype(np.int64, copy=False)
        epoch = n // TOTAL_PROPORTION
        offset = n - epoch * TOTAL_PROPORTION
        is_person = offset < PERSON_PROPORTION
        is_bid = offset >= PERSON_PROPORTION + AUCTION_PROPORTION
        is_auction = ~(is_person | is_bid)
        cols = {"person": is_person, "auction": is_auction, "bid": is_bid,
                TIMESTAMP_FIELD: self.first_event_micros + n * self.inter_event_micros}
        want = set(self.columns)
        if "person.id" in want:
            cols["person.id"] = np.where(is_person, FIRST_PERSON_ID + epoch, 0)
        if "auction.id" in want:
            cols["auction.id"] = np.where(
                is_auction, FIRST_AUCTION_ID + epoch * AUCTION_PROPORTION + offset - PERSON_PROPORTION, 0)
        if "bid.auction" in want or "bid.price" in want:
            r = splitmix64(n.view(np.uint64) + self._keys[0])
        if "bid.auction" in want:
            # the auctions of earlier 50-event epochs are the ones "so far"
            so_far = np.maximum(epoch * AUCTION_PROPORTION, 1)
            is_hot = (r & _U(0xFFFF)) < _U(HOT_SHARE_PERCENT * 65536 // 100)
            pick = (r >> _U(16)) & _U(0xFFFFFF)
            hot = np.maximum(so_far - 1 - _scaled(pick, 24, _U(HOT_AUCTIONS)), 0)
            cold = _scaled(pick, 24, so_far.view(np.uint64))
            cols["bid.auction"] = np.where(is_bid, FIRST_AUCTION_ID + np.where(is_hot, hot, cold), 0)
        if "bid.price" in want:
            cols["bid.price"] = np.where(is_bid, MIN_PRICE + _scaled(r >> _U(40), 24, _U(PRICE_SPAN)), 0)
        if "bid.bidder" in want:
            r2 = splitmix64(n.view(np.uint64) + self._keys[1])
            people = np.maximum(epoch * PERSON_PROPORTION, 1)
            cols["bid.bidder"] = np.where(
                is_bid, FIRST_PERSON_ID + _scaled(r2 >> _U(40), 24, people.view(np.uint64)), 0)
        return cols


def make(seed: int, stream: dict, columns) -> Nexmark:
    """The generator a configuration's ``stream`` names: its
    ``inter_event_micros`` and ``first_event_micros``."""
    return Nexmark(seed, int(stream["inter_event_micros"]), int(stream.get("first_event_micros", 0)),
                   columns=columns)
