"""Helpers the metric readers share."""


def quantile(values, q: float) -> float:
    """The q-quantile by linear interpolation between order statistics."""
    v = sorted(values)
    x = q * (len(v) - 1)
    i = int(x)
    return v[i] if i + 1 >= len(v) else v[i] + (v[i + 1] - v[i]) * (x - i)


def per_mevent(total: float, record: dict):
    events = record.get("events_in_window") or 0
    return total / (events / 1e6) if events > 0 else None


def idle_share(record: dict):
    """100 x (1 - each card's busy share of the traced window), averaged
    over the cards the cell uses."""
    tr = record.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    cards = range(record["chips"])
    return 100.0 * sum(1.0 - tr["busy_s"].get(c, 0.0) / tr["window_s"] for c in cards) / len(cards)
