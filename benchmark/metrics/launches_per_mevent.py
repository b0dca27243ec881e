"""The system's own launch counters (its libraries' kernel counts, its
wrappers' calls where a library keeps none) over the measured window, per
million events: an exact count."""

from metrics._common import per_mevent


def read(record):
    n = sum(record.get("launches", {}).values())
    return per_mevent(n, record) if n else None
