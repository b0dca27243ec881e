"""1 - the union of device-operation intervals on each card over the traced
window, in percent, averaged over the cell's cards (throughput cells)."""

from metrics._common import idle_share


def read(record):
    return idle_share(record)
