"""Events the generator emitted in the measured window, over its wall time."""


def read(record):
    return record["events_in_window"] / record["window_s"] if record["window_s"] > 0 else None
