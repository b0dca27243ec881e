"""The system's profiler (obs/profile.py TaskProfiler): self wall time of
every task in the measured window, summed, per million events."""

from metrics._common import per_mevent


def read(record):
    st = record.get("self_time_s")
    return per_mevent(1e3 * sum(st.values()), record) if st else None
