"""The system's profiler (obs/profile.py TaskProfiler): self thread-CPU time
of every task in the measured window, summed, per million events. Beside
the wall time of engine_self_ms_per_mevent, it leaves out the time a task's
thread waited for a core or the interpreter lock: the steadier reading of
the host path's cost on a host whose cores are shared."""

from metrics._common import per_mevent


def read(record):
    st = record.get("self_cpu_s")
    return per_mevent(1e3 * sum(st.values()), record) if st else None
