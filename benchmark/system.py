"""Everything the harness reads from or sets in the system under test (the
PyTorch and CUDA package): its configuration, its counters and its spans.
The harness takes nothing else from it but the job it runs.
"""

from __future__ import annotations

from pathlib import Path

PACKAGE = "arroyo_tpu_torch"


def cache_dirs(root: Path) -> dict:
    """The system's build and kernel caches, inside the checkout: the nvcc
    and g++ libraries go to the package's build/ (fixed there by the
    package), Triton's cache to build/triton."""
    build = root / PACKAGE / "build"
    return {"TRITON_CACHE_DIR": str(build / "triton")}


def configure(settings: dict, storage_url: str) -> None:
    """The system's configuration for one job: its defaults, then the
    deployment's settings, checkpoints under ``storage_url``."""
    from arroyo_tpu_torch import config as tcfg

    tcfg.reset()
    tcfg.update({**settings, "checkpoint.storage-url": storage_url})


def register_connectors() -> None:
    from arroyo_tpu_torch.connectors import load_all

    load_all()
    from gen import connector  # noqa: F401 - registers the benchmark's connectors


def _loaded_libraries() -> set:
    from arroyo_tpu_torch.ops import kernels

    return set(kernels._libs)


def launch_counts() -> dict:
    """Kernel launches so far, by kernel: the library's own count where it
    keeps one (it counts every kernel a call launches), the wrapper's count
    of calls elsewhere (one kernel a call). A library not loaded has
    launched nothing and is not loaded for the count."""
    from arroyo_tpu_torch.ops import (hash_kernels, join_kernels, kernels, segment_kernel,
                                      sharded_kernels)

    calls = {**kernels.launch_counts(), **join_kernels.launch_counts(),
             **sharded_kernels.launch_counts(), **hash_kernels.launch_counts()}
    # K1's merge-mode launches are among its calls (K2's read-and-clear
    # launches are apart from its read-alone ones)
    calls.pop("slot_scatter_combine_merge", None)
    out = dict(calls)
    out["segment_fused"] = segment_kernel.segment_fused.kernel_launches
    loaded = _loaded_libraries()
    library = {
        "slot_agg": {"slot_gather": kernels.gather_kernel_launches},
        "join_probe": {"join_sort_pairs": join_kernels.sort_kernel_launches},
        "sharded_agg": {"agg_sort_reduce": sharded_kernels.sort_reduce_kernel_launches,
                        "agg_probe_merge": sharded_kernels.probe_merge_kernel_launches,
                        "shard_exchange": sharded_kernels.exchange_kernel_launches,
                        "shard_spill": sharded_kernels.spill_kernel_launches,
                        "shard_extract": sharded_kernels.extract_kernel_launches},
        "hash_agg": {"hash_free": hash_kernels.free_kernel_launches},
    }
    for lib, counters in library.items():
        for name, fn in counters.items():
            if name in out:
                out[name] = int(fn()) if lib in loaded else 0
    return {k: int(v) for k, v in out.items()}


def self_time(job_id: str, kind: str = "self_time") -> dict:
    """Each task's profiler self time so far, summed over its categories
    (s), by task: wall (``self_time``) or its thread's CPU (``self_cpu``)."""
    from arroyo_tpu_torch.metrics import registry

    out = {}
    for node, m in registry.job_metrics(job_id).items():
        for sub, d in (m.get("per_subtask") or {}).items():
            st = d.get(kind) if isinstance(d, dict) else None
            if st:
                out[f"{node}/{sub}"] = float(sum(st.values()))
    return out


def mesh_counts() -> dict:
    """The mesh's dispatch ledger: fused micro-batches and aggregate steps."""
    from arroyo_tpu_torch.engine.segment import mesh_dispatch_counts
    from arroyo_tpu_torch.parallel.sharded_agg import dispatch_counts

    return {**{f"segment_{k}": v for k, v in mesh_dispatch_counts().items()},
            **{f"aggregate_{k}": v for k, v in dispatch_counts().items()}}


def segment_events(job_id: str) -> dict:
    """How the chained segments ran: compiled, or fallen back."""
    from arroyo_tpu_torch.obs.events import recorder

    return {code: len(recorder.events(job_id, code))
            for code in ("SEGMENT_COMPILED", "SEGMENT_FALLBACK")}

