"""UDF activation for the port's control plane (the Python-UDF part of
arroyo_tpu/compiler.py).

A persisted UDF record (a controller DB row, or a worker's ``--udfs-file``)
is registered into this process's planner-visible registry before a job is
planned. A ``python`` record executes its source, which imports
``register_udf`` / ``register_udaf`` from ``arroyo_tpu_torch.udf`` and calls
them. A ``cpp`` record needs the native UDF compile service and its dylib
host, which are ROADMAP A.8's remainder: it raises.
"""

from __future__ import annotations

CPP_UDF_REMAINDER = (
    "native C++ UDFs (the compile service and its dylib host) are not ported yet: "
    "ROADMAP.md A.8's remainder lists them")


class CompileError(RuntimeError):
    pass


def activate_udf_specs(specs: list[dict]) -> None:
    """Register persisted UDF records into this process's registry."""
    for rec in specs:
        if rec["language"] == "cpp":
            raise CompileError(f"UDF {rec.get('name')!r}: {CPP_UDF_REMAINDER}")
        if rec["language"] != "python":
            raise CompileError(f"unknown UDF language {rec['language']!r}")
        exec(rec["source"], {})  # noqa: S102 - user-supplied UDF, by design
