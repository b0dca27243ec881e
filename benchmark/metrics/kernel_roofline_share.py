"""Sum over the system's kernels of the least time the work needs (its
bytes, rooflines/<kernel>.py, over the card's published bandwidth) over the
sum of their measured device time in the traced window, in percent."""

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def rooflines():
    import importlib.util

    out = []
    for path in sorted((BENCH / "rooflines").glob("[!_]*.py")):
        spec = importlib.util.spec_from_file_location(f"benchmark_roofline_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out.append(mod)
    return out


def read(record):
    tr, shape = record.get("trace"), record.get("shape")
    peak = json.loads((BENCH / "peaks.json").read_text()).get(record["device_kind"])
    if not tr or not shape or not peak:
        return None
    bound = measured = 0.0
    for mod in rooflines():
        t = sum(s for name, s in tr["device_s_by_name"].items()
                if name in mod.KERNELS or name.split("<", 1)[0] in mod.KERNELS)
        if t > 0:
            measured += t
            bound += mod.work_bytes(shape, record) / peak["hbm_bytes_per_s"]
    return 100.0 * bound / measured if measured > 0 else None
