"""Shared human-unit formatters for the terminal views (`top`, `explain`;
the port's copy of arroyo_tpu/obs/fmt.py).

One place for rate/duration/byte rendering so the two views can't drift;
`per_sec`/`spaced` cover the stylistic difference between the dense `top`
table ("1.2k", "1.5KiB") and the annotated explain lines ("1.2k/s",
"1.5 KiB").
"""

from __future__ import annotations


def fmt_rate(v, per_sec: bool = False) -> str:
    if v is None:
        return "-"
    v = float(v)
    suffix = "/s" if per_sec else ""
    if v >= 1e6:
        return f"{v / 1e6:.2f}M{suffix}"
    if v >= 1e3:
        return f"{v / 1e3:.1f}k{suffix}"
    return f"{v:.1f}{suffix}"


def fmt_secs(v) -> str:
    if v is None:
        return "-"
    v = float(v)
    if v >= 3600:
        return f"{v / 3600:.1f}h"
    if v >= 60:
        return f"{v / 60:.1f}m"
    if v >= 1:
        return f"{v:.2f}s"
    return f"{v * 1e3:.1f}ms"


def fmt_bytes(v, spaced: bool = False) -> str:
    v = float(v)
    sep = " " if spaced else ""
    for unit in ("B", "KiB", "MiB", "GiB"):
        if v < 1024 or unit == "GiB":
            return (f"{v:.0f}{sep}B" if unit == "B"
                    else f"{v:.1f}{sep}{unit}")
        v /= 1024
    return f"{v:.1f}{sep}GiB"
