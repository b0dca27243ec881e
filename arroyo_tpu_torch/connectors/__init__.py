"""Connector registry of the port: source and sink constructors dispatch on
the ``connector`` key of the node config. Each connector module registers
itself on import."""

from __future__ import annotations

from typing import Callable

from ..engine.engine import register_operator
from ..graph import OpName

_SOURCES: dict[str, Callable[[dict], object]] = {}
_SINKS: dict[str, Callable[[dict], object]] = {}


def register_source(name: str):
    def deco(fn):
        _SOURCES[name] = fn
        return fn

    return deco


def register_sink(name: str):
    def deco(fn):
        _SINKS[name] = fn
        return fn

    return deco


@register_operator(OpName.SOURCE)
def _make_source(cfg: dict):
    name = cfg["connector"]
    if name not in _SOURCES:
        raise ValueError(f"unknown source connector {name!r} (have {sorted(_SOURCES)})")
    return _SOURCES[name](cfg)


@register_operator(OpName.SINK)
def _make_sink(cfg: dict):
    name = cfg["connector"]
    if name not in _SINKS:
        raise ValueError(f"unknown sink connector {name!r} (have {sorted(_SINKS)})")
    return _SINKS[name](cfg)


def load_all() -> None:
    from . import impulse, nexmark, vec  # noqa: F401
