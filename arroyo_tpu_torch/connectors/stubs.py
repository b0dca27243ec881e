"""Gated connectors (the port's copy of arroyo_tpu/connectors/stubs.py, and
the network connectors still to port).

fluvio needs its client package, as in the JAX package: constructing one
without it raises with the package to install. The network connectors of the
JAX package that the port does not have yet (its http_conn, websocket,
broker_base, nats, mqtt, rabbitmq, kinesis, redis and kafka modules) are
registered under the JAX package's names, so the registry lists every name
the JAX package lists; constructing one raises naming ROADMAP A.9's
remainder. None is skipped and none runs as a silent stub.
"""

from __future__ import annotations

from . import register_sink, register_source

_SPECS = {
    "fluvio": {
        "package": "fluvio",
        "options": ["endpoint", "topic"],
        "kinds": ("source", "sink"),
    },
}

# connector name -> (the JAX package's module, its kinds)
REMAINDER = {
    "sse": ("http_conn", ("source",)),
    "polling_http": ("http_conn", ("source",)),
    "webhook": ("http_conn", ("sink",)),
    "websocket": ("websocket", ("source",)),
    "nats": ("nats", ("source", "sink")),
    "mqtt": ("mqtt", ("source", "sink")),
    "rabbitmq": ("rabbitmq", ("source", "sink")),
    "kinesis": ("kinesis", ("source", "sink")),
    "redis": ("redis", ("sink",)),
    "kafka": ("kafka", ("source", "sink")),
}


class NotPortedError(NotImplementedError):
    pass


def _make_stub(name: str, spec: dict):
    class _Stub:
        def __init__(self, cfg: dict):
            raise ImportError(
                f"the {name!r} connector requires the {spec['package']!r} "
                f"package, which is not installed. "
                f"Options: {', '.join(spec['options'])}. "
                f"pip install {spec['package']} to enable it."
            )

    _Stub.__name__ = f"{name.capitalize()}Connector"
    return _Stub


def _make_remainder(name: str, module: str):
    class _Remainder:
        def __init__(self, cfg: dict):
            raise NotPortedError(
                f"the {name!r} connector (arroyo_tpu/connectors/{module}.py, over its "
                f"broker's protocol) is not in the port yet: it is ROADMAP A.9's remainder")

    _Remainder.__name__ = f"{name.capitalize()}Connector"
    return _Remainder


for _name, _spec in _SPECS.items():
    stub = _make_stub(_name, _spec)
    if "source" in _spec["kinds"]:
        register_source(_name)(stub)
    if "sink" in _spec["kinds"]:
        register_sink(_name)(stub)

for _name, (_module, _kinds) in REMAINDER.items():
    stub = _make_remainder(_name, _module)
    if "source" in _kinds:
        register_source(_name)(stub)
    if "sink" in _kinds:
        register_sink(_name)(stub)
