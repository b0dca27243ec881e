"""Gated connectors (the port's copy of arroyo_tpu/connectors/stubs.py).

fluvio's wire protocol has no stable public spec, so it registers here with
its config surface, as in the JAX package: constructing one without its
client package raises with the package to install. The network connectors
with from-scratch protocol clients (http_conn, websocket, nats, mqtt,
rabbitmq, kinesis, redis) and kafka, gated on confluent_kafka where it runs,
have modules of their own.
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


for _name, _spec in _SPECS.items():
    stub = _make_stub(_name, _spec)
    if "source" in _spec["kinds"]:
        register_source(_name)(stub)
    if "sink" in _spec["kinds"]:
        register_sink(_name)(stub)
