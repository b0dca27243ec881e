"""REST API server (reference crates/arroyo-api; the port's copy of
arroyo_tpu/api)."""

from .server import ApiServer

__all__ = ["ApiServer"]
