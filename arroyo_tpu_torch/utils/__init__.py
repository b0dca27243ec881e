"""Utilities shared across the port."""

from .arrow import ensure_parquet_initialized

__all__ = ["ensure_parquet_initialized"]
