"""Columnar micro-batch model (the port's copy of arroyo_tpu/batch.py).

A batch is a dict of equal-length NumPy columns. Operators work on the host
in numpy; only the window aggregator moves its state and inputs to a torch
device.

Conventions:
  - ``_timestamp``: int64 micros event-time column, present on every batch.
  - ``_key``: uint64 routing-hash column, present after a Key operator.
  - string columns are object-dtype ndarrays host-side; they never reach the
    device (keyed device state stores 64-bit hashes and the operator keeps a
    hash -> value dictionary for output reconstruction).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Iterable, Optional

import numpy as np

TIMESTAMP_FIELD = "_timestamp"
KEY_FIELD = "_key"

# dtype sentinels
STRING = "string"
_NUMPY_DTYPES = {
    "int32": np.int32,
    "int64": np.int64,
    "uint64": np.uint64,
    "float32": np.float32,
    "float64": np.float64,
    "bool": np.bool_,
    # event-time micros; int64 on device, ISO-8601 strings at the
    # format boundary (json_fmt parses/formats by schema dtype)
    "timestamp": np.int64,
}


@dataclass(frozen=True)
class Field:
    name: str
    dtype: str  # "int32"|"int64"|"uint64"|"float32"|"float64"|"bool"|"string"
    nullable: bool = False

    def numpy_dtype(self):
        if self.dtype == STRING:
            return np.dtype(object)
        return np.dtype(_NUMPY_DTYPES[self.dtype])


@dataclass(frozen=True)
class Schema:
    """Stream schema (reference: arroyo-rpc/src/df.rs:24 ArroyoSchema)."""

    fields: tuple[Field, ...]
    key_fields: tuple[str, ...] = ()  # logical group-by columns
    has_keys: bool = False  # whether batches carry a _key routing column

    def __post_init__(self):
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate fields in schema: {names}")

    @staticmethod
    def of(fields: Iterable[Field | tuple[str, str]], key_fields=(), has_keys=False) -> "Schema":
        fs = tuple(f if isinstance(f, Field) else Field(f[0], f[1]) for f in fields)
        return Schema(fs, tuple(key_fields), has_keys)

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    def data_names(self) -> list[str]:
        """Field names excluding internal _timestamp/_key columns."""
        return [f.name for f in self.fields if f.name not in (TIMESTAMP_FIELD, KEY_FIELD)]

    def with_keys(self, key_fields: Iterable[str]) -> "Schema":
        fields = self.fields
        if KEY_FIELD not in [f.name for f in fields]:
            fields = fields + (Field(KEY_FIELD, "uint64"),)
        return Schema(fields, tuple(key_fields), True)

    def without_keys(self) -> "Schema":
        fields = tuple(f for f in self.fields if f.name != KEY_FIELD)
        return Schema(fields, (), False)

    def to_json(self) -> dict:
        return {
            "fields": [{"name": f.name, "dtype": f.dtype, "nullable": f.nullable} for f in self.fields],
            "key_fields": list(self.key_fields),
            "has_keys": self.has_keys,
        }

    @staticmethod
    def from_json(d: dict) -> "Schema":
        return Schema(
            tuple(Field(f["name"], f["dtype"], f.get("nullable", False)) for f in d["fields"]),
            tuple(d.get("key_fields", ())),
            d.get("has_keys", False),
        )


class Batch:
    """A columnar micro-batch: equal-length numpy columns."""

    __slots__ = ("columns", "num_rows")

    def __init__(self, columns: dict[str, np.ndarray]):
        if not columns:
            raise ValueError("batch must have at least one column")
        n = None
        for name, col in columns.items():
            if n is None:
                n = len(col)
            elif len(col) != n:
                raise ValueError(f"column {name} length {len(col)} != {n}")
        self.columns = columns
        self.num_rows = int(n)

    def __len__(self) -> int:
        return self.num_rows

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    @property
    def timestamps(self) -> np.ndarray:
        return self.columns[TIMESTAMP_FIELD]

    @property
    def keys(self) -> np.ndarray:
        return self.columns[KEY_FIELD]

    def with_column(self, name: str, col: np.ndarray) -> "Batch":
        cols = dict(self.columns)
        cols[name] = col
        return Batch(cols)

    def without_columns(self, names: Iterable[str]) -> "Batch":
        drop = set(names)
        return Batch({k: v for k, v in self.columns.items() if k not in drop})

    def select(self, names: Iterable[str]) -> "Batch":
        return Batch({n: self.columns[n] for n in names})

    def take(self, indices: np.ndarray) -> "Batch":
        return Batch({k: v[indices] for k, v in self.columns.items()})

    def filter(self, mask: np.ndarray) -> "Batch":
        return Batch({k: v[mask] for k, v in self.columns.items()})

    def slice(self, start: int, stop: int) -> "Batch":
        return Batch({k: v[start:stop] for k, v in self.columns.items()})

    @staticmethod
    def concat(batches: list["Batch"]) -> "Batch":
        if not batches:
            raise ValueError("cannot concat zero batches")
        if len(batches) == 1:
            return batches[0]
        names = batches[0].columns.keys()
        return Batch({n: np.concatenate([b.columns[n] for b in batches]) for n in names})

    @staticmethod
    def empty(schema: Schema) -> "Batch":
        return Batch({f.name: np.empty(0, dtype=f.numpy_dtype()) for f in schema.fields})

    def to_pylist(self) -> list[dict]:
        names = list(self.columns.keys())
        cols = [self.columns[n] for n in names]
        return [
            {n: _to_py(c[i]) for n, c in zip(names, cols)}
            for i in range(self.num_rows)
        ]

    def nbytes(self) -> int:
        """Approximate payload size (object columns estimated)."""
        total = 0
        for c in self.columns.values():
            if c.dtype == object:
                total += 16 * len(c)
            else:
                total += c.nbytes
        return total

    def __repr__(self) -> str:
        return f"Batch(rows={self.num_rows}, cols={list(self.columns.keys())})"


def object_column(values) -> "np.ndarray":
    """1-D object array from arbitrary python values. np.array(vals,
    dtype=object) coerces equal-length lists into a 2-D array; element-wise
    assignment keeps list-valued cells (UDAF collect state) intact."""
    vals = list(values)
    col = np.empty(len(vals), dtype=object)
    for i, v in enumerate(vals):
        col[i] = v
    return col


def _to_py(v):
    if isinstance(v, np.generic):
        return v.item()
    return v


def batch_from_pylist(rows: list[dict], schema: Schema) -> Batch:
    cols = {}
    for f in schema.fields:
        vals = [r.get(f.name) for r in rows]
        if f.dtype == STRING:
            cols[f.name] = np.array(vals, dtype=object)
        else:
            cols[f.name] = np.array(vals, dtype=f.numpy_dtype())
    return Batch(cols)
