"""What the port's SQL path still refuses, each with the ROADMAP item that
lifts it: the formats other than JSON are refused by name (ROADMAP A.9)."""

from __future__ import annotations

import numpy as np
import pytest

from arroyo_tpu_torch.batch import Batch, Schema
from arroyo_tpu_torch.formats import make_deserializer, serialize_batch
from arroyo_tpu_torch.formats.registry import NOT_PORTED


@pytest.mark.parametrize("fmt", NOT_PORTED)
def test_other_formats_refused_naming_a9(fmt):
    schema = Schema.of([("x", "int64")])
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.9"):
        make_deserializer({"format": fmt}, schema)
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.9"):
        serialize_batch({"format": fmt}, Batch({"x": np.arange(3)}), schema)


def test_json_formats_are_taken():
    schema = Schema.of([("x", "int64")])
    for fmt in ("json", "debezium_json"):
        make_deserializer({"format": fmt}, schema)
        assert serialize_batch({"format": fmt}, Batch({"x": np.arange(2)}), schema) == [
            b'{"x":0}', b'{"x":1}']
