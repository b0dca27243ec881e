"""The ``bad_data`` option of a SQL source through both packages on the CPU:
a ``single_file`` JSON source whose file holds malformed lines, planned by
each package's ``plan_query`` and run by each engine, chained and unchained.

  - ``bad_data = 'drop'``: the sink lines are equal, sorted, and each
    package's metrics registry counts the same bad records for the source
    operator, one for each malformed line; both record BAD_DATA_DROPPED;
  - ``bad_data = 'fail'``: both runs fail on the first malformed line with
    the same decode error, and count no bad record;
  - a well-formed line whose value does not fit its column's type is not a
    decode error: both packages fail on it under ``drop`` too.
"""

from __future__ import annotations

import json

import pytest

import arroyo_tpu
import arroyo_tpu.config as jcfg
import arroyo_tpu_torch.config as tcfg
from arroyo_tpu.engine.engine import Engine as JEngine
from arroyo_tpu.metrics import registry as jregistry
from arroyo_tpu.obs.events import recorder as jrecorder
from arroyo_tpu.sql import plan_query as jplan
from arroyo_tpu_torch.engine.engine import Engine as TEngine
from arroyo_tpu_torch.metrics import registry as tregistry
from arroyo_tpu_torch.obs.events import recorder as trecorder
from arroyo_tpu_torch.sql import plan_query as tplan

MALFORMED = ['{"timestamp": "2023-01-01T00:00:01Z", "driver_id": ', "not json at all",
             '{"timestamp": "2023-01-01T00:00:02Z" "driver_id": 3}']
CHAINING = pytest.mark.parametrize("chaining", [False, True], ids=["unchained", "chained"])


def write_input(path, extra: list[str]) -> int:
    """40 good rows with ``extra``'s lines spread among them; the number of
    lines from ``extra`` written."""
    lines, n = [], 0
    for i in range(40):
        lines.append(json.dumps({"timestamp": "2023-01-01T00:00:%02dZ" % i,
                                 "driver_id": i % 7,
                                 "event_type": "dropoff" if i % 3 == 0 else "pickup"}))
        if i % 6 == 2:
            lines.append(extra[n % len(extra)])
            n += 1
    path.write_text("\n".join(lines) + "\n")
    return n


def query(src: str, policy: str, out: str) -> str:
    return f"""
CREATE TABLE cars (timestamp TIMESTAMP, driver_id BIGINT, event_type TEXT) WITH (
  connector = 'single_file', path = '{src}', format = 'json', type = 'source',
  event_time_field = 'timestamp', bad_data = '{policy}');
CREATE TABLE picked (driver_id BIGINT, event_type TEXT) WITH (
  connector = 'single_file', path = '{out}', format = 'json', type = 'sink');
INSERT INTO picked SELECT driver_id * 2 AS driver_id, event_type FROM cars
WHERE driver_id > 1;
"""


@pytest.fixture
def both(tmp_path):
    arroyo_tpu._load_operators()
    tcfg.reset()
    tcfg.update({"checkpoint.storage-url": str(tmp_path / "port-ckpt")})
    yield
    tcfg.reset()


def run_both(tmp_path, policy: str, chaining: bool, job: str):
    """Each package's run of the query: (sink lines or the error's text,
    bad records counted for the job), port first."""
    tcfg.update({"pipeline.chaining.enabled": chaining})
    jcfg.update({"pipeline.chaining.enabled": chaining})
    out = []
    for name, plan, engine, kw, registry, recorder in (
            ("port", tplan, TEngine, {"device": "cpu"}, tregistry, trecorder),
            ("jax", jplan, JEngine, {}, jregistry, jrecorder)):
        sink, job_id = tmp_path / f"{name}.json", f"{job}-{name}"
        recorder.clear_job(job_id)
        sql = query(str(tmp_path / "in.json"), policy, str(sink))
        try:
            engine(plan(sql).graph, job_id=job_id, **kw).run_to_completion(timeout=60)
            got = sorted(sink.read_text().splitlines())
        except RuntimeError as exc:
            got = str(exc)
        out.append((got, registry.bad_records(job_id),
                    [e for e in recorder.events(job_id) if e["code"] == "BAD_DATA_DROPPED"]))
    return out


@CHAINING
def test_drop_rows_and_counts_equal_jax(chaining, tmp_path, both):
    n_bad = write_input(tmp_path / "in.json", MALFORMED)
    (tlines, tbad, tevents), (jlines, jbad, jevents) = run_both(
        tmp_path, "drop", chaining, f"bad-drop-{chaining}")
    assert isinstance(tlines, list) and tlines == jlines
    assert len(tlines) == sum(1 for i in range(40) if i % 7 > 1)
    assert tbad == jbad == {"source_0_cars": n_bad}
    assert tevents and jevents


@CHAINING
def test_fail_raises_the_decode_error_in_both(chaining, tmp_path, both):
    write_input(tmp_path / "in.json", MALFORMED)
    (terr, tbad, _), (jerr, jbad, _) = run_both(
        tmp_path, "fail", chaining, f"bad-fail-{chaining}")
    want = "JSONDecodeError: Expecting value: line 1 column 52 (char 51)"
    assert isinstance(terr, str) and want in terr and want in jerr
    assert tbad == jbad == {}


def test_type_mismatch_fails_under_drop_in_both(tmp_path, both):
    write_input(tmp_path / "in.json", [
        '{"timestamp": "2023-01-01T00:00:01Z", "driver_id": "seven", "event_type": "x"}'])
    (terr, tbad, _), (jerr, jbad, _) = run_both(tmp_path, "drop", True, "bad-type")
    want = "ValueError: invalid literal for int() with base 10: 'seven'"
    assert isinstance(terr, str) and want in terr and want in jerr
    assert tbad == jbad == {}
