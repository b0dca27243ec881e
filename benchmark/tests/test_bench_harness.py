"""The harness: finds a new cell, configuration and metric from files
alone; prints the result line's keys; imports nothing of JAX or of the
JAX package, compared by whole top-level module names."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from _cpu import cpu_run
from run import BENCH, ROOT, load_module

FORBIDDEN = {"jax", "jaxlib", "flax", "arroyo_tpu"}


@pytest.mark.parametrize("rate", [0, 20_000], ids=["closed_loop", "open_loop"])
def test_a_new_cell_config_and_metric_from_files_alone(tmp_path, rate):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((bench / "configs" / "nexmark_q7.json").read_text())
    conf["name"] = "nexmark_q7_wide"
    conf["window_micros"] = 20_000_000
    (bench / "configs" / "nexmark_q7_wide.json").write_text(json.dumps(conf))
    work = json.loads((bench / "workloads" / "q7.hot.json").read_text())
    work.update({"config": "nexmark_q7_wide", "traffic": "hot"})
    if rate:  # a positive rate opens the loop: each event due at that rate
        work.update({"rate_events_per_s": rate, "poll_ms": 10})
    (bench / "workloads" / "q7w.hot.json").write_text(json.dumps(work))
    (bench / "metrics" / "result_rows_per_s.py").write_text(
        "def read(record):\n    return record['compare']['rows_total'] / record['window_s']\n")
    spec["configs"].append({"name": "nexmark_q7_wide", "source": "test", "reduced": [],
                            "file": "benchmark/configs/nexmark_q7_wide.json", "why": "test"})
    spec["workloads"].append({"name": "q7w.hot", "config": "nexmark_q7_wide", "traffic": "hot",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "result_rows_per_s", "unit": "rows/s", "better": "higher",
                               "bound": 0.1, "source": "host_clock", "workloads": ["q7w.hot"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    copy = load_module(bench / "run.py", "benchmark_run_copy")
    cpu = __import__("_cpu")
    result, _checks, record = copy.run("q7w.hot", 5, 1.0, False, device="cpu",
                                       overrides=cpu.SMALL, stream_overrides=cpu.STREAM,
                                       root=tmp_path)
    assert result["correct"], result["checks"]
    # events_per_s names its cells, and this is none of them
    assert set(result["metrics"]) == {"setup_s", "result_rows_per_s"}
    assert record["config"]["window_micros"] == 20_000_000
    if rate:  # 20,000 events a second close a 20 s window (20,000 events) each second
        assert record["latencies_s"] and record["rate_events_per_s"] == rate


@pytest.mark.parametrize("cell", ["q7m.hot", "q7.hot"])
def test_the_result_line(cell):
    result, checks, _record = cpu_run(cell, seed=3, seconds=1.0)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"  # the numbers compared come last
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["attempted"] > 0 and line["failed"] == 0 and line["correct"] is True
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {k for k, _v, _l in checks} == set(line["checks"])


def imported_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.rglob("*.py") if "tests" not in p.parts))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {name.split(".", 1)[0] for name in imported_names(BENCH / path)}
    assert not tops & FORBIDDEN


def test_a_run_loads_no_jax_module(tmp_path):
    code = ("import sys, json; sys.path[:0] = [%r, %r, %r]\n"
            "from _cpu import cpu_run\n"
            "r, _c, _rec = cpu_run('q7m.hot', seconds=0.5)\n"
            "print(json.dumps([r['correct'], sorted({m.split('.', 1)[0] for m in sys.modules})]))"
            % (str(BENCH / "tests"), str(BENCH), str(ROOT)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct
    assert "arroyo_tpu_torch" in tops and not set(tops) & FORBIDDEN


def test_no_card_no_result(tmp_path):
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "q7m.hot",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_only_the_benchmark_and_its_json_is_not_enough(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "q7m.hot", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_cell_the_json_does_not_name_prints_no_result():
    # q7.hot's files are there, but BENCHMARK.json does not name the cell
    assert (BENCH / "workloads" / "q7.hot.json").exists()
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "q7.hot", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no cell 'q7.hot' in BENCHMARK.json" in out.stderr
