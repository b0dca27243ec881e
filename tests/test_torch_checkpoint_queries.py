"""Exactly-once restore of bench.py's queries with chaining on (q7, q5, q8,
the updating aggregate qu in device and host mode, and the session window
qs) through the port on
the CPU, held against arroyo_tpu at small sizes.

For each query both packages run the same graph with the source held at
the same batch (chip_smoke.BarrierGate), where ``checkpoint_and_wait(1,
then_stop=True)`` lands epoch 1; then:

- the two packages' epoch-1 tables are equal once decoded, table by table
  and row by row in any order (the slot order of the stores may differ,
  ROADMAP C5), the sources' offsets included;
- a restore from epoch 1 finishes the stream exactly once in every
  direction (the port's checkpoint in the port and in the JAX package,
  the JAX package's in the port): the first run's rows and the restored
  run's together equal the query's oracle, and so does an uninterrupted
  JAX run. The JAX package runs with ``checkpoint.file-format = "npz"``,
  the codec the port writes."""

import os
import shutil

import pytest

import arroyo_tpu_torch.config as tcfg
import chip_smoke
from arroyo_tpu import batch as jbatch
from arroyo_tpu import config as jcfg
from arroyo_tpu import expr as jexpr
from arroyo_tpu import graph as jgraph
from arroyo_tpu.engine import Engine as JEngine
from arroyo_tpu.state import tables as jtables
from arroyo_tpu_torch import batch as tbatch
from arroyo_tpu_torch import expr as texpr
from arroyo_tpu_torch import graph as tgraph
from arroyo_tpu_torch.engine import Engine as TEngine
from arroyo_tpu_torch.state import storage as tstorage
from arroyo_tpu_torch.state import tables as ttables
from test_torch_q5 import build_q5
from test_torch_q7 import build_q7

MODULES = {"torch": (tbatch, texpr, tgraph), "jax": (jbatch, jexpr, jgraph)}

# query -> (graph over (B, E, G), rows, events), events, source batch, the
# poll the barrier lands at, oracle, check
QUERIES = {
    "q7": (lambda m, rows, n: build_q7(m, rows, n), 60_000, 2048, 15,
           chip_smoke.oracle_q7, chip_smoke.check_q7),
    "q5": (lambda m, rows, n: build_q5(m, rows, n), 60_000, 2048, 15,
           chip_smoke.oracle_q5, chip_smoke.check_q5),
    "q8": (lambda m, rows, n: chip_smoke.q8_graph(*m, rows, n), 250_000, 16384, 8,
           chip_smoke.oracle_q8, chip_smoke.check_q8),
    # flushes follow the watermarks alone (no wall-clock flush), so the
    # two packages' states at the barrier are equal
    "qu": (lambda m, rows, n: chip_smoke.qu_graph(*m, rows, n,
                                                  flush_interval_micros=chip_smoke.DAY_MICROS),
           60_000, 4096, 8, chip_smoke.oracle_qu, chip_smoke.check_qu),
    "qu host mode": (lambda m, rows, n: chip_smoke.qu_graph(
        *m, rows, n, backend="numpy", flush_interval_micros=chip_smoke.DAY_MICROS),
        60_000, 4096, 8, chip_smoke.oracle_qu, chip_smoke.check_qu),
    "qs": (lambda m, rows, n: chip_smoke.qs_graph(*m, rows, n), 60_000, 4096, 8,
           chip_smoke.oracle_qs, chip_smoke.check_qs),
}


def _configure(query: str) -> None:
    batch = QUERIES[query][2]
    over = {"pipeline.source-batch-size": batch, "device.batch-capacity": batch,
            "worker.queue-size": 2 * batch, "pipeline.chaining.enabled": True,
            "segment.compile.min-rows": 0}
    tcfg.reset()
    tcfg.update({**over, "device.table-capacity": 8192})
    jcfg.update({**over, "checkpoint.file-format": "npz"})


def _engine(pkg, g, job, url, **kw):
    if pkg == "torch":
        return TEngine(g, job_id=job, device="cpu", storage_url=url, **kw)
    return JEngine(g, job_id=job, storage_url=url, **kw)


def _first_run(pkg: str, query: str, url: str) -> list:
    """The query up to the barrier at its gated poll; epoch 1 completes and
    the job stops there."""
    build, n, _b, polls, _o, _c = QUERIES[query]
    rows: list = []
    eng = _engine(pkg, build(MODULES[pkg], rows, n), query, url)
    gate = chip_smoke.gate_source(eng, polls)
    eng.start()
    assert gate.reached.wait(120), "the source finished before the gated poll"
    assert eng.checkpoint_and_wait(1, timeout=120, then_stop=True)
    eng.stop()
    eng.join(timeout=120)
    assert jtables.latest_complete_checkpoint(url, query) == 1
    return rows


def _restore(pkg: str, query: str, url: str) -> list:
    build, n = QUERIES[query][:2]
    rows: list = []
    _engine(pkg, build(MODULES[pkg], rows, n), query, url,
            restore_epoch=1).run_to_completion(timeout=300)
    return rows


def decoded_tables(url: str, job: str, epoch: int = 1) -> dict:
    """(operator, table, subtask) -> a global table's dict, or an expiring
    table's rows as sorted tuples of (column, value): the order of the rows
    is the stores' and may differ."""
    out = {}
    d = ttables.checkpoint_dir(url, job, epoch)
    for opd in sorted(os.listdir(d)):
        if not opd.startswith("operator-"):
            continue
        for fn in sorted(os.listdir(os.path.join(d, opd))):
            if not fn.startswith("metadata-"):
                continue
            p = os.path.join(d, opd, fn)
            meta = ttables.load_json_with_integrity(tstorage.read_text(p), p, True)
            for fm in meta["files"]:
                path = os.path.join(d, opd, fm["file"])
                if fm["kind"] == "global_keyed":
                    value = ttables.loads_values(tstorage.read_bytes(path))
                else:
                    cols = ttables.read_columnar(path, expect=fm, restore=True)
                    names = sorted(cols)
                    value = sorted((tuple((c, cols[c][i].item() if hasattr(cols[c][i], "item")
                                           else cols[c][i]) for c in names)
                                    for i in range(len(cols[names[0]]))), key=repr)
                out[(opd, fm["table"], meta["subtask_index"])] = value
    return out


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """query -> {"torch": (storage, rows before the stop), "jax": ...}, made
    once per query and copied by each test that restores from it."""
    made: dict = {}

    def get(query):
        if query not in made:
            _configure(query)
            base = tmp_path_factory.mktemp(query)
            made[query] = {pkg: (str(base / pkg), _first_run(pkg, query, str(base / pkg)))
                           for pkg in ("torch", "jax")}
        return made[query]

    return get


# operators fed by two inputs: which input's batch arrives first is thread
# timing in both packages, and the key-skew sketch's space-saving eviction
# depends on the order it sees keys (and the batch count on how the inputs'
# rows were coalesced), so their __sketch tables agree in the rows counted,
# not entry by entry
TWO_INPUTS = {"operator-join"}


def _sketch_invariants(value: dict) -> dict:
    return {sub: {f: st[f] for f in ("total", "sample_every")}
            for sub, st in value.items()}


@pytest.mark.parametrize("query", list(QUERIES))
def test_tables_at_the_barrier_equal_the_jax_packages(query, checkpoints):
    _configure(query)
    ck = checkpoints(query)
    t, j = decoded_tables(ck["torch"][0], query), decoded_tables(ck["jax"][0], query)
    assert set(t) == set(j)
    for k in t:
        if k[1] == "__sketch" and k[0] in TWO_INPUTS:
            assert _sketch_invariants(t[k]) == _sketch_invariants(j[k]), k
        else:
            assert t[k] == j[k], k
    # the barrier landed mid-stream: the source stopped at its gated batch
    # and some state was open
    n, batch, polls = QUERIES[query][1:4]
    assert t[("operator-src", "s", 0)] == {0: (polls - 1) * batch} and (polls - 1) * batch < n
    assert any(isinstance(v, list) and v for v in t.values())
    # the first runs emitted the same rows, less than the whole
    whole = sum(b.num_rows for b in _uninterrupted(query))
    for name in ("torch", "jax"):
        assert sum(b.num_rows for b in ck[name][1]) < whole


_FULL: dict = {}


def _uninterrupted(query: str) -> list:
    if query not in _FULL:
        build, n = QUERIES[query][:2]
        rows: list = []
        _engine("jax", build(MODULES["jax"], rows, n), query + "-full",
                None).run_to_completion(timeout=300)
        _FULL[query] = rows
    return _FULL[query]


@pytest.mark.parametrize("direction", ["torch->torch", "torch->jax", "jax->torch"])
@pytest.mark.parametrize("query", list(QUERIES))
def test_restore_finishes_the_stream_exactly_once(query, direction, checkpoints, tmp_path):
    _configure(query)
    writer, reader = direction.split("->")
    src_url, before = checkpoints(query)[writer]
    url = str(tmp_path / "ck")
    shutil.copytree(src_url, url)
    after = _restore(reader, query, url)
    oracle, check = QUERIES[query][4], QUERIES[query][5]
    want = oracle(QUERIES[query][1])
    check(before + after, want)
    check(_uninterrupted(query), want)
