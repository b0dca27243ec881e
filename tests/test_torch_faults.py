"""The port's fault injection (arroyo_tpu_torch/faults), its shared retry
layer (utils/retry.py) and its storage, queue and worker fault sites,
against the JAX package's.

- plan parsing and its errors, counters, ordinals and seeded replay give
  the same verdicts as ``arroyo_tpu.faults`` for the same plan, seed and
  calls;
- retry, budget and breaker (the JAX tests' cases);
- storage transient faults recover in place, permanent ones raise; the
  ``corrupt`` verdicts damage the bytes in flight as the JAX package's do;
  a ``queue.put`` delay stalls the producer;
- ``worker:crash@barrier=2`` on the window's subtask of q7, q5, qu and qs
  (chaining on): epoch 1 completes, epoch 2 has state files and no marker,
  the job fails loudly, ``pick_restore_epoch`` gives 1, and the restore
  finishes the stream exactly as the JAX package's restore does."""

import dataclasses
import os
import time

import numpy as np
import pytest

import arroyo_tpu_torch.config as tcfg
import chip_smoke
from arroyo_tpu import batch as jbatch
from arroyo_tpu import config as jcfg
from arroyo_tpu import expr as jexpr
from arroyo_tpu import faults as jfaults
from arroyo_tpu import graph as jgraph
from arroyo_tpu.engine import Engine as JEngine
from arroyo_tpu.state import storage as jstorage
from arroyo_tpu_torch import batch as tbatch
from arroyo_tpu_torch import expr as texpr
from arroyo_tpu_torch import faults
from arroyo_tpu_torch import graph as tgraph
from arroyo_tpu_torch.engine import Engine as TEngine
from arroyo_tpu_torch.faults import (InjectedCrash, InjectedFault, InjectedPartition,
                                     PlanSyntaxError)
from arroyo_tpu_torch.obs.events import recorder
from arroyo_tpu_torch.state import storage
from arroyo_tpu_torch.state.integrity import pick_restore_epoch
from arroyo_tpu_torch.state.tables import checkpoint_dir, read_job_checkpoint_metadata
from arroyo_tpu_torch.utils.retry import (Backoff, CircuitBreaker, CircuitOpenError,
                                          RetryBudget, RetryPolicy, retry_call)
from test_torch_q5 import build_q5
from test_torch_q7 import build_q7

MODULES = {"torch": (tbatch, texpr, tgraph), "jax": (jbatch, jexpr, jgraph)}


@pytest.fixture(autouse=True)
def _port_state():
    """The port's config with no retry backoff; fault plans and the storage
    circuit never leak across tests (the JAX package's are reset by
    tests/conftest.py)."""
    tcfg.reset()
    tcfg.update({"storage.retry.base-delay-ms": 0})
    yield
    faults.clear()
    storage.reset_retry_state()
    tcfg.reset()


# ------------------------------------------------------------ plan grammar

PLANS = [
    "storage.put:fail_once@epoch=2, network.send:drop@step=40,"
    "worker:crash@barrier=3&step=1, queue.put:delay=50@after=2,"
    "storage.put:fail_n=3@match=compacted",
    "storage.get:corrupt=bitflip@match=table-,storage.put:corrupt=truncate",
    "evolve_cutover:hang=0.5@epoch=1,storage.list:force=7",
]


def _spec_view(specs):
    return [(s.site, s.action, s.arg, s.conds) for s in specs]


@pytest.mark.parametrize("plan", PLANS)
def test_plans_parse_as_the_jax_packages(plan):
    assert _spec_view(faults.parse_plan(plan)) == _spec_view(jfaults.parse_plan(plan))
    assert [s.describe() for s in faults.parse_plan(plan)] == \
        [s.describe() for s in jfaults.parse_plan(plan)]


BAD_PLANS = [("nonsense", "site:action"), ("storage.put:explode", "unknown action"),
             ("queue.put:delay", "needs =ARG"), ("storage.put:fail@oops", "bad condition"),
             ("storage.put:corrupt=melt", "corrupt mode"), ("storage.put:fail@step=x", "numeric"),
             ("storage.put:delay=abc", "bad arg")]


@pytest.mark.parametrize("plan,msg", BAD_PLANS)
def test_plan_errors_are_the_jax_packages(plan, msg):
    with pytest.raises(PlanSyntaxError, match=msg) as t:
        faults.parse_plan(plan)
    with pytest.raises(jfaults.PlanSyntaxError) as j:
        jfaults.parse_plan(plan)
    assert str(t.value) == str(j.value)


def _verdicts(mod, plan, seed, calls):
    """Each call's outcome under ``mod``'s injector: a verdict, or the name
    of what it raised."""
    inj = mod.FaultInjector(plan, seed=seed)
    out = []
    for site, ctx in calls:
        try:
            out.append(inj.hit(site, **ctx))
        except Exception as e:  # noqa: BLE001 - the raised type is the verdict
            out.append(type(e).__name__)
    return out, [s.hits for s in inj.specs], [s.fired for s in inj.specs]


CALLS = ([("storage.put", {"key": "a/checkpoint-0000002/x"}), ("storage.put", {"key": "other"}),
          ("network.send", {"key": "q"}), ("worker", {"barrier": 3, "node": "agg"}),
          ("worker", {"barrier": 2}), ("queue.put", {"input": 0}),
          ("storage.get", {"key": "op/table-t-000.npz"}),
          ("connector.poll", {"key": "k"})] * 6)


@pytest.mark.parametrize("plan,seed", [
    ("storage.put:fail_once@match=checkpoint,network.send:drop@step=2,"
     "worker:crash@barrier=3&node=agg,queue.put:dup@after=3", 0),
    ("storage.put:fail_n=2,storage.get:corrupt=truncate@match=table-&step=4,"
     "worker:crash@barrier=2", 3),
    ("connector.poll:fail@prob=0.5,network.send:partition@prob=0.3,storage.put:drop@prob=0.7", 42),
    ("connector.poll:fail@prob=0.5,network.send:partition@prob=0.3,storage.put:drop@prob=0.7", 43),
])
def test_counters_ordinals_and_seeded_replay_match_the_jax_package(plan, seed):
    got = _verdicts(faults, plan, seed, CALLS)
    assert got == _verdicts(jfaults, plan, seed, CALLS)
    assert got == _verdicts(faults, plan, seed, CALLS)  # replays


def test_injector_counters_and_ordinals():
    inj = faults.install("storage.put:fail_once@match=ckpt,network.send:drop@step=2", seed=1)
    assert faults.fault_point("storage.put", key="other") is None
    with pytest.raises(InjectedFault):
        faults.fault_point("storage.put", key="a/ckpt/b")
    assert faults.fault_point("storage.put", key="a/ckpt/b") is None
    assert faults.fault_point("network.send", key="q") is None
    assert faults.fault_point("network.send", key="q") == ("drop", None)
    assert faults.fault_point("network.send", key="q") is None
    assert len(inj.fired_log) == 2


def test_crash_and_partition_types():
    faults.install("network.send:partition@step=1,worker:crash@barrier=7")
    with pytest.raises(ConnectionError):
        faults.fault_point("network.send", key="q")
    assert faults.fault_point("worker", barrier=6) is None
    with pytest.raises(InjectedCrash) as e:
        faults.fault_point("worker", barrier=7)
    assert not e.value.transient and InjectedPartition.transient is False


def test_fault_point_noop_without_plan_and_config_install():
    faults.clear()
    assert faults.fault_point("storage.put", key="x") is None and faults.active() is None
    tcfg.update({"faults.plan": "storage.put:fail@match=x", "faults.seed": 5})
    inj = faults.install_from_config()
    assert faults.active() is inj and inj.seed == 5
    tcfg.update({"faults.plan": ""})
    faults.install_from_config()  # an emptied config clears its own plan
    assert faults.active() is None
    direct = faults.install("storage.get:fail")
    faults.install_from_config()  # ... and leaves a directly installed one
    assert faults.active() is direct


def test_engine_installs_the_configured_plan():
    from test_torch_port_rules import _tiny_graph

    tcfg.update({"faults.plan": "queue.put:delay=1@step=1", "faults.seed": 9})
    eng = TEngine(_tiny_graph([]), job_id="cfg-plan", device="cpu")
    assert faults.active() is not None and faults.active().plan == "queue.put:delay=1@step=1"
    assert eng.plan_hash


# ---------------------------------------------------------------- retry.py


def test_retry_call_recovers_transient_and_raises_permanent():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ConnectionError("transient")
        return "ok"

    assert retry_call(flaky, policy=RetryPolicy(base_delay_s=0.001),
                      sleep=lambda s: None) == "ok"
    assert calls["n"] == 3

    def permanent():
        raise ValueError("logic bug")

    with pytest.raises(ValueError):
        retry_call(permanent, policy=RetryPolicy(base_delay_s=0.001))


def test_retry_exhaustion_raises_last_error():
    def always():
        raise TimeoutError("still down")

    with pytest.raises(TimeoutError, match="still down"):
        retry_call(always, policy=RetryPolicy(max_attempts=3, base_delay_s=0.001),
                   sleep=lambda s: None)


def test_backoff_growth_jitter_and_deadline():
    b = Backoff(RetryPolicy(max_attempts=100, base_delay_s=0.1, max_delay_s=1.0,
                            multiplier=2.0, jitter=0.0))
    assert [round(b.next_delay(), 3) for _ in range(5)] == [0.1, 0.2, 0.4, 0.8, 1.0]
    d = Backoff(RetryPolicy(base_delay_s=0.1, jitter=0.5)).next_delay()
    assert 0.05 <= d <= 0.1
    deadline = Backoff(RetryPolicy(max_attempts=1000, deadline_s=0.0))
    time.sleep(0.001)
    assert deadline.exhausted()


def test_policy_from_config_has_the_jax_defaults():
    from arroyo_tpu.utils.retry import RetryPolicy as JPolicy

    tcfg.reset()
    jcfg.reset()
    assert dataclasses.asdict(RetryPolicy.from_config("storage.retry")) == \
        dataclasses.asdict(JPolicy.from_config("storage.retry"))
    tcfg.update({"storage.retry.max-attempts": 7, "storage.retry.deadline-ms": 250})
    p = RetryPolicy.from_config("storage.retry")
    assert p.max_attempts == 7 and p.deadline_s == 0.25


def test_retry_budget_denies_when_drained():
    budget = RetryBudget(capacity=2, refill_per_s=0.0)
    calls = {"n": 0}

    def always():
        calls["n"] += 1
        raise ConnectionError("x")

    with pytest.raises(ConnectionError):
        retry_call(always, policy=RetryPolicy(max_attempts=10, base_delay_s=0.001),
                   sleep=lambda s: None, budget=budget)
    assert calls["n"] == 3  # the first try and the two budgeted retries


def test_circuit_breaker_opens_and_half_opens():
    br = CircuitBreaker(threshold=2, cooldown_s=0.05, name="t")

    def boom():
        raise ConnectionError("x")

    for _ in range(2):
        with pytest.raises(ConnectionError):
            retry_call(boom, policy=RetryPolicy(max_attempts=1), breaker=br)
    assert br.open
    with pytest.raises(CircuitOpenError):
        retry_call(boom, policy=RetryPolicy(max_attempts=1), breaker=br)
    time.sleep(0.06)
    assert retry_call(lambda: "up", breaker=br) == "up"
    assert not br.open


# ----------------------------------------------------- storage under faults


def test_storage_transient_fault_recovers_in_place(tmp_path):
    p = str(tmp_path / "blob.bin")
    faults.install("storage.put:fail_once@match=blob,storage.get:fail_once@match=blob,"
                   "storage.list:fail_once,storage.delete:fail_once")
    storage.write_bytes(p, b"payload")
    assert storage.read_bytes(p) == b"payload"
    assert storage.listdir(str(tmp_path)) == ["blob.bin"]
    storage.remove(p)
    assert not os.path.exists(p)
    assert len(faults.active().fired_log) == 4


def test_storage_permanent_fault_exhausts_and_raises(tmp_path):
    calls = {"n": 0}
    faults.install("storage.put:fail@match=doomed")
    orig = faults.active().hit

    def counted(site, **ctx):
        calls["n"] += site == "storage.put"
        return orig(site, **ctx)

    faults.active().hit = counted
    with pytest.raises(InjectedFault):
        storage.write_bytes(str(tmp_path / "doomed.bin"), b"x")
    # the first try and max_attempts retries, as the JAX package's layer
    assert calls["n"] == RetryPolicy.from_config("storage.retry").max_attempts + 1
    assert not os.path.exists(tmp_path / "doomed.bin")
    faults.clear()
    storage.write_bytes(str(tmp_path / "doomed.bin"), b"x")  # recovers after


@pytest.mark.parametrize("mode", ["bitflip", "truncate"])
@pytest.mark.parametrize("site", ["put", "get"])
def test_corrupt_verdicts_damage_the_bytes_as_the_jax_package(mode, site, tmp_path):
    data = bytes(range(256)) * 5
    for pkg, fmod, smod in (("torch", faults, storage), ("jax", jfaults, jstorage)):
        p = str(tmp_path / f"table-x-{pkg}.bin")
        fmod.install(f"storage.{site}:corrupt={mode}@match=table-")
        env = smod.write_bytes(p, data)
        got = smod.read_bytes(p)
        fmod.clear()
        assert env == storage.checksum_of(data)  # the envelope of the true bytes
        want = data[:len(data) // 2] if mode == "truncate" else \
            data[:640] + bytes([data[640] ^ 1]) + data[641:]
        assert got == want
        with pytest.raises(storage.IntegrityError):
            storage.verify_envelope(got, env, p)


def test_queue_put_delay_fault():
    from arroyo_tpu_torch.batch import TIMESTAMP_FIELD, Batch
    from arroyo_tpu_torch.engine.queues import TaskInbox

    inbox = TaskInbox(1, 1024)
    faults.install("queue.put:delay=30@step=1")
    b = Batch({TIMESTAMP_FIELD: np.array([1, 2], dtype=np.int64)})
    t0 = time.monotonic()
    inbox.put(0, b)
    assert time.monotonic() - t0 >= 0.025
    assert inbox.get(timeout=1) is not None
    t0 = time.monotonic()
    inbox.put(0, b)  # step=1 fired once
    assert time.monotonic() - t0 < 0.025


def test_queue_put_fail_fails_the_producer_loudly():
    from test_torch_port_rules import _tiny_graph

    faults.install("queue.put:fail@after=3")
    eng = TEngine(_tiny_graph([], event_count=100_000), job_id="q-fail", device="cpu")
    with pytest.raises(RuntimeError, match="injected fault at queue.put"):
        eng.run_to_completion(timeout=60)


# ----------------------------------------- a crash at the worst spot

EVENTS = 60_000
# query -> (graph over (B, E, G), rows), source batch, the two polls the
# barriers land at, merge of the runs' windows (later runs win) or None,
# oracle, check
QUERIES = {
    "q7": (lambda m, rows: build_q7(m, rows, EVENTS), 2048, (10, 20),
           chip_smoke.merged_q7, chip_smoke.oracle_q7, chip_smoke.check_q7),
    "q5": (lambda m, rows: build_q5(m, rows, EVENTS), 2048, (10, 20),
           chip_smoke.merged_q5, chip_smoke.oracle_q5, chip_smoke.check_q5),
    "qu": (lambda m, rows: chip_smoke.qu_graph(*m, rows, EVENTS,
                                               flush_interval_micros=chip_smoke.DAY_MICROS),
           4096, (5, 10), None, chip_smoke.oracle_qu, chip_smoke.check_qu),
    "qs": (lambda m, rows: chip_smoke.qs_graph(*m, rows, EVENTS), 4096, (5, 10),
           chip_smoke.merged_qs, chip_smoke.oracle_qs, chip_smoke.check_qs),
}


def _configure(query):
    batch = QUERIES[query][1]
    over = {"pipeline.source-batch-size": batch, "device.batch-capacity": batch,
            "worker.queue-size": 2 * batch, "pipeline.chaining.enabled": True,
            "segment.compile.min-rows": 0}
    tcfg.update({**over, "device.table-capacity": 8192, "storage.retry.base-delay-ms": 0})
    jcfg.update({**over, "checkpoint.file-format": "npz"})


def _engine(pkg, query, url):
    if pkg == "torch":
        return lambda g, **kw: TEngine(g, job_id=query, device="cpu", storage_url=url, **kw)
    return lambda g, **kw: JEngine(g, job_id=query, storage_url=url, **kw)


def _crash_and_restore(pkg, query, url):
    """The query with epoch 1 at the first poll and a crash of the window's
    subtask at barrier 2 (the second poll); then the fallback ladder and a
    restore. Returns (first run's rows, restored run's rows, picked epoch,
    epoch 2's state files)."""
    build, _batch, holds = QUERIES[query][:3]
    fmod = faults if pkg == "torch" else jfaults
    engine = _engine(pkg, query, url)
    rows1: list = []
    eng = engine(build(MODULES[pkg], rows1))
    eng.build()
    node = chip_smoke.window_node(eng)
    fmod.install(f"worker:crash@barrier=2&node={node}&subtask=0")
    chip_smoke.crash_at_last_barrier(eng, holds, timeout=120)
    fmod.clear()
    d2 = checkpoint_dir(url, query, 2)
    files2 = sorted(f for _r, _d, fs in os.walk(d2) for f in fs if f.startswith("table-"))
    assert read_job_checkpoint_metadata(url, query, 2) is None
    recorder.clear_job(query)
    epoch = pick_restore_epoch(url, query)
    rows2: list = []
    engine(build(MODULES[pkg], rows2), restore_epoch=epoch).run_to_completion(timeout=300)
    return rows1, rows2, epoch, files2


@pytest.mark.parametrize("query", list(QUERIES))
def test_crash_after_the_state_files_restores_as_the_jax_package(query, tmp_path):
    _configure(query)
    t1, t2, te, tfiles = _crash_and_restore("torch", query, str(tmp_path / "torch"))
    j1, j2, je, jfiles = _crash_and_restore("jax", query, str(tmp_path / "jax"))
    assert te == je == 1
    # the window's subtask crashed after its epoch-2 state files went down
    assert tfiles and tfiles == jfiles
    # nothing was quarantined: epoch 2 has no marker, it is simply invisible
    assert [e["code"] for e in recorder.events(query)] == []
    build, _b, holds, merge, oracle, check = QUERIES[query]
    want = oracle(EVENTS)
    # exactly once: the rows emitted before barrier 1 (a run stopped there)
    # and the restored run's hold the oracle
    before: list = []
    chip_smoke.run_gated_epochs(_engine("torch", query, str(tmp_path / "stop"))(
        build(MODULES["torch"], before)), holds[:1], timeout=120)
    check(before + t2, want)
    if merge is None:  # the updating aggregate: its changelogs row for row
        assert chip_smoke.same_changelog(chip_smoke.changelog(t2), chip_smoke.changelog(j2),
                                         "restored qu")
        assert chip_smoke.same_changelog(chip_smoke.changelog(t1), chip_smoke.changelog(j1),
                                         "qu up to the crash")
        return
    assert merge([t1, t2]) == merge([j1, j2]) == want
    assert merge([t2]) == merge([j2])
