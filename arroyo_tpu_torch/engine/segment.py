"""Whole-segment compilation: one fused device program per micro-batch (the
port's copy of arroyo_tpu/engine/segment.py, single device).

A chained run of shuffle-free operators (optimizer.chain_graph) runs its
data path -- ValueOperator projections/filters, KeyOperator key columns and
routing hash, the WatermarkGenerator's per-batch max, and the window
operators' insert prep (bins + accumulator inputs) -- as ONE launch of the
fused segment kernel K4 per micro-batch (ops/segment_kernel.py: Triton
source generated from the bound plan on CUDA, its plain PyTorch version on
the CPU), built once per (segment, input schema) and cached process-wide.

Design rules, as in the JAX package:

  - **Masked, padded execution.** The kernel threads a validity mask
    instead of compacting; inputs pad to ``_padded_size`` so varying batch
    sizes reuse a handful of shapes. The host compacts once, after the
    kernel, with the mask.
  - **State stays where it was.** The kernel is pure; per-member host
    finishers feed its outputs into the members' own state-mutation methods
    (``WatermarkGenerator.observe_batch_max``, the window operators'
    ``insert_arrays``).
  - **Verify-then-trust.** The first batch of every freshly built
    (segment, schema) entry runs BOTH ways: the kernel and a pure numpy
    reference that mirrors the interpreted members exactly. Any difference,
    values or dtypes, bit for bit, falls the segment back to the
    interpreted path permanently (a ``SEGMENT_FALLBACK`` WARN event), as
    does a plan or dtype the kernel does not take.
  - **A broken kernel is not a fallback.** On a CUDA device an error from
    building or launching K4 propagates and fails the job, like the slot
    aggregator's kernels: no path quietly runs the plain version on the
    card. Which version runs is decided by the tensors' device, never by
    catching an exception.
  - **Signals stay interpreted.** Watermarks, stop and end-of-data take the
    ChainCollector path.

Cache keys include the member configs, the input column (name, dtype)
signature, the node parallelism, the device, the mesh width and its
placement over device slots (``segment.compile.cache-max`` bounds the LRU).

Mesh fusion (``device.mesh-devices`` > 1, ``segment.compile.mesh-fuse``
on, a chain marked "mesh"): after the first batch is verified on the host
path, each micro-batch runs K4 and hands its device outputs straight to the
sharded aggregate's exchange + merge (``ShardedAggregator.fused_step``):
rows never return to the host between projection and state update (K4 runs
on the segment's card; each of the mesh's device slots takes its shards'
rows from there, a copy where the slot is another card). The
member's ``mesh_insert_begin`` does the host half (drain, late split,
bookkeeping). A failure while staging the batch, before any state has
changed, leaves it to the per-batch host path (a SEGMENT_FALLBACK event
with ``mesh``); any error of the step itself, which updates the sharded
table in place, fails the job. ``mesh_dispatch_counts`` is the ledger: micro-batches
committed fused and through the host path.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..batch import KEY_FIELD, TIMESTAMP_FIELD, Batch
from ..config import config
from ..expr import BinOp, Case, Cast, Col, Expr, Func, Lit, Neg, Not, eval_expr
from ..graph import OpName
from ..ops import kernels, segment_kernel
from ..ops.segment_kernel import SegmentProgram, insert_step as _insert_step

# scalar functions whose device evaluation is bit-identical to the numpy path
# (elementwise, IEEE-exact or pure integer). Transcendentals (exp/ln/log10/
# power) and decimal-scaled round() are NOT listed: libm and the device may round
# differently, which would break byte-exact goldens.
_TRACEABLE_FUNCS = {"abs", "floor", "ceil", "sqrt", "extract_epoch",
                    "date_trunc_micros", "to_timestamp_micros"}

_TRACEABLE_BINOPS = {"+", "-", "*", "/", "%", "==", "!=", "<", "<=", ">",
                     ">=", "and", "or"}

# ops with a device twin in the JAX package yet deliberately kept out of the
# allowlist: their two implementations are not bit-exact (libm vs device
# rounding for the transcendentals; decimal-scaled round).
_KNOWN_DIVERGENT_FUNCS = {"ln", "log10", "exp", "power", "round"}

_KNOWN_DIVERGENT_BINOPS: set[str] = set()


def expr_traceable(e: Expr) -> Optional[str]:
    """None if ``e`` evaluates identically under eval_torch and the segment
    kernel, else the reason it cannot (plan-time marking and runtime gate)."""
    if isinstance(e, Col):
        return None
    if isinstance(e, Lit):
        if isinstance(e.value, (bool, int, float)):
            return None
        return f"non-numeric literal {e.value!r}"
    if isinstance(e, BinOp):
        if e.op not in _TRACEABLE_BINOPS:
            return f"operator {e.op!r}"
        return expr_traceable(e.left) or expr_traceable(e.right)
    if isinstance(e, (Not, Neg)):
        return expr_traceable(e.inner)
    if isinstance(e, Cast):
        if e.dtype == "string":
            return "cast to string"
        return expr_traceable(e.inner)
    if isinstance(e, Case):
        if e.otherwise is None:
            # numpy leaves unmatched rows holding the first branch's value,
            # the device twin would yield NaN: don't trace the divergent shape
            return "CASE without ELSE"
        for c, v in e.branches:
            r = expr_traceable(c) or expr_traceable(v)
            if r:
                return r
        return expr_traceable(e.otherwise)
    if isinstance(e, Func):
        if e.name not in _TRACEABLE_FUNCS:
            return f"function {e.name}()"
        for a in e.args:
            r = expr_traceable(a)
            if r:
                return r
        return None
    return f"expression {type(e).__name__}"  # UdfExpr and anything unknown


def _referenced(exprs) -> set[str]:
    out: set[str] = set()
    for e in exprs:
        if e is not None:
            out |= e.columns()
    return out


# ------------------------------------------------------- plan-time marking

_WINDOW_OPS = (OpName.TUMBLING_AGGREGATE.value, OpName.SLIDING_AGGREGATE.value)


def _scan_members(members: list[tuple[str, dict]]) -> tuple[int, bool, str]:
    """(traceable prefix length, ends in a window insert, stop reason)."""
    k = 0
    insert = False
    stop = "end of chain"
    for op, cfg in members:
        reason = _member_traceable(op, cfg, first=k == 0)
        if reason is not None:
            stop = reason
            break
        k += 1
        if op in _WINDOW_OPS:
            insert = True
            stop = "window insert terminates the traced prefix"
            break
    return k, insert, stop


def segment_marking(members: list[tuple[str, dict]]) -> Optional[dict]:
    """Static compilability of a chained run: the maximal traceable PREFIX
    of the member list, judged by op kind and expression shape (runtime
    still gates on actual column dtypes and verifies the first batch).
    Returns ``{"prefix": k, "insert": bool, "stop": reason, "mesh": bool}``
    when the prefix is worth compiling (>= 2 members), else None."""
    k, insert, stop = _scan_members(members)
    if k < 2:
        return None
    return {"prefix": k, "insert": insert, "stop": stop,
            "mesh": insert and _mesh_markable(members, k)}


def _mesh_markable(members: list[tuple[str, dict]], k: int) -> bool:
    """Static half of the mesh-fusion gate (SegmentRunner._setup_mesh has
    the rest): no in-trace filter past the hoistable leading member."""
    for op, cfg in members[1:k]:
        if op == OpName.VALUE.value and cfg.get("filter") is not None:
            return False
    return True


def segment_reject_reason(members: list[tuple[str, dict]]) -> Optional[str]:
    """Human-readable ``not compilable: <reason>`` for a chained run that
    ``segment_marking`` declined to mark, or None when it IS marked.

    Attached to the chained node's config at plan time (optimizer.
    chain_graph) and copied into the task metrics' ``segment_reason``."""
    k, _insert, stop = _scan_members(members)
    if k >= 2:
        return None
    # the stop reason leads: narrow renderers (`top` truncates) must show
    # the actionable part, not a boilerplate prefix
    return f"not compilable: {stop} (traceable prefix {k} < 2)"


def _member_traceable(op: str, cfg: dict, first: bool = False) -> Optional[str]:
    if op == OpName.VALUE.value:
        # a FIRST member's filter is hoisted to the host (evaluated exactly
        # as interpreted, object columns and all), so only its projections
        # must trace
        exprs = ([] if first else [cfg.get("filter")]) + \
            [e for _n, e in (cfg.get("projections") or [])]
        for e in exprs:
            if e is None:
                continue
            r = expr_traceable(e)
            if r:
                return f"value: {r}"
        return None
    if op == OpName.KEY.value:
        for _n, e in cfg.get("keys", []):
            r = expr_traceable(e)
            if r:
                return f"key: {r}"
        return None
    if op == OpName.WATERMARK.value:
        r = expr_traceable(cfg["expr"])
        return f"watermark: {r}" if r else None
    if op in _WINDOW_OPS:
        for _n, kind, e in cfg.get("aggregates", []):
            if kind.startswith("udaf:") or kind in ("collect", "count_distinct"):
                return f"window: {kind} accumulator is host-resident"
            if e is not None:
                r = expr_traceable(e)
                if r:
                    return f"window: {r}"
        return None
    return f"operator {op} is not traceable"


# ------------------------------------------------------------- stage plans
#
# A bound segment is a list of small stage records; the kernel's code
# generator and its plain version (ops/segment_kernel.py) fold them into one
# function and ``_reference`` executes the interpreted members' exact numpy
# logic for the first-batch verification. Both read the SAME records, so a
# drift between them is a verification failure, not a silent divergence.


class _Stage:
    __slots__ = ("kind", "member_index", "member")

    def __init__(self, kind: str, member_index: int, member):
        self.kind = kind  # "value" | "key" | "wm" | "insert"
        self.member_index = member_index
        self.member = member


class _SegmentPlan:
    """Static description of what the segment function consumes/produces."""

    def __init__(self):
        self.stages: list[_Stage] = []
        self.prefix = 0  # members covered (including an insert member)
        self.insert: Optional[_Stage] = None
        self.traced_in: list[str] = []  # input columns fed to the kernel
        self.traced_out: list[str] = []  # kernel output names, fixed order
        self.insert_has_key = False
        # final batch assembly: ordered (name, "host" | "traced")
        self.out_plan: list[tuple[str, str]] = []
        self.emits_batch = True  # False in insert mode
        self.wm_stages: list[_Stage] = []
        # leading-filter hoist: the FIRST member's filter evaluates on the
        # host (eval_expr, exactly the interpreted path, object columns
        # allowed) and the inputs compact BEFORE the kernel; filters in
        # LATER members run in the kernel as mask narrowing
        self.prefilter: Optional[Expr] = None


class SegmentUntraceable(Exception):
    """Raised during binding when the actual batch makes the marked
    segment untraceable (object columns, host accumulators, ...)."""


# a leading filter keeping less than this fraction of rows is hoisted to
# the host: computing a mostly-dead padded batch costs more than
# interpreted's compact-then-compute
_HOIST_SELECTIVITY = 0.5


def _bind(members, prefix: int, batch: Batch, probe: bool = False,
          hoist: bool = False) -> _SegmentPlan:
    """Resolve the plan against the first batch's real columns: decide
    which inputs the kernel consumes, the output assembly order, and gate
    every referenced column on a numeric/bool dtype. ``probe`` builds a
    plan only for a one-off ``_reference`` run (the insert member's
    key-transport setup), skipping the kernel-only gates; ``hoist`` moves
    the leading member's filter out of the kernel."""
    from ..operators.builtin import KeyOperator, ValueOperator, WatermarkGenerator
    from ..windows.sliding import SlidingAggregate
    from ..windows.tumbling import TumblingAggregate

    plan = _SegmentPlan()
    plan.prefix = prefix
    # provenance: name -> None (verbatim input column) | "computed";
    # ``order`` mirrors the dict insertion order the interpreted members
    # produce, so the emitted Batch's column order is byte-identical
    prov: dict[str, Optional[str]] = {n: None for n in batch.columns}
    order: list[str] = list(batch.columns)
    referenced: set[str] = set()

    def ref(exprs):
        for name in _referenced(exprs):
            if name not in prov:
                raise SegmentUntraceable(
                    f"expression references unknown column {name!r}")
            if prov[name] is None:
                referenced.add(name)

    for i in range(prefix):
        m = members[i]
        if isinstance(m, ValueOperator):
            st = _Stage("value", i, m)
            if i == 0 and m.filter is not None and hoist:
                # hoisted: evaluated host-side before the kernel, never in it
                plan.prefilter = m.filter
                for name in m.filter.columns():
                    if name not in prov:
                        raise SegmentUntraceable(
                            f"filter references unknown column {name!r}")
                ref([e for _n, e in (m.projections or [])])
            else:
                ref([m.filter] + [e for _n, e in (m.projections or [])])
            if m.projections is not None:
                new_order: list[str] = []
                new_prov: dict[str, Optional[str]] = {}
                for name, _e in m.projections:
                    if name not in new_prov:
                        new_order.append(name)
                    new_prov[name] = "computed"
                if TIMESTAMP_FIELD not in new_prov:
                    if TIMESTAMP_FIELD not in prov:
                        raise SegmentUntraceable("batch has no _timestamp")
                    new_order.append(TIMESTAMP_FIELD)
                    new_prov[TIMESTAMP_FIELD] = prov[TIMESTAMP_FIELD]
                for carried in (KEY_FIELD, "_is_retract"):
                    if carried in prov and carried not in new_prov:
                        new_order.append(carried)
                        new_prov[carried] = prov[carried]
                order, prov = new_order, new_prov
        elif isinstance(m, KeyOperator):
            st = _Stage("key", i, m)
            ref([e for _n, e in m.keys])
            for name, _e in m.keys:
                if name not in prov:
                    order.append(name)
                prov[name] = "computed"
            if KEY_FIELD not in prov:
                order.append(KEY_FIELD)
            prov[KEY_FIELD] = "computed"
        elif isinstance(m, WatermarkGenerator):
            st = _Stage("wm", i, m)
            ref([m.expr])
            plan.wm_stages.append(st)
        elif isinstance(m, (TumblingAggregate, SlidingAggregate)):
            st = _Stage("insert", i, m)
            if m.lane_key_fields is None:
                raise SegmentUntraceable("window key transport unresolved")
            if m.dict_key_fields:
                raise SegmentUntraceable(
                    f"window group-by columns {m.dict_key_fields} are "
                    f"non-numeric (host key dictionary)")
            if "collect" in m.acc_kinds:
                raise SegmentUntraceable("collect accumulator is host-resident")
            ref([e for e in m.acc_inputs if e is not None])
            if TIMESTAMP_FIELD not in prov:
                raise SegmentUntraceable("window input has no _timestamp")
            if prov[TIMESTAMP_FIELD] is None:
                referenced.add(TIMESTAMP_FIELD)
            if KEY_FIELD in prov:
                plan.insert_has_key = True
                if prov[KEY_FIELD] is None:
                    referenced.add(KEY_FIELD)
            plan.insert = st
            plan.emits_batch = False
        else:
            raise SegmentUntraceable(f"member {m.name()} is not traceable")
        plan.stages.append(st)

    if not probe:
        # dtype gate: every input column the kernel consumes must be numeric
        for name in sorted(referenced):
            dt = np.asarray(batch.columns[name]).dtype
            if dt.kind not in "biuf":
                raise SegmentUntraceable(f"column {name!r} has dtype {dt} "
                                         f"(only numeric/bool columns trace)")
        if not referenced:
            raise SegmentUntraceable("segment computes nothing traceable")
    plan.traced_in = sorted(referenced)
    if plan.emits_batch:
        for name in order:
            plan.out_plan.append(
                (name, "host" if prov.get(name) is None else "traced"))
        plan.traced_out = [n for n, src in plan.out_plan if src == "traced"]
    else:
        m = plan.insert.member
        plan.traced_out = ["__bins"]
        if plan.insert_has_key:
            plan.traced_out.append("__hash")
        plan.traced_out += [f"__val{i}" for i, inp in enumerate(m.acc_inputs)
                            if inp is not None]
    return plan


# ------------------------------------------------------------ device program


def _trace_fn(plan: _SegmentPlan, in_dtypes, device: torch.device) -> Callable:
    """Build the segment function for a bound plan on ``device``: K4 on
    CUDA, its plain PyTorch version on the CPU (ops/segment_kernel.py).

    Signature: ``run(n, arrays)`` over numpy arrays padded to one length P;
    ``run.on_device(n, arrays)`` stops before the copy to the host. ``run``
    returns ``(outs, mask, aux)`` where ``outs`` maps ``plan.traced_out`` to
    numpy arrays, ``mask`` selects valid rows (None when no member filters
    in the kernel: the padding tail is then dropped by slicing), and ``aux``
    carries one ``(batch_max, valid_count)`` pair per watermark stage. A
    batch crosses to the card in one copy (``segment_kernel.stage_inputs``)
    and back in one: the kernel writes everything into one packed buffer.
    A plan or dtype the kernel does not take raises SegmentUntraceable
    here, on either device."""
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}: the segment runs on cuda or cpu")
    try:
        prog = SegmentProgram(plan, in_dtypes)
    except TypeError as e:
        raise SegmentUntraceable(f"not in the segment kernel: {e}") from e
    cuda = device.type == "cuda"

    def guarded(fn):
        def call(n: int, arrays: list[np.ndarray]):
            if not cuda:
                return fn(n, arrays)
            try:
                return fn(n, arrays)
            except Exception as e:  # noqa: BLE001 - re-raised: a kernel fault fails the job
                raise segment_kernel.KernelError(
                    f"segment kernel K4 on {device}: {type(e).__name__}: {e}") from e
        return call

    def _on_device(n: int, arrays: list[np.ndarray]):
        ins = segment_kernel.stage_inputs(prog, arrays, device)
        packed = torch.empty(prog.out_layout(len(arrays[0])).nbytes, dtype=torch.uint8,
                             device=device)
        return (packed, *segment_kernel.segment_fused(prog, n, ins, out=packed))

    def _run(n: int, arrays: list[np.ndarray]):
        packed = _on_device(n, arrays)[0]
        if cuda:
            host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            torch.cuda.current_stream(device).synchronize()
        else:
            host = packed
        return prog.unpack(host.numpy(), len(arrays[0]))

    run = guarded(_run)
    # the fused mesh step keeps K4's outputs on the device: (packed buffer,
    # outs {name: [P] tensor, uint64 as int64 bits}, mask, aux pairs), the
    # last three views of the first (run.program.out_layout)
    run.on_device = guarded(_on_device)
    run.program = prog
    return run


# --------------------------------------------------------------- reference
def _reference(plan: _SegmentPlan, batch: Batch) -> dict:
    """Pure-numpy twin of the interpreted member hooks, mutating nothing:
    the oracle the kernel's outputs must match bit for bit. Structure
    mirrors ValueOperator/KeyOperator/WatermarkGenerator and the window
    operators' process_batch exactly (compaction at each filter, eval_expr
    per expression, hash_columns for routing keys)."""
    from ..hashing import hash_columns

    cols = dict(batch.columns)
    n = batch.num_rows
    aux: list[tuple[Optional[int], int]] = []
    res: dict[str, Any] = {}
    for st in plan.stages:
        m = st.member
        if st.kind == "value":
            if m.filter is not None:
                fmask = np.asarray(eval_expr(m.filter, cols, n), dtype=bool)
                if not fmask.all():
                    cols = {k: v[fmask] for k, v in cols.items()}
                    n = int(fmask.sum())
            if m.projections is not None:
                new = {}
                for name, e in m.projections:
                    new[name] = eval_expr(e, cols, n)
                if TIMESTAMP_FIELD not in new:
                    new[TIMESTAMP_FIELD] = cols[TIMESTAMP_FIELD]
                if KEY_FIELD in cols and KEY_FIELD not in new:
                    new[KEY_FIELD] = cols[KEY_FIELD]
                if "_is_retract" in cols and "_is_retract" not in new:
                    new["_is_retract"] = cols["_is_retract"]
                cols = new
        elif st.kind == "key":
            key_cols = []
            for name, e in m.keys:
                c = eval_expr(e, cols, n)
                cols[name] = c
                key_cols.append(np.asarray(c))
            cols[KEY_FIELD] = (hash_columns(key_cols) if n
                               else np.zeros(0, dtype=np.uint64))
        elif st.kind == "wm":
            if n:
                vals = np.asarray(eval_expr(m.expr, cols, n))
                aux.append((int(vals.max()), n))
            else:
                aux.append((None, 0))
        else:  # insert
            res["__bins"] = np.asarray(cols[TIMESTAMP_FIELD]) // _insert_step(m)
            if plan.insert_has_key:
                res["__hash"] = np.asarray(cols[KEY_FIELD]).astype(np.uint64)
            for i, (inp, dt) in enumerate(zip(m.acc_inputs, m.acc_dtypes)):
                if inp is not None:
                    res[f"__val{i}"] = np.asarray(
                        eval_expr(inp, cols, n)).astype(dt)
    if plan.emits_batch:
        for name, _src in plan.out_plan:
            res[name] = np.asarray(cols[name])
    return {"cols": res, "aux": aux, "n": n}


# ----------------------------------------------------------- compiled entry


_PAD_QUANTUM = 4096


def _padded_size(n: int) -> int:
    """Padded length for an n-row batch: next power of two below the
    quantum, then quantum multiples, capping padding waste at one quantum."""
    if n <= 16:
        return 16
    if n < _PAD_QUANTUM:
        return 1 << (n - 1).bit_length()
    return -(-n // _PAD_QUANTUM) * _PAD_QUANTUM



class CompiledSegment:
    """One (segment, schema) cache entry: the bound plan + segment
    function, shared by every subtask of the node."""

    def __init__(self, plan: _SegmentPlan, fn: Callable, sig: tuple):
        self.plan = plan
        self.fn = fn
        self.sig = sig
        # padded lengths this entry has run at: the first call at each
        # builds K4 for that shape (Triton compiles it)
        self._shapes: set[int] = set()
        self._lock = threading.Lock()

    def execute(self, batch: Batch, min_rows: int = 0,
                job_id: Optional[str] = None) -> Optional[dict]:
        """Run the segment function on one batch; returns the same structure
        ``_reference`` produces (compacted numpy arrays + aux pairs), or
        None when fewer than ``min_rows`` rows survive the hoisted filter
        (too small to pay the launch; the caller runs interpreted). The
        first call at a padded shape is timed into the job's
        ``arroyo_segment_compile_seconds`` when ``job_id`` is given; no
        later call waits for anything more than it did."""
        fmask = None
        n = batch.num_rows
        if self.plan.prefilter is not None:
            fm = np.asarray(
                eval_expr(self.plan.prefilter, batch.columns, n), dtype=bool)
            if not fm.any():
                # the interpreted leading member emits nothing: downstream
                # stages never see this batch
                return {"cols": {}, "n": 0,
                        "aux": [(None, 0)] * len(self.plan.wm_stages)}
            if not fm.all():
                survivors = int(fm.sum())
                if survivors < min_rows:
                    return None
                fmask = fm
                n = survivors
        p = _padded_size(n)
        arrays = []
        for name in self.plan.traced_in:
            a = np.asarray(batch.columns[name])
            if fmask is not None:
                # fused compact + pad: one pass per column
                buf = np.zeros(p, dtype=a.dtype)
                np.compress(fmask, a, out=buf[:n])
                a = buf
            elif p > n:
                padded = np.zeros(p, dtype=a.dtype)
                padded[:n] = a
                a = padded
            arrays.append(a)
        with self._lock:
            new_shape = p not in self._shapes
            self._shapes.add(p)
        if new_shape and job_id is not None:
            t0 = time.perf_counter()
            outs, mask, aux = self.fn(n, arrays)
            from ..metrics import registry

            registry.observe_segment_compile(job_id, time.perf_counter() - t0)
        else:
            outs, mask, aux = self.fn(n, arrays)

        def host_col(name):
            # passthrough columns never enter the kernel; they only pay the
            # hoisted filter's compaction, exactly like interpreted
            col = batch.columns[name]
            return col[fmask] if fmask is not None else col

        if mask is not None:
            idx = np.flatnonzero(mask)
            k = len(idx)
            res = {name: a[idx] for name, a in outs.items()}
            if self.plan.emits_batch:
                for name, src in self.plan.out_plan:
                    if src == "host":
                        res[name] = host_col(name)[idx]
        else:
            k = n
            res = {name: a[:n] for name, a in outs.items()}
            if self.plan.emits_batch:
                for name, src in self.plan.out_plan:
                    if src == "host":
                        res[name] = host_col(name)
        pairs = []
        it = iter(aux)
        for mx in it:
            cnt = int(next(it))
            pairs.append((int(mx) if cnt else None, cnt))
        return {"cols": res, "aux": pairs, "n": k}


def _outputs_equal(got: dict, want: dict) -> Optional[str]:
    """Bitwise comparison of an execute() result against the reference;
    returns a mismatch description or None."""
    if got["n"] != want["n"]:
        return f"row count {got['n']} != {want['n']}"
    if got["aux"] != want["aux"]:
        return f"watermark aux {got['aux']} != {want['aux']}"
    if got["n"] == 0 and not got["cols"]:
        return None  # hoisted filter killed the whole batch: nothing flows
    gc, wc = got["cols"], want["cols"]
    if set(gc) != set(wc):
        return f"column set {sorted(gc)} != {sorted(wc)}"
    for name in wc:
        g, w = np.asarray(gc[name]), np.asarray(wc[name])
        if g.dtype != w.dtype:
            return f"{name}: dtype {g.dtype} != {w.dtype}"
        if g.dtype == object:
            if len(g) != len(w) or any(
                    not (a is None and b is None) and a != b
                    for a, b in zip(g, w)):
                return f"{name}: object values differ"
        elif g.tobytes() != w.tobytes():
            return f"{name}: values differ"
    return None


# ------------------------------------------------------------ global cache


class _SegmentCache:
    """Process-wide LRU of built (and known-untraceable) segments, so the N
    subtasks of a node share one build. Keys include the device."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, Any]" = OrderedDict()

    def _max(self) -> int:
        return int(config().get("segment.compile.cache-max", 32) or 32)

    def lookup(self, key: tuple) -> tuple[bool, Any]:
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return True, self._entries[key]
            return False, None

    def store(self, key: tuple, entry) -> None:
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self._max():
                self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


segment_cache = _SegmentCache()


class _Fallback:
    """Negative cache entry: this (segment, schema) is untraceable."""

    __slots__ = ("reason",)

    def __init__(self, reason: str):
        self.reason = reason


def _kernel_error(e: BaseException) -> bool:
    """An exception that must fail the job instead of falling back: anything
    raised on a CUDA device while staging, building, launching or reading
    back K4 (segment_kernel.KernelError), and a build or launch error of any
    other kernel of the port (kernels.KernelError: the sharded aggregate's
    K8-K11 in the fused mesh step). Host-side steps (binding, the hoisted
    filter, compaction, verification) fall back as in the JAX package."""
    return isinstance(e, kernels.KernelError)


# ----------------------------------------------------------------- runner


# per-process micro-batch commit counts of mesh-armed runners: "fused" =
# committed through the fused mesh step, "host" = through the per-batch host
# path (first-batch verification, small batches, recovery after a failed
# fused step). bench.py --mesh-ab's ledger: with fusion on, "fused" equals
# the sharded aggregate's fused_steps, one step per fused micro-batch.
_MESH_DISPATCH = {"fused": 0, "host": 0}


def mesh_dispatch_counts() -> dict:
    return dict(_MESH_DISPATCH)


def reset_mesh_dispatch_counts() -> None:
    for k in _MESH_DISPATCH:
        _MESH_DISPATCH[k] = 0


class SegmentRunner:
    """Per-task runner: owns the compile/fallback decision for one chained
    operator and runs the segment function per batch. The task run loop
    invokes ``process_batch`` in place of the chain's member hook loop."""

    def __init__(self, chain, ctx, metrics, marking: dict):
        self.chain = chain
        self.ctx = ctx
        self.metrics = metrics
        self.marking = marking
        self._entry: Optional[CompiledSegment] = None
        self._sig: Optional[tuple] = None
        self._fallback = False
        self._min_rows = int(config().get("segment.compile.min-rows", 8192))
        # cost demotion (not a fallback): a run of consecutive batches whose
        # hoisted-filter survivors stayed under min-rows latches interpreted
        self._small_streak = 0
        # mesh fusion (device.mesh-devices > 1 and a mesh-markable insert
        # prefix): K4's outputs feed the sharded aggregate's exchange +
        # merge on the device instead of the host insert path. _mesh_n > 1
        # also forces the leading-filter hoist (_should_hoist): the fused
        # step takes no mask.
        mesh_n = int(config().get("device.mesh-devices", 0) or 0)
        self._mesh_n = (
            mesh_n if mesh_n > 1 and marking.get("mesh")
            and bool(config().get("segment.compile.mesh-fuse", True)) else 0)
        self._mesh_step = None  # the armed fused step (_setup_mesh)
        self._mesh_agg = None
        self._mesh_member = None
        self._mesh_off = False  # latched: fusion declined or failed, host path only
        self._mesh_shapes: set[int] = set()  # padded lengths the fused step ran at
        # cache identity: the traced prefix's configs (tail members never
        # enter the kernel; their configs may hold run-local objects), the
        # node's parallelism, the device, the mesh width (a resize changes
        # the forced-hoist decision) and its placement over device slots
        # (the fused step's K4 runs on the segment's card; each slot takes
        # its shards' rows from there)
        cfgs = [(op, _cfg_fingerprint(c))
                for op, c in chain.cfg_members[: int(marking["prefix"])]]
        placement = config().get("device.mesh-placement") if self._mesh_n else None
        self._seg_key = hashlib.sha1(json.dumps(
            [cfgs, ctx.task_info.parallelism, str(ctx.device), self._mesh_n,
             None if placement is None else str(placement)], default=repr,
        ).encode()).hexdigest()[:16]

    # -- events ---------------------------------------------------------

    def _event(self, level: str, code: str, message: str, **data) -> None:
        from ..obs.events import recorder as _events

        ti = self.ctx.task_info
        _events.record(ti.job_id, level, code, message=message,
                       node=ti.node_id, subtask=ti.subtask_index,
                       data={"segment": self.chain.name(), **data})

    # -- per-batch entry point -----------------------------------------

    def process_batch(self, batch, ctx, collector, input_index=0) -> None:
        # segment.compile.min-rows: batches too small to amortize the launch
        # run interpreted; the two paths are verified interchangeable
        if self._fallback or batch.num_rows < max(1, self._min_rows):
            self.chain.process_batch(batch, ctx, collector, input_index=input_index)
            return
        if self._entry is None or self._sig != _schema_sig(batch):
            verified = self._prepare(batch)
            if self._fallback:
                self.chain.process_batch(batch, ctx, collector, input_index=input_index)
                return
            if verified is not None:
                # fresh build: the verification pass already executed this
                # batch; commit its (proven-equal) outputs
                self._commit(verified, collector)
                return
            if self._entry is None:
                # vacuous first batch (hoisted filter left no survivors): a
                # no-op on both paths; the build retries on the next batch
                return
        if self._mesh_step is not None and self._mesh_execute(batch, collector):
            return
        try:
            res = self._entry.execute(batch, min_rows=self._min_rows,
                                      job_id=self.ctx.task_info.job_id)
        except Exception as e:  # noqa: BLE001 - host-side failures fall back
            if _kernel_error(e):
                raise
            self._mark_fallback(f"{type(e).__name__}: {e}")
            self.chain.process_batch(batch, ctx, collector, input_index=input_index)
            return
        if res is None:
            self._small_streak += 1
            if self._small_streak >= 8:
                self._fallback = True  # cost latch; state paths unaffected
                self.metrics.segment_compiled = False
                self.metrics.segment_reason = (
                    "hoisted-filter survivors stayed under "
                    "segment.compile.min-rows (cost latch)")
            self.chain.process_batch(batch, ctx, collector, input_index=input_index)
            return
        self._small_streak = 0
        self._commit(res, collector)

    # -- compile --------------------------------------------------------

    def _prepare(self, batch: Batch) -> Optional[dict]:
        """Resolve/build the entry for this batch's schema; on a FRESH
        build, returns the verification pass's execute() result for this
        batch (proven bit-equal to the reference) so the caller can commit
        it without re-running; None on cache hit or fallback."""
        sig = _schema_sig(batch)
        key = (self._seg_key, sig)
        members = self.chain.members[: int(self.marking["prefix"])]
        # the insert member's key-transport split must exist before binding
        # (acc lanes extend acc_inputs); dtype-only, so deriving it from the
        # first batch matches what the first surviving batch would do
        err = self._setup_insert(members, batch)
        if err is not None:
            segment_cache.store(key, _Fallback(err))
            self._mark_fallback(err)
            return None
        from ..metrics import registry

        hit, entry = segment_cache.lookup(key)
        if hit:
            if isinstance(entry, _Fallback):
                # a negative entry is no cache hit: the metric counts
                # reuses of a built kernel
                self._mark_fallback(entry.reason)
                return None
            registry.add_segment_cache_hit(self.ctx.task_info.job_id)
            self._entry, self._sig = entry, sig
            self.metrics.segment_compiled = True
            self._setup_mesh(entry)
            self._event(
                "INFO", "SEGMENT_COMPILED",
                f"segment {self.chain.name()} running compiled "
                f"({entry.plan.prefix}/{len(self.chain.members)} members, cache hit)",
                members=entry.plan.prefix, cached=True,
                schema=[list(pair) for pair in sig])
            return None
        t0 = time.perf_counter()
        try:
            plan = _bind(members, len(members), batch,
                         hoist=self._should_hoist(members[0], batch))
            in_dtypes = [np.asarray(batch.columns[n]).dtype for n in plan.traced_in]
            entry = CompiledSegment(plan, _trace_fn(plan, in_dtypes, self.ctx.device), sig)
            # no job_id: the build's total below covers this first shape
            got = entry.execute(batch)
            if got["n"] == 0 and not got["cols"]:
                # the hoisted filter killed the entire first batch: the
                # kernel never ran, so "verification" would be vacuous; do
                # not cache or adopt the unproven entry
                return None
            want = _reference(plan, batch)
            mismatch = _outputs_equal(got, want)
            if mismatch is not None:
                raise SegmentUntraceable(f"verification failed: {mismatch}")
        except SegmentUntraceable as e:
            segment_cache.store(key, _Fallback(str(e)))
            self._mark_fallback(str(e))
            return None
        except Exception as e:  # noqa: BLE001 - host-side failures fall back
            if _kernel_error(e):
                raise
            reason = f"{type(e).__name__}: {e}"
            segment_cache.store(key, _Fallback(reason))
            self._mark_fallback(reason)
            return None
        elapsed = time.perf_counter() - t0
        segment_cache.store(key, entry)
        registry.observe_segment_compile(self.ctx.task_info.job_id, elapsed)
        self._entry, self._sig = entry, sig
        self.metrics.segment_compiled = True
        self._setup_mesh(entry)
        self._event(
            "INFO", "SEGMENT_COMPILED",
            f"segment {self.chain.name()} compiled to one fused kernel "
            f"({plan.prefix}/{len(self.chain.members)} members, "
            f"{elapsed * 1e3:.1f}ms, first batch verified)",
            members=plan.prefix, compile_ms=round(elapsed * 1e3, 2),
            schema=[list(pair) for pair in sig])
        return got

    def _should_hoist(self, m0, batch: Batch) -> bool:
        """Hoist the leading filter out of the kernel when it must be (the
        expression or its columns cannot trace) or when the first batch
        shows it selective enough that compact-then-compute beats masked
        full-length execution. Either choice is correct: the first-batch
        verification covers both shapes."""
        from ..operators.builtin import ValueOperator

        if not isinstance(m0, ValueOperator) or m0.filter is None:
            return False
        if self._mesh_n > 1:
            # the fused mesh step takes no mask, so a leading filter must
            # run on the host; cache keys include the mesh width
            return True
        if expr_traceable(m0.filter) is not None:
            return True
        for name in m0.filter.columns():
            col = batch.columns.get(name)
            if col is None or np.asarray(col).dtype.kind not in "biuf":
                return True
        fm = np.asarray(
            eval_expr(m0.filter, batch.columns, batch.num_rows), dtype=bool)
        return bool(fm.mean() < _HOIST_SELECTIVITY)

    def _setup_insert(self, members, batch: Batch) -> Optional[str]:
        if not self.marking.get("insert"):
            return None
        m = members[-1]
        if m.lane_key_fields is not None:
            return None
        # the split must be derived from the member's OWN input, exactly what
        # process_batch would see, so run the prefix as a one-off pure
        # reference (a group-by column name can shadow a differently-typed
        # source column)
        try:
            probe = _bind(members[:-1], len(members) - 1, batch, probe=True)
        except SegmentUntraceable as e:
            return str(e)
        inter = _reference(probe, batch)["cols"]
        missing = [f for f in m.key_fields if f not in inter]
        if missing:
            return (f"window group-by columns {missing} not produced by "
                    f"the traced prefix")
        m._setup_key_transport(Batch(inter))
        return None

    def _mark_fallback(self, reason: str) -> None:
        self._fallback = True
        self.metrics.segment_compiled = False
        self.metrics.segment_reason = reason
        self._event(
            "WARN", "SEGMENT_FALLBACK",
            f"segment {self.chain.name()} fell back to the interpreted "
            f"path: {reason}", reason=reason)

    # -- mesh fusion ----------------------------------------------------

    def _setup_mesh(self, entry: CompiledSegment) -> None:
        """Arm the fused mesh step for a freshly adopted entry: K4's outputs
        feed the sharded aggregate's exchange + merge on the device. Fusion
        sits on top of the verified per-batch path: a gate that fails
        quietly keeps the host path (no SEGMENT_FALLBACK: the segment is
        still compiled)."""
        self._mesh_step = None
        self._mesh_agg = None
        self._mesh_member = None
        if self._mesh_n <= 1 or self._mesh_off:
            return
        plan = entry.plan
        if plan.insert is None:
            self._mesh_off = True
            return
        # the member resolves BY INDEX against THIS chain (as in _commit)
        member = self.chain.members[plan.insert.member_index]
        from ..parallel.sharded_agg import ShardedAggregator

        # the window operators build their store at first insert; force it
        # (the path an insert would take) to see its type
        agg_fn = getattr(member, "_aggregator", None)
        agg = agg_fn() if agg_fn is not None else getattr(member, "_agg", None)
        if not isinstance(agg, ShardedAggregator):
            self._mesh_off = True
            return
        for si, st in enumerate(plan.stages):
            if (st.kind == "value" and st.member.filter is not None
                    and (si != 0 or plan.prefilter is None)):
                # an in-kernel filter would desync the host prologue (late
                # split, open bins) from the rows the step inserts
                self._mesh_off = True
                return
        # the host prologue bins the VERBATIM event time, so the insert's
        # _timestamp must be the input column untouched
        ts_verbatim = TIMESTAMP_FIELD in plan.traced_in
        for st in plan.stages:
            if (st.kind == "value" and st.member.projections is not None
                    and any(name == TIMESTAMP_FIELD for name, _e in st.member.projections)):
                ts_verbatim = False
        if not ts_verbatim or getattr(member, "mesh_insert_begin", None) is None:
            self._mesh_off = True
            return
        self._mesh_step = agg.fused_step(self._build_mesh_prefix(entry, member),
                                         len(plan.traced_in), 2 * len(plan.wm_stages))
        self._mesh_agg = agg
        self._mesh_member = member
        self._mesh_shapes = set()

    def _build_mesh_prefix(self, entry: CompiledSegment, member) -> Callable:
        """The fused step's prologue: K4 over the padded batch, its insert
        outputs left on the device. Contract (ShardedAggregator.fused_step):
        ``prefix_fn(n, arrays) -> (key_i64, bins_abs, vals, aux)`` with
        device tensors of the padded length (vals None for a count lane of
        ones) and the watermark stages' (max, count) pairs over the batch's
        valid rows as host scalars, computed once over the whole batch (the
        JAX step computes one pair per shard; the host combines shards by
        max and sum, so the values it reads are the same)."""
        plan = entry.plan
        acc = list(zip(member.acc_inputs, member.acc_dtypes))
        insert_has_key = plan.insert_has_key

        prog = entry.fn.program

        def prefix_fn(n: int, arrays):
            packed, outs, mask, _aux = entry.fn.on_device(n, arrays)
            if mask is not None:
                raise SegmentUntraceable("the fused mesh step takes no in-kernel filter")
            bins = outs["__bins"]
            key = (outs["__hash"] if insert_has_key
                   else torch.zeros(bins.shape, dtype=torch.int64, device=bins.device))
            # K4 writes uint64 columns as their int64 bits
            vals = [None if inp is None else
                    outs[f"__val{i}"].view(torch.uint64) if np.dtype(dt) == np.uint64
                    else outs[f"__val{i}"] for i, (inp, dt) in enumerate(acc)]
            # the watermark part of the packed buffer in one read
            P = len(arrays[0])
            wm = packed[prog.out_layout(P).wm_offset:].cpu().numpy()
            return key, bins, vals, list(prog.unpack_wm(wm, P))

        return prefix_fn

    def _mesh_execute(self, batch: Batch, collector) -> bool:
        """One fused micro-batch: the host prologue (hoisted filter, binning
        and padding, then the member's mesh_insert_begin), then K4 and the
        sharded exchange + merge on the device. Returns False to hand the
        batch to the per-batch host path, which recovers it exactly only
        while nothing has changed: a failure of the staging before
        mesh_insert_begin falls back. mesh_insert_begin's bookkeeping (late
        rows, open bins) is not idempotent, so its errors propagate as the
        host path's would; and the step updates the sharded table in place
        (K9, the spill append), so any error inside it fails the job as a
        kernels.KernelError: a re-run on the host path would insert the
        merged rows twice."""
        plan = self._entry.plan
        member = self._mesh_member
        agg = self._mesh_agg
        n = batch.num_rows
        fmask = None
        if plan.prefilter is not None:
            fm = np.asarray(eval_expr(plan.prefilter, batch.columns, n), dtype=bool)
            if not fm.any():
                self._small_streak = 0
                return True  # nothing flows on either path
            if not fm.all():
                survivors = int(fm.sum())
                if survivors < max(1, self._min_rows):
                    return False  # the host path owns the small-batch latch
                fmask = fm
                n = survivors
        try:
            ts = np.asarray(batch.columns[TIMESTAMP_FIELD])
            if fmask is not None:
                ts = ts[fmask]
            bins_abs = ts // _insert_step(member)
            mcols = self.chain._chain_cols(collector)
            p = _padded_size(n)
            if p % agg.n_dev:
                p = -(-p // agg.n_dev) * agg.n_dev
            arrays = []
            for name in plan.traced_in:
                a = np.asarray(batch.columns[name])
                buf = np.zeros(p, dtype=a.dtype)
                if fmask is not None:
                    np.compress(fmask, a, out=buf[:n])
                else:
                    buf[:n] = a
                arrays.append(buf)
        except Exception as e:  # noqa: BLE001 - staging failures fall back
            self._mesh_step = None
            self._mesh_off = True
            self._event(
                "WARN", "SEGMENT_FALLBACK",
                f"segment {self.chain.name()} fused mesh step failed; batches "
                f"continue on the compiled host path: {type(e).__name__}: {e}",
                reason=str(e), mesh=True)
            return False
        ontime = member.mesh_insert_begin(bins_abs, mcols[plan.insert.member_index])
        new_shape = p not in self._mesh_shapes
        self._mesh_shapes.add(p)
        t0 = time.perf_counter()
        try:
            aux = agg.update_fused(
                self._mesh_step, n, 0 if member.base_bin is None else int(member.base_bin),
                ontime, arrays)
        except kernels.KernelError:
            raise
        except Exception as e:  # noqa: BLE001 - the table may hold part of the step
            raise kernels.KernelError(
                f"segment {self.chain.name()}: fused mesh step failed after it "
                f"may have changed the sharded table: {type(e).__name__}: {e}") from e
        if new_shape:
            # the fused step's first call at a padded shape builds K4 there
            from ..metrics import registry

            registry.observe_segment_compile(self.ctx.task_info.job_id,
                                             time.perf_counter() - t0)
        pairs = []
        it = iter(aux)
        for mx in it:
            total = int(np.asarray(next(it)).sum())
            # exact across shards: an empty part reports the dtype floor,
            # which never exceeds a real value
            pairs.append((int(np.asarray(mx).max()) if total else None, total))
        for st, (mx, cnt) in zip(reversed(plan.wm_stages), reversed(pairs)):
            if cnt:
                self.chain.members[st.member_index].observe_batch_max(
                    mx, mcols[st.member_index])
        self._small_streak = 0
        self.metrics.segment_batches += 1
        self.metrics.segment_mesh = True
        _MESH_DISPATCH["fused"] += 1
        return True

    # -- host finish ----------------------------------------------------

    def _commit(self, res: dict, collector) -> None:
        """Feed verified outputs into the members' own state mutation and
        emission methods, in the interpreted path's order: data first
        (terminal collect or window insert), then the watermark state
        machines innermost-first. Members resolve BY INDEX against this
        runner's chain, never via the cached plan's stage objects: a
        cache-hit entry was bound by another operator incarnation."""
        if self._mesh_n > 1:
            _MESH_DISPATCH["host"] += 1
        chain = self.chain
        cols = chain._chain_cols(collector)
        plan = self._entry.plan
        k = res["n"]
        if res["cols"]:  # a batch the hoisted filter emptied launched nothing
            self.metrics.segment_batches += 1
        if plan.insert is not None:
            if k:
                m = chain.members[plan.insert.member_index]
                vals = []
                for i, (inp, dt) in enumerate(zip(m.acc_inputs, m.acc_dtypes)):
                    vals.append(np.ones(k, dtype=dt) if inp is None
                                else res["cols"][f"__val{i}"])
                hashes = (res["cols"]["__hash"] if plan.insert_has_key
                          else np.zeros(k, dtype=np.uint64))
                m.insert_arrays(hashes, res["cols"]["__bins"], vals,
                                cols[plan.insert.member_index])
        elif k:
            out = {name: res["cols"][name] for name, _src in plan.out_plan}
            cols[plan.prefix - 1].collect(Batch(out))
        for st, (mx, cnt) in zip(reversed(plan.wm_stages), reversed(res["aux"])):
            if cnt:
                chain.members[st.member_index].observe_batch_max(mx, cols[st.member_index])


def _schema_sig(batch: Batch) -> tuple:
    return tuple((name, np.asarray(c).dtype.str)
                 for name, c in batch.columns.items())


def _cfg_fingerprint(cfg: dict):
    """JSON-stable view of a member config (exprs as tagged trees; live
    callables dropped the way graph serialization drops them)."""
    from ..graph import _jsonable

    return _jsonable(cfg)


def runner_for(operator, ctx, metrics) -> Optional[SegmentRunner]:
    """The task run loop's hook: a SegmentRunner when ``operator`` is a
    chained run marked compilable at plan time and ``segment.compile.
    enabled`` is on; None means run the interpreted hook loop."""
    if not config().get("segment.compile.enabled", True):
        return None
    from ..operators.chained import ChainedOperator

    if not isinstance(operator, ChainedOperator):
        return None
    marking = operator.compile_marking
    if not marking:
        reason = getattr(operator, "compile_reject", None)
        if reason:
            metrics.segment_reason = reason
        return None
    return SegmentRunner(operator, ctx, metrics, marking)
