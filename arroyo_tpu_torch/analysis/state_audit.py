"""Replay-soundness auditor: prove operator state is checkpoint-covered
(the port's copy of the JAX package's ``analysis/state_audit.py``).

The engine's headline guarantees — byte-exact recovery and exactly-once
sinks via 2PC — rest on a convention the type system cannot see: every
piece of mutable per-operator state an operator grows in its hot path must
be mirrored into the TableManager at barrier time and rebuilt at restore,
and every external side effect of a committing operator must wait for the
job-level commit message. PR 2 and PR 4 each found violations of exactly
this convention by chaos-testing after the fact; this module proves the
invariant statically, over every Operator/SourceOperator subclass in
``operators/``, ``windows/``, and ``connectors/`` (the LR2xx series, same
Diagnostic model as the plan analyzer and repo lint).

Per class the auditor builds a **mutable-state model**: instance
attributes assigned or mutated (``self.x = …``, ``+=``, ``.append`` /
``.add`` / ``.pop`` / …, subscript stores) inside hot-path methods
(``process_batch`` / ``handle_watermark`` / ``handle_tick`` / ``run`` /
``on_close``), resolved through the class's own helper methods (a mutation
in ``_drain()`` called from ``process_batch`` counts) and through sweep-
known base classes. Each hot-mutated attribute is then classified:

    covered          assigned/mutated in the ``on_start`` closure: restore
                     rebuilds it (from restored tables or deterministically)
                     before any batch flows, so replay sees the same value
    barrier-flushed  consumed AND reset inside the ``handle_checkpoint``
                     closure: its pre-barrier content was persisted or
                     emitted at the barrier, and post-barrier content is
                     rebuilt by source replay (e.g. a committing sink's
                     per-epoch buffer)
    lazy-memo        every hot-path store sits under an ``is None`` /
                     identity guard on the attribute itself: a derived
                     cache deterministically rebuilt on first use
    ephemeral        explicitly waived with ``# state: ephemeral — why``
                     on a line (or the line above one) that assigns or
                     mutates the attribute anywhere in the class
    LR201 (ERROR)    none of the above: unregistered mutable state — a
                     crash+restore silently forgets it and replay diverges

Rule catalog:

    LR201 unregistered-mutable-state   hot-path-mutated attribute with no
                                       checkpoint coverage (above)
    LR202 side-effect-not-commit-gated storage put / socket send / broker
                                       publish reachable from the hot path
                                       of a committing class
                                       (``is_committing`` can return True)
                                       must sit under ``handle_commit`` (or
                                       the post-commit control message) —
                                       waive with ``# effect: idempotent —
                                       why`` when the effect is safe to
                                       replay
    LR203 checkpoint-restore-asymmetry table name-sets written at the
                                       barrier, read at restore, and
                                       declared in ``tables()`` must agree
                                       (TableManager.restore loads by the
                                       DECLARED specs; an undeclared table
                                       restores with default retention, an
                                       unrestored one is silent data loss)
    LR204 unordered-iteration-emit     iterating a set/dict without
                                       ``sorted()`` on a path that reaches
                                       ``collector.collect`` — set order
                                       varies across processes (str hash
                                       randomization) and dict insertion
                                       order diverges after a restore, so
                                       emission order is not replay-stable

Waivers: LR201 takes the attribute-bound ``# state: ephemeral — why``
grammar; LR202 takes ``# effect: idempotent — why``; every rule also
accepts the repo-lint ``# lint: waive LR2xx — why`` form. A waiver with no
justification text does not suppress the finding.

The static verdict is cross-checked at runtime: tests/test_state_audit.py
runs a smoke pipeline through the JAX package, checkpoints, restores and
diffs every audited-covered attribute across the roundtrip; the port's
tests (tests/test_torch_state_audit.py) hold its verdicts to the JAX
package's on the same sources.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Iterable, Optional

from .diagnostics import Diagnostic, Severity, finish
from .repo_lint import ModuleInfo, _parse

# hot-path roots: methods the task run loop invokes per batch/signal/tick
HOT_ROOTS = ("process_batch", "process_batches", "handle_watermark",
             "handle_tick", "run", "on_close")
# LR202 scopes to the pre-barrier hot path; on_close is a legitimate final
# commit point (graceful drain: the operator is the only writer left)
EFFECT_ROOTS = ("process_batch", "process_batches", "handle_watermark",
                "handle_tick", "run")
CKPT_ROOT = "handle_checkpoint"
RESTORE_ROOT = "on_start"
COMMIT_ROOT = "handle_commit"

# attribute method calls that mutate the receiver in place
MUTATORS = frozenset({
    "append", "appendleft", "add", "pop", "popleft", "popitem", "push",
    "extend", "extendleft", "update", "insert", "remove", "discard",
    "clear", "setdefault", "sort", "reverse", "rotate",
    # tiered-state annex accessors (state/spill.py): probes tombstone what
    # they promote and spills move ownership, so every one of these is a
    # state mutation the replay contract must cover
    "lookup_many", "scan_expired", "spill", "spill_rows", "probe",
    "touch", "adopt",
})

_STATE_WAIVE_RE = re.compile(
    r"state:\s*ephemeral\s*(?:[-—:,]\s*)?(.*)", re.I)
_EFFECT_WAIVE_RE = re.compile(
    r"effect:\s*idempotent\s*(?:[-—:,]\s*)?(.*)", re.I)

# side-effect call shapes for LR202: (set of trailing call names that are
# effects on ANY receiver) and (names that are effects only with a
# receiver whose identifier suggests an external channel)
_EFFECT_ANY_RECV = frozenset({
    "produce", "publish", "basic_publish", "xadd", "send_message",
    "put_record", "put_records", "sendall",
})
_EFFECT_CHANNEL_RECV = frozenset({"send"})
_CHANNEL_HINTS = ("sock", "ws", "conn", "producer", "channel", "client",
                  "sess", "broker")
_STORAGE_WRITES = frozenset({"write_bytes", "write_text", "put_bytes"})


# --------------------------------------------------------------- AST mining


def _root_self_attr(expr: ast.expr) -> Optional[str]:
    """First attribute above ``self`` in a dotted chain (``self.a.b`` ->
    ``a``); None when the chain does not bottom out at ``self``."""
    attr = None
    while isinstance(expr, ast.Attribute):
        attr = expr.attr
        expr = expr.value
    if isinstance(expr, ast.Name) and expr.id == "self":
        return attr
    return None


def _call_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _recv_ident(call: ast.Call) -> str:
    """Identifier of the receiver (``producer`` in self.producer.produce)."""
    f = call.func
    if isinstance(f, ast.Attribute):
        v = f.value
        if isinstance(v, ast.Name):
            return v.id
        if isinstance(v, ast.Attribute):
            return v.attr
        if isinstance(v, ast.Subscript) and isinstance(v.value, (ast.Name, ast.Attribute)):
            return getattr(v.value, "id", getattr(v.value, "attr", ""))
    return ""


def _dotted(expr: ast.expr) -> str:
    parts: list[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
    return ".".join(reversed(parts))


def _guard_attrs(test: ast.expr) -> set[str]:
    """Attributes null-checked by an ``if`` test made up ONLY of true
    lazy-init shapes: ``self.a is None`` / ``not self.a``. A test mixing
    in any other condition is NOT a memo guard — the monotone-advance
    pattern ``self.a is None or v > self.a`` and the change-tracking
    pattern ``self.a is not new`` both mutate real hot-path state."""
    if isinstance(test, ast.BoolOp):
        out: set[str] = set()
        for v in test.values:
            sub = _guard_attrs(v)
            if not sub:
                return set()
            out |= sub
        return out
    if isinstance(test, ast.Compare) and len(test.ops) == 1 and \
            isinstance(test.ops[0], ast.Is):
        left, right = test.left, test.comparators[0]
        for side, other in ((left, right), (right, left)):
            a = _root_self_attr(side)
            if a and isinstance(other, ast.Constant) and other.value is None:
                return {a}
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        a = _root_self_attr(test.operand)
        if a:
            return {a}
    return set()


@dataclass
class AttrEvent:
    attr: str
    kind: str  # "store" | "mut" | "load"
    line: int
    memo: bool = False  # store under an is-None/identity guard on itself


@dataclass
class MethodModel:
    name: str
    relpath: str
    lineno: int
    events: list[AttrEvent] = field(default_factory=list)
    self_calls: set[str] = field(default_factory=set)
    # (table_name_or_None_if_dynamic, line) per table-manager access
    table_uses: list[tuple[Optional[str], int]] = field(default_factory=list)
    # TableSpec literal names (None = dynamic) declared in this method
    table_specs: list[tuple[Optional[str], int]] = field(default_factory=list)
    collects: bool = False  # calls collector.collect directly
    effects: list[tuple[str, int]] = field(default_factory=list)
    returns_true: bool = False  # any `return` that is not literal False/None
    local_unordered: set[str] = field(default_factory=set)  # set-typed locals
    # locals built as plain dicts in this method: per-call insertion order,
    # reproducible on replay, so iterating them is order-safe
    local_det_dicts: set[str] = field(default_factory=set)
    # (table_name_or_None, line) per checkpoint_manifest/restore_manifest
    # call — the tiered-state manifest convention check (name must end in
    # "__spill")
    manifest_uses: list[tuple[Optional[str], int]] = field(default_factory=list)
    fn: Optional[ast.FunctionDef] = None


_UNORDERED_CTORS = frozenset({"set", "dict", "frozenset", "defaultdict",
                              "Counter", "OrderedDict"})
# set-typed values iterate in hash order (varies across processes under str
# hash randomization); dict-typed ATTRIBUTES iterate in insertion order,
# which diverges once a restore rebuilds them in checkpoint-file order
_SET_CTORS = frozenset({"set", "frozenset"})
_DICT_CTORS = frozenset({"dict", "defaultdict", "Counter", "OrderedDict"})
# consumers that erase iteration order, so an unordered iterable is safe
_ORDER_INSENSITIVE = frozenset({"sorted", "min", "max", "sum", "any", "all",
                                "len", "set", "frozenset"})


def _is_unordered_expr(expr: ast.expr) -> bool:
    if isinstance(expr, (ast.Set, ast.SetComp, ast.Dict, ast.DictComp)):
        return True
    if isinstance(expr, ast.Call) and _call_name(expr) in _UNORDERED_CTORS:
        return True
    return False


def _is_set_expr(expr: ast.expr) -> bool:
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return True
    if isinstance(expr, ast.Call) and _call_name(expr) in _SET_CTORS:
        return True
    return False


def _is_dict_build_expr(expr: ast.expr) -> bool:
    if isinstance(expr, (ast.Dict, ast.DictComp)):
        return True
    if isinstance(expr, ast.Call) and _call_name(expr) in _DICT_CTORS:
        return True
    return False


def _mine_method(fn: ast.FunctionDef, relpath: str) -> MethodModel:
    m = MethodModel(fn.name, relpath, fn.lineno, fn=fn)

    def record_call(n: ast.Call) -> None:
        name = _call_name(n)
        recv = _recv_ident(n)
        if isinstance(n.func, ast.Attribute):
            a = _root_self_attr(n.func.value)
            if a is not None and name in MUTATORS:
                m.events.append(AttrEvent(a, "mut", n.lineno))
            if isinstance(n.func.value, ast.Name) and n.func.value.id == "self":
                m.self_calls.add(name)
        if name in ("global_keyed", "expiring_time_key"):
            arg = n.args[0] if n.args else None
            lit = arg.value if isinstance(arg, ast.Constant) and \
                isinstance(arg.value, str) else None
            m.table_uses.append((lit, n.lineno))
        if name in ("persist_mark", "restore_marks"):
            # the shared meta-mark helpers (operators/base.py) take the
            # table name as their second argument
            arg = n.args[1] if len(n.args) > 1 else None
            lit = arg.value if isinstance(arg, ast.Constant) and \
                isinstance(arg.value, str) else None
            m.table_uses.append((lit, n.lineno))
        if name in ("checkpoint_manifest", "restore_manifest"):
            # tiered-state manifest helpers (state/spill.py): same
            # second-argument table-name shape as persist_mark, and the
            # name must follow the "<base>__spill" convention — the
            # checkpoint metadata and spill-run GC both key on the suffix
            arg = n.args[1] if len(n.args) > 1 else None
            lit = arg.value if isinstance(arg, ast.Constant) and \
                isinstance(arg.value, str) else None
            m.table_uses.append((lit, n.lineno))
            m.manifest_uses.append((lit, n.lineno))
        if name == "TableSpec":
            arg = n.args[0] if n.args else next(
                (k.value for k in n.keywords if k.arg == "name"), None)
            lit = arg.value if isinstance(arg, ast.Constant) and \
                isinstance(arg.value, str) else None
            m.table_specs.append((lit, n.lineno))
        if name == "collect" and "collector" in recv.lower():
            m.collects = True
        # LR202 effect shapes
        if name in _EFFECT_ANY_RECV:
            m.effects.append((f"{recv or '<expr>'}.{name}()", n.lineno))
        elif name in _EFFECT_CHANNEL_RECV and \
                any(h in recv.lower() for h in _CHANNEL_HINTS):
            m.effects.append((f"{recv}.{name}()", n.lineno))
        elif name in _STORAGE_WRITES and "storage" in _dotted(n.func).lower():
            m.effects.append((f"storage.{name}()", n.lineno))
        elif isinstance(n.func, ast.Name) and n.func.id == "open" and \
                len(n.args) >= 2 and isinstance(n.args[1], ast.Constant) and \
                isinstance(n.args[1].value, str) and \
                any(c in n.args[1].value for c in "wax"):
            m.effects.append(("open(..., 'w')", n.lineno))

    def store_target(t: ast.expr, line: int, memo_guarded: frozenset) -> None:
        if isinstance(t, ast.Attribute):
            a = _root_self_attr(t)
            if a is not None:
                if t.attr == a and isinstance(t.value, ast.Name):
                    m.events.append(AttrEvent(a, "store", line,
                                              memo=a in memo_guarded))
                else:  # self.a.b = ... mutates a
                    m.events.append(AttrEvent(a, "mut", line))
        elif isinstance(t, ast.Subscript):
            a = _root_self_attr(t.value)
            if a is not None:
                m.events.append(AttrEvent(a, "mut", line))
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                store_target(e, line, memo_guarded)
        elif isinstance(t, ast.Starred):
            store_target(t.value, line, memo_guarded)

    def walk_expr(e: ast.AST) -> None:
        for n in ast.walk(e):
            if isinstance(n, ast.Call):
                record_call(n)
            elif isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load):
                a = _root_self_attr(n)
                if a is not None:
                    m.events.append(AttrEvent(a, "load", n.lineno))

    def walk_stmts(stmts: Iterable[ast.stmt], memo_guarded: frozenset) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            if isinstance(st, ast.If):
                walk_expr(st.test)
                walk_stmts(st.body,
                           memo_guarded | frozenset(_guard_attrs(st.test)))
                walk_stmts(st.orelse, memo_guarded)
                continue
            if isinstance(st, ast.Assign):
                walk_expr(st.value)
                for t in st.targets:
                    store_target(t, st.lineno, memo_guarded)
                    if isinstance(t, ast.Name):
                        if _is_set_expr(st.value):
                            m.local_unordered.add(t.id)
                        elif _is_dict_build_expr(st.value):
                            m.local_det_dicts.add(t.id)
                continue
            if isinstance(st, (ast.AnnAssign, ast.AugAssign)):
                if st.value is not None:
                    walk_expr(st.value)
                    if isinstance(st, ast.AnnAssign) and \
                            isinstance(st.target, ast.Name):
                        if _is_set_expr(st.value):
                            m.local_unordered.add(st.target.id)
                        elif _is_dict_build_expr(st.value):
                            m.local_det_dicts.add(st.target.id)
                if isinstance(st, ast.AnnAssign) and st.value is None:
                    continue  # bare annotation: no store happens
                kind_guard = memo_guarded if isinstance(st, ast.AnnAssign) \
                    else frozenset()
                t = st.target
                if isinstance(st, ast.AugAssign):
                    if isinstance(t, ast.Attribute):
                        a = _root_self_attr(t)
                        if a is not None:
                            m.events.append(AttrEvent(a, "mut", st.lineno))
                    elif isinstance(t, ast.Subscript):
                        a = _root_self_attr(t.value)
                        if a is not None:
                            m.events.append(AttrEvent(a, "mut", st.lineno))
                        walk_expr(t)
                else:
                    store_target(t, st.lineno, kind_guard)
                continue
            if isinstance(st, ast.Delete):
                for t in st.targets:
                    if isinstance(t, ast.Subscript):
                        a = _root_self_attr(t.value)
                        if a is not None:
                            m.events.append(AttrEvent(a, "mut", st.lineno))
                    elif isinstance(t, ast.Attribute):
                        a = _root_self_attr(t)
                        if a is not None:
                            m.events.append(AttrEvent(a, "mut", st.lineno))
                continue
            if isinstance(st, ast.For):
                walk_expr(st.iter)
                store_target(st.target, st.lineno, frozenset())
                walk_stmts(st.body, memo_guarded)
                walk_stmts(st.orelse, memo_guarded)
                continue
            if isinstance(st, ast.While):
                walk_expr(st.test)
                walk_stmts(st.body, memo_guarded)
                walk_stmts(st.orelse, memo_guarded)
                continue
            if isinstance(st, ast.With):
                for item in st.items:
                    walk_expr(item.context_expr)
                walk_stmts(st.body, memo_guarded)
                continue
            if isinstance(st, ast.Try):
                walk_stmts(st.body, memo_guarded)
                for h in st.handlers:
                    walk_stmts(h.body, memo_guarded)
                walk_stmts(st.orelse, memo_guarded)
                walk_stmts(st.finalbody, memo_guarded)
                continue
            if isinstance(st, ast.Return):
                if st.value is not None:
                    walk_expr(st.value)
                    is_false = isinstance(st.value, ast.Constant) and \
                        st.value.value in (False, None)
                    if not is_false:
                        m.returns_true = True
                continue
            # expression statements and everything else
            for sub in ast.iter_child_nodes(st):
                walk_expr(sub)

    walk_stmts(fn.body, frozenset())
    return m


@dataclass
class ClassModel:
    name: str
    relpath: str
    lineno: int
    bases: list[str]
    own_methods: dict[str, MethodModel]
    module: ModuleInfo

    def qualname(self) -> str:
        return f"{self.relpath}:{self.name}"


def _mine_class(cd: ast.ClassDef, mod: ModuleInfo) -> ClassModel:
    methods = {}
    for st in cd.body:
        if isinstance(st, ast.FunctionDef):
            methods[st.name] = _mine_method(st, mod.relpath)
    return ClassModel(cd.name, mod.relpath, cd.lineno,
                      [_dotted(b) for b in cd.bases], methods, mod)


# -------------------------------------------------------- class resolution


OPERATOR_BASES = ("Operator", "SourceOperator")


class Sweep:
    """All classes mined from the audited modules. Classes are keyed by
    QUALIFIED name (relpath:Class) so two same-named classes in different
    modules are both audited; base references resolve by simple name,
    preferring a same-module definition."""

    def __init__(self) -> None:
        self.classes: dict[str, ClassModel] = {}  # qualname -> model
        self._by_name: dict[str, list[ClassModel]] = {}

    def add_module(self, mod: ModuleInfo) -> None:
        for n in ast.walk(mod.tree):
            if isinstance(n, ast.ClassDef):
                model = _mine_class(n, mod)
                if model.qualname() not in self.classes:
                    self.classes[model.qualname()] = model
                    self._by_name.setdefault(model.name, []).append(model)

    def _resolve_base(self, name: str, relpath: str) -> Optional[ClassModel]:
        cands = self._by_name.get(name, [])
        for c in cands:
            if c.relpath == relpath:
                return c
        return cands[0] if cands else None

    def _base_chain(self, model: ClassModel, seen: set[str]) -> list[ClassModel]:
        out = [model]
        for b in model.bases:
            b = b.rsplit(".", 1)[-1]
            if b in seen:
                continue
            seen.add(b)
            sub = self._resolve_base(b, model.relpath)
            if sub is not None:
                out.extend(self._base_chain(sub, seen))
        return out

    def is_operator(self, model: ClassModel) -> tuple[bool, bool]:
        """(is_operator_subclass, is_source)."""
        names = {model.name}
        for m in self._base_chain(model, {model.name}):
            names.update(b.rsplit(".", 1)[-1] for b in m.bases)
        is_src = "SourceOperator" in names
        return (bool(names & set(OPERATOR_BASES)), is_src)

    def resolved_methods(self, model: ClassModel) -> dict[str, MethodModel]:
        """Own methods plus inherited ones from sweep-known bases
        (nearest definition wins)."""
        out: dict[str, MethodModel] = {}
        for m in self._base_chain(model, {model.name}):
            for name, mm in m.own_methods.items():
                out.setdefault(name, mm)
        return out


# ------------------------------------------------------------ the analysis


@dataclass
class AttrVerdict:
    classification: str  # covered | barrier-flushed | lazy-memo | ephemeral
    #                      | ctor-constant | unregistered
    justification: str = ""
    sites: tuple = ()  # (relpath, line) mutation sites in hot paths


@dataclass
class ClassAudit:
    cls: str  # class name
    relpath: str
    attrs: dict[str, AttrVerdict] = field(default_factory=dict)

    def covered_attrs(self) -> list[str]:
        return sorted(a for a, v in self.attrs.items()
                      if v.classification == "covered")


def _closure(methods: dict[str, MethodModel], roots: Iterable[str]) -> set[str]:
    todo = [r for r in roots if r in methods]
    seen: set[str] = set()
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        todo.extend(c for c in methods[name].self_calls
                    if c in methods and c not in seen)
    return seen


def _attr_waiver(attr: str, methods: dict[str, MethodModel],
                 mods: dict[str, ModuleInfo]) -> Optional[str]:
    """``# state: ephemeral — why`` bound to any line that stores/mutates
    ``attr`` (or the line above it), anywhere in the class — the idiomatic
    spot is the attribute's ``__init__`` assignment."""
    for mm in methods.values():
        mod = mods.get(mm.relpath)
        if mod is None:
            continue
        for ev in mm.events:
            if ev.attr != attr or ev.kind == "load":
                continue
            for ln in (ev.line, ev.line - 1):
                m = _STATE_WAIVE_RE.search(mod.comments.get(ln, ""))
                if m and m.group(1).strip():
                    return m.group(1).strip()
    return None


def _line_waiver(mod: Optional[ModuleInfo], line: int, rule_id: str,
                 extra_re: Optional[re.Pattern] = None) -> Optional[str]:
    if mod is None:
        return None
    just = mod.waiver(line, rule_id)
    if just:
        return just
    if extra_re is not None:
        for ln in (line, line - 1):
            m = extra_re.search(mod.comments.get(ln, ""))
            if m and m.group(1).strip():
                return m.group(1).strip()
    return None


def audit_sweep(sweep: Sweep, mods: dict[str, ModuleInfo]
                ) -> tuple[list[Diagnostic], dict[str, ClassAudit]]:
    diags: list[Diagnostic] = []
    audits: dict[str, ClassAudit] = {}

    for qual in sorted(sweep.classes):
        model = sweep.classes[qual]
        cname = model.name
        is_op, is_source = sweep.is_operator(model)
        if not is_op or cname in OPERATOR_BASES:
            continue
        methods = sweep.resolved_methods(model)
        mod = mods.get(model.relpath)

        hot = _closure(methods, HOT_ROOTS)
        ckpt = _closure(methods, (CKPT_ROOT,))
        restore = _closure(methods, (RESTORE_ROOT,))
        effect_scope = _closure(methods, EFFECT_ROOTS)

        audit = ClassAudit(cname, model.relpath)
        audits[model.qualname()] = audit

        # ---- the per-attribute state model (LR201) -----------------------
        attr_events: dict[str, list[tuple[str, AttrEvent]]] = {}
        for mname, mm in methods.items():
            for ev in mm.events:
                attr_events.setdefault(ev.attr, []).append((mname, ev))

        for attr in sorted(attr_events):
            evs = attr_events[attr]
            hot_muts = [(mn, ev) for mn, ev in evs
                        if mn in hot and ev.kind in ("store", "mut")]
            real_muts = [(mn, ev) for mn, ev in hot_muts
                         if not (ev.kind == "store" and ev.memo)]
            stores_everywhere = [(mn, ev) for mn, ev in evs
                                 if ev.kind in ("store", "mut")]
            if not hot_muts:
                if stores_everywhere and all(mn == "__init__"
                                             for mn, _ in stores_everywhere):
                    audit.attrs[attr] = AttrVerdict("ctor-constant")
                continue
            sites = tuple(sorted({(methods[mn].relpath, ev.line)
                                  for mn, ev in real_muts or hot_muts}))
            restored = any(mn in restore and ev.kind in ("store", "mut")
                           for mn, ev in evs)
            if restored:
                audit.attrs[attr] = AttrVerdict("covered", sites=sites)
                continue
            if not real_muts:
                audit.attrs[attr] = AttrVerdict("lazy-memo", sites=sites)
                continue
            flushed = any(mn in ckpt and ev.kind == "store"
                          for mn, ev in evs) and \
                any(mn in ckpt and ev.kind == "load" for mn, ev in evs)
            if flushed:
                audit.attrs[attr] = AttrVerdict("barrier-flushed", sites=sites)
                continue
            just = _attr_waiver(attr, methods, mods)
            if just is None and sites:
                just = _line_waiver(mods.get(sites[0][0]), sites[0][1], "LR201")
            if just:
                audit.attrs[attr] = AttrVerdict("ephemeral", just, sites)
                continue
            audit.attrs[attr] = AttrVerdict("unregistered", sites=sites)
            rp, line = sites[0]
            diags.append(Diagnostic(
                "LR201", Severity.ERROR, f"{rp}:{line}",
                f"{cname}.{attr} is mutated on the hot path but never "
                "restored in on_start, never flushed at the barrier, and "
                "not waived: a crash+restore silently forgets it, so "
                "replay diverges from the original run",
                "mirror it into a TableManager table in handle_checkpoint "
                "and rebuild it in on_start, or annotate the assignment "
                "with `# state: ephemeral — <why replay-safe>`"))

        # ---- LR202: side effects outside the commit gate -----------------
        committing = any(mm.returns_true
                         for mname, mm in methods.items()
                         if mname == "is_committing")
        if committing:
            for mname in sorted(effect_scope):
                mm = methods[mname]
                for desc, line in mm.effects:
                    emod = mods.get(mm.relpath)
                    if _line_waiver(emod, line, "LR202", _EFFECT_WAIVE_RE):
                        continue
                    diags.append(Diagnostic(
                        "LR202", Severity.ERROR, f"{mm.relpath}:{line}",
                        f"{cname}: external side effect {desc} is reachable "
                        f"from {mname}() but the class commits via 2PC "
                        "(is_committing): effects must wait for "
                        "handle_commit / the commit control message, or a "
                        "replayed epoch re-fires them",
                        "move the effect under handle_commit, or waive with "
                        "`# effect: idempotent — <why replay is safe>`"))

        # ---- LR203: tables written vs restored vs declared ---------------
        decl_m = methods.get("tables")
        declared_pairs = decl_m.table_specs if decl_m else []
        ckpt_uses = [u for mn in ckpt for u in methods[mn].table_uses]
        restore_uses = [u for mn in restore for u in methods[mn].table_uses]
        if is_source and "run" in methods:
            run_cl = _closure(methods, ("run",))
            run_uses = [u for mn in run_cl for u in methods[mn].table_uses]
            ckpt_uses += run_uses
            restore_uses += run_uses
        dynamic = any(n is None for n, _ in declared_pairs) or \
            any(n is None for n, _ in ckpt_uses + restore_uses)
        if not dynamic and (declared_pairs or ckpt_uses or restore_uses):
            declared = {n for n, _ in declared_pairs}
            written = {n for n, _ in ckpt_uses}
            restored_t = {n for n, _ in restore_uses}
            site = f"{model.relpath}:{model.lineno}"
            if not _line_waiver(mod, model.lineno, "LR203"):
                for n in sorted(written - declared):
                    diags.append(Diagnostic(
                        "LR203", Severity.ERROR, site,
                        f"{cname} writes state table {n!r} at the barrier "
                        "but does not declare it in tables(): restore loads "
                        "by the declared specs, so this table comes back "
                        "with default retention (or not at all)",
                        f"add TableSpec({n!r}, ...) to tables()"))
                for n in sorted(restored_t - declared):
                    diags.append(Diagnostic(
                        "LR203", Severity.ERROR, site,
                        f"{cname} restores state table {n!r} in on_start "
                        "but does not declare it in tables()",
                        f"add TableSpec({n!r}, ...) to tables()"))
                for n in sorted(written - restored_t):
                    diags.append(Diagnostic(
                        "LR203", Severity.ERROR, site,
                        f"{cname} writes state table {n!r} at the barrier "
                        "but never reads it at restore: the snapshot is "
                        "dead weight and the state it mirrors is silently "
                        "lost on recovery",
                        "load it in on_start (table_manager."
                        f"global_keyed/expiring_time_key({n!r}))"))
                for n in sorted(restored_t - written):
                    diags.append(Diagnostic(
                        "LR203", Severity.ERROR, site,
                        f"{cname} restores state table {n!r} in on_start "
                        "but never writes it at the barrier: after the "
                        "first checkpoint the restored value is stale",
                        "write it in handle_checkpoint"))
                for n in sorted(declared - written - restored_t):
                    diags.append(Diagnostic(
                        "LR203", Severity.WARNING, site,
                        f"{cname} declares state table {n!r} in tables() "
                        "but neither writes it at the barrier nor reads it "
                        "at restore",
                        "remove the declaration or wire the table"))

        # ---- LR203b: the spill-manifest table name convention ------------
        # checkpoint metadata lifts run references and the spill-run GC
        # scans for liveness keyed on the "__spill" suffix: a manifest
        # persisted under any other name checkpoints fine but its runs are
        # invisible to GC liveness — they would be deleted under a live
        # checkpoint
        for mname, mm in sorted(model.own_methods.items()):
            for lit, line in mm.manifest_uses:
                if lit is None or lit.endswith("__spill"):
                    continue
                if _line_waiver(mods.get(mm.relpath), line, "LR203"):
                    continue
                diags.append(Diagnostic(
                    "LR203", Severity.ERROR, f"{mm.relpath}:{line}",
                    f"{cname}: spill manifest table {lit!r} does not end "
                    "in '__spill': checkpoint metadata and spill-run GC "
                    "both key on that suffix, so the runs this manifest "
                    "references are invisible to liveness tracking and "
                    "get deleted under a live checkpoint",
                    "name the manifest table '<base>__spill'"))

        # ---- LR204: unordered iteration feeding emission -----------------
        unordered_attrs: set[str] = set()
        for mm in methods.values():
            if mm.fn is None:
                continue
            for st in ast.walk(mm.fn):
                if isinstance(st, ast.Assign):
                    targets = st.targets
                elif isinstance(st, ast.AnnAssign) and st.value is not None:
                    targets = [st.target]  # `self.buf: dict = {}` style
                else:
                    continue
                if not _is_unordered_expr(st.value):
                    continue
                for t in targets:
                    if isinstance(t, ast.Attribute) and \
                            _root_self_attr(t) == t.attr:
                        unordered_attrs.add(t.attr)
        emit_scope = hot | ckpt
        collecting = {mn for mn in methods if methods[mn].collects}
        # methods whose closure reaches a collect call
        reaches_collect = {mn for mn in methods
                           if _closure(methods, (mn,)) & collecting}
        for mname in sorted(emit_scope & reaches_collect):
            mm = methods[mname]
            if mm.fn is None:
                continue
            # arguments of order-insensitive consumers are exempt
            # (``sorted(x for x in self.buf)`` is the FIX, not a finding)
            exempt: set[int] = set()
            for n in ast.walk(mm.fn):
                if isinstance(n, ast.Call) and \
                        _call_name(n) in _ORDER_INSENSITIVE:
                    for a in ast.walk(n):
                        if a is not n:
                            exempt.add(id(a))
            iters: list[tuple[ast.expr, int]] = []
            for n in ast.walk(mm.fn):
                if isinstance(n, ast.For) and id(n.iter) not in exempt:
                    iters.append((n.iter, n.lineno))
                elif isinstance(n, (ast.ListComp, ast.SetComp, ast.DictComp,
                                    ast.GeneratorExp)) and id(n) not in exempt:
                    iters.extend((g.iter, n.lineno) for g in n.generators
                                 if id(g.iter) not in exempt)
            for it, lineno in iters:
                flagged = None
                if isinstance(it, ast.Call) and _call_name(it) in (
                        "keys", "values", "items"):
                    recv = it.func.value if isinstance(it.func, ast.Attribute) \
                        else None
                    a = _root_self_attr(recv) if recv is not None else None
                    nm = a or (recv.id if isinstance(recv, ast.Name) else "")
                    if isinstance(recv, ast.Name) and \
                            recv.id in mm.local_det_dicts:
                        continue  # per-call dict: replay-deterministic order
                    if isinstance(recv, ast.Attribute) and \
                            recv.attr == "columns":
                        # Batch.columns insertion order is fixed by batch
                        # construction, identical across replays
                        continue
                    flagged = f"{'self.' + a if a else nm or '<expr>'}." \
                              f"{_call_name(it)}()"
                elif isinstance(it, ast.Attribute):
                    a = _root_self_attr(it)
                    if a in unordered_attrs:
                        flagged = f"self.{a}"
                elif isinstance(it, ast.Name) and it.id in mm.local_unordered:
                    flagged = it.id
                elif isinstance(it, ast.Call) and _call_name(it) in _SET_CTORS:
                    flagged = f"{_call_name(it)}(...)"
                if flagged is None:
                    continue
                lmod = mods.get(mm.relpath)
                if _line_waiver(lmod, lineno, "LR204"):
                    continue
                diags.append(Diagnostic(
                    "LR204", Severity.ERROR, f"{mm.relpath}:{lineno}",
                    f"{cname}.{mname} iterates {flagged} (set/dict order) "
                    "on a path that reaches collector.collect: set order "
                    "varies across processes and dict insertion order "
                    "diverges after a restore, so emitted row order is not "
                    "replay-stable",
                    "iterate sorted(...) (or an explicitly ordered "
                    "structure), or waive with justification if order "
                    "provably cannot reach the output"))

    return finish(diags), audits


# ------------------------------------------------------------- entry points

AUDITED_DIRS = ("operators", "windows", "connectors")

RULES = ("LR201", "LR202", "LR203", "LR204")


def audit_modules(infos: list[ModuleInfo]) -> tuple[list[Diagnostic],
                                                    dict[str, ClassAudit]]:
    """Audit already-parsed modules (the lint sweep hands its own)."""
    sweep = Sweep()
    mods: dict[str, ModuleInfo] = {}
    for info in infos:
        mods[info.relpath] = info
        sweep.add_module(info)
    return audit_sweep(sweep, mods)


def audit_source(source: str, relpath: str = "operators/fixture.py"
                 ) -> list[Diagnostic]:
    """Audit one file's text (test surface)."""
    return audit_modules([_parse(source, relpath)])[0]


def audit_package(pkg_dir: Optional[str] = None
                  ) -> tuple[list[Diagnostic], dict[str, ClassAudit]]:
    """Audit the installed package's operator/window/connector modules."""
    if pkg_dir is None:
        import arroyo_tpu_torch

        pkg_dir = os.path.dirname(os.path.abspath(arroyo_tpu_torch.__file__))
    root = os.path.dirname(pkg_dir)
    infos: list[ModuleInfo] = []
    for d in AUDITED_DIRS:
        base = os.path.join(pkg_dir, d)
        if not os.path.isdir(base):
            continue
        for fname in sorted(os.listdir(base)):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(base, fname)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path) as f:
                infos.append(_parse(f.read(), rel))
    return audit_modules(infos)


def coverage_for_class(cls: type,
                       audits: Optional[dict[str, ClassAudit]] = None
                       ) -> Optional[ClassAudit]:
    """The audit entry for a live operator class (runtime cross-check
    surface): matched against the package audit by defining module + name
    where possible (same-named classes in different modules stay distinct),
    walking the MRO so test subclasses resolve to their audited base."""
    if audits is None:
        audits = audit_package()[1]
    for base in cls.__mro__:
        relpath = base.__module__.replace(".", "/") + ".py"
        hit = audits.get(f"{relpath}:{base.__name__}")
        if hit is not None:
            return hit
    by_name = {a.cls: a for a in audits.values()}
    for base in cls.__mro__:
        if base.__name__ in by_name:
            return by_name[base.__name__]
    return None
