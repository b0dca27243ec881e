"""Concurrency auditor: whole-program lock/thread analysis (LR4xx; the
port's copy of the JAX package's ``analysis/concurrency_audit.py``).

The control plane holds five threaded subsystems — fleet admission, the
evolve state machine, the background capacity probe, the node daemon, and
the buffered data plane — whose safety rested on convention (the reference
runtime gets these guarantees from Rust ownership). This pass makes the
convention checkable, in the spirit of RacerD's lock-region reasoning,
over every module under ``engine/``, ``state/`` and ``controller/``.

Per class the auditor builds two models:

**Thread-role model** — which methods run on which thread. Roles are
seeded from ``threading.Thread(target=self._m, name="...")`` call sites
(the thread's ``name=`` constant, else the target method name; nested
``def`` targets become pseudo-methods of the class since they close over
``self``) and from the annotation grammar ``# thread: <role>`` on a
``def`` line for dynamically-dispatched entry points (e.g. HTTP handler
routes). Public methods — and private methods no same-class code calls —
additionally carry the implicit ``caller`` role (they are entered from
outside the class, on whatever thread the caller runs). Roles propagate
through same-class ``self.*()`` calls. ``__init__`` carries no role: it
happens-before every thread the object starts.

**Lock-attribution map** — which ``self.*`` attributes are read/mutated
while which locks are held. Lock attributes are mined from
``threading.Lock/RLock/Condition`` (and ``obs.lockorder.make_lock``)
assignments; ``Condition(self._lock)`` aliases to its underlying lock.
``with self.<lock>:`` regions are tracked through a statement walk, and a
private helper only ever called with a lock held inherits that lock as
its entry context (fixpoint over same-class call sites), so attribution
survives the extract-a-helper refactor that blinds intraprocedural
checks.

Rule catalog:

    LR401 (ERROR)  unlocked-shared-attr  attribute written outside
                   ``__init__`` and accessed on >= 2 thread roles with no
                   single lock common to every access (or, in lock-free
                   classes, written on >= 2 roles). Waive per attribute
                   with ``# concurrency: single-writer — why`` on (or
                   above) a write line
    LR402 (ERROR)  lock-order-cycle      cycle in the global
                   acquires-while-holding graph over ``Class.attr`` lock
                   nodes (edges from nested ``with`` regions, same-class
                   helper closures, and cross-class calls through typed
                   attributes); also re-acquiring a non-reentrant lock
                   already held (self-deadlock)
    LR403 (ERROR)  lock-across-blocking  blocking call (sleep / socket /
                   storage / queue / join / os.write) while holding a
                   lock — interprocedural: follows same-class helper
                   calls and lock entry contexts, subsuming LR105, whose
                   id still binds as a waiver alias.
                   ``Condition.wait`` on a condition whose underlying
                   lock is held is exempt (wait releases it)
    LR404 (WARNING) non-atomic-check-act  an ``if``/``while`` test reads
                   a shared attribute under one lock set and a write to
                   the same attribute in the guarded body runs under a
                   disjoint one — the fleet-ledger/queue-position shape.
                   Only fires for attributes the class elsewhere writes
                   under a lock (i.e. treats as shared)

Waivers: LR401/LR404 take the attribute-bound ``# concurrency:
single-writer — why`` grammar; every rule also accepts the repo-lint
``# lint: waive LR4xx — why`` form (LR403 additionally accepts the
legacy ``LR105`` id). A waiver with no justification does not suppress.

The static LR402 graph is cross-checked at runtime: ``obs/lockorder.py``
wraps production locks (opt-in) and records acquires-while-holding edges
while the test suite runs; tests/test_torch_concurrency_audit.py asserts every
observed edge appears in the static graph.

Known approximations (documented, deliberate): nested functions that are
not thread targets are skipped (they run inline; their lock regions are
rare in this codebase); cross-class calls contribute lock-order edges but
not blocking reach; role propagation stays within one class.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Iterable, Optional

from .diagnostics import Diagnostic, Severity, finish
from .repo_lint import (ModuleInfo, _call_name, _dotted, _mentions_lock,
                        _parse, _receiver_name, _walk_skipping_nested_defs)

RULES: tuple[str, ...] = ("LR401", "LR402", "LR403", "LR404")

# modules audited (the threaded control/data plane); every parsed module
# still contributes classes so cross-class lock references resolve
_AUDIT_DIRS = ("engine", "state", "controller")

_CONC_WAIVE_RE = re.compile(
    r"concurrency:\s*single-writer\s*(?:[-—:,]\s*)?(.*)", re.I)
_ROLE_RE = re.compile(r"#\s*thread:\s*([A-Za-z0-9_.\-]+)")

# in-place mutators on an attribute receiver (self.x.append(...) mutates x)
_MUTATORS = frozenset({
    "append", "appendleft", "add", "pop", "popleft", "popitem", "push",
    "extend", "extendleft", "update", "insert", "remove", "discard",
    "clear", "setdefault", "sort", "reverse", "rotate",
})

# blocking sinks (superset of the retired intraprocedural LR105 list:
# os.write/os.read are added because the data plane writes socket fds
# through them, and Event/Condition waits through the sync-attr model)
_BLOCKING = frozenset({
    "sleep", "sendall", "recv", "accept", "connect", "urlopen",
    "check_output", "put_bytes", "get_bytes", "read_bytes", "write_bytes",
})


# --------------------------------------------------------------- data model


@dataclass
class LockAttr:
    attr: str
    kind: str  # "lock" | "rlock" | "cond"
    alias_of: Optional[str]  # Condition(self._lock) -> "_lock"
    line: int


@dataclass
class Access:
    attr: str
    kind: str  # "store" | "mut" | "load"
    line: int
    locks: frozenset  # lock keys held at the site (mined, pre-entry-ctx)


@dataclass
class SelfCall:
    callee: str
    line: int
    locks: frozenset
    caller: str


@dataclass
class Blocking:
    name: str
    line: int
    locks: frozenset
    cond_key: Optional[str]  # set for Condition.wait: its underlying lock


@dataclass
class Acquire:
    key: str
    line: int
    held: frozenset


@dataclass
class ForeignCall:
    attr: str  # self.<attr>.<method>() receiver attribute
    method: str
    line: int
    locks: frozenset


@dataclass
class CheckAct:
    attr: str
    check_line: int
    check_locks: frozenset
    act_line: int
    act_locks: frozenset


@dataclass
class MethodModel:
    name: str
    fn: ast.AST
    accesses: list = field(default_factory=list)
    self_calls: list = field(default_factory=list)
    blocking: list = field(default_factory=list)
    acquires: list = field(default_factory=list)
    foreign_calls: list = field(default_factory=list)
    checkacts: list = field(default_factory=list)
    ann_role: Optional[str] = None  # from `# thread: <role>`
    pseudo: bool = False  # nested-def thread target
    entry_locks: frozenset = frozenset()
    roles: set = field(default_factory=set)


@dataclass
class ClassModel:
    name: str
    mod: ModuleInfo
    node: ast.ClassDef
    locks: dict = field(default_factory=dict)  # attr -> LockAttr
    events: set = field(default_factory=set)  # threading.Event attrs
    attr_types: dict = field(default_factory=dict)  # attr -> class name
    methods: dict = field(default_factory=dict)  # name -> MethodModel
    thread_seeds: dict = field(default_factory=dict)  # method -> role

    def sync_attrs(self) -> set:
        return set(self.locks) | self.events

    def lock_key(self, attr: str) -> str:
        """Canonical graph node for a lock attribute of this class,
        resolved through Condition aliasing."""
        la = self.locks.get(attr)
        seen = set()
        while la is not None and la.alias_of and la.alias_of not in seen:
            seen.add(la.alias_of)
            attr = la.alias_of
            la = self.locks.get(attr)
        return f"{self.name}.{attr}"

    def lock_kind(self, attr: str) -> str:
        la = self.locks.get(attr)
        if la is not None and la.alias_of and la.alias_of in self.locks:
            la = self.locks[la.alias_of]
        return la.kind if la is not None else "lock"


# ------------------------------------------------------------- class mining


def _root_self_attr(expr: ast.expr) -> Optional[str]:
    """The X in self.X / self.X[...] / self.X.y (store targets)."""
    while isinstance(expr, ast.Subscript):
        expr = expr.value
    # peel trailing attribute chain down to the one hanging off `self`
    chain = expr
    while isinstance(chain, ast.Attribute):
        if isinstance(chain.value, ast.Name) and chain.value.id == "self":
            return chain.attr
        chain = chain.value
    return None


def _kwarg(call: ast.Call, name: str) -> Optional[ast.expr]:
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _self_attr_of(expr: ast.expr) -> Optional[str]:
    if isinstance(expr, ast.Attribute) and \
            isinstance(expr.value, ast.Name) and expr.value.id == "self":
        return expr.attr
    return None


def _lock_ctor(mod: ModuleInfo, call: ast.Call):
    """(kind, alias_attr) when `call` constructs a lock/condition, else
    None. Recognizes threading primitives and obs.lockorder.make_lock."""
    dn = mod.canonical(_dotted(call.func))
    base = dn.rsplit(".", 1)[-1]
    kind = alias = None
    if dn.startswith("threading.") and base in (
            "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"):
        kind = {"RLock": "rlock", "Condition": "cond"}.get(base, "lock")
    elif base == "make_lock":
        kv = _kwarg(call, "kind")
        kind = kv.value if isinstance(kv, ast.Constant) and \
            isinstance(kv.value, str) else "lock"
    if kind is None:
        return None
    lock_arg = _kwarg(call, "lock")
    if lock_arg is None and kind == "cond" and call.args:
        lock_arg = call.args[0]
    if lock_arg is not None:
        alias = _self_attr_of(lock_arg)
    return kind, alias


def _ann_name(ann: Optional[ast.expr]) -> Optional[str]:
    """Class name out of a parameter annotation: handles ``C``, ``m.C``,
    ``"C"`` forward refs, ``Optional[C]`` and ``C | None``."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        t = ann.value.strip().strip("\"'").rsplit(".", 1)[-1]
        return t if t and t != "None" else None
    if isinstance(ann, ast.Subscript):
        return _ann_name(ann.slice)
    if isinstance(ann, ast.BinOp):
        return _ann_name(ann.left) or _ann_name(ann.right)
    t = _dotted(ann).rsplit(".", 1)[-1]
    return t if t and t != "None" else None


def _thread_name_const(call: ast.Call) -> Optional[str]:
    nv = _kwarg(call, "name")
    if isinstance(nv, ast.Constant) and isinstance(nv.value, str):
        return nv.value
    if isinstance(nv, ast.JoinedStr):
        for v in nv.values:  # f"ckpt-gc-{job}" -> "ckpt-gc"
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                piece = v.value.strip().rstrip("-_. ")
                if piece:
                    return piece
    return None


def _def_role(mod: ModuleInfo, fn: ast.AST) -> Optional[str]:
    for ln in (fn.lineno, fn.lineno - 1):
        m = _ROLE_RE.search(mod.comments.get(ln, ""))
        if m:
            return m.group(1)
    return None


class Sweep:
    """Whole-program view: every class in the sweep, keyed by name, plus
    the subset of modules the LR4xx rules actually audit."""

    def __init__(self) -> None:
        self.classes: dict[str, ClassModel] = {}
        self.audited: list[ModuleInfo] = []
        self._acq_memo: dict[tuple[str, str], frozenset] = {}

    def add_module(self, mod: ModuleInfo) -> None:
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                self.classes[node.name] = _mine_class(mod, node)
        if mod.in_dirs(*_AUDIT_DIRS):
            self.audited.append(mod)

    # transitive lock keys acquired by Class.method and its same-class
    # callees (for cross-class lock-order edges)
    def acquired_closure(self, cls_name: str, method: str) -> frozenset:
        key = (cls_name, method)
        if key in self._acq_memo:
            return self._acq_memo[key]
        self._acq_memo[key] = frozenset()  # cycle guard
        cm = self.classes.get(cls_name)
        if cm is None or method not in cm.methods:
            return frozenset()
        out = set()
        stack, seen = [method], set()
        while stack:
            m = stack.pop()
            if m in seen or m not in cm.methods:
                continue
            seen.add(m)
            mm = cm.methods[m]
            out.update(a.key for a in mm.acquires if not a.key.startswith("<"))
            stack.extend(c.callee for c in mm.self_calls)
        self._acq_memo[key] = frozenset(out)
        return self._acq_memo[key]


def _mine_class(mod: ModuleInfo, cnode: ast.ClassDef) -> ClassModel:
    cm = ClassModel(cnode.name, mod, cnode)
    defs = [n for n in cnode.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]

    # ---- pass 1: sync attrs, attr types, thread seeds --------------------
    for fn in defs:
        ann: dict[str, str] = {}
        for a in list(fn.args.args) + list(fn.args.kwonlyargs):
            t = _ann_name(a.annotation)
            if t:
                ann[a.arg] = t
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign) and len(n.targets) == 1:
                attr = _self_attr_of(n.targets[0])
                if attr is None:
                    continue
                if isinstance(n.value, ast.Call):
                    lc = _lock_ctor(mod, n.value)
                    if lc is not None:
                        kind, alias = lc
                        cm.locks[attr] = LockAttr(attr, kind, alias, n.lineno)
                        continue
                    dn = mod.canonical(_dotted(n.value.func))
                    if dn in ("threading.Event",):
                        cm.events.add(attr)
                        continue
                    ctor = dn.rsplit(".", 1)[-1]
                    if ctor[:1].isupper():
                        cm.attr_types.setdefault(attr, ctor)
                elif isinstance(n.value, ast.Name) and n.value.id in ann:
                    cm.attr_types.setdefault(attr, ann[n.value.id])
            if isinstance(n, ast.Call):
                dn = mod.canonical(_dotted(n.func))
                if dn.rsplit(".", 1)[-1] != "Thread" or \
                        not (dn.startswith("threading.") or dn == "Thread"):
                    continue
                target = _kwarg(n, "target")
                role = _thread_name_const(n) or ""
                tattr = _self_attr_of(target) if target is not None else None
                if tattr is not None:
                    cm.thread_seeds[tattr] = role or tattr
                elif isinstance(target, ast.Name):
                    # nested `def _probe(): ...` closing over self: register
                    # as a pseudo-method carrying the thread role
                    for inner in ast.walk(fn):
                        if isinstance(inner, ast.FunctionDef) and \
                                inner.name == target.id and inner is not fn:
                            pname = f"{fn.name}.{inner.name}"
                            mm = MethodModel(pname, inner, pseudo=True)
                            cm.methods[pname] = mm
                            cm.thread_seeds[pname] = role or inner.name
                            break

    # ---- pass 2: mine every method body ----------------------------------
    for fn in defs:
        mm = MethodModel(fn.name, fn)
        mm.ann_role = _def_role(mod, fn)
        cm.methods[fn.name] = mm
        _mine_method(mod, cm, mm)
    for mm in cm.methods.values():
        if mm.pseudo:
            _mine_method(mod, cm, mm)
    return cm


def _mine_method(mod: ModuleInfo, cm: ClassModel, mm: MethodModel) -> None:
    sync = cm.sync_attrs()

    def lock_key_of(expr: ast.expr) -> Optional[str]:
        attr = _self_attr_of(expr)
        if attr is not None:
            if attr in cm.locks:
                return cm.lock_key(attr)
            if "lock" in attr.lower() or "cond" in attr.lower():
                return f"{cm.name}.{attr}"  # untracked but lock-named
            return None
        if isinstance(expr, ast.Attribute):  # self.obj._lock / foreign
            owner = _self_attr_of(expr.value)
            if owner is not None:
                tname = cm.attr_types.get(owner)
                leaf = expr.attr
                if "lock" in leaf.lower() or "cond" in leaf.lower():
                    return f"{tname or '?'}.{leaf}"
        if isinstance(expr, ast.Name) and "lock" in expr.id.lower():
            return f"<local:{expr.id}>"  # held for LR403, not a graph node
        return None

    def cond_key_of(attr: str) -> Optional[str]:
        la = cm.locks.get(attr)
        if la is not None and la.kind == "cond":
            return cm.lock_key(attr)
        return None

    def record_store(target: ast.expr, held: frozenset, checks) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                record_store(el, held, checks)
            return
        attr = _root_self_attr(target)
        if attr is None or attr in sync:
            return
        kind = "store" if _self_attr_of(target) is not None else "mut"
        mm.accesses.append(Access(attr, kind, target.lineno, held))
        _match_check(attr, target.lineno, held, checks)

    def _match_check(attr: str, line: int, held: frozenset, checks) -> None:
        for attrs, locks, cline in reversed(checks):
            if attr in attrs:
                mm.checkacts.append(CheckAct(attr, cline, locks, line, held))
                return

    def handle_call(n: ast.Call, held: frozenset) -> None:
        name = _call_name(n)
        recv = _receiver_name(n)
        dn = mod.canonical(_dotted(n.func))
        fv = getattr(n.func, "value", None)
        # same-class call: self.m(...)
        callee_attr = _self_attr_of(n.func) if \
            isinstance(n.func, ast.Attribute) else None
        if callee_attr is not None and callee_attr not in sync:
            mm.self_calls.append(SelfCall(callee_attr, n.lineno, held,
                                          mm.name))
        # explicit acquire on a lock-valued expression
        if name == "acquire" and fv is not None:
            k = lock_key_of(fv)
            if k is not None:
                mm.acquires.append(Acquire(k, n.lineno, held))
                return
        # in-place mutation through a method (self.x.append(...))
        if name in _MUTATORS and fv is not None:
            attr = _root_self_attr(fv)
            if attr is not None and attr not in sync:
                mm.accesses.append(Access(attr, "mut", n.lineno, held))
        # cross-class call through a typed attribute (self.db.record(...))
        if fv is not None and isinstance(fv, ast.Attribute):
            owner = _self_attr_of(fv)
            if owner is not None and owner in cm.attr_types:
                mm.foreign_calls.append(ForeignCall(
                    owner, name, n.lineno, held))
        # blocking classification ----------------------------------------
        blocking = name in _BLOCKING or dn in ("os.write", "os.read")
        cond_key = None
        if name == "join" and recv not in ("path", "os") and not blocking:
            blocking = not isinstance(fv, ast.Constant)
        if name in ("get", "put") and (
                "queue" in recv.lower() or "inbox" in recv.lower()):
            # dict-style .get(key[, default]) carries positional args; a
            # blocking queue get() has none. put(item) always has one, so
            # only the block=False kwarg exempts it.
            blocking = not any(
                k.arg == "block" and isinstance(k.value, ast.Constant)
                and k.value.value is False for k in n.keywords)
            if name == "get" and n.args:
                blocking = False
        if name in ("wait", "wait_for") and fv is not None:
            wattr = _self_attr_of(fv)
            if wattr is not None:
                if wattr in cm.locks and cm.locks[wattr].kind == "cond":
                    blocking, cond_key = True, cond_key_of(wattr)
                elif wattr in cm.events:
                    blocking = True
        if blocking:
            mm.blocking.append(Blocking(name, n.lineno, held, cond_key))

    def scan_value(expr: Optional[ast.expr], held: frozenset, checks,
                   is_check: bool = False) -> set:
        """Record loads/calls inside one expression; returns the self
        attrs loaded (used to seed LR404 check frames)."""
        loaded: set = set()
        if expr is None:
            return loaded
        skip: set = set()
        stack = [expr]
        while stack:
            n = stack.pop()
            if isinstance(n, ast.Lambda):
                continue
            if isinstance(n, ast.Call):
                handle_call(n, held)
                if isinstance(n.func, ast.Attribute):
                    skip.add(id(n.func))
            elif isinstance(n, ast.Attribute) and id(n) not in skip:
                attr = _self_attr_of(n)
                if attr is not None and attr not in sync and \
                        isinstance(n.ctx, ast.Load):
                    mm.accesses.append(Access(attr, "load", n.lineno, held))
                    loaded.add(attr)
            stack.extend(ast.iter_child_nodes(n))
        return loaded if is_check else loaded

    def walk_stmts(stmts, held: frozenset, checks) -> None:
        for st in stmts:
            walk_stmt(st, held, checks)

    def walk_stmt(st: ast.stmt, held: frozenset, checks) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return  # nested defs run later / are mined as pseudo-methods
        if isinstance(st, ast.With):
            new_held = set(held)
            for item in st.items:
                k = lock_key_of(item.context_expr)
                if k is None and _mentions_lock(item.context_expr):
                    k = f"<anon:{item.context_expr.lineno}>"
                scan_value(item.context_expr, held, checks)
                if k is None:
                    continue
                if k in held:
                    # re-entry: legal for rlocks, self-deadlock otherwise
                    mm.acquires.append(Acquire(k, st.lineno, frozenset(held)))
                else:
                    mm.acquires.append(Acquire(k, st.lineno, frozenset(held)))
                    new_held.add(k)
            walk_stmts(st.body, frozenset(new_held), checks)
            return
        if isinstance(st, (ast.If, ast.While)):
            guard = scan_value(st.test, held, checks, is_check=True)
            frame = (guard, held, st.lineno) if guard else None
            sub = checks + [frame] if frame else checks
            walk_stmts(st.body, held, sub)
            walk_stmts(st.orelse, held, sub)
            return
        if isinstance(st, ast.For):
            scan_value(st.iter, held, checks)
            walk_stmts(st.body, held, checks)
            walk_stmts(st.orelse, held, checks)
            return
        if isinstance(st, ast.Try):
            walk_stmts(st.body, held, checks)
            for h in st.handlers:
                walk_stmts(h.body, held, checks)
            walk_stmts(st.orelse, held, checks)
            walk_stmts(st.finalbody, held, checks)
            return
        if isinstance(st, ast.Assign):
            scan_value(st.value, held, checks)
            for t in st.targets:
                record_store(t, held, checks)
                if isinstance(t, ast.Subscript):
                    scan_value(t.slice, held, checks)
            return
        if isinstance(st, ast.AugAssign):
            scan_value(st.value, held, checks)
            attr = _root_self_attr(st.target)
            if attr is not None and attr not in sync:
                mm.accesses.append(Access(attr, "mut", st.lineno, held))
                _match_check(attr, st.lineno, held, checks)
            return
        if isinstance(st, ast.AnnAssign):
            scan_value(st.value, held, checks)
            if st.value is not None:
                record_store(st.target, held, checks)
            return
        if isinstance(st, ast.Delete):
            for t in st.targets:
                attr = _root_self_attr(t)
                if attr is not None and attr not in sync:
                    mm.accesses.append(Access(attr, "mut", st.lineno, held))
            return
        # generic statement: scan its expressions, recurse into any bodies
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                scan_value(child, held, checks)
            elif isinstance(child, ast.stmt):
                walk_stmt(child, held, checks)

    body = mm.fn.body if isinstance(
        mm.fn, (ast.FunctionDef, ast.AsyncFunctionDef)) else []
    walk_stmts(body, frozenset(), [])


# -------------------------------------------------- roles + entry contexts


def _is_public(name: str) -> bool:
    if name == "__init__":
        return False
    if name.startswith("__") and name.endswith("__"):
        return True
    return not name.startswith("_")


def _assign_roles(cm: ClassModel) -> None:
    callers: dict[str, int] = {}
    for mm in cm.methods.values():
        if mm.name == "__init__":
            continue  # init happens-before every thread start
        for c in mm.self_calls:
            callers[c.callee] = callers.get(c.callee, 0) + 1
    # helpers only reachable from __init__ run pre-thread: no role at all
    init_reach: set = set()
    if "__init__" in cm.methods:
        stack = [c.callee for c in cm.methods["__init__"].self_calls]
        while stack:
            m = stack.pop()
            if m in init_reach or m not in cm.methods:
                continue
            init_reach.add(m)
            stack.extend(c.callee for c in cm.methods[m].self_calls)
    for name, mm in cm.methods.items():
        role = cm.thread_seeds.get(name)
        if role:
            mm.roles.add(role)
        if mm.ann_role:
            mm.roles.add(mm.ann_role)
        if mm.pseudo or role or mm.ann_role or name == "__init__":
            continue
        if _is_public(name) or (callers.get(name, 0) == 0
                                and name not in init_reach):
            mm.roles.add("caller")
    # propagate along same-class calls (init excluded as a source)
    for _ in range(len(cm.methods) + 1):
        changed = False
        for mm in cm.methods.values():
            if mm.name == "__init__" or not mm.roles:
                continue
            for c in mm.self_calls:
                cal = cm.methods.get(c.callee)
                if cal is not None and not mm.roles <= cal.roles:
                    cal.roles |= mm.roles
                    changed = True
        if not changed:
            break


def _entry_fixpoint(cm: ClassModel) -> None:
    """Private helpers only ever called with a lock held inherit it as
    their entry context (intersection over same-class call sites)."""
    sites: dict[str, list] = {}
    for mm in cm.methods.values():
        for c in mm.self_calls:
            sites.setdefault(c.callee, []).append((mm.name, c.locks))
    for _ in range(10):
        changed = False
        for name, mm in cm.methods.items():
            if _is_public(name) or mm.pseudo or mm.ann_role or \
                    cm.thread_seeds.get(name) or name == "__init__":
                continue
            ss = sites.get(name)
            if not ss:
                continue
            new = None
            for caller, locks in ss:
                eff = locks | cm.methods[caller].entry_locks \
                    if caller in cm.methods else locks
                new = eff if new is None else (new & eff)
            new = new or frozenset()
            if new != mm.entry_locks:
                mm.entry_locks = frozenset(new)
                changed = True
        if not changed:
            break


# ----------------------------------------------------------------- waivers


def _attr_waiver(cm: ClassModel, attr: str) -> bool:
    """`# concurrency: single-writer — why` on/above any write of attr
    (or its __init__ assignment) suppresses LR401/LR404 for that attr."""
    lines = set()
    for mm in cm.methods.values():
        for ev in mm.accesses:
            if ev.attr == attr and ev.kind in ("store", "mut"):
                lines.add(ev.line)
    for n in ast.walk(cm.node):
        if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            tgts = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in tgts:
                if _root_self_attr(t) == attr:
                    lines.add(n.lineno)
    for line in lines:
        for ln in (line, line - 1):
            m = _CONC_WAIVE_RE.search(cm.mod.comments.get(ln, ""))
            if m and m.group(1).strip():
                return True
    return False


def _line_waived(mod: ModuleInfo, line: int, *rule_ids: str) -> bool:
    return any(mod.waiver(line, rid) for rid in rule_ids)


# ------------------------------------------------------------------- rules


def _fmt_locks(locks: Iterable[str]) -> str:
    ls = sorted(l for l in locks if not l.startswith("<"))
    return "/".join(ls) if ls else "no lock"


def _eff(mm: MethodModel, locks: frozenset) -> frozenset:
    return locks | mm.entry_locks


def _rule_lr401(cm: ClassModel) -> Iterable[Diagnostic]:
    per_attr: dict[str, list] = {}
    for mm in cm.methods.values():
        if mm.name == "__init__" or not mm.roles:
            continue
        for ev in mm.accesses:
            per_attr.setdefault(ev.attr, []).append(
                (mm.roles, ev.kind, _eff(mm, ev.locks), ev.line))
    for attr in sorted(per_attr):
        evs = per_attr[attr]
        writes = [e for e in evs if e[1] in ("store", "mut")]
        if not writes:
            continue
        roles_all = set()
        for roles, _k, _l, _ln in evs:
            roles_all |= roles
        if len(roles_all) < 2:
            continue
        if cm.locks:
            common = None
            for _r, _k, locks, _ln in evs:
                common = locks if common is None else (common & locks)
            if common:
                continue
        else:
            w_roles = set()
            for roles, _k, _l, _ln in writes:
                w_roles |= roles
            if len(w_roles) < 2:
                continue
        site_line = min(ln for _r, _k, _l, ln in writes)
        if _attr_waiver(cm, attr) or \
                _line_waived(cm.mod, site_line, "LR401"):
            continue
        unlocked = sorted({ln for _r, _k, locks, ln in evs if not locks})
        yield Diagnostic(
            "LR401", Severity.ERROR, f"{cm.mod.relpath}:{site_line}",
            f"{cm.name}.{attr} is written outside __init__ and accessed on "
            f"thread roles {sorted(roles_all)} with no common lock "
            f"(unlocked access lines: {unlocked[:6]})",
            "guard every access with one lock, or waive the attribute with "
            "`# concurrency: single-writer — why` if one role provably owns "
            "all writes")


def _sccs(edges: dict) -> list:
    """Strongly connected components (iterative Tarjan) over the edge
    dict {(src, dst): site}; returns node lists, only SCCs with a cycle."""
    adj: dict[str, list] = {}
    nodes: list = []
    for (s, d) in edges:
        adj.setdefault(s, []).append(d)
        adj.setdefault(d, [])
    for n in sorted(adj):
        nodes.append(n)
        adj[n].sort()
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set = set()
    stack: list = []
    out: list = []
    counter = [0]

    for root in nodes:
        if root in index:
            continue
        work = [(root, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            advanced = False
            for i in range(pi, len(adj[node])):
                nxt = adj[node][i]
                if nxt not in index:
                    work[-1] = (node, i + 1)
                    work.append((nxt, 0))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1 or (node, node) in edges:
                    out.append(sorted(comp))
    return out


def static_lock_graph(sweep: Sweep) -> dict:
    """The acquires-while-holding graph: {(held, acquired): "path:line"}
    over canonical ``Class.attr`` lock nodes. This is what the runtime
    witness (obs/lockorder.py) cross-checks observed edges against."""
    edges: dict = {}

    def add(src: str, dst: str, mod: ModuleInfo, line: int) -> None:
        if src.startswith("<") or dst.startswith("<"):
            return
        site = f"{mod.relpath}:{line}"
        cur = edges.get((src, dst))
        if cur is None or site < cur:
            edges[(src, dst)] = site

    def reentrant(key: str) -> bool:
        cls, _, attr = key.partition(".")
        owner = sweep.classes.get(cls)
        return owner is not None and owner.lock_kind(attr) == "rlock"

    for cname in sorted(sweep.classes):
        cm = sweep.classes[cname]
        for mname in sorted(cm.methods):
            mm = cm.methods[mname]
            for a in mm.acquires:
                for h in _eff(mm, a.held):
                    # h == key: re-acquiring a held lock — legal only for
                    # rlocks; the self-edge makes it an SCC (self-deadlock)
                    if h != a.key or not reentrant(a.key):
                        add(h, a.key, cm.mod, a.line)
            for c in mm.self_calls:
                held = _eff(mm, c.locks)
                if not held:
                    continue
                for k in sweep.acquired_closure(cm.name, c.callee):
                    for h in held:
                        if h != k or not reentrant(k):
                            add(h, k, cm.mod, c.line)
            for f in mm.foreign_calls:
                held = _eff(mm, f.locks)
                if not held:
                    continue
                tname = cm.attr_types.get(f.attr)
                if tname is None or tname not in sweep.classes:
                    continue
                for k in sweep.acquired_closure(tname, f.method):
                    for h in held:
                        if h != k or not reentrant(k):
                            add(h, k, cm.mod, f.line)
    return edges


def _rule_lr402(sweep: Sweep) -> Iterable[Diagnostic]:
    # audit-scope filter: only report cycles whose first site lies in an
    # audited module (the graph itself spans the whole sweep)
    audited_paths = {m.relpath for m in sweep.audited}
    mods_by_path = {m.relpath: m for m in sweep.audited}
    edges = static_lock_graph(sweep)
    for comp in _sccs(edges):
        comp_edges = sorted(
            (site, s, d) for (s, d), site in edges.items()
            if s in comp and d in comp)
        if not comp_edges:
            continue
        site, s0, d0 = comp_edges[0]
        path, _, line_s = site.rpartition(":")
        if path not in audited_paths:
            continue
        mod = mods_by_path[path]
        if any(_line_waived(mods_by_path.get(es.rpartition(":")[0]),
                            int(es.rpartition(":")[2]), "LR402")
               for es, _s, _d in comp_edges
               if es.rpartition(":")[0] in mods_by_path):
            continue
        if len(comp) == 1:
            msg = (f"non-reentrant lock {comp[0]} re-acquired while already "
                   "held (self-deadlock)")
        else:
            msg = ("lock-ordering cycle (deadlock potential): " +
                   " -> ".join(comp + [comp[0]]) + "; first edge "
                   f"{s0} -> {d0}")
        yield Diagnostic(
            "LR402", Severity.ERROR, site, msg,
            "impose one global acquire order (or collapse to a single "
            "lock); waive an edge site with `# lint: waive LR402 — why` "
            "only for a provably unreachable interleaving")


def _rule_lr403(sweep: Sweep) -> Iterable[Diagnostic]:
    emitted: set = set()
    for mod in sweep.audited:
        classes = [sweep.classes[n.name] for n in mod.tree.body
                   if isinstance(n, ast.ClassDef)
                   and n.name in sweep.classes
                   and sweep.classes[n.name].mod is mod]
        # direct + entry-context findings
        for cm in classes:
            for mname in sorted(cm.methods):
                mm = cm.methods[mname]
                for b in mm.blocking:
                    held = _eff(mm, b.locks)
                    if not held:
                        continue
                    if b.cond_key is not None and b.cond_key in held:
                        continue  # Condition.wait releases its lock
                    if _line_waived(mod, b.line, "LR403", "LR105"):
                        emitted.add((mod.relpath, b.line))
                        continue
                    emitted.add((mod.relpath, b.line))
                    yield Diagnostic(
                        "LR403", Severity.ERROR,
                        f"{mod.relpath}:{b.line}",
                        f"blocking call {b.name}() while holding "
                        f"{_fmt_locks(held)}: every contending thread "
                        "stalls for the full call",
                        "move the blocking call outside the lock (copy "
                        "state under the lock, act after release)")
            # helper reach: blocking sink inside a callee whose own entry
            # context did not prove the lock (the old LR105 blind spot)
            for mname in sorted(cm.methods):
                mm = cm.methods[mname]
                for c in mm.self_calls:
                    held = _eff(mm, c.locks)
                    if not held:
                        continue
                    for b in _reach_blocking(cm, c.callee):
                        if (mod.relpath, b.line) in emitted:
                            continue
                        eff = held | b.locks
                        if b.cond_key is not None and b.cond_key in eff:
                            continue
                        if _line_waived(mod, c.line, "LR403", "LR105") or \
                                _line_waived(mod, b.line, "LR403", "LR105"):
                            continue
                        emitted.add((mod.relpath, b.line))
                        yield Diagnostic(
                            "LR403", Severity.ERROR,
                            f"{mod.relpath}:{b.line}",
                            f"blocking call {b.name}() reached via "
                            f"self.{c.callee}() from {cm.name}.{mm.name} "
                            f"while holding {_fmt_locks(held)}",
                            "move the blocking call (or the helper call) "
                            "outside the lock")
        # module-level functions: the legacy intraprocedural region scan
        yield from _module_level_lr403(mod, emitted)


def _reach_blocking(cm: ClassModel, root: str) -> list:
    out, stack, seen = [], [root], set()
    while stack:
        m = stack.pop()
        if m in seen or m not in cm.methods:
            continue
        seen.add(m)
        mm = cm.methods[m]
        out.extend(mm.blocking)
        stack.extend(c.callee for c in mm.self_calls)
    return out


def _module_level_lr403(mod: ModuleInfo, emitted: set) -> Iterable[Diagnostic]:
    in_class: set = set()
    for n in ast.walk(mod.tree):
        if isinstance(n, ast.ClassDef):
            for sub in ast.walk(n):
                in_class.add(id(sub))
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.With) or id(node) in in_class:
            continue
        if not any(_mentions_lock(i.context_expr) for i in node.items):
            continue
        for n in _walk_skipping_nested_defs(node):
            if not isinstance(n, ast.Call):
                continue
            name = _call_name(n)
            recv = _receiver_name(n)
            blocking = name in _BLOCKING or \
                mod.canonical(_dotted(n.func)) in ("os.write", "os.read")
            if name == "join" and recv not in ("path", "os") and not blocking:
                blocking = not isinstance(
                    getattr(n.func, "value", None), ast.Constant)
            if name in ("get", "put") and (
                    "queue" in recv.lower() or "inbox" in recv.lower()):
                blocking = not any(
                    k.arg == "block" and isinstance(k.value, ast.Constant)
                    and k.value.value is False for k in n.keywords)
                if name == "get" and n.args:
                    blocking = False  # dict-style .get(key[, default])
            if not blocking or (mod.relpath, n.lineno) in emitted:
                continue
            emitted.add((mod.relpath, n.lineno))
            if _line_waived(mod, n.lineno, "LR403", "LR105"):
                continue
            yield Diagnostic(
                "LR403", Severity.ERROR, f"{mod.relpath}:{n.lineno}",
                f"blocking call {name}() while holding a lock (with-lock "
                f"region at line {node.lineno}): all contending threads "
                "stall for the full call",
                "move the blocking call outside the lock (copy state under "
                "the lock, act on it after release)")


def _rule_lr404(cm: ClassModel) -> Iterable[Diagnostic]:
    if not cm.locks:
        return
    locked_writes: dict[str, set] = {}
    for mm in cm.methods.values():
        if mm.name == "__init__":
            continue
        for ev in mm.accesses:
            if ev.kind in ("store", "mut"):
                eff = _eff(mm, ev.locks)
                if eff:
                    locked_writes.setdefault(ev.attr, set()).update(eff)
    for mname in sorted(cm.methods):
        mm = cm.methods[mname]
        if mm.name == "__init__":
            continue
        for ca in mm.checkacts:
            check = _eff(mm, ca.check_locks)
            act = _eff(mm, ca.act_locks)
            if check & act:
                continue
            if not locked_writes.get(ca.attr):
                continue  # never lock-attributed: LR401's (or nobody's) job
            if _attr_waiver(cm, ca.attr) or \
                    _line_waived(cm.mod, ca.act_line, "LR404"):
                continue
            yield Diagnostic(
                "LR404", Severity.WARNING,
                f"{cm.mod.relpath}:{ca.act_line}",
                f"non-atomic check-then-act on {cm.name}.{ca.attr}: guard "
                f"read at line {ca.check_line} under "
                f"{_fmt_locks(check)}, dependent write under "
                f"{_fmt_locks(act)} — the checked condition can be "
                "invalidated between the two",
                "hold one lock across both the check and the write, or "
                "waive with `# concurrency: single-writer — why`")


# ------------------------------------------------------------ entry points


def build_sweep(mods: Iterable[ModuleInfo]) -> Sweep:
    sweep = Sweep()
    for mod in mods:
        sweep.add_module(mod)
    for cm in sweep.classes.values():
        _assign_roles(cm)
        _entry_fixpoint(cm)
    return sweep


def audit_concurrency_modules(mods: list) -> list:
    """LR4xx over parsed modules: whole-program (classes resolve across
    every module given) but findings only in engine/state/controller."""
    sweep = build_sweep(mods)
    diags: list[Diagnostic] = []
    audited_paths = {m.relpath for m in sweep.audited}
    for cname in sorted(sweep.classes):
        cm = sweep.classes[cname]
        if cm.mod.relpath not in audited_paths:
            continue
        if not cm.locks and not cm.thread_seeds and not any(
                mm.ann_role for mm in cm.methods.values()):
            continue
        diags.extend(_rule_lr401(cm))
        diags.extend(_rule_lr404(cm))
    diags.extend(_rule_lr402(sweep))
    diags.extend(_rule_lr403(sweep))
    return finish(diags)


def audit_concurrency_source(source: str,
                             relpath: str = "engine/fixture.py") -> list:
    """Audit one file's text (fixture entry point for tests)."""
    return audit_concurrency_modules([_parse(source, relpath)])


def static_lock_graph_package(root: Optional[str] = None) -> dict:
    """The static acquires-while-holding graph for the arroyo_tpu_torch package
    ({(held, acquired): site}), for the runtime witness cross-check."""
    pkg = root or os.path.join(os.path.dirname(__file__), "..")
    pkg = os.path.abspath(pkg)
    base = os.path.dirname(pkg)
    mods = []
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for f in sorted(filenames):
            if not f.endswith(".py"):
                continue
            p = os.path.join(dirpath, f)
            rel = os.path.relpath(p, base).replace(os.sep, "/")
            with open(p) as fh:
                try:
                    mods.append(_parse(fh.read(), rel))
                except SyntaxError:
                    continue
    return static_lock_graph(build_sweep(mods))
