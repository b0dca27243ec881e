"""Trace-safety auditor: prove the twins of K4 are pure, shape-stable and
dtype-safe (the port's copy of the JAX package's
``analysis/trace_audit.py``, keyed to PyTorch and to K4).

The whole-segment compiler (engine/segment.py) runs a chained run's
expressions as ONE generated Triton kernel (K4, ops/segment_kernel.py) and
holds its first batch byte for byte against the plain version, which
evaluates the same plan through expr.py's ``eval_torch`` twins. That
contract rests on conventions the kernel cannot check for us: code on the
twins' and the plain version's path must compute what a kernel can — no
host syncs, no Python control flow on batch values, no member-state reads
or writes (PURE), no data-dependent output shapes (SHAPE-STABLE), no
PyTorch default dtypes where the reference computes in 64 bits
(DTYPE-SAFE) — and the generator, which runs once per compile, must have
no side effects that a cached program would skip. This module proves
those invariants statically, repo-wide, at lint time (the LR3xx series)
and at plan time (AR009).

**The trace-reachability model.** Trace roots are (a) every ``eval_torch``
method (the expression twins), (b) K4's plain version, ``segment_plain``
and ``_plain`` in ops/segment_kernel.py, and (c) K4's generator, every
method of ``_Gen`` and ``generate`` in the same file. The audited set is
the call closure over those roots, resolved through sweep-known functions
by name (nested defs and methods included). Within the closure a
per-function TAINT analysis marks batch values: a root's parameters
(those not annotated with a non-tensor type: ``_plain``'s ``inputs``,
not its ``prog`` or ``n``), ``torch.`` results, method calls on tainted
tensors, and calls into closure functions whose returns are tainted.
Static metadata (``.dtype`` / ``.shape`` / ``.dt`` / ``.device``,
``.dim()`` / ``.numel()``, ``np.dtype``, ``is None`` identity tests) is
NOT tainted: branching on it is specialization, as K4's generator does.
The generator's closure handles source text, not tensors: it is held to
LR305 only (and to LR303's emitter check).

Rule catalog:

    LR301 trace-impurity       host sync or impurity on the twins' and
                               the plain version's path: ``.item()`` /
                               ``.tolist()`` / ``.cpu()`` / ``.numpy()``,
                               ``torch.cuda.synchronize()``, ``int()`` /
                               ``float()`` / ``bool()`` on tensors,
                               ``np.*`` calls on tensors, ``if`` /
                               ``while`` on tensor booleans, and reads /
                               writes of mutable ``self`` state
    LR302 trace-shape-unstable data-dependent output shape:
                               ``torch.nonzero`` / ``unique`` /
                               ``unique_consecutive`` / ``argwhere`` /
                               ``masked_select`` (and their method forms
                               on tensors), single-argument
                               ``torch.where``, boolean-mask indexing
    LR303 allowlist-drift      segment.py's ``_TRACEABLE_FUNCS`` /
                               ``_TRACEABLE_BINOPS`` against expr.py's
                               twins and K4's ``_Gen`` emitters: an
                               allowlisted op with no ``eval_torch`` twin
                               or no emitter fails only when a first
                               batch reaches it on the card (ERROR); an
                               op with twins in neither the allowlist nor
                               ``_KNOWN_DIVERGENT_*`` is a silently
                               uncompiled segment (WARN)
    LR304 dual-path-dtype      PyTorch's default-dtype traps:
                               ``torch.zeros`` / ``ones`` / ``empty`` /
                               ``linspace`` without ``dtype=``, and
                               ``torch.full`` / ``tensor`` / ``arange``
                               with float arguments and no ``dtype=``
                               (float32, where the reference computes in
                               float64); ``.astype(int/float/bool)`` with
                               Python builtins; and any module that moves
                               torch's default dtype
                               (``torch.set_default_dtype``), which shifts
                               every dtype-less constructor at once
    LR305 trace-time-side-effect print / logging / event / metric / clock
                               / open calls on the roots' closure: in the
                               generator they run ONCE per compile and
                               never for a cached program; on the twins'
                               path they run interpreted but never in the
                               compiled kernel

Waivers: the repo-lint grammar, ``# lint: waive LR3xx — justification``
on the flagged line or the line above.

**AR009 (plan pass).** For every chained run the optimizer marked
compilable, propagate the input edge schema's dtypes through each traced-
prefix expression TWICE — empirically through the numpy evaluators, and
through a static model of the compiled segment's dtypes (jax.numpy's in
64-bit mode, which the port's eval_torch and K4 follow: weak Python
scalars, the int x float32 lattice divergence, the float-function rules)
— and REJECT the pipeline at plan time when the compiled program would
compute in a different dtype than the interpreted path. Chains the
optimizer declined to mark carry their ``not compilable: <reason>``
string as an INFO diagnostic.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np

from .diagnostics import Diagnostic, Severity, finish
from .repo_lint import ModuleInfo, _call_name, _dotted, _parse

RULES = ("LR301", "LR302", "LR303", "LR304", "LR305")

# attribute loads that yield static (trace-time) metadata, not batch data:
# numpy's and torch's, and expr.TVal's dtype and weak flag
_STATIC_ATTRS = frozenset({
    "dtype", "shape", "ndim", "size", "kind", "itemsize", "names",
    "dt", "weak", "device", "is_cuda", "layout", "requires_grad",
})

# library calls that return static metadata even when fed tensors
_METADATA_FNS = frozenset({
    "dtype", "issubdtype", "promote_types", "result_type", "can_cast",
    "iinfo", "finfo", "isdtype", "is_floating_point", "is_tensor",
})

# tensor methods that return static metadata
_METADATA_METHODS = frozenset({
    "dim", "numel", "size", "element_size", "is_floating_point",
    "is_complex", "is_signed", "stride", "get_device", "nelement",
    "ndimension", "is_contiguous", "data_ptr", "type",
})

# builtins that pass taint through from their arguments
_PROPAGATING_BUILTINS = frozenset({
    "zip", "enumerate", "reversed", "sorted", "list", "tuple", "iter",
    "map", "filter", "next", "sum", "min", "max", "abs",
})

# host syncs: a method of that name on any receiver, or the device-wide wait
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_SYNC_NAMES = ("torch.cuda.synchronize",)

# calls with data-dependent output shapes (torch.* or a tensor's method)
_SHAPE_UNSTABLE = frozenset({
    "nonzero", "argwhere", "unique", "unique_consecutive", "masked_select",
    "nonzero_static",
})

# torch constructors that default to float32 (torch's default dtype)
# whatever their arguments, and those whose dtype follows their values
# (a float value gives float32): name -> argument positions of the values
_DEFAULT_FLOAT_CTORS = frozenset({"zeros", "ones", "empty", "linspace",
                                  "rand", "randn"})
_VALUE_DTYPE_CTORS = {"full": (1,), "tensor": (0,), "arange": (0, 1, 2)}
_VALUE_KWARGS = frozenset({"fill_value", "data", "start", "end", "step"})

_CLOCK_FNS = frozenset({
    "time", "monotonic", "perf_counter", "thread_time", "process_time",
    "monotonic_ns", "perf_counter_ns", "thread_time_ns", "process_time_ns",
    "sleep",
})

_LOG_METHODS = frozenset({"debug", "info", "warning", "error", "exception",
                          "critical"})

_MUTATORS = frozenset({
    "append", "appendleft", "add", "pop", "popleft", "popitem", "push",
    "extend", "extendleft", "update", "insert", "remove", "discard",
    "clear", "setdefault", "sort", "reverse", "rotate",
})

# K4's files and roots: the plain version, and the generator
_K4_MODULE = "segment_kernel.py"
_PLAIN_ROOTS = ("segment_plain", "_plain")
_GEN_CLASS = "_Gen"
_GEN_FUNCS = ("generate",)


def _canon(mod: ModuleInfo, expr: ast.expr) -> str:
    return mod.canonical(_dotted(expr))


def _is_torch(canon: str) -> bool:
    return canon.startswith("torch.")


# ----------------------------------------------------------- function index


@dataclass
class FnInfo:
    name: str
    relpath: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    mod: ModuleInfo
    cls: Optional[str] = None  # owning class, for method self-state checks
    # taint state (fixpoint): which params are traced, does it return taint
    param_taint: set[str] = field(default_factory=set)
    all_params_tainted: bool = False
    returns_traced: bool = False
    taint: set[str] = field(default_factory=set)
    # reached only from the generator: source text, not tensors (LR305 only)
    gen_only: bool = False

    def key(self):
        return (self.relpath, id(self.node))

    def params(self) -> list[str]:
        a = self.node.args
        names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
        if a.vararg:
            names.append(a.vararg.arg)
        if a.kwarg:
            names.append(a.kwarg.arg)
        return names

    def host_params(self) -> set[str]:
        """Parameters annotated with a type that holds no tensor (``n:
        int``, ``prog: "SegmentProgram"``): never batch values."""
        a = self.node.args
        out = set()
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if p.annotation is not None:
                text = ast.unparse(p.annotation)
                if not any(w in text for w in ("Tensor", "TVal", "Any")):
                    out.add(p.arg)
        return out

    def tensor_params(self) -> list[str]:
        """A root's parameters that carry batch values: all but ``self`` /
        ``cls`` and the host-typed ones."""
        host = self.host_params() | {"self", "cls"}
        return [p for p in self.params() if p not in host]


class _Index:
    """Every function/method (nested included) in the sweep, by bare name."""

    def __init__(self):
        self.by_name: dict[str, list[FnInfo]] = {}
        self.fns: list[FnInfo] = []
        # (relpath, class) -> attrs mutated outside __init__ (mutable state)
        self.class_mutable: dict[tuple[str, str], set[str]] = {}

    def add_module(self, mod: ModuleInfo) -> None:
        def walk(node: ast.AST, cls: Optional[str]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    self._mine_class(child, mod)
                    walk(child, child.name)
                elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fi = FnInfo(child.name, mod.relpath, child, mod, cls)
                    self.fns.append(fi)
                    self.by_name.setdefault(child.name, []).append(fi)
                    walk(child, None)  # nested defs are not methods
                else:
                    walk(child, cls)

        walk(mod.tree, None)

    def _mine_class(self, cd: ast.ClassDef, mod: ModuleInfo) -> None:
        mutable: set[str] = set()
        for st in cd.body:
            if not isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or st.name == "__init__":
                continue
            for n in ast.walk(st):
                if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    targets = n.targets if isinstance(n, ast.Assign) \
                        else [n.target]
                    for t in targets:
                        a = _self_attr(t)
                        if a:
                            mutable.add(a)
                elif isinstance(n, ast.Call) and \
                        isinstance(n.func, ast.Attribute) and \
                        n.func.attr in _MUTATORS:
                    a = _self_attr(n.func.value)
                    if a:
                        mutable.add(a)
        self.class_mutable[(mod.relpath, cd.name)] = mutable

    def resolve_bare(self, name: str, relpath: str) -> list[FnInfo]:
        """What a call through the bare ``name`` can reach: functions, not
        methods (``next(it)`` is the builtin, never a class's ``next``)."""
        cands = [c for c in self.by_name.get(name, []) if c.cls is None]
        local = [c for c in cands if c.relpath == relpath]
        return local or cands


def _self_attr(t: ast.expr) -> Optional[str]:
    """'x' for a target/receiver rooted at ``self`` (``self.x``,
    ``self.x.y``, ``self.x[i]``)."""
    while isinstance(t, (ast.Subscript, ast.Attribute)):
        if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                and t.value.id == "self":
            return t.attr
        t = t.value
    return None


def _walk_own(root: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body WITHOUT descending into nested function/class
    definitions: nested defs are separate closure entries with their own
    taint environment, so scanning them here would double-report findings
    under the wrong context."""
    stack = list(ast.iter_child_nodes(root))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


# ------------------------------------------------------------ root discovery


def _find_roots(index: _Index) -> tuple[list[FnInfo], list[FnInfo]]:
    """(twin and plain-version roots, generator roots)."""
    roots = list(index.by_name.get("eval_torch", []))
    gen: list[FnInfo] = []
    for fi in index.fns:
        if not fi.relpath.endswith(_K4_MODULE):
            continue
        if fi.name in _PLAIN_ROOTS and fi.cls is None:
            roots.append(fi)
        elif fi.cls == _GEN_CLASS or (fi.cls is None and fi.name in _GEN_FUNCS):
            gen.append(fi)
    return roots, gen


# ------------------------------------------------------------- taint engine


class _Taint:
    """Per-function forward taint over local names (flat scope)."""

    def __init__(self, fi: FnInfo, index: _Index, closure: dict):
        self.fi = fi
        self.index = index
        self.closure = closure  # key -> FnInfo for closure membership
        self.taint = set(fi.param_taint)
        if fi.all_params_tainted:
            self.taint |= set(fi.tensor_params())
        # (callee FnInfo, [tainted positional args]) observed at callsites
        self.callee_args: list[tuple[FnInfo, list[int], bool]] = []

    def tainted(self, e: ast.expr) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.taint
        if isinstance(e, ast.Attribute):
            if e.attr in _STATIC_ATTRS:
                return False
            return self.tainted(e.value)
        if isinstance(e, ast.Subscript):
            return self.tainted(e.value)
        if isinstance(e, ast.Call):
            return self.call_tainted(e)
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops):
                return False  # trace-time identity (x is None)
            if all(_str_literal(c) for c in e.comparators):
                return False  # a tag test (kind == "same"): no tensor is a str
            return self.tainted(e.left) or any(self.tainted(c)
                                               for c in e.comparators)
        if isinstance(e, ast.BoolOp):
            return any(self.tainted(v) for v in e.values)
        if isinstance(e, ast.BinOp):
            return self.tainted(e.left) or self.tainted(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.tainted(e.operand)
        if isinstance(e, ast.IfExp):
            return self.tainted(e.body) or self.tainted(e.orelse)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any(self.tainted(x) for x in e.elts)
        if isinstance(e, ast.Dict):
            return any(self.tainted(v) for v in e.values if v is not None)
        if isinstance(e, ast.Starred):
            return self.tainted(e.value)
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self.tainted(e.elt) or any(self.tainted(g.iter)
                                              for g in e.generators)
        if isinstance(e, ast.DictComp):
            return self.tainted(e.value) or any(self.tainted(g.iter)
                                                for g in e.generators)
        return False

    def call_tainted(self, call: ast.Call) -> bool:
        canon = _canon(self.fi.mod, call.func)
        name = _call_name(call)
        args_tainted = any(self.tainted(a) for a in call.args) or \
            any(self.tainted(k.value) for k in call.keywords)
        if name in _METADATA_FNS:
            return False
        if _is_torch(canon):
            return True
        if name == "eval_torch":
            return True
        if isinstance(call.func, ast.Name) and \
                name in _PROPAGATING_BUILTINS:
            return args_tainted
        # a tensor's method gives a tensor, but its metadata methods
        if isinstance(call.func, ast.Attribute) and \
                name not in _METADATA_METHODS and \
                self.tainted(call.func.value):
            return True
        # sweep-resolved callee: taint iff its returns are traced
        for fi in self._resolved(call):
            if fi.returns_traced:
                return True
        return False

    def _resolved(self, call: ast.Call) -> list[FnInfo]:
        name = _call_name(call)
        if isinstance(call.func, ast.Name):
            return [fi for fi in self.index.resolve_bare(name, self.fi.relpath)
                    if fi.key() in self.closure]
        return []

    # -- statement walk -------------------------------------------------

    def run(self) -> None:
        for _ in range(4):  # small fixpoint: loops rarely nest deeper
            before = set(self.taint)
            self._walk(self.fi.node.body)
            if self.taint == before:
                break

    def _assign_target(self, t: ast.expr, tainted: bool) -> None:
        if isinstance(t, ast.Name):
            if tainted:
                self.taint.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._assign_target(e, tainted)
        elif isinstance(t, ast.Starred):
            self._assign_target(t.value, tainted)

    def _record_callsites(self, node: ast.AST) -> None:
        for n in _walk_own(node):
            if not isinstance(n, ast.Call):
                continue
            for fi in self._resolved(n):
                pos = [i for i, a in enumerate(n.args) if self.tainted(a)]
                kw = any(self.tainted(k.value) for k in n.keywords)
                self.callee_args.append((fi, pos, kw))

    def _walk(self, stmts: Iterable[ast.stmt]) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue  # nested defs audited separately (if reachable)
            if isinstance(st, ast.Assign):
                t = self.tainted(st.value)
                for tgt in st.targets:
                    self._assign_target(tgt, t)
            elif isinstance(st, ast.AnnAssign) and st.value is not None:
                self._assign_target(st.target, self.tainted(st.value))
            elif isinstance(st, ast.AugAssign):
                if self.tainted(st.value) or self.tainted(st.target):
                    self._assign_target(st.target, True)
            elif isinstance(st, ast.For):
                it = st.iter
                # per-position taint through zip()/enumerate() so static
                # config zipped with batch values doesn't over-taint
                if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                        and it.func.id in ("zip", "enumerate") \
                        and isinstance(st.target, ast.Tuple) and it.args:
                    srcs = list(it.args)
                    if it.func.id == "enumerate":
                        srcs = [None] + srcs
                    for tgt, src in zip(st.target.elts, srcs):
                        self._assign_target(
                            tgt, src is not None and self.tainted(src))
                elif isinstance(it, (ast.Tuple, ast.List)) and it.elts and \
                        isinstance(st.target, ast.Tuple) and all(
                            isinstance(row, ast.Tuple)
                            and len(row.elts) == len(st.target.elts)
                            for row in it.elts):
                    # a literal table of rows: per-position taint, so a
                    # constant column stays untainted beside a tensor one
                    for i, tgt in enumerate(st.target.elts):
                        self._assign_target(tgt, any(
                            self.tainted(row.elts[i]) for row in it.elts))
                else:
                    self._assign_target(st.target, self.tainted(it))
                self._walk(st.body)
                self._walk(st.orelse)
                continue
            elif isinstance(st, (ast.If, ast.While)):
                self._walk(st.body)
                self._walk(st.orelse)
                continue
            elif isinstance(st, ast.With):
                self._walk(st.body)
                continue
            elif isinstance(st, ast.Try):
                self._walk(st.body)
                for h in st.handlers:
                    self._walk(h.body)
                self._walk(st.orelse)
                self._walk(st.finalbody)
                continue
            elif isinstance(st, ast.Return) and st.value is not None:
                if self.tainted(st.value):
                    self.fi.returns_traced = True


def _build_closure(index: _Index, roots: list[FnInfo], gen_roots: list[FnInfo]
                   ) -> dict[tuple, FnInfo]:
    """BFS over sweep-resolvable calls from the roots; a function reached
    only from the generator is marked ``gen_only``."""
    closure: dict[tuple, FnInfo] = {}

    def bfs(start: list[FnInfo], gen: bool) -> None:
        todo = list(start)
        seen: set = set()
        while todo:
            fi = todo.pop()
            if fi.key() in seen:
                continue
            seen.add(fi.key())
            if fi.key() not in closure:
                closure[fi.key()] = fi
                fi.gen_only = gen
            elif not gen:
                fi.gen_only = False
            for n in ast.walk(fi.node):
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
                    for cand in index.resolve_bare(n.func.id, fi.relpath):
                        if cand.key() not in seen:
                            todo.append(cand)

    for fi in roots:
        fi.all_params_tainted = True
    bfs(roots, False)
    bfs(gen_roots, True)
    return closure


def _taint_fixpoint(index: _Index, closure: dict[tuple, FnInfo]
                    ) -> dict[tuple, _Taint]:
    """Iterate per-function taint until param/return verdicts stabilize."""
    analyses: dict[tuple, _Taint] = {}
    for _ in range(6):
        changed = False
        for key, fi in closure.items():
            t = _Taint(fi, index, closure)
            t.run()
            t._record_callsites(fi.node)
            analyses[key] = t
            for callee, pos, kw_tainted in t.callee_args:
                if callee.key() not in closure:
                    continue
                params = [p for p in callee.params() if p not in ("self",)]
                if kw_tainted and not pos:
                    new = set(params)
                else:
                    new = {params[i] for i in pos if i < len(params)}
                    if kw_tainted:
                        new |= set(params)
                new -= callee.host_params()
                if not new <= callee.param_taint:
                    callee.param_taint |= new
                    changed = True
        if not changed:
            break
    return analyses


# ----------------------------------------------------------------- findings

# rule, relpath, line, msg, hint [, Severity] — severity defaults to ERROR
Finding = tuple


def _floaty(e: Optional[ast.expr]) -> bool:
    """A float value written in the source: ``1.5``, ``-0.0``,
    ``float(...)``, ``math.inf`` / ``np.nan`` and the like, or arithmetic
    and containers holding one."""
    if e is None:
        return False
    if isinstance(e, ast.Constant):
        return isinstance(e.value, float)
    if isinstance(e, ast.UnaryOp):
        return _floaty(e.operand)
    if isinstance(e, ast.BinOp):
        return _floaty(e.left) or _floaty(e.right) or isinstance(e.op, ast.Div)
    if isinstance(e, ast.Call):
        return isinstance(e.func, ast.Name) and e.func.id == "float"
    if isinstance(e, ast.Attribute):
        return e.attr in ("inf", "nan", "pi", "e")
    if isinstance(e, (ast.List, ast.Tuple)):
        return any(_floaty(x) for x in e.elts)
    return False


def _str_literal(e: ast.expr) -> bool:
    """A str constant, or a tuple / list / set of them."""
    if isinstance(e, ast.Constant):
        return isinstance(e.value, str)
    if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
        return bool(e.elts) and all(_str_literal(x) for x in e.elts)
    return False


def _mask_slice(sl: ast.expr) -> bool:
    """An index that is a boolean mask: a comparison, ``and`` / ``or``,
    ``not`` / ``~`` of something, or masks combined with ``&`` / ``|``."""
    if isinstance(sl, (ast.Compare, ast.BoolOp)):
        return True
    if isinstance(sl, ast.UnaryOp) and isinstance(sl.op, (ast.Not, ast.Invert)):
        return True
    if isinstance(sl, ast.BinOp) and isinstance(sl.op, (ast.BitAnd, ast.BitOr)):
        return _mask_slice(sl.left) or _mask_slice(sl.right)
    return False


def _side_effect(fi: FnInfo, n: ast.Call) -> Optional[str]:
    canon = _canon(fi.mod, n.func)
    recv = ""
    if isinstance(n.func, ast.Attribute):
        v = n.func.value
        recv = getattr(v, "id", getattr(v, "attr", "")) or ""
    if isinstance(n.func, ast.Name) and n.func.id in ("print", "open"):
        return f"{n.func.id}()"
    if canon.startswith("logging."):
        return canon + "()"
    if isinstance(n.func, ast.Attribute) and \
            n.func.attr in _LOG_METHODS and "log" in recv.lower():
        return f"{recv}.{n.func.attr}()"
    if canon.startswith("time.") and canon.rsplit(".", 1)[-1] in _CLOCK_FNS:
        return canon + "()"
    if isinstance(n.func, ast.Attribute) and (
            (n.func.attr == "record"
             and ("record" in recv.lower() or "event" in recv.lower()))
            or n.func.attr in ("_event", "_emit")):
        return f"{recv}.{n.func.attr}()"
    return None


def _scan_closure(analyses: dict[tuple, _Taint]) -> list[Finding]:
    out: list[Finding] = []
    for key in sorted(analyses, key=lambda k: (k[0], analyses[k].fi.node.lineno)):
        t = analyses[key]
        fi = t.fi
        rel = fi.relpath
        ctx = f"trace-reachable {'method' if fi.cls else 'function'} " \
              f"{(fi.cls + '.') if fi.cls else ''}{fi.name}"
        mutable = _mutable_for(t, fi)
        for n in _walk_own(fi.node):
            # ---- LR305: side effects a compiled program skips -----------
            if isinstance(n, ast.Call):
                effect = _side_effect(fi, n)
                if effect is not None:
                    where = ("K4's generator: it runs ONCE per compile, never "
                             "for a cached program" if fi.gen_only else
                             "the twins' path: it runs interpreted, but never "
                             "inside the compiled kernel")
                    out.append((
                        "LR305", rel, n.lineno,
                        f"{effect} in {ctx} on {where}, so the two paths "
                        "silently differ in it",
                        "move it to the host code around the kernel's build "
                        "and launch (events/metrics/logging belong in the "
                        "segment runner)"))
            if fi.gen_only:
                continue
            # ---- LR301: host sync / impurity ----------------------------
            if isinstance(n, ast.Call):
                name = _call_name(n)
                canon = _canon(fi.mod, n.func)
                if (name in _SYNC_METHODS and isinstance(n.func, ast.Attribute)) \
                        or canon in _SYNC_NAMES:
                    out.append((
                        "LR301", rel, n.lineno,
                        f"{canon if canon in _SYNC_NAMES else '.' + name}() in "
                        f"{ctx}: a device->host copy and wait that K4 cannot "
                        "make — the plain version stops being the kernel's "
                        "twin, and on the card it stalls every batch",
                        "keep the value a tensor; read it on the host after "
                        "the segment returns"))
                elif isinstance(n.func, ast.Name) and \
                        n.func.id in ("int", "float", "bool") and \
                        any(t.tainted(a) for a in n.args):
                    out.append((
                        "LR301", rel, n.lineno,
                        f"{n.func.id}() on a tensor in {ctx}: waits for the "
                        "device and freezes one batch value into a Python "
                        "scalar, which K4's generated code cannot do",
                        "keep the computation in torch; convert on the host "
                        "after the segment returns"))
                elif canon.startswith(("numpy.", "np.")) and \
                        canon.rsplit(".", 1)[-1] not in _METADATA_FNS and \
                        any(t.tainted(a) for a in n.args):
                    out.append((
                        "LR301", rel, n.lineno,
                        f"{canon}() on a tensor in {ctx}: numpy evaluates on "
                        "the host, so the value leaves the device and the "
                        "twin no longer mirrors the kernel",
                        "use the torch twin of this call"))
            if isinstance(n, (ast.If, ast.While)) and t.tainted(n.test):
                out.append((
                    "LR301", rel, n.lineno,
                    f"Python {'if' if isinstance(n, ast.If) else 'while'} "
                    f"on a tensor value in {ctx}: branching on batch data "
                    "waits for the device, and K4's kernel cannot branch "
                    "the same way",
                    "use torch.where / a mask instead"))
            # self-state writes & mutable reads
            if fi.cls is not None:
                if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    targets = n.targets if isinstance(n, ast.Assign) \
                        else [n.target]
                    for tgt in targets:
                        a = _self_attr(tgt)
                        if a:
                            out.append((
                                "LR301", rel, n.lineno,
                                f"write to self.{a} in {ctx}: the twins must "
                                "be pure — K4's kernel never makes the store, "
                                "so member state diverges between the "
                                "compiled and the interpreted path",
                                "return the value and commit it in a host "
                                "finisher (the segment runner's carry "
                                "contract)"))
                elif isinstance(n, ast.Call) and \
                        isinstance(n.func, ast.Attribute) and \
                        n.func.attr in _MUTATORS:
                    a = _self_attr(n.func.value)
                    if a:
                        out.append((
                            "LR301", rel, n.lineno,
                            f"self.{a}.{n.func.attr}() in {ctx}: in-place "
                            "member mutation that K4's kernel never makes",
                            "thread the value through the return and mutate "
                            "on the host"))
                elif isinstance(n, ast.Attribute) and \
                        isinstance(n.ctx, ast.Load) and \
                        isinstance(n.value, ast.Name) and \
                        n.value.id == "self" and n.attr in (mutable or ()):
                    out.append((
                        "LR301", rel, n.lineno,
                        f"read of mutable member state self.{n.attr} in "
                        f"{ctx}: K4's source is generated once from the "
                        "plan, so a later mutation reaches the plain version "
                        "but never the compiled kernel",
                        "pass the value in as an input column, or keep this "
                        "expression out of the compiled prefix"))
            # ---- LR302: shape instability -------------------------------
            if isinstance(n, ast.Call):
                canon = _canon(fi.mod, n.func)
                tail = canon.rsplit(".", 1)[-1]
                method = isinstance(n.func, ast.Attribute) and \
                    not _is_torch(canon) and t.tainted(n.func.value)
                if tail in _SHAPE_UNSTABLE and (_is_torch(canon) or method):
                    out.append((
                        "LR302", rel, n.lineno,
                        f"{canon}() in {ctx}: the output shape depends on "
                        "batch VALUES, which K4's fixed-size blocks cannot "
                        "produce",
                        "thread a validity mask (torch.where) and compact on "
                        "the host after the segment, as K4's mask does"))
                if _is_torch(canon) and tail == "where" and \
                        len(n.args) == 1 and not n.keywords:
                    out.append((
                        "LR302", rel, n.lineno,
                        f"single-argument torch.where() in {ctx} is "
                        "nonzero() in disguise: data-dependent output shape",
                        "use the three-argument form"))
            if isinstance(n, ast.Subscript) and t.tainted(n.value) and \
                    _mask_slice(n.slice):
                out.append((
                    "LR302", rel, n.lineno,
                    f"boolean-mask indexing in {ctx}: the result length "
                    "depends on how many rows match, which K4's fixed-size "
                    "blocks cannot produce",
                    "thread a validity mask (torch.where) and compact on the "
                    "host, as the segment's mask does"))
            # ---- LR304: default-dtype construction ----------------------
            if isinstance(n, ast.Call):
                canon = _canon(fi.mod, n.func)
                tail = canon.rsplit(".", 1)[-1]
                has_dtype = any(k.arg == "dtype" for k in n.keywords)
                trap = None
                if _is_torch(canon) and not has_dtype:
                    if tail in _DEFAULT_FLOAT_CTORS:
                        trap = "takes torch's default dtype (float32)"
                    elif tail in _VALUE_DTYPE_CTORS and (
                            any(_floaty(n.args[i]) for i in _VALUE_DTYPE_CTORS[tail]
                                if i < len(n.args))
                            or any(_floaty(k.value) for k in n.keywords
                                   if k.arg in _VALUE_KWARGS)):
                        trap = "with a float value gives torch's default dtype (float32)"
                if trap:
                    out.append((
                        "LR304", rel, n.lineno,
                        f"{canon}() without an explicit dtype in {ctx} "
                        f"{trap}, where the reference computes in float64 — "
                        "the twins and the kernel silently diverge",
                        "pass dtype= explicitly (torch.int64 / torch.float64)"))
                if isinstance(n.func, ast.Attribute) and \
                        n.func.attr == "astype" and n.args and \
                        isinstance(n.args[0], ast.Name) and \
                        n.args[0].id in ("int", "float", "bool"):
                    out.append((
                        "LR304", rel, n.lineno,
                        f".astype({n.args[0].id}) in {ctx}: the Python "
                        "builtin maps to a platform-dependent width",
                        "name the dtype exactly (np.int64, np.float64, "
                        "np.bool_)"))
    return out


def _mutable_for(t: _Taint, fi: FnInfo) -> set[str]:
    if fi.cls is None:
        return set()
    return t.index.class_mutable.get((fi.relpath, fi.cls), set())


# ------------------------------------------- LR304: the default dtype moved


_DEFAULT_DTYPE_SETTERS = ("torch.set_default_dtype",
                          "torch.set_default_tensor_type")


def _check_default_dtype(mods: dict[str, ModuleInfo]) -> list[Finding]:
    """Moving torch's default dtype changes what every dtype-less float
    constructor makes, in every module at once (the port's counterpart of
    the JAX package's x64 pin)."""
    out: list[Finding] = []
    for rel in sorted(mods):
        mod = mods[rel]
        for n in ast.walk(mod.tree):
            if isinstance(n, ast.Call) and \
                    _canon(mod, n.func) in _DEFAULT_DTYPE_SETTERS:
                out.append((
                    "LR304", rel, n.lineno,
                    f"{_canon(mod, n.func)}() moves torch's default dtype: "
                    "every torch.zeros / full / tensor / arange without "
                    "dtype= in the process then computes in another width "
                    "than the reference, and K4's first-batch check fails "
                    "into a permanent fallback",
                    "leave the default alone and pass dtype= where a "
                    "constructor needs one"))
    return out


# --------------------------------------------------- LR303: allowlist drift


def _set_literal(tree: ast.AST, varname: str) -> Optional[tuple[set, int]]:
    for n in ast.walk(tree):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                isinstance(n.targets[0], ast.Name) and \
                n.targets[0].id == varname:
            value = n.value
        elif isinstance(n, ast.AnnAssign) and \
                isinstance(n.target, ast.Name) and n.target.id == varname \
                and n.value is not None:
            value = n.value  # `X: set[str] = {...}` parses like the bare form
        else:
            continue
        vals = set()
        if isinstance(value, (ast.Set, ast.Tuple, ast.List)):
            for e in value.elts:
                if isinstance(e, ast.Constant):
                    vals.add(e.value)
        elif isinstance(value, ast.Call):  # set(...) / frozenset(...)
            for a in value.args:
                if isinstance(a, (ast.Set, ast.Tuple, ast.List)):
                    for e in a.elts:
                        if isinstance(e, ast.Constant):
                            vals.add(e.value)
        else:
            continue
        return vals, n.lineno
    return None


def _dict_keys(tree: ast.AST, varname: str) -> set:
    out: set = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Assign):
            targets, value = n.targets, n.value
        elif isinstance(n, ast.AnnAssign) and n.value is not None:
            targets, value = [n.target], n.value
        else:
            continue
        if any(isinstance(t, ast.Name) and t.id == varname
               for t in targets) and isinstance(value, ast.Dict):
            for k in value.keys:
                if isinstance(k, ast.Constant):
                    out.add(k.value)
    return out


def _dispatch_names(fn: ast.AST, var: str, tree: ast.AST) -> set:
    """String constants a function dispatches on: ``var == "x"``, ``var in
    ("x", "y")``, every dict-literal key inside it, and the keys of a
    module-level dict it indexes with ``[var]``."""
    out: set = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Compare) and \
                isinstance(n.left, ast.Name) and n.left.id == var:
            for comp in n.comparators:
                if isinstance(comp, ast.Constant):
                    out.add(comp.value)
                elif isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
                    out |= {e.value for e in comp.elts
                            if isinstance(e, ast.Constant)}
        elif isinstance(n, ast.Dict):
            out |= {k.value for k in n.keys if isinstance(k, ast.Constant)}
        elif isinstance(n, ast.Subscript) and isinstance(n.value, ast.Name) \
                and isinstance(n.slice, ast.Name) and n.slice.id == var:
            out |= _dict_keys(tree, n.value.id)
    return out


def _method(cls_node: Optional[ast.ClassDef], name: str) -> Optional[ast.FunctionDef]:
    if cls_node is None:
        return None
    return next((st for st in cls_node.body
                 if isinstance(st, ast.FunctionDef) and st.name == name), None)


def _class_node(tree: ast.AST, name: str) -> Optional[ast.ClassDef]:
    for n in ast.walk(tree):
        if isinstance(n, ast.ClassDef) and n.name == name:
            return n
    return None


def _op_closure_names(start: Optional[ast.AST], tree: ast.AST, cls_node=None) -> set:
    """Operators dispatched on by ``start`` and by every function it calls
    (module-level by name, or ``self.`` methods of ``cls_node``) that takes
    an ``op`` parameter."""
    if start is None:
        return set()
    funcs = {n.name: n for n in getattr(tree, "body", [])
             if isinstance(n, ast.FunctionDef)}
    methods = {st.name: st for st in (cls_node.body if cls_node else [])
               if isinstance(st, ast.FunctionDef)}
    out: set = set()
    todo, seen = [start], set()
    while todo:
        fn = todo.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        if fn is start or any(a.arg == "op" for a in fn.args.args):
            out |= _dispatch_names(fn, "op", tree)
        for n in ast.walk(fn):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            if isinstance(f, ast.Name) and f.id in funcs:
                todo.append(funcs[f.id])
            elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                    and f.value.id == "self" and f.attr in methods:
                todo.append(methods[f.attr])
    return out


def _check_allowlist_drift(mods: dict[str, ModuleInfo]) -> list[Finding]:
    seg = next((m for m in mods.values()
                if _set_literal(m.tree, "_TRACEABLE_FUNCS") is not None
                and m.relpath.endswith("segment.py")), None)
    ex = next((m for m in mods.values()
               if _class_node(m.tree, "Func") is not None
               and m.relpath.endswith("expr.py")), None)
    if seg is None or ex is None:
        return []
    out: list[Finding] = []
    funcs, fline = _set_literal(seg.tree, "_TRACEABLE_FUNCS")
    binops, bline = _set_literal(seg.tree, "_TRACEABLE_BINOPS")
    divergent = (_set_literal(seg.tree, "_KNOWN_DIVERGENT_FUNCS")
                 or (set(), fline))[0]
    divergent_b = (_set_literal(seg.tree, "_KNOWN_DIVERGENT_BINOPS")
                   or (set(), bline))[0]

    func_cls = _class_node(ex.tree, "Func")
    np_impl = _dispatch_names(_method(func_cls, "eval_np") or ast.Module([], []),
                              "name", ex.tree)
    twin_impl = _dispatch_names(_method(func_cls, "eval_torch") or ast.Module([], []),
                                "name", ex.tree)
    np_bin = _dict_keys(ex.tree, "_NP_BINOPS")
    twin_bin = _op_closure_names(_method(_class_node(ex.tree, "BinOp"), "eval_torch"),
                                 ex.tree)

    for f in sorted(funcs - twin_impl):
        out.append((
            "LR303", seg.relpath, fline,
            f"allowlisted func {f!r} (_TRACEABLE_FUNCS) has no twin in "
            "expr.Func.eval_torch: every segment using it compiles and then "
            "fails its plain version, falling back to the interpreted path",
            "implement the eval_torch twin (and hold it byte for byte to "
            "the JAX package's) or remove the op from the allowlist"))
    for f in sorted(funcs - np_impl):
        out.append((
            "LR303", seg.relpath, fline,
            f"allowlisted func {f!r} has no numpy implementation in "
            "expr.Func.eval_np: the interpreted path cannot evaluate it",
            "implement eval_np or remove the op from the allowlist"))
    for f in sorted((np_impl & twin_impl) - funcs - divergent):
        out.append((
            "LR303", seg.relpath, fline,
            f"func {f!r} has BOTH numpy and torch implementations but is in "
            "neither _TRACEABLE_FUNCS nor _KNOWN_DIVERGENT_FUNCS: segments "
            "using it silently never compile",
            "allowlist it if the twins are bit-exact or declare it in "
            "_KNOWN_DIVERGENT_FUNCS with the reason", Severity.WARNING))
    for f in sorted(funcs & divergent):
        out.append((
            "LR303", seg.relpath, fline,
            f"func {f!r} is in both _TRACEABLE_FUNCS and "
            "_KNOWN_DIVERGENT_FUNCS: the allowlist claims bit-exactness "
            "the divergence set denies",
            "keep it in exactly one of the two sets"))
    for op in sorted(binops - twin_bin):
        out.append((
            "LR303", seg.relpath, bline,
            f"allowlisted operator {op!r} (_TRACEABLE_BINOPS) has no "
            "dispatch entry on expr.BinOp.eval_torch's path",
            "add the torch twin or remove the operator from the allowlist"))
    for op in sorted(binops - np_bin):
        out.append((
            "LR303", seg.relpath, bline,
            f"allowlisted operator {op!r} has no _NP_BINOPS entry",
            "add the numpy twin or remove the operator from the allowlist"))
    for op in sorted((np_bin & twin_bin) - binops - divergent_b):
        out.append((
            "LR303", seg.relpath, bline,
            f"operator {op!r} has both numpy and torch implementations but "
            "is in neither _TRACEABLE_BINOPS nor _KNOWN_DIVERGENT_BINOPS: "
            "segments using it silently never compile",
            "allowlist it if bit-exact, else declare it known-divergent",
            Severity.WARNING))

    # K4's generator: an allowlisted op it cannot emit shows itself only
    # when a first batch reaches it on the card
    gm = next((m for m in mods.values()
               if _class_node(m.tree, _GEN_CLASS) is not None
               and m.relpath.endswith(_K4_MODULE)), None)
    if gm is not None:
        gen_cls = _class_node(gm.tree, _GEN_CLASS)
        gen_funcs = _dispatch_names(_method(gen_cls, "func") or ast.Module([], []),
                                    "name", gm.tree)
        gen_bin = _op_closure_names(_method(gen_cls, "binop"), gm.tree, gen_cls)
        for f in sorted(funcs - gen_funcs):
            out.append((
                "LR303", seg.relpath, fline,
                f"allowlisted func {f!r} has no emitter in K4's generator "
                f"({gm.relpath} _Gen.func): a segment using it compiles on "
                "the CPU, where the plain version runs, and fails only at "
                "its first batch on the card",
                "add the emitter (and its case to the segment phase's plans) "
                "or remove the op from the allowlist"))
        for op in sorted(binops - gen_bin):
            out.append((
                "LR303", seg.relpath, bline,
                f"allowlisted operator {op!r} has no emitter on K4's "
                f"generator path ({gm.relpath} _Gen.binop): it fails only "
                "at a first batch on the card",
                "add the emitter or remove the operator from the allowlist"))
    return out


# -------------------------------------------------------------- entry points


def audit_trace_modules(mods: list[ModuleInfo]) -> list[Diagnostic]:
    """LR3xx over already-parsed modules (the lint sweep hands its own)."""
    index = _Index()
    by_rel: dict[str, ModuleInfo] = {}
    for mod in mods:
        by_rel.setdefault(mod.relpath, mod)
        index.add_module(mod)
    roots, gen_roots = _find_roots(index)
    closure = _build_closure(index, roots, gen_roots)
    analyses = _taint_fixpoint(index, closure)

    findings: list[Finding] = []
    findings += _scan_closure(analyses)
    findings += _check_default_dtype(by_rel)
    findings += _check_allowlist_drift(by_rel)

    diags: list[Diagnostic] = []
    seen: set[tuple] = set()
    for rule, rel, line, msg, hint, *rest in findings:
        sev = rest[0] if rest else Severity.ERROR
        mod = by_rel.get(rel)
        if mod is not None and mod.waiver(line, rule):
            continue
        key = (rule, rel, line, msg)
        if key in seen:
            continue
        seen.add(key)
        diags.append(Diagnostic(rule, sev, f"{rel}:{line}", msg, hint))
    return finish(diags)


def audit_trace_source(source: str, relpath: str = "engine/fixture.py"
                       ) -> list[Diagnostic]:
    """Audit one file's text (test surface)."""
    return audit_trace_modules([_parse(source, relpath)])


def audit_trace_sources(named: list[tuple[str, str]]) -> list[Diagnostic]:
    """Audit several (source, relpath) files as one sweep (test surface
    for the cross-module rules, e.g. LR303's segment/expr/generator
    triple)."""
    return audit_trace_modules([_parse(src, rel) for src, rel in named])


# =========================================================================
# AR009 — plan-time dual-path dtype propagation
# =========================================================================


class _Weak:
    """A weak-typed Python scalar inside the jax dtype model."""

    __slots__ = ("kind",)

    def __init__(self, kind: str):  # "i" | "f" | "b"
        self.kind = kind


class _Unmodeled(Exception):
    """The dtype model does not cover this expression shape; AR009 skips
    it (the runtime first-batch verification still covers it)."""


def _jnp_promote(a, b):
    """jax-x64 binary promotion. Identical to numpy except the lattice's
    famous corner: integer x float32 stays float32 under jax where numpy
    widens to float64 (the divergence AR009 exists to reject)."""
    if isinstance(a, _Weak) and isinstance(b, _Weak):
        if "f" in (a.kind, b.kind):
            return _Weak("f")
        if "i" in (a.kind, b.kind):
            return _Weak("i")
        return _Weak("b")
    if isinstance(a, _Weak):
        a, b = b, a
    if isinstance(b, _Weak):
        if b.kind == "f":
            return a if a.kind == "f" else np.dtype(np.float64)
        if b.kind == "i":
            return np.dtype(np.int64) if a.kind == "b" else a
        return np.dtype(np.int64) if a.kind == "b" else a
    if (a.kind in "iu" and b == np.float32) or \
            (b.kind in "iu" and a == np.float32):
        return np.dtype(np.float32)
    return np.promote_types(a, b)


def _resolve_weak(d):
    if isinstance(d, _Weak):
        return np.dtype({"i": np.int64, "f": np.float64, "b": np.bool_}[d.kind])
    return d


def _jnp_dtype(expr, env: dict):
    """Static model of the dtype the compiled segment computes for ``expr``
    (jax.numpy's in 64-bit mode, which the port's eval_torch and kernel
    mirror)."""
    from ..expr import BinOp, Case, Cast, Col, Expr, Func, Lit, Neg, Not

    e = expr
    if isinstance(e, Col):
        d = env.get(e.name)
        if d is None or d == np.dtype(object):
            raise _Unmodeled(e.name)
        return d
    if isinstance(e, Lit):
        if isinstance(e.value, bool):
            return np.dtype(np.bool_)
        if isinstance(e.value, int):
            return _Weak("i")
        if isinstance(e.value, float):
            return _Weak("f")
        raise _Unmodeled(repr(e.value))
    if isinstance(e, BinOp):
        if e.op in ("==", "!=", "<", "<=", ">", ">=", "and", "or"):
            _jnp_dtype(e.left, env), _jnp_dtype(e.right, env)
            return np.dtype(np.bool_)
        l = _jnp_dtype(e.left, env)
        r = _jnp_dtype(e.right, env)
        out = _jnp_promote(l, r)
        if e.op == "/":
            li, ri = (isinstance(x, _Weak) and x.kind == "i"
                      or (not isinstance(x, _Weak) and x.kind in "iu")
                      for x in (l, r))
            if not (li and ri):
                # true division: float result
                rf = _resolve_weak(out)
                if rf.kind in "iub":
                    # int/int handled above; mixed int-float promoted
                    out = np.dtype(np.float64)
        return out
    if isinstance(e, Not):
        return np.dtype(np.bool_)
    if isinstance(e, Neg):
        return _jnp_dtype(e.inner, env)
    if isinstance(e, Cast):
        try:
            from ..batch import Field

            return np.dtype(Field("_", e.dtype).numpy_dtype())
        except Exception as err:
            raise _Unmodeled(e.dtype) from err
    if isinstance(e, Case):
        if e.otherwise is None:
            raise _Unmodeled("CASE without ELSE")
        out = _jnp_dtype(e.otherwise, env)
        for c, v in e.branches:
            _jnp_dtype(c, env)
            out = _jnp_promote(out, _jnp_dtype(v, env))
        return out
    if isinstance(e, Func):
        args = [_jnp_dtype(a, env) for a in e.args]
        if e.name == "abs":
            return args[0]
        if e.name in ("floor", "ceil", "sqrt"):
            a = args[0]
            if isinstance(a, _Weak):
                return np.dtype(np.float64)
            if a.kind == "f":
                return a
            if a.kind in "iu":
                # expr.py promotes integer inputs to float64 explicitly
                return np.dtype(np.float64)
            # bool: numpy computes float16, jnp has no exact twin —
            # model the jnp results so the comparison flags the mismatch
            return np.dtype(np.bool_) if e.name != "sqrt" \
                else np.dtype(np.float32)
        if e.name == "extract_epoch":
            return _jnp_promote(args[0], _Weak("i"))
        if e.name == "date_trunc_micros":
            return _jnp_promote(args[1], args[0])
        if e.name == "to_timestamp_micros":
            return np.dtype(np.int64)
        raise _Unmodeled(e.name)
    if isinstance(e, Expr):
        raise _Unmodeled(type(e).__name__)
    raise _Unmodeled(repr(e))


def _np_dtype_of(expr, env: dict):
    """The dtype the interpreted path actually computes — measured, not
    modeled: evaluate on zero-row columns through the real eval_np."""
    from ..expr import eval_expr

    cols = {name: np.empty(0, dtype=dt) for name, dt in env.items()}
    return np.asarray(eval_expr(expr, cols, 0)).dtype


def pass_segment_compile(ctx) -> None:
    """AR009: dual-path dtype parity of plan-marked-compilable segments,
    plus the ``not compilable: <reason>`` surfacing for chains the
    optimizer declined to mark.

    Deliberately ignores ``pipeline.chaining.enabled``: chaining is a
    deploy-time flag that can flip on a pipeline AFTER it was accepted
    (restores re-plan under the then-current config), so a plan accepted
    today must stay byte-exact under tomorrow's chained execution — the
    same reasoning that makes AR004 warn about unbounded state regardless
    of today's memory. ``segment.compile.enabled`` is the explicit
    opt-out: with compilation off, segments can never trace and the
    divergence cannot materialize, so the pass stands down entirely."""
    from ..batch import KEY_FIELD, TIMESTAMP_FIELD
    from ..config import config
    from ..graph import OpName
    from ..optimizer import chain_graph

    if not config().get("segment.compile.enabled", True):
        return  # segments never compile: the divergence cannot materialize
    try:
        g2 = chain_graph(ctx.graph)
    except Exception:
        return  # a malformed graph fails other passes; nothing to add here
    for nid in sorted(g2.nodes):
        node = g2.nodes[nid]
        if node.op != OpName.CHAINED:
            continue
        reject = node.config.get("compile_reject")
        if reject:
            ctx.add("AR009", Severity.INFO, node.node_id,
                    f"chained run is {reject}; it will execute interpreted",
                    "expected for chains ending at a sink or using "
                    "host-only expressions — see README \"why is my "
                    "segment not compiled\"")
            continue
        marking = node.config.get("compile")
        if not marking:
            continue
        env: dict = {}
        for e in g2.in_edges(node.node_id):
            for f in e.schema.fields:
                try:
                    env[f.name] = np.dtype(f.numpy_dtype())
                except Exception:
                    continue
        env.setdefault(TIMESTAMP_FIELD, np.dtype(np.int64))
        members = list(node.config.get("members", []))[: int(marking["prefix"])]

        def compare(label: str, expr, mi: int, op: str) -> None:
            refs = expr.columns()
            strings = sorted(r for r in refs
                             if env.get(r) == np.dtype(object))
            if strings:
                ctx.add(
                    "AR009", Severity.INFO, node.node_id,
                    f"compile-marked segment member {mi} references "
                    f"non-numeric column(s) {strings}: the segment will "
                    "fall back to the interpreted path at runtime (only "
                    "numeric/bool columns trace)",
                    "expected when projections carry strings; the "
                    "fallback is safe and permanent")
                return
            try:
                want = _np_dtype_of(expr, env)
                got = _resolve_weak(_jnp_dtype(expr, env))
            except Exception:
                return  # unmodeled shape: the first-batch verify covers it
            if np.dtype(got) != np.dtype(want):
                ctx.add(
                    "AR009", Severity.ERROR, node.node_id,
                    f"dual-path dtype divergence in {label} (chain member "
                    f"{mi}, {op}): the interpreted path computes {want} "
                    f"but the traced program would compute {np.dtype(got)}"
                    " — the byte-exactness contract cannot hold, so the "
                    "pipeline is rejected at plan time instead of failing "
                    "verification on the first batch",
                    "make the dtype explicit (e.g. CAST both operands to "
                    "DOUBLE) so both paths agree, or rewrite the "
                    "expression out of the compile-marked chain")

        for mi, (op, cfg) in enumerate(members):
            if op == OpName.VALUE.value:
                projections = cfg.get("projections")
                for n, e in projections or []:
                    compare(f"projection {n!r}", e, mi, op)
                if projections is not None:
                    nenv: dict = {}
                    for n, e in projections:
                        try:
                            nenv[n] = _np_dtype_of(e, env)
                        except Exception:
                            nenv[n] = np.dtype(object)  # host-only value
                    for carried in (TIMESTAMP_FIELD, KEY_FIELD,
                                    "_is_retract"):
                        if carried in env and carried not in nenv:
                            nenv[carried] = env[carried]
                    env = nenv
            elif op == OpName.KEY.value:
                for n, e in cfg.get("keys") or []:
                    compare(f"key {n!r}", e, mi, op)
                    try:
                        env[n] = _np_dtype_of(e, env)
                    except Exception:
                        env[n] = np.dtype(object)
                env[KEY_FIELD] = np.dtype(np.uint64)
            elif op == OpName.WATERMARK.value:
                if cfg.get("expr") is not None:
                    compare("watermark expression", cfg["expr"], mi, op)
            else:  # window insert: accumulator input expressions
                for n, _k, e in cfg.get("aggregates") or []:
                    if e is not None:
                        compare(f"aggregate input {n!r}", e, mi, op)
