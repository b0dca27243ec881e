"""Repo lint engine: AST checks encoding invariants this repo paid to learn
(the port's copy of the JAX package's ``analysis/repo_lint.py``, keyed to
the port's paths and to PyTorch's idioms).

Each rule exists because its violation has already cost a debugging session
here (see CHANGES.md): ad-hoc sleep loops hid unrecoverable retries until
the chaos suite replaced them with the shared layer; a swallowed exception
let a crashed pipeline report success; an unseeded random in an operator
made replay nondeterministic; a peer dial under the connection-map lock
stalled every sender. The linter makes the lesson structural.

Rule catalog:

    LR101 ad-hoc-retry-sleep   ``time.sleep`` inside an except handler whose
                               delay does not come from the shared
                               utils/retry layer (Backoff.next_delay)
    LR102 swallowed-exception  bare ``except:`` anywhere; ``except
                               (Base)Exception: pass`` in engine/state/
                               connector/controller code
    LR103 unseeded-random      module-level random / np.random calls in
                               operator or engine code (replay determinism)
    LR104 host-sync-hot-path   ``torch.cuda.synchronize()`` anywhere in
                               operator code; ``.item()`` / ``.tolist()``
                               / ``.cpu()`` / ``.numpy()``, ``int()`` /
                               ``float()`` / ``bool()`` and ``np.asarray``
                               on tensors inside the operator hot paths
                               (``process_batch`` / ``handle_watermark``
                               / ``handle_tick``)
    LR105 lock-across-blocking RETIRED as a standalone rule: folded into
                               the interprocedural LR403 (concurrency
                               auditor), which follows same-class helper
                               calls to the blocking sink. The LR105 id
                               still binds as a waiver alias at LR403
                               sites, so existing waivers keep suppressing
    LR106 fault-site-coverage  storage/network/queue mutations must route
                               through ``faults`` hooks; every declared
                               fault site must be wired somewhere
    LR107 emit-in-loop         direct ``collector.collect(...)`` inside a
                               Python loop in operator hot-path code: one
                               sub-threshold batch per iteration pays full
                               per-batch overhead per emit; build columns
                               across iterations and emit once (the
                               coalescing layer smooths queue transits, but
                               cannot remove per-collect routing work)
    LR108 bare-print           ``print()`` in arroyo_tpu_torch/ library code
                               (outside cli.py/__main__.py): worker stdout
                               IS the JSON-lines control protocol, so a
                               stray print corrupts controller event
                               parsing — and it bypasses the configured
                               logging format/level; route through
                               ``logging.getLogger(...)``
    LR109 ad-hoc-self-timing   ``time.time()``/``time.monotonic()``/
                               ``time.perf_counter()``/``time.thread_time()``
                               in operator/window/state code: self-
                               measurement belongs in the profiler hooks
                               (obs/profile.py TaskProfiler wraps every
                               operator hook), or cost attribution
                               fragments into untrackable side channels.
                               Legitimate wall-clock uses (cache TTLs,
                               event-time idle detection, coalescing
                               deadlines) carry waivers naming the reason
    LR110 logger-in-function   ``logging.getLogger("name")`` inside a
                               function body: acquire the module's logger
                               ONCE at module level (``_log = logging.
                               getLogger(...)``) — per-call acquisition
                               hides the logger from level configuration
                               audits, re-pays the registry lookup on hot
                               error paths, and encourages the inline
                               ``import logging`` that shadows the
                               structured-events bridge setup. Bare
                               ``logging.getLogger()`` (the root logger,
                               used by logging-INIT code) is exempt
    LR111 build-in-hot-path    a kernel build inside an operator hot-path
                               method (process_batch / handle_watermark /
                               handle_tick): ``kernels.build_source``
                               (nvcc), the construction of K4's
                               ``SegmentProgram`` (its Triton source
                               generated) or its ``.module()`` (written
                               and imported), ``triton.jit`` or
                               ``torch.compile``. Built kernels belong in
                               the segment-compiler cache (engine/
                               segment.py) or a once-per-source loader
                               (ops/kernels.py ``build_source``); hot
                               paths only CALL them

The LR2xx series (replay-soundness audit: checkpoint-coverage of operator
state, commit-gated side effects, checkpoint/restore table symmetry,
ordered emission) lives in ``state_audit.py`` and runs as part of every
``lint_paths`` sweep that touches operators/, windows/, or connectors/.
The LR3xx series (trace-safety audit: purity/host-sync, shape stability,
allowlist drift, and dual-path dtype parity of segment-compiled and device
code) lives in ``trace_audit.py`` and runs as a whole-program pass over
every ``lint_paths`` sweep.

Waivers: append ``# lint: waive LR1xx — justification`` on the flagged
line (or the line above). A waiver with no justification text does not
suppress the finding.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Iterable, Optional

from .diagnostics import Diagnostic, Severity, finish

_WAIVE_RE = re.compile(r"lint:\s*waive\s+(LR\d+)\s*(?:[-—:,]\s*)?(.*)", re.I)


@dataclass
class ModuleInfo:
    relpath: str  # forward-slash path relative to the repo/package root
    tree: ast.AST
    comments: dict[int, str] = field(default_factory=dict)  # line -> text
    # local name -> canonical dotted origin, mined from module imports
    # (``import torch.cuda as whatever`` -> {"whatever": "torch.cuda"},
    # ``from torch import cuda as C`` -> {"C": "torch.cuda"}), so no rule keyed
    # on a module/function name can be dodged by an import alias
    aliases: dict[str, str] = field(default_factory=dict)
    # the same for relative from-imports, which bind the port's own names
    # (``from ..ops.kernels import build_source as B`` -> {"B":
    # "ops.kernels.build_source"}): LR111 keys on those
    rel_aliases: dict[str, str] = field(default_factory=dict)

    def in_dirs(self, *dirs: str) -> bool:
        parts = self.relpath.split("/")
        return any(d in parts for d in dirs)

    def canonical(self, dotted: str) -> str:
        """Rewrite the leading segment of a dotted name through the
        module's import aliases (``whatever.synchronize`` -> ``torch.cuda.
        synchronize``). Names with no alias pass through unchanged."""
        if not dotted:
            return dotted
        head, _, rest = dotted.partition(".")
        root = self.aliases.get(head)
        if root is None:
            return dotted
        return f"{root}.{rest}" if rest else root

    def waiver(self, line: int, rule_id: str) -> Optional[str]:
        """Justification text if a valid waiver covers (line, rule)."""
        for ln in (line, line - 1):
            m = _WAIVE_RE.search(self.comments.get(ln, ""))
            if m and m.group(1).upper() == rule_id and m.group(2).strip():
                return m.group(2).strip()
        return None


def _mine_aliases(tree: ast.AST) -> dict[str, str]:
    """Module-wide import alias map (absolute imports only: relative
    imports bind package-internal names the rules never key on)."""
    out: dict[str, str] = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            for a in n.names:
                if a.asname:
                    out[a.asname] = a.name
                else:  # `import torch.cuda` binds the root name `torch`
                    root = a.name.split(".")[0]
                    out.setdefault(root, root)
        elif isinstance(n, ast.ImportFrom) and n.module and not n.level:
            for a in n.names:
                if a.name != "*":
                    out[a.asname or a.name] = f"{n.module}.{a.name}"
    return out


def _mine_relative_aliases(tree: ast.AST) -> dict[str, str]:
    out: dict[str, str] = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.ImportFrom) and n.level:
            for a in n.names:
                if a.name != "*":
                    out[a.asname or a.name] = ".".join(
                        p for p in (n.module, a.name) if p)
    return out


def _parse(source: str, relpath: str) -> ModuleInfo:
    info = ModuleInfo(relpath.replace(os.sep, "/"), ast.parse(source))
    info.aliases = _mine_aliases(info.tree)
    info.rel_aliases = _mine_relative_aliases(info.tree)
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                info.comments[tok.start[0]] = tok.string
    except tokenize.TokenError:
        pass
    return info


# ------------------------------------------------------------- AST helpers


def _call_name(call: ast.Call) -> str:
    """Trailing identifier of the called expression ('sleep', 'put', ...)."""
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _receiver_name(call: ast.Call) -> str:
    """Identifier the method is called on ('time' in time.sleep, '_out' in
    self._out.get); empty for plain names."""
    f = call.func
    if isinstance(f, ast.Attribute):
        v = f.value
        if isinstance(v, ast.Name):
            return v.id
        if isinstance(v, ast.Attribute):
            return v.attr
    return ""


def _dotted(expr: ast.expr) -> str:
    """Best-effort dotted name ('np.random.uniform')."""
    parts: list[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
    return ".".join(reversed(parts))


def _mentions_lock(expr: ast.expr) -> bool:
    for n in ast.walk(expr):
        ident = None
        if isinstance(n, ast.Name):
            ident = n.id
        elif isinstance(n, ast.Attribute):
            ident = n.attr
        if ident is not None and "lock" in ident.lower():
            return True
    return False


def _walk_skipping_nested_defs(node: ast.AST) -> Iterable[ast.AST]:
    """Walk a statement body without descending into nested function/class
    defs (their bodies execute later, outside the enclosing region)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


Finding = tuple[int, str, str]  # line, message, hint


# ------------------------------------------------------------------- rules


def rule_lr101(mod: ModuleInfo) -> Iterable[Finding]:
    """time.sleep inside an except handler = a hand-rolled retry backoff,
    unless the delay comes from the shared retry layer."""
    if mod.relpath.endswith("utils/retry.py"):
        return
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            # canonical first: `from time import sleep as zz; zz(...)`
            # must resolve — the bare-name dodge the alias map exists for
            is_sleep = mod.canonical(_dotted(n.func)) == "time.sleep" or (
                _call_name(n) == "sleep"
                and _receiver_name(n) in ("time", "_time"))
            if not is_sleep:
                continue
            from_shared = any(
                isinstance(a, ast.Call) and _call_name(a) == "next_delay"
                for arg in n.args for a in ast.walk(arg)
            )
            if not from_shared:
                yield (n.lineno,
                       "ad-hoc retry backoff: time.sleep inside an except "
                       "handler with a delay not drawn from the shared retry "
                       "layer",
                       "use utils/retry.py (retry_call, or Backoff.next_delay "
                       "for loops)")


def rule_lr102(mod: ModuleInfo) -> Iterable[Finding]:
    """Bare except anywhere; silently-swallowed broad except in the
    engine/state/connector/controller layers."""
    strict_scope = mod.in_dirs("engine", "state", "connectors", "controller")
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            yield (node.lineno,
                   "bare except: catches KeyboardInterrupt/SystemExit and "
                   "hides programming errors",
                   "catch Exception (or the specific errors) instead")
            continue
        if not strict_scope:
            continue
        broad = isinstance(node.type, ast.Name) and node.type.id in (
            "Exception", "BaseException")
        swallows = len(node.body) == 1 and isinstance(node.body[0], ast.Pass)
        if broad and swallows:
            yield (node.lineno,
                   "swallowed exception: broad except with a bare `pass` in "
                   "engine/state/connector code can hide real failures "
                   "(a crashed pipeline once reported success this way)",
                   "log it, narrow the type, or waive with justification if "
                   "failure here is genuinely unactionable")


_RANDOM_FNS = {"random", "randrange", "randint", "uniform", "choice",
               "choices", "shuffle", "sample", "normal", "rand", "randn"}


def rule_lr103(mod: ModuleInfo) -> Iterable[Finding]:
    """Module-level random/np.random draws in operator or engine code break
    replay determinism (checkpoint recovery re-executes these paths)."""
    if not mod.in_dirs("operators", "ops", "windows", "parallel", "engine"):
        return
    for n in ast.walk(mod.tree):
        if not isinstance(n, ast.Call):
            continue
        dn = mod.canonical(_dotted(n.func))
        if dn.startswith(("random.", "numpy.random.")) and \
                dn.rsplit(".", 1)[-1] in _RANDOM_FNS:
            yield (n.lineno,
                   f"unseeded {dn}() in operator/engine code: output differs "
                   "across replays, so checkpoint recovery is no longer "
                   "byte-exact",
                   "derive the value deterministically (task identity, "
                   "config seed) or use a seeded Random instance")


# the operator hot-path methods LR104 and LR111 look inside
_HOT_METHODS = ("process_batch", "process_batches", "handle_watermark", "handle_tick")
# tensor methods that copy to the host and wait for the device
_LR104_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")


def rule_lr104(mod: ModuleInfo) -> Iterable[Finding]:
    """Host sync in the per-batch hot path: torch.cuda.synchronize()
    anywhere in operator code; .item()/.tolist()/.cpu()/.numpy() and
    int()/float()/bool()/np.asarray()/np.array() applied to tensors (names
    bound from ``torch.*`` or ``eval_torch`` calls) inside the hot-path
    methods."""
    if not mod.in_dirs("operators", "ops", "windows", "parallel"):
        return
    for n in ast.walk(mod.tree):
        if isinstance(n, ast.Call) and \
                mod.canonical(_dotted(n.func)) == "torch.cuda.synchronize":
            yield (n.lineno,
                   "torch.cuda.synchronize() in operator code waits for the "
                   "whole device per batch, serializing the device pipeline",
                   "let values stay on the device; wait on one event (ops/"
                   "prefetch.py HostFetch) at sinks or checkpoint boundaries")
    for fn in ast.walk(mod.tree):
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name in _HOT_METHODS):
            continue
        device_names: set[str] = set()
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                    isinstance(n.targets[0], ast.Name):
                produces_device = any(
                    isinstance(c, ast.Call) and (
                        _call_name(c) == "eval_torch"
                        or mod.canonical(_dotted(c.func)).startswith("torch.")
                    )
                    for c in ast.walk(n.value)
                )
                if produces_device:
                    device_names.add(n.targets[0].id)
        if not device_names:
            continue
        for n in ast.walk(fn):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            if isinstance(f, ast.Attribute) and f.attr in _LR104_SYNC_METHODS \
                    and isinstance(f.value, ast.Name) and f.value.id in device_names:
                yield (n.lineno,
                       f".{f.attr}() on a tensor inside {fn.name}: copies it to "
                       "the host and waits for the device in the per-batch hot "
                       "path",
                       "keep the value on the device, or move the transfer to "
                       "flush/checkpoint time (a HostFetch behind an event)")
                continue
            if not n.args:
                continue
            arg0 = n.args[0]
            if not (isinstance(arg0, ast.Name) and arg0.id in device_names):
                continue
            dn = mod.canonical(_dotted(f))
            if dn in ("int", "float", "bool") or dn in (
                    "numpy.asarray", "numpy.array", "np.asarray", "np.array"):
                yield (n.lineno,
                       f"{dn}() on a tensor inside {fn.name}: forces a "
                       "blocking device->host transfer in the per-batch hot "
                       "path",
                       "keep the value in torch on the device, or move the "
                       "transfer to flush/checkpoint time")


# LR105 (intraprocedural lock-across-blocking) is retired: the concurrency
# auditor's LR403 subsumes it with interprocedural reach (same-class helper
# closures, lock entry contexts) and runs in every lint_paths sweep below.
# Existing `# lint: waive LR105` comments still bind at LR403 sites.


# file-suffix -> (functions that mutate storage/network/queues, gateways
# that count as routing through the fault layer)
_LR106_TARGETS = {
    "state/storage.py": (
        ("read_bytes", "write_bytes", "read_text", "write_text", "exists",
         "isdir", "listdir", "remove", "rmtree"),
        ("fault_point", "_guarded"),
    ),
    "engine/network.py": (
        ("put", "_read_loop"),
        ("fault_point",),
    ),
    "engine/queues.py": (
        ("put",),
        ("fault_point",),
    ),
}


def rule_lr106(mod: ModuleInfo) -> Iterable[Finding]:
    """Every storage/network/queue mutation must route through the faults
    hooks — otherwise the chaos suite silently stops covering it."""
    target = next((v for k, v in _LR106_TARGETS.items()
                   if mod.relpath.endswith(k)), None)
    if target is None:
        return
    required, gateways = target
    # intra-module call graph over every function (methods by bare name)
    funcs: dict[str, list[ast.FunctionDef]] = {}
    for n in ast.walk(mod.tree):
        if isinstance(n, ast.FunctionDef):
            funcs.setdefault(n.name, []).append(n)

    def reaches_gateway(name: str, seen: set[str]) -> bool:
        if name in seen:
            return False
        seen.add(name)
        for fn in funcs.get(name, []):
            for n in ast.walk(fn):
                if isinstance(n, ast.Call):
                    cn = _call_name(n)
                    if cn in gateways:
                        return True
                    if cn in funcs and reaches_gateway(cn, seen):
                        return True
        return False

    for name in required:
        for fn in funcs.get(name, []):
            if not reaches_gateway(name, set()):
                yield (fn.lineno,
                       f"{name}() mutates storage/network/queue state but "
                       "never routes through a faults hook; chaos tests "
                       "cannot exercise its failure path",
                       "call faults.fault_point(...) (directly or via the "
                       "module's guarded helper) inside the operation")


def rule_lr107(mod: ModuleInfo) -> Iterable[Finding]:
    """Per-iteration emits in operator hot paths: N tiny batches through
    collector -> queue -> data plane where one coalesced batch would do.
    The fused multi-window closes (InstantJoin/SlidingAggregate) exist
    precisely to keep this pattern out of the emission path."""
    if not mod.in_dirs("operators", "windows", "ops"):
        return
    seen: set[int] = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.For, ast.While)):
            continue
        for n in _walk_skipping_nested_defs(node):
            if (isinstance(n, ast.Call) and _call_name(n) == "collect"
                    and "collector" in _receiver_name(n).lower()
                    and n.lineno not in seen):
                seen.add(n.lineno)
                yield (n.lineno,
                       "collector.collect() inside a loop emits one "
                       "sub-threshold batch per iteration through the full "
                       "collector/queue/data-plane path",
                       "accumulate the iterations' columns and emit one "
                       "batch after the loop (see the fused multi-window "
                       "closes), or waive with justification")


def rule_lr108(mod: ModuleInfo) -> Iterable[Finding]:
    """Bare print() in library code. A worker subprocess's stdout is the
    JSON-lines wire protocol to the controller (scheduler.py docstring):
    a print from engine/operator/connector code interleaves garbage into
    the event stream (the reader skips unparseable lines, silently losing
    the message). CLI entry points (cli.py, __main__.py) own their stdout
    and are exempt; bench.py and tools/ live outside the package."""
    if not mod.relpath.startswith("arroyo_tpu_torch/"):
        return
    if mod.relpath in ("arroyo_tpu_torch/cli.py", "arroyo_tpu_torch/__main__.py"):
        return
    for n in ast.walk(mod.tree):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id == "print":
            yield (n.lineno,
                   "bare print() in library code: worker stdout is the "
                   "JSON-lines control protocol (a stray line corrupts "
                   "controller event parsing) and prints bypass the "
                   "configured logging format/level",
                   "route through logging.getLogger('arroyo_tpu_torch...') — or "
                   "waive with justification for genuinely CLI-owned output")


_LR109_TIME_FNS = {"time", "monotonic", "perf_counter", "thread_time",
                   "process_time", "monotonic_ns", "perf_counter_ns",
                   "thread_time_ns", "process_time_ns"}


def rule_lr109(mod: ModuleInfo) -> Iterable[Finding]:
    """Clock reads in operator/window/state code. Self-time measurement is
    the profiler's job (obs/profile.py wraps every operator hook with
    wall + thread-CPU accounting) — a stray stopwatch in an operator both
    duplicates that attribution and, worse, escapes it. Non-measurement
    clock uses (cache TTLs, idle detection, flush deadlines) are real and
    carry waivers so each documents why it is not self-measurement."""
    if not mod.in_dirs("operators", "windows", "state", "ops"):
        return
    for n in ast.walk(mod.tree):
        if not isinstance(n, ast.Call):
            continue
        dn = mod.canonical(_dotted(n.func))
        clock = (dn.startswith("time.") and
                 dn.split(".", 1)[1] in _LR109_TIME_FNS) or \
            (_receiver_name(n) in ("time", "_time")
             and _call_name(n) in _LR109_TIME_FNS)
        if clock:
            yield (n.lineno,
                   f"{_receiver_name(n) or dn.rsplit('.', 1)[0]}."
                   f"{_call_name(n)}() in operator/"
                   "window/state code: self-measurement belongs in the "
                   "profiler hooks (obs/profile.py), where it lands in "
                   "arroyo_worker_self_time_seconds instead of a side "
                   "channel",
                   "let the task run loop attribute the cost; for a "
                   "genuine wall-clock need (TTL, idle detection, flush "
                   "deadline), waive with the reason")


def rule_lr110(mod: ModuleInfo) -> Iterable[Finding]:
    """Named logger acquisition inside a function body. The package's
    convention is one module-level ``_log = logging.getLogger(...)``;
    inline acquisition (found twice in controller.py before this rule)
    drifts into per-call ``import logging`` blocks and makes the set of
    logger names impossible to audit statically."""
    if not mod.relpath.startswith("arroyo_tpu_torch/"):
        return
    seen: set[int] = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for n in ast.walk(node):
            if (isinstance(n, ast.Call) and _call_name(n) == "getLogger"
                    and _receiver_name(n) == "logging"
                    and (n.args or n.keywords)  # bare root-logger is exempt
                    and n.lineno not in seen):
                seen.add(n.lineno)
                yield (n.lineno,
                       "logging.getLogger(...) inside a function body: "
                       "loggers are acquired once at module level in this "
                       "package, so names stay statically auditable and "
                       "hot error paths skip the registry lookup",
                       "hoist to a module-level `_log = logging."
                       "getLogger(\"arroyo_tpu_torch...\")` and use _log here")


# calls that build a kernel: nvcc through ops/kernels.py, K4's Triton
# source generation (SegmentProgram) and its load (.module()), and the
# library compilers
_LR111_BUILD_CALLS = ("build_source", "SegmentProgram")
_LR111_BUILD_NAMES = ("triton.jit", "torch.compile",
                      "torch.utils.cpp_extension.load",
                      "torch.utils.cpp_extension.load_inline")


def rule_lr111(mod: ModuleInfo) -> Iterable[Finding]:
    """A kernel build inside operator hot paths. ``SegmentProgram(plan,
    dtypes)`` per batch generates K4's Triton source again and its
    ``.module()`` writes and imports it (Triton then compiles at the first
    launch); ``build_source`` runs nvcc when its digest is new. Either
    costs milliseconds to seconds a batch that profile as 'process'
    self-time. Built kernels live in the segment-compiler cache, or in
    the per-source loaders of ops/kernels.py; hot paths only CALL them."""
    if not mod.in_dirs("operators", "windows", "ops"):
        return
    for fn in ast.walk(mod.tree):
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name in _HOT_METHODS):
            continue
        for n in ast.walk(fn):
            if not isinstance(n, ast.Call):
                continue
            dn = mod.canonical(_dotted(n.func))
            name = _call_name(n)
            if isinstance(n.func, ast.Name) and name in mod.rel_aliases:
                name = mod.rel_aliases[name].rsplit(".", 1)[-1]
            build = name in _LR111_BUILD_CALLS or dn in _LR111_BUILD_NAMES or (
                name == "module" and isinstance(n.func, ast.Attribute)
                and not n.args and not n.keywords)
            if build:
                yield (n.lineno,
                       f"{dn or name}() inside {fn.name}: a kernel build per "
                       "batch regenerates, rewrites or recompiles the kernel "
                       "on every batch — the rebuild-per-batch bug the segment "
                       "compiler's cache (engine/segment.py) exists to prevent",
                       "build the kernel once — in the segment-compiler cache "
                       "or a per-source loader — and only call it from the "
                       "hot path")


RULES: tuple[tuple[str, Severity, object], ...] = (
    ("LR101", Severity.ERROR, rule_lr101),
    ("LR102", Severity.ERROR, rule_lr102),
    ("LR103", Severity.ERROR, rule_lr103),
    ("LR104", Severity.WARNING, rule_lr104),
    ("LR106", Severity.ERROR, rule_lr106),
    ("LR107", Severity.ERROR, rule_lr107),
    ("LR108", Severity.ERROR, rule_lr108),
    ("LR109", Severity.ERROR, rule_lr109),
    ("LR110", Severity.ERROR, rule_lr110),
    ("LR111", Severity.ERROR, rule_lr111),
)

# fault sites every full-package lint must find wired (mirrors faults.SITES;
# a literal copy so the linter itself has no runtime imports of the engine)
_DECLARED_FAULT_SITES = (
    "storage.put", "storage.get", "storage.delete", "storage.list",
    "storage.multipart", "network.send", "network.recv", "queue.put",
    "connector.poll", "connector.commit", "worker", "worker.heartbeat",
    "node.start_worker", "controller_rpc", "commit", "rescale",
    "autoscale_decide", "spill_write", "spill_probe", "spill_compact",
    "admission", "fleet_place", "job_tick", "evolve_drain", "evolve_cutover",
    "lock_contend",
)


def lint_module(mod: ModuleInfo) -> list[Diagnostic]:
    """Run every rule over one parsed module; waived findings suppressed."""
    out: list[Diagnostic] = []
    for rule_id, sev, rule in RULES:
        for line, message, hint in rule(mod):
            if mod.waiver(line, rule_id):
                continue
            out.append(Diagnostic(rule_id, sev, f"{mod.relpath}:{line}",
                                  message, hint))
    return out


def lint_source(source: str, relpath: str) -> list[Diagnostic]:
    """Lint one file's text."""
    return lint_module(_parse(source, relpath))


def _site_literals(tree: ast.AST) -> set[str]:
    # sites reach fault_point either directly or through a module's guarded
    # gateway (storage.py's _guarded/_guarded_v, spill.py's _write_run),
    # which takes the site as its first argument
    out = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) \
                and _call_name(n) in ("fault_point", "_guarded", "_guarded_v",
                                      "_write_run", "_encode_and_write") \
                and n.args:
            a = n.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                out.add(a.value)
    return out


def lint_paths(paths: list[str], root: Optional[str] = None) -> list[Diagnostic]:
    """Lint every .py file under ``paths`` (files or directories).

    When the sweep includes the faults package itself (i.e. a whole-package
    run), additionally checks that every declared fault site is wired at
    least once somewhere in the sweep (LR106). Modules under the audited
    operator/window/connector dirs additionally run the replay-soundness
    auditor (state_audit, LR201-LR204) as one whole-program pass over the
    sweep, so ``python -m arroyo_tpu_torch lint`` is the single entry point."""
    root = os.path.abspath(root or os.getcwd())
    files: list[str] = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
                files.extend(os.path.join(dirpath, f)
                             for f in sorted(filenames) if f.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    diags: list[Diagnostic] = []
    wired_sites: set[str] = set()
    saw_faults_pkg = False
    audited: list[ModuleInfo] = []
    parsed: list[ModuleInfo] = []
    for f in files:
        rel = os.path.relpath(f, root).replace(os.sep, "/")
        with open(f) as fh:
            src = fh.read()
        try:
            mod = _parse(src, rel)
        except SyntaxError as e:
            diags.append(Diagnostic("LR000", Severity.ERROR, f"{rel}:{e.lineno or 0}",
                                    f"file does not parse: {e.msg}"))
            continue
        parsed.append(mod)
        diags.extend(lint_module(mod))
        wired_sites |= _site_literals(mod.tree)
        if mod.in_dirs("operators", "windows", "connectors"):
            audited.append(mod)
        if rel.endswith("faults/__init__.py"):
            saw_faults_pkg = True
    if audited:
        from .state_audit import audit_modules

        diags.extend(audit_modules(audited)[0])
    if parsed:
        # trace-safety audit (LR3xx): a whole-program pass over the sweep —
        # it self-selects its scope (eval_torch twins and K4's plain
        # version and generator), so running
        # it over every parsed module keeps `lint` the single entry point
        from .trace_audit import audit_trace_modules

        diags.extend(audit_trace_modules(parsed))
        # concurrency audit (LR4xx): whole-program over the sweep — classes
        # resolve across every parsed module, findings self-scope to the
        # threaded engine/state/controller layers
        from .concurrency_audit import audit_concurrency_modules

        diags.extend(audit_concurrency_modules(parsed))
    if saw_faults_pkg:
        for site in _DECLARED_FAULT_SITES:
            if site not in wired_sites:
                diags.append(Diagnostic(
                    "LR106", Severity.ERROR, "arroyo_tpu_torch/faults/__init__.py:1",
                    f"declared fault site {site!r} has no fault_point call "
                    "site anywhere in the package",
                    "wire the site or remove it from faults.SITES"))
    return finish(diags)
