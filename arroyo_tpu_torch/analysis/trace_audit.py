"""AR009, plan-time dual-path dtype propagation (the port's share of the
JAX package's ``analysis/trace_audit.py``: its dtype model and
``pass_segment_compile``; the LR3xx source auditor is ROADMAP A.10).

The port's segment kernel takes every node's dtype from the JAX twin's
(expr.py's type functions mirror jax.numpy in 64-bit mode), so the model of
the traced dtype below holds for the port's compiled segment as it does for
the JAX package's, and AR009 gives the same verdicts.
"""

from __future__ import annotations

import numpy as np

from .diagnostics import Severity


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
