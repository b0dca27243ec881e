"""Static analysis over the port (its copy of the JAX package's
``analysis``): one diagnostic model (``diagnostics``) shared by

- the plan passes AR001-AR009 (``plan_passes``, with AR009's dtype model
  in ``trace_audit``), which ``sql.plan_query`` runs on every planned
  graph and ``check_sql`` / ``python -m arroyo_tpu_torch check`` report;
- the plan-diff pass (``plan_diff``, AR010-AR012): it matches operators
  across an old and a new plan by state identity, classifies each as
  carried, rebuilt, dropped or incompatible, emits the evolution mapping
  a restore applies, and derives the plan fingerprint stamped into
  checkpoint markers;
- the repo lint (``repo_lint``, LR101-LR111) and, in the same sweep
  (``lint_paths``, ``python -m arroyo_tpu_torch lint``), the replay-
  soundness audit (``state_audit``, LR201-LR204), the trace-safety audit
  of K4's twins, plain version and generator (``trace_audit``,
  LR301-LR305) and the concurrency audit (``concurrency_audit``,
  LR401-LR404, whose static lock graph obs/lockorder.py's witness is
  held to).
"""

from __future__ import annotations

from .diagnostics import (  # noqa: F401
    AnalysisError,
    Diagnostic,
    Severity,
    finish,
    render_json,
    render_report,
    render_sarif,
    worst,
)
from .plan_diff import (  # noqa: F401
    NodeClassification,
    PlanDiff,
    diff_plans,
    plan_fingerprint,
)
from .plan_passes import PLAN_PASSES, PassContext, analyze_graph  # noqa: F401
from .repo_lint import RULES as LINT_RULES  # noqa: F401
from .repo_lint import lint_paths, lint_source  # noqa: F401
from .state_audit import RULES as AUDIT_RULES  # noqa: F401
from .state_audit import (  # noqa: F401
    audit_modules,
    audit_package,
    audit_source,
    coverage_for_class,
)
from .trace_audit import RULES as TRACE_RULES  # noqa: F401
from .trace_audit import (  # noqa: F401
    audit_trace_modules,
    audit_trace_source,
    audit_trace_sources,
)
from .concurrency_audit import RULES as CONCURRENCY_RULES  # noqa: F401
from .concurrency_audit import (  # noqa: F401
    audit_concurrency_modules,
    audit_concurrency_source,
    static_lock_graph,
    static_lock_graph_package,
)


def check_sql(sql: str, parallelism: int = 1):
    """Plan ``sql`` with the port's planner and run every analyzer pass,
    collecting ALL diagnostics instead of raising on the first error (the
    ``check`` CLI surface).

    Returns ``(planned_pipeline_or_None, diagnostics)``; the pipeline is
    None when planning itself fails (those failures surface as an AR000
    diagnostic so check output always speaks rule ids)."""
    from ..sql.lexer import SqlError
    from ..sql.planner import plan_query

    try:
        pp = plan_query(sql, parallelism=parallelism, analyze=False)
    except SqlError as e:
        return None, [Diagnostic("AR000", Severity.ERROR, "<plan>", str(e),
                                 "fix the SQL; this failure precedes graph "
                                 "analysis")]
    return pp, analyze_graph(pp.graph)
