"""Static analysis over the port's plans (the port's share of the JAX
package's ``analysis``): the shared diagnostic model (``diagnostics``),
the plan-diff pass (``plan_diff``, AR010-AR012), which matches operators
across an old and a new plan by state identity, classifies each as carried,
rebuilt, dropped or incompatible, emits the evolution mapping a restore
applies, and derives the plan fingerprint stamped into checkpoint markers,
and the plan passes AR001-AR009 (``plan_passes``, with AR009's dtype model
in ``trace_audit``), which ``sql.plan_query`` runs on every planned graph.
The repo lint and the other auditors come later (ROADMAP A.10).
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
