"""Static analysis over the port's plans (the port's share of the JAX
package's ``analysis``): the shared diagnostic model (``diagnostics``) and
the plan-diff pass (``plan_diff``, AR010-AR012), which matches operators
across an old and a new plan by state identity, classifies each as carried,
rebuilt, dropped or incompatible, emits the evolution mapping a restore
applies, and derives the plan fingerprint stamped into checkpoint markers.

The plan passes (AR001-AR009) come with the SQL front end; the repo lint
and the auditors come later.
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
