"""Shared diagnostic model for both analysis engines (the port's copy of
the JAX package's ``analysis/diagnostics.py``).

One shape serves the plan analyzer (sites are graph node/edge ids) and the
repo lint engine (sites are file:line): rule id, severity, site, message,
fix hint. Diagnostics order deterministically (same input -> identical
ordered output) so CI diffs and golden assertions are stable.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterable, Optional


class Severity(enum.IntEnum):
    """Ordered so max() picks the worst finding."""

    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:  # "error", not "Severity.ERROR"
        return self.name.lower()


@dataclass(frozen=True)
class Diagnostic:
    rule_id: str  # e.g. "AR002" (plan) / "LR105" (repo lint)
    severity: Severity
    site: str  # node id / "src -> dst" edge / "path:line"
    message: str
    hint: str = ""  # actionable fix suggestion, may be empty

    def render(self) -> str:
        out = f"{self.severity}[{self.rule_id}] {self.site}: {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def to_dict(self) -> dict:
        """Machine-readable shape for ``--json`` output / CI annotation."""
        return {"rule": self.rule_id, "severity": str(self.severity),
                "site": self.site, "message": self.message, "hint": self.hint}

    def sort_key(self):
        # worst first, then stable by site/rule/message so equal inputs
        # always produce byte-identical reports
        return (-int(self.severity), self.site, self.rule_id, self.message)


from ..sql.lexer import SqlError as _SqlError


class AnalysisError(_SqlError):
    """Raised when plan analysis finds ERROR-severity diagnostics.

    A SqlError subclass so every existing plan-failure surface (API 400s,
    CLI run, tests) rejects analyzer findings the same way it rejects parse
    errors. Carries the full diagnostic list; str() is the rendered report
    so the rule id reaches CLI/API users unchanged.
    """

    def __init__(self, diagnostics: list[Diagnostic]):
        self.diagnostics = list(diagnostics)
        super().__init__(render_report(self.diagnostics))


def finish(diags: Iterable[Diagnostic]) -> list[Diagnostic]:
    """Deterministic final ordering + exact-duplicate removal."""
    seen = set()
    out = []
    for d in sorted(diags, key=Diagnostic.sort_key):
        if d not in seen:
            seen.add(d)
            out.append(d)
    return out


def worst(diags: Iterable[Diagnostic]) -> Optional[Severity]:
    sevs = [d.severity for d in diags]
    return max(sevs) if sevs else None


def render_json(diags: list[Diagnostic]) -> str:
    """Deterministic JSON array of diagnostics (one object per finding:
    rule, severity, site, message, hint) for ``lint --json``/``check
    --json`` — CI annotates from this without scraping the text report."""
    import json

    return json.dumps([d.to_dict() for d in diags], indent=2)


_SITE_RE = None  # compiled lazily; module stays import-light


def render_sarif(diags: list[Diagnostic]) -> str:
    """Deterministic SARIF 2.1.0 document for ``lint --sarif`` / ``check
    --sarif``: CI annotates findings inline on PRs from this without any
    site-string scraping. ``path:line`` sites become physical locations;
    plan-graph sites (node ids, ``src -> dst`` edges) become logical
    locations. Severity maps ERROR->error, WARNING->warning, INFO->note;
    exit codes are owned by the CLI and unchanged by the format."""
    import json
    import re

    global _SITE_RE
    if _SITE_RE is None:
        _SITE_RE = re.compile(r"^(?P<path>[^\s:]+\.(?:py|sql)):(?P<line>\d+)$")
    level = {Severity.ERROR: "error", Severity.WARNING: "warning",
             Severity.INFO: "note"}
    results = []
    for d in diags:
        res = {
            "ruleId": d.rule_id,
            "level": level[d.severity],
            "message": {"text": d.message + (f"\nhint: {d.hint}" if d.hint
                                             else "")},
        }
        m = _SITE_RE.match(d.site)
        if m:
            res["locations"] = [{"physicalLocation": {
                "artifactLocation": {"uri": m.group("path")},
                "region": {"startLine": int(m.group("line"))},
            }}]
        else:
            res["locations"] = [{"logicalLocations": [
                {"fullyQualifiedName": d.site}]}]
        results.append(res)
    rules = [{"id": rid} for rid in sorted({d.rule_id for d in diags})]
    doc = {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                    "master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {"name": "arroyo-tpu-analysis",
                                "rules": rules}},
            "results": results,
        }],
    }
    return json.dumps(doc, indent=2)


def render_report(diags: list[Diagnostic]) -> str:
    if not diags:
        return "no findings"
    lines = [d.render() for d in diags]
    n_err = sum(1 for d in diags if d.severity == Severity.ERROR)
    n_warn = sum(1 for d in diags if d.severity == Severity.WARNING)
    lines.append(f"{len(diags)} finding(s): {n_err} error(s), {n_warn} warning(s)")
    return "\n".join(lines)
