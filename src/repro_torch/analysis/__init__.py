"""Static and dynamic design-rule checking for the port (DESIGN.md §13).

Two halves, as in ``repro.analysis``:

* :mod:`repro_torch.analysis.lint` + :mod:`repro_torch.analysis.rules`
  — the dependency-free AST contract linter (``python -m
  repro_torch.analysis --gate``).  Importing ``repro_torch.analysis``
  pulls in only the stdlib.
* :mod:`repro_torch.analysis.audit` — the auditor behind
  ``CompiledBNN.audit()``, the port's counterpart of the reference's
  jaxpr auditor.  It needs torch, so it is loaded lazily via module
  ``__getattr__``; the gate never touches it.
"""

from __future__ import annotations

from typing import Any

from repro_torch.analysis.lint import (
    Finding,
    LintRun,
    Module,
    Rule,
    lint_files,
    lint_paths,
    repo_root,
)

__all__ = [
    "Finding",
    "LintRun",
    "Module",
    "Rule",
    "audit_compiled",
    "lint_files",
    "lint_paths",
    "repo_root",
]


def __getattr__(name: str) -> Any:
    if name in ("audit_compiled", "audit", "AuditReport", "AuditError"):
        from repro_torch.analysis import audit

        if name == "audit":
            return audit
        return getattr(audit, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
