"""The contract-lint engine of the port: design-rule checking in ``ast``.

A copy of the reference's engine (``repro.analysis.lint``): each rule in
:mod:`repro_torch.analysis.rules` is a numbered ``RPL###`` with a
DESIGN.md citation and checks a *repo-specific* contract that a generic
linter cannot express — the pack bit ``x > 0`` against the fold compare
``>= 0``, packing only at its blessed sites, the layers' import arrows,
serving counters under their locks, ``ThreadKill`` never swallowed, no
``jax`` or ``repro`` in the port.  The engine is **dependency-free on
purpose** (stdlib ``ast`` only — no torch, no numpy), so the gate runs
on a host with nothing installed.

API:

* :func:`lint_paths` / :func:`lint_files` -> ``list[Finding]``
* ``python -m repro_torch.analysis --gate`` lints ``src/repro_torch``,
  ``chip_smoke.py`` and ``examples/torch_*.py`` and exits nonzero on
  any finding, one line each::

      RPL004 src/repro_torch/serving/server.py:441 <message> (DESIGN.md §10)

The dynamic half of the same contracts, on a compiled artifact, is
``repro_torch.analysis.audit`` behind ``CompiledBNN.audit()``.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Finding",
    "LintRun",
    "Module",
    "Rule",
    "attr_chain",
    "lint_files",
    "lint_paths",
    "parse_module",
    "repo_root",
    "walk_with_parents",
]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One design-rule violation, formatted ``RPL### path:line msg (§)``."""

    rule: str
    path: str
    line: int
    message: str
    design_ref: str

    def format(self) -> str:
        return f"{self.rule} {self.path}:{self.line} {self.message} ({self.design_ref})"


@dataclasses.dataclass(frozen=True)
class Module:
    """One parsed source file handed to every rule.

    ``path`` is the display path (repo-relative when under the root);
    ``norm`` is the forward-slash form every scope predicate matches
    against (so ``tests/analysis_corpus/serving/server.py`` scopes the
    same way ``src/repro_torch/serving/server.py`` does).
    """

    path: str
    norm: str
    tree: ast.Module
    source: str

    def in_dir(self, segment: str) -> bool:
        """True when a ``/segment/`` path component is present."""
        return f"/{segment}/" in f"/{self.norm}"

    def endswith(self, suffix: str) -> bool:
        return self.norm.endswith(suffix)


@dataclasses.dataclass(frozen=True)
class Rule:
    """One executable design rule.

    ``check(module, run)`` yields ``(line, message)`` pairs; the engine
    stamps the rule id and DESIGN.md citation onto each.  ``run`` is
    the whole :class:`LintRun`, so cross-file rules (e.g. RPL005's
    deprecated-shim table) see every module linted together.
    """

    rule_id: str
    title: str
    design_ref: str
    check: Callable[["Module", "LintRun"], Iterable[Tuple[int, str]]]

    def apply(self, module: Module, run: "LintRun") -> List[Finding]:
        return [
            Finding(self.rule_id, module.path, line, msg, self.design_ref)
            for line, msg in self.check(module, run)
        ]


class LintRun:
    """All modules of one lint invocation + lazily-computed shared
    facts (cross-file rules cache their pass-1 tables here)."""

    def __init__(self, modules: Sequence[Module]) -> None:
        self.modules = tuple(modules)
        self._cache: Dict[str, object] = {}

    def computed(self, key: str, build: Callable[["LintRun"], object]) -> object:
        if key not in self._cache:
            self._cache[key] = build(self)
        return self._cache[key]


# ------------------------------------------------------------------ #
# shared AST helpers (used by the rule catalog)                        #
# ------------------------------------------------------------------ #
def attr_chain(node: ast.AST) -> Optional[str]:
    """Dotted name of a Name/Attribute chain (``jnp.where`` ->
    ``"jnp.where"``), or None for anything more dynamic."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def walk_with_parents(tree: ast.AST) -> Iterable[Tuple[ast.AST, Tuple[ast.AST, ...]]]:
    """ast.walk with the ancestor stack (outermost first)."""
    stack: List[Tuple[ast.AST, Tuple[ast.AST, ...]]] = [(tree, ())]
    while stack:
        node, parents = stack.pop()
        yield node, parents
        child_parents = parents + (node,)
        for child in ast.iter_child_nodes(node):
            stack.append((child, child_parents))


def repo_root() -> Path:
    """The repository root, derived from this file's location
    (``<root>/src/repro_torch/analysis/lint.py``) — the gate works from
    any working directory."""
    return Path(__file__).resolve().parents[3]


# ------------------------------------------------------------------ #
# the engine                                                           #
# ------------------------------------------------------------------ #
def _norm(path: Path, root: Optional[Path]) -> Tuple[str, str]:
    """(display, scope) forms of a path: repo-relative forward-slash
    when under the root, resolved forward-slash otherwise."""
    rp = path.resolve()
    if root is not None:
        try:
            rel = rp.relative_to(root.resolve())
            return rel.as_posix(), rel.as_posix()
        except ValueError:
            pass
    return str(path), rp.as_posix()


def parse_module(path: Path, root: Optional[Path] = None) -> Module:
    source = path.read_text(encoding="utf-8")
    display, norm = _norm(path, root)
    return Module(display, norm, ast.parse(source, filename=display), source)


def collect_py_files(paths: Sequence[Path]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            out.append(p)
        else:
            raise ValueError(f"not a Python file or directory: {p}")
    return out


def lint_files(
    files: Sequence[Path],
    root: Optional[Path] = None,
    rules: Optional[Sequence[Rule]] = None,
) -> List[Finding]:
    """Lint already-collected files as ONE run (cross-file rules see
    the whole set).  Findings are sorted by path, line, rule id."""
    if rules is None:
        from repro_torch.analysis.rules import ALL_RULES

        rules = ALL_RULES
    run = LintRun([parse_module(f, root) for f in files])
    findings: List[Finding] = []
    for module in run.modules:
        for rule in rules:
            findings.extend(rule.apply(module, run))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def lint_paths(
    paths: Sequence[Path],
    root: Optional[Path] = None,
    rules: Optional[Sequence[Rule]] = None,
) -> List[Finding]:
    """Recursively lint files and directories (the gate entry point)."""
    return lint_files(collect_py_files(paths), root=root, rules=rules)
