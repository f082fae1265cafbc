"""CLI for the port's contract linter: ``python -m repro_torch.analysis``.

The gate is ``python -m repro_torch.analysis --gate``: lint
``src/repro_torch``, ``chip_smoke.py`` and the example twins
(``examples/torch_*.py``) with the port's RPL catalog,
print one line per finding (``RPL### path:line message (DESIGN.md
§N)``), exit nonzero on any.  Stdlib-only by design — see
:mod:`repro_torch.analysis.lint`.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional, Sequence

from repro_torch.analysis.lint import lint_paths, repo_root
from repro_torch.analysis.rules import ALL_RULES


def default_gate_paths() -> List[Path]:
    root = repo_root()
    return [root / "src" / "repro_torch", root / "chip_smoke.py",
            *sorted((root / "examples").glob("torch_*.py"))]


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Design-rule check the port's contracts (DESIGN.md §13).",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        type=Path,
        help="files or directories to lint (default: src/repro_torch, "
        "chip_smoke.py and examples/torch_*.py)",
    )
    parser.add_argument(
        "--gate",
        action="store_true",
        help="CI mode: exit 1 when any rule fires",
    )
    parser.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule catalog and exit",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.rule_id}  {rule.title}  ({rule.design_ref})")
        return 0

    paths = list(args.paths) or default_gate_paths()
    missing = [p for p in paths if not p.exists()]
    if missing:
        for p in missing:
            print(f"error: no such path: {p}", file=sys.stderr)
        return 2

    findings = lint_paths(paths, root=repo_root())
    for finding in findings:
        print(finding.format())
    if findings:
        print(
            f"{len(findings)} contract violation(s) — "
            f"see DESIGN.md §13 for the rule catalog",
            file=sys.stderr,
        )
        return 1
    if not args.gate:
        print(f"clean: {len(ALL_RULES)} rules, no findings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
