"""Cross-module layering rules of the port (RPL005, RPL006, RPL011).

The counterpart of ``repro.analysis.rules.layering``, pointed at the
port's layers: kernels sit below core, serving never imports the chaos
layer, sim imports only core, graph and kernels
(``repro_torch/sim/__init__.py``), the lint engine stays stdlib-only,
deprecated shims are exits not thoroughfares — and, the port's own
rule, no module imports ``jax`` or the reference package ``repro``
(beside ``tests/test_torch_graph.py``'s import scan, which it does not
replace).

RPL008 (buffer donation only in owning modules) has no counterpart:
the port never donates a buffer (``GraphedApply`` copies each request
into its own static input, and ``CompiledBNN.serving_jit_kwargs`` is
not ported, by decision — ROADMAP, "Not ported").
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Tuple

from repro_torch.analysis.lint import (LintRun, Module, Rule, attr_chain,
                                       parse_module, repo_root)

# the port's shim hosts — scanned even when the gate is run on a single
# file, so a corpus/caller module still resolves the table
_SHIM_HOST_SUFFIXES = (
    "models/layers.py",
    "core/bnn_layers.py",
)


def _deprecated_defs(module: Module) -> Dict[str, str]:
    """``{function name: defining module norm}`` for every function
    whose docstring declares it a DEPRECATED shim."""
    out: Dict[str, str] = {}
    for node in ast.walk(module.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            doc = ast.get_docstring(node)
            if doc is not None and doc.lstrip().startswith("DEPRECATED"):
                out[node.name] = module.norm
    return out


def _shim_table(run: LintRun) -> Dict[str, str]:
    def build(r: LintRun) -> Dict[str, str]:
        table: Dict[str, str] = {}
        seen = {m.norm for m in r.modules}
        for suffix in _SHIM_HOST_SUFFIXES:
            path = repo_root() / "src" / "repro_torch" / suffix
            norm = f"src/repro_torch/{suffix}"
            if norm not in seen and path.exists():
                table.update(_deprecated_defs(parse_module(path, repo_root())))
        for m in r.modules:
            table.update(_deprecated_defs(m))
        return table

    return run.computed("rpl005.shims", build)  # type: ignore[return-value]


# the card's smoke run is an external caller: it holds the shims
# themselves (phase 11 drives models.layers.packed_mlp) on the card
_EXTERNAL_CALLERS = ("chip_smoke.py",)


def _check_shim_calls(module: Module, run: LintRun) -> Iterable[Tuple[int, str]]:
    table = _shim_table(run)
    if not table or module.norm in _EXTERNAL_CALLERS:
        return
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        if chain is None:
            continue
        leaf = chain.split(".")[-1]
        host = table.get(leaf)
        if host is None or host == module.norm:
            continue
        yield (
            node.lineno,
            f"call to DEPRECATED shim `{leaf}` (defined in {host}) — "
            f"internal code uses the graph front door "
            f"(repro_torch.graph.compile); shims exist only for external "
            f"callers mid-migration",
        )


def _imported_modules(tree: ast.Module) -> Iterable[Tuple[int, str]]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.module is not None:
            yield node.lineno, node.module


def _violates(imported: str, forbidden_prefix: str) -> bool:
    return imported == forbidden_prefix or imported.startswith(forbidden_prefix + ".")


# what sim may import of the port (repro_torch/sim/__init__.py)
_SIM_LAYERS = ("core", "graph", "kernels", "sim")


def _check_layering(module: Module, run: LintRun) -> Iterable[Tuple[int, str]]:
    in_kernels = module.in_dir("kernels")
    in_serving = module.in_dir("serving")
    in_sim = module.in_dir("sim")
    # the linter half of repro_torch.analysis must stay importable with
    # nothing installed; the auditor (audit.py) runs the compiled model
    bare_analysis = module.in_dir("analysis") and not module.endswith(
        "analysis/audit.py")
    for line, name in _imported_modules(module.tree):
        if in_kernels and _violates(name, "repro_torch.core"):
            yield (
                line,
                f"kernels module imports `{name}` — kernels are the "
                f"bottom layer; repro_torch.core depends on kernels, "
                f"never the reverse",
            )
        elif in_serving and _violates(name, "repro_torch.robustness"):
            yield (
                line,
                f"serving module imports `{name}` — fault injection "
                f"wraps the server from outside (no serving -> "
                f"robustness cycle)",
            )
        elif in_sim and _violates(name, "repro_torch") and not any(
            _violates(name, f"repro_torch.{layer}") for layer in _SIM_LAYERS
        ):
            yield (
                line,
                f"sim module imports `{name}` — the mesh simulator is a "
                f"measurement instrument over core/graph/kernels, never "
                f"a deployment path (DESIGN.md §14)",
            )
        elif bare_analysis and (
            name.split(".")[0] in ("torch", "numpy", "jax", "jaxlib")
            or (
                _violates(name, "repro_torch")
                and not _violates(name, "repro_torch.analysis")
            )
        ):
            yield (
                line,
                f"contract linter imports `{name}` — the lint engine is "
                f"dependency-free (stdlib ast only) so the gate runs on "
                f"a bare host; the auditor lives in "
                f"repro_torch.analysis.audit",
            )


def _check_port_imports(module: Module, run: LintRun) -> Iterable[Tuple[int, str]]:
    for line, name in _imported_modules(module.tree):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            yield (
                line,
                f"the port imports `{name}` — it runs on torch alone and "
                f"keeps its own copy of any reference module it needs; "
                f"only the parity tests import both packages",
            )


RULES = [
    Rule(
        "RPL005",
        "deprecated shims are not called internally",
        "DESIGN.md §8",
        _check_shim_calls,
    ),
    Rule(
        "RPL006",
        "layer import arrows point one way",
        "DESIGN.md §13",
        _check_layering,
    ),
    Rule(
        "RPL011",
        "the port imports neither jax nor the reference package",
        "DESIGN.md §13",
        _check_port_imports,
    ),
]
