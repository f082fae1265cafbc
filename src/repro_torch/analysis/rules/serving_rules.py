"""Serving-engine design rules of the port: threads, locks, clocks
(RPL002, RPL004, RPL009, RPL010).

The counterpart of ``repro.analysis.rules.serving_rules``, over the
port's ``serving/`` (DESIGN.md §10-§11): worker loops never swallow a
``ThreadKill`` (it derives BaseException precisely so ``except
Exception`` cannot eat it), ``BNNServer``'s counters mutate only under
their lock, deadlines use the monotonic clock, and lock acquisition
order is acyclic.  The port's server keeps the reference's counters; its
captured CUDA graphs (``_graphs``) take the place of the jit-trace set
under the trace lock.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.lint import (
    LintRun,
    Module,
    Rule,
    attr_chain,
    walk_with_parents,
)


def _handler_type_names(handler: ast.ExceptHandler) -> List[Optional[str]]:
    t = handler.type
    if t is None:
        return [None]
    if isinstance(t, ast.Tuple):
        return [attr_chain(e) for e in t.elts]
    return [attr_chain(t)]


def _handler_reraises(handler: ast.ExceptHandler) -> bool:
    """The handler re-raises (bare ``raise``) or classifies through a
    ``*_is_kill``-style predicate before deciding — either keeps a
    chaos ThreadKill lethal."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise) and node.exc is None:
            return True
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain is not None and "is_kill" in chain.split(".")[-1]:
                return True
    return False


def _check_loop_excepts(module: Module, run: LintRun) -> Iterable[Tuple[int, str]]:
    if not module.in_dir("serving"):
        return
    for fn in ast.walk(module.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not fn.name.endswith("_loop"):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.ExceptHandler):
                continue
            names = _handler_type_names(node)
            broad = None in names or any(
                n is not None and n.split(".")[-1] == "BaseException" for n in names
            )
            if broad and not _handler_reraises(node):
                what = "bare `except:`" if None in names else "`except BaseException`"
                yield (
                    node.lineno,
                    f"{what} in worker loop `{fn.name}` swallows "
                    f"ThreadKill — catch Exception, or re-raise after "
                    f"an `_is_kill` check",
                )


# counters of serving/server.py and the lock each mutation must hold
# (the map is the contract: adding a counter means adding it here)
_PROTECTED: Dict[str, "frozenset[str]"] = {
    "_qlock": frozenset({"_queue", "_queued_rows"}),
    "_trace_lock": frozenset({"_graphs"}),
    "_stats_lock": frozenset(
        {
            "_n_requests",
            "_n_rows",
            "_n_batches",
            "_bucket_hits",
            "_bucket_misses",
            "_padded_rows",
            "_valid_rows",
            "_real_rows",
            "_hbm_bytes",
            "_inflight_n",
            "_inflight_peak",
            "_flight_faults",
            "_backend_fallbacks",
            "_retries",
            "_bisections",
            "_poisoned",
            "_timeouts",
            "_rejected",
            "_thread_restarts",
            "_latency",
            "_queue_wait",
            "_host_ns",
        }
    ),
}
_LOCK_OF = {name: lock for lock, names in _PROTECTED.items() for name in names}
_MUTATORS = frozenset(
    {
        "add",
        "append",
        "appendleft",
        "clear",
        "discard",
        "extend",
        "insert",
        "pop",
        "popleft",
        "put",
        "remove",
        "update",
    }
)
# single-threaded by construction: no lock needed before the worker
# threads exist
_EXEMPT_METHODS = frozenset({"__init__", "start"})


def _self_attr(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _mutated_attr(node: ast.AST) -> Optional[Tuple[str, int]]:
    """(self-attribute name, line) when ``node`` mutates it."""
    if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for t in targets:
            if isinstance(t, ast.Subscript):
                t = t.value
            attr = _self_attr(t)
            if attr is not None:
                return attr, node.lineno
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in _MUTATORS
    ):
        attr = _self_attr(node.func.value)
        if attr is not None:
            return attr, node.lineno
    return None


def _with_locks(node: ast.With) -> List[str]:
    out = []
    for item in node.items:
        attr = _self_attr(item.context_expr)
        if attr is not None and "lock" in attr:
            out.append(attr)
    return out


def _check_counter_locks(module: Module, run: LintRun) -> Iterable[Tuple[int, str]]:
    if not module.endswith("serving/server.py"):
        return
    for node, parents in walk_with_parents(module.tree):
        mut = _mutated_attr(node)
        if mut is None:
            continue
        attr, line = mut
        lock = _LOCK_OF.get(attr)
        if lock is None:
            continue
        fn = next(
            (
                p.name
                for p in reversed(parents)
                if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef))
            ),
            None,
        )
        if fn in _EXEMPT_METHODS or fn is None:
            continue
        held = {
            lk for p in parents if isinstance(p, ast.With) for lk in _with_locks(p)
        }
        if lock not in held:
            yield (
                line,
                f"`self.{attr}` mutated in `{fn}` without holding "
                f"`self.{lock}` — worker threads race this counter",
            )


def _check_monotonic_clock(module: Module, run: LintRun) -> Iterable[Tuple[int, str]]:
    if not module.in_dir("serving"):
        return
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Call) and attr_chain(node.func) == "time.time":
            yield (
                node.lineno,
                "wall-clock `time.time()` in the serving layer — "
                "deadlines and latency math use the monotonic "
                "`time.perf_counter()`",
            )


# ------------------------------------------------------------------ #
# RPL010: static lock-acquisition-order graph with cycle detection     #
# ------------------------------------------------------------------ #
def _class_lock_attrs(cls: ast.ClassDef) -> Set[str]:
    locks: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            chain = attr_chain(node.value.func)
            if chain is not None and chain.split(".")[-1] in ("Lock", "RLock"):
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        locks.add(attr)
    return locks


def _method_locks(
    name: str,
    methods: Dict[str, ast.FunctionDef],
    locks: Set[str],
    memo: Dict[str, Set[str]],
    seen: Set[str],
) -> Set[str]:
    """All locks a method may acquire, including through self-calls."""
    if name in memo:
        return memo[name]
    if name in seen or name not in methods:
        return set()
    seen = seen | {name}
    acquired: Set[str] = set()
    for node in ast.walk(methods[name]):
        if isinstance(node, ast.With):
            acquired.update(lk for lk in _with_locks(node) if lk in locks)
        if isinstance(node, ast.Call):
            callee = _self_attr(node.func)
            if callee is not None:
                acquired |= _method_locks(callee, methods, locks, memo, seen)
    memo[name] = acquired
    return acquired


def _find_cycle(edges: Dict[str, Set[str]]) -> Optional[List[str]]:
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in edges}
    path: List[str] = []

    def visit(n: str) -> Optional[List[str]]:
        color[n] = GRAY
        path.append(n)
        for m in sorted(edges.get(n, ())):
            if color.get(m, WHITE) == GRAY:
                return path[path.index(m) :] + [m]
            if color.get(m, WHITE) == WHITE:
                cyc = visit(m)
                if cyc is not None:
                    return cyc
        path.pop()
        color[n] = BLACK
        return None

    for n in sorted(edges):
        if color[n] == WHITE:
            cyc = visit(n)
            if cyc is not None:
                return cyc
    return None


def _check_lock_order(module: Module, run: LintRun) -> Iterable[Tuple[int, str]]:
    for cls in ast.walk(module.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        locks = _class_lock_attrs(cls)
        if len(locks) < 2:
            continue
        methods = {
            n.name: n for n in cls.body if isinstance(n, ast.FunctionDef)
        }
        memo: Dict[str, Set[str]] = {}
        edges: Dict[str, Set[str]] = {lk: set() for lk in locks}
        for m in methods.values():
            for node, parents in walk_with_parents(m):
                held = [
                    lk
                    for p in parents
                    if isinstance(p, ast.With)
                    for lk in _with_locks(p)
                    if lk in locks
                ]
                if not held:
                    continue
                inner: Set[str] = set()
                if isinstance(node, ast.With):
                    inner.update(lk for lk in _with_locks(node) if lk in locks)
                if isinstance(node, ast.Call):
                    callee = _self_attr(node.func)
                    if callee is not None:
                        inner |= _method_locks(callee, methods, locks, memo, set())
                for outer in held:
                    edges[outer].update(lk for lk in inner if lk != outer)
        cycle = _find_cycle(edges)
        if cycle is not None:
            yield (
                cls.lineno,
                f"lock acquisition order has a cycle in class "
                f"`{cls.name}`: {' -> '.join(cycle)} — two threads "
                f"taking these locks in opposite nesting deadlock",
            )


RULES = [
    Rule(
        "RPL002",
        "worker loops must not swallow ThreadKill",
        "DESIGN.md §11",
        _check_loop_excepts,
    ),
    Rule(
        "RPL004",
        "serving counters mutate only under their lock",
        "DESIGN.md §10",
        _check_counter_locks,
    ),
    Rule(
        "RPL009",
        "serving uses the monotonic clock",
        "DESIGN.md §11",
        _check_monotonic_clock,
    ),
    Rule(
        "RPL010",
        "lock acquisition order is acyclic",
        "DESIGN.md §10",
        _check_lock_order,
    ),
]
