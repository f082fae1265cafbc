"""The RPL rule catalog of the port (DESIGN.md §13).

Each module contributes a ``RULES`` list; this package concatenates
them into ``ALL_RULES`` sorted by rule id and guarantees ids are
unique.  An ID keeps the reference's meaning where the rule is the
same (``repro.analysis.rules``); the port carries:

* RPL001, RPL003, RPL007 (``packing``): packing and sign literals only
  at their blessed sites; the shared-memory budget single-sourced in
  ``kernels.fused_mlp.SMEM_BYTES`` (the reference's VMEM budget);
* RPL002, RPL004, RPL009, RPL010 (``serving_rules``): ThreadKill never
  swallowed, counters under their lock, the monotonic clock, an acyclic
  lock order;
* RPL005, RPL006 (``layering``): no internal calls of deprecated shims,
  the port's import arrows;
* RPL011 (``layering``), the port's own: no ``jax`` and no ``repro``
  import.

RPL008 (donation only in owning modules) has no counterpart: the port
never donates a buffer (ROADMAP, "Not ported, by decision").
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.analysis.lint import Rule
from repro_torch.analysis.rules import layering, packing, serving_rules

ALL_RULES: List[Rule] = sorted(
    [*packing.RULES, *serving_rules.RULES, *layering.RULES],
    key=lambda r: r.rule_id,
)

_by_id: Dict[str, Rule] = {}
for _rule in ALL_RULES:
    if _rule.rule_id in _by_id:
        raise AssertionError(f"duplicate rule id {_rule.rule_id}")
    _by_id[_rule.rule_id] = _rule

RULES_BY_ID: Dict[str, Rule] = dict(_by_id)

__all__ = ["ALL_RULES", "RULES_BY_ID"]
