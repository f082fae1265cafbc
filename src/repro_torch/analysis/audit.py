"""The auditor: dynamic design-rule checking of a compiled artifact.

The port's counterpart of ``repro.analysis.jaxpr_audit``.  The port has
no jaxpr, so it checks ``CompiledBNN.apply`` through what an eager run
shows and re-derives the plan's own claims:

* **launches** — the launches that ``kernels._build.recording()`` sees
  in one eager ``apply`` equal ``launch_count()``, kernel by kernel
  (the plan steps' ``launches``).  On the card only; the CPU's
  wrappers take their plain versions and launch nothing.
* **int32-escape** — under a ``TorchDispatchMode`` that records the
  dtype, shape and device of every tensor ``apply`` creates, no int32
  tensor of a shape from :func:`banned_int32_shapes` (the activations
  an unfused chain would write: NHWC conv planes and their [B, M, N]
  twins, a residual half-step's int32 dot, thresholded dense and
  fused-stack activations) exists on the
  card.  This stands in for walking the jaxpr.  Skipped on the
  ``"torch"`` backend (as the reference skips ``"xla"``) and on the
  CPU, where the plain versions form the int32 dot by design.
* **plan-smem** — every fused step's ``stack_plan`` and every direct
  conv step's ``tile_plan``, re-derived at the audited batch (with the
  tuning table's entry where it has one), still fits the shared memory
  a block may use (``kernels.fused_mlp.SMEM_BYTES``), and its claim in
  the plan (``args["smem_bytes"]``) does too; a fused stack still fits
  one launch and a conv keeps its impl.
* **trace-bound** — the graphs a server captures over ``dispatch_grid``
  (one per level) stay within ``trace_bound(max_batch, ragged=True)``,
  and the prewarm key set within that bound times the launches.
* **donation** — reported as skipped: the port never donates.

``CompiledBNN.audit()`` is the front door and raises
:class:`AuditError` on a failure.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Dict, List, Optional, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.graph.passes import _dense_nodes, fused_key
from repro_torch.kernels import _build, autotune, fused_mlp, packed_conv
from repro_torch.kernels import ops as kops
from repro_torch.kernels import residual as kres
from repro_torch.kernels.packed import WORD, get_backend
from repro_torch.serving.bucketing import dispatch_grid, trace_bound

__all__ = [
    "AuditCheck",
    "AuditError",
    "AuditReport",
    "TensorLog",
    "audit_compiled",
    "banned_int32_shapes",
    "expected_launches",
]


class AuditError(AssertionError):
    """A compiled artifact violated a DESIGN.md contract."""


@dataclasses.dataclass(frozen=True)
class AuditCheck:
    """One audited contract: ``ok`` is the verdict, ``skipped`` marks
    checks the backend or device makes inapplicable (still ok)."""

    name: str
    ok: bool
    detail: str
    skipped: bool = False

    def format(self) -> str:
        mark = "SKIP" if self.skipped else ("ok" if self.ok else "FAIL")
        return f"[{mark:>4s}] {self.name}: {self.detail}"


@dataclasses.dataclass(frozen=True)
class AuditReport:
    """audit_compiled's result: per-check verdicts and what the run
    showed."""

    spec_name: str
    backend: str
    device: str
    batch: int
    checks: Tuple[AuditCheck, ...]
    int32_shapes: "frozenset[tuple]"
    banned_shapes: "frozenset[tuple]"
    launches: Dict[str, int]

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.checks)

    def failures(self) -> List[AuditCheck]:
        return [c for c in self.checks if not c.ok]

    def format(self) -> str:
        head = (f"audit {self.spec_name} (backend {self.backend}, device "
                f"{self.device}, batch {self.batch}): "
                f"{'PASS' if self.ok else 'FAIL'}")
        return "\n".join([head] + [f"  {c.format()}" for c in self.checks])

    def raise_if_failed(self) -> "AuditReport":
        if not self.ok:
            raise AuditError(self.format())
        return self


# ------------------------------------------------------------------ #
# what apply creates                                                   #
# ------------------------------------------------------------------ #
class TensorLog(TorchDispatchMode):
    """Records (dtype, shape, device type) of every tensor an aten op
    returns inside the block — every tensor ``apply`` creates, kernel
    outputs included (the wrappers allocate them with ``torch.empty``)."""

    def __init__(self):
        super().__init__()
        self.seen: Set[Tuple[torch.dtype, tuple, str]] = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.seen.add((t.dtype, tuple(t.shape), t.device.type))
        return out


# ------------------------------------------------------------------ #
# deriving what must (not) happen from the plan itself                 #
# ------------------------------------------------------------------ #
def banned_int32_shapes(compiled: Any, batch: int) -> Set[tuple]:
    """The int32 activation shapes an *unfused* chain would write to
    device memory under this plan at ``batch`` rows: NHWC conv planes
    and their batch-major [B, M, N] twins (a residual half-step's int32
    dot among them), and every thresholded dense and fused-stack
    activation.  None may exist on the card.  As in the
    reference, the flattened 2-D [B*M, N] forms and the classifier
    head's int32 dot are not banned."""
    dense = _dense_nodes(compiled.spec)
    conv_nodes = compiled.spec.conv_nodes
    banned: Set[tuple] = set()
    for step in compiled.plan:
        if step.kind == "binary_conv":
            nd = conv_nodes[step.args["conv_idx"]]
            banned.add((batch, nd.h_out, nd.w_out, nd.c_out))
            banned.add((batch, nd.h_out * nd.w_out, nd.c_out))
        elif step.kind == "residual_conv":
            nd = compiled.spec.residual_nodes[step.args["res_idx"]]
            banned.add((batch, nd.h_out, nd.w_out, nd.c_out))
            banned.add((batch, nd.h_out * nd.w_out, nd.c_out))
        elif step.kind == "dense" and step.args["pack_out"]:
            banned.add((batch, dense[step.args["fc_idx"]].n_out))
        elif step.kind == "fused_stack":
            for j in step.args["fc_indices"]:
                banned.add((batch, dense[j].n_out))
    return banned


def expected_launches(compiled: Any, batch: int) -> Dict[str, int]:
    """Kernel name -> launches one ``apply`` of ``batch`` rows makes on
    the card under this plan: its steps' ``launches``, where a fused
    stack that no longer fits one launch at ``batch`` chains one
    popcount_gemm a layer."""
    dense = _dense_nodes(compiled.spec)
    want: Counter = Counter()
    for step in compiled.plan:
        if step.kind == "fused_stack":
            nds = [dense[j] for j in step.args["fc_indices"]]
            if not fused_mlp.stack_plan(batch, nds[0].n_in,
                                        [nd.n_out for nd in nds])["fits"]:
                want["popcount_gemm"] += len(nds)
                continue
        want.update(step.launches)
    return dict(want)


def _sample_inputs(compiled: Any, batch: int) -> Tuple[Dict[str, Any], Any]:
    """Deterministic (params, x) at ``batch`` rows on the compiled's
    device: integer NHWC images in [-3, 3] for image specs (exact in any
    summation order), a packed [batch, K0] input for dense-entry specs."""
    params = compiled.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    shape = compiled.spec.input_shape
    if len(shape) == 3:
        x: Any = torch.randint(-3, 4, (batch, *shape), generator=gen
                               ).to(torch.float32).to(compiled.device)
    else:
        x = kops.binarize_pack(
            torch.randn(batch, shape[0], generator=gen).to(compiled.device),
            backend=compiled.backend)
    return params, x


# ------------------------------------------------------------------ #
# the checks                                                           #
# ------------------------------------------------------------------ #
def _on_card(compiled: Any) -> bool:
    return compiled.device.type == "cuda"


def _check_launches(compiled: Any, batch: int,
                    rec: Dict[str, int]) -> AuditCheck:
    be = get_backend(compiled.backend)
    if not be.uses_kernels or not _on_card(compiled):
        why = (f"backend {be.name!r} runs no kernel" if not be.uses_kernels
               else "on the CPU the wrappers take their plain versions and "
                    "launch nothing")
        return AuditCheck("launches", True, f"skipped: {why}", skipped=True)
    want = expected_launches(compiled, batch)
    if rec != want or sum(rec.values()) != compiled.launch_count():
        return AuditCheck(
            "launches", False,
            f"one eager apply launched {rec or 'nothing'}; the plan "
            f"expects {want} ({compiled.launch_count()} launches)")
    return AuditCheck(
        "launches", True,
        f"{sum(rec.values())} launches = launch_count(), kernel by kernel "
        f"{rec}")


def _check_int32_escape(compiled: Any, seen: Set[tuple], batch: int
                        ) -> Tuple[AuditCheck, "frozenset[tuple]",
                                   "frozenset[tuple]"]:
    be = get_backend(compiled.backend)
    if not be.uses_kernels or not _on_card(compiled):
        why = (f"on backend {be.name!r} the plain versions form the int32 "
               f"dot by design" if not be.uses_kernels else
               "on the CPU the wrappers' plain versions form the int32 dot "
               "by design; the contract is the card's memory")
        return (AuditCheck("int32-escape", True, f"skipped: {why}",
                           skipped=True), frozenset(), frozenset())
    banned = frozenset(banned_int32_shapes(compiled, batch))
    shapes = frozenset(shape for dt, shape, dev in seen
                       if dt == WORD and dev == "cuda")
    leaked = sorted(banned & shapes)
    if leaked:
        return (AuditCheck(
            "int32-escape", False,
            f"int32 activation(s) {leaked} exist on the card — a "
            f"threshold->pack epilogue is not fused (DESIGN.md §6)"),
            shapes, banned)
    return (AuditCheck(
        "int32-escape", True,
        f"none of {len(banned)} banned activation shapes among the "
        f"{len(shapes)} int32 shapes apply made on the card"),
        shapes, banned)


def _check_plan_smem(compiled: Any, batch: int) -> AuditCheck:
    limit = fused_mlp.SMEM_BYTES
    device = compiled.device if _on_card(compiled) else None
    dense = _dense_nodes(compiled.spec)
    conv_nodes = compiled.spec.conv_nodes
    problems: List[str] = []
    audited = 0
    for step in compiled.plan:
        claim = step.args.get("smem_bytes")
        if claim is not None and claim > limit:
            problems.append(f"{step.name}: the plan claims {claim} B of "
                            f"shared memory a block, over {limit}")
        if step.kind == "fused_stack":
            nds = [dense[j] for j in step.args["fc_indices"]]
            k0, ns = nds[0].n_in, [nd.n_out for nd in nds]
            sp = fused_mlp.stack_plan(batch, k0, ns)
            e = autotune.resolve(fused_key(batch, k0, ns), device)
            smem = fused_mlp.smem_bytes(e["bm"], sp["buf_words"])
            audited += 1
            if not sp["fits"] or sp["smem_bytes"] > limit or smem > limit:
                problems.append(
                    f"{step.name}: fused stack at batch {batch} needs "
                    f"{max(smem, sp['smem_bytes'])} B a block (BM="
                    f"{e['bm']}), fits one launch: {sp['fits']}, limit "
                    f"{limit}")
        elif step.kind == "binary_conv" and step.args["impl"] == "direct":
            nd = conv_nodes[step.args["conv_idx"]]
            d = kops.plan_conv_launch(
                nd.h_in, nd.w_in, nd.c_in, nd.c_out, nd.kh, nd.kw,
                stride=step.args["stride"], padding=step.args["pad"],
                pack_out=True, impl="auto", nb=batch)
            e = autotune.resolve(d["key"], device)
            smem = packed_conv.smem_bytes(e["bm"], e["bn"],
                                          nd.kh * nd.kw * d["c32"], d["c32"])
            audited += 1
            if d["impl"] != "direct":
                problems.append(f"{step.name}: plan recorded impl='direct' "
                                f"but the rule resolves {d['impl']!r} at "
                                f"batch {batch}")
            elif smem > limit:
                problems.append(f"{step.name}: tile {e['bm']}x{e['bn']} at "
                                f"batch {batch} needs {smem} B a block, "
                                f"over {limit}")
        elif step.kind == "residual_conv":
            nd = compiled.spec.residual_nodes[step.args["res_idx"]]
            c32 = -(-nd.c_in // 32)
            k32 = nd.k * nd.k * c32
            e = kres.residual_tile_plan(batch * nd.h_out * nd.w_out,
                                        nd.c_out, k32, autotune._sms(device))
            smem = packed_conv.smem_bytes(e["bm"], e["bn"], k32, c32)
            audited += 1
            if smem > limit:
                problems.append(f"{step.name}: tile {e['bm']}x{e['bn']} at "
                                f"batch {batch} needs {smem} B a block, "
                                f"over {limit}")
    if problems:
        return AuditCheck("plan-smem", False, "; ".join(problems))
    return AuditCheck(
        "plan-smem", True,
        f"{audited} launch plan(s) re-derived at batch {batch} within "
        f"{limit} B of shared memory a block")


def _check_trace_bound(compiled: Any, max_batch: int) -> AuditCheck:
    grid = dispatch_grid(max_batch)
    bound = trace_bound(max_batch, ragged=True)
    launches = max(1, compiled.launch_count())
    if len(grid) > bound:
        return AuditCheck(
            "trace-bound", False,
            f"a server captures {len(grid)} graphs (one per (bucket, "
            f"valid) level) > trace_bound {bound}")
    keys = compiled.tuning_keys_for_batches(sorted({v for _, v in grid}))
    if len(keys) > bound * launches:
        return AuditCheck(
            "trace-bound", False,
            f"{len(keys)} prewarm keys exceed trace_bound {bound} x "
            f"{launches} launches — a launch plan per request shape "
            f"instead of per level")
    return AuditCheck(
        "trace-bound", True,
        f"{len(grid)} graphs over the dispatch grid, {len(keys)} prewarm "
        f"keys (bound {bound} x {launches} launches) at max_batch "
        f"{max_batch}")


def _check_donation() -> AuditCheck:
    return AuditCheck(
        "donation", True,
        "skipped: the port never donates (GraphedApply copies each request "
        "into its own static input; the params are never written)",
        skipped=True)


def audit_compiled(compiled: Any, params: Optional[Dict[str, Any]] = None,
                   x: Any = None, batch: Optional[int] = None,
                   max_batch: int = 64) -> AuditReport:
    """Run every check against a CompiledBNN.

    ``params``/``x`` default to deterministic samples shaped from the
    spec on the compiled's device; ``batch`` defaults to ``max(2,
    compiled.batch)`` (taken from ``x`` when given); ``max_batch``
    scopes the trace-bound check.  Returns the report —
    ``CompiledBNN.audit()`` raises on a failure."""
    if x is not None:
        batch = int(x.words.shape[0] if hasattr(x, "words") else x.shape[0])
    elif batch is None:
        batch = max(2, compiled.batch)
    if x is None:
        sample_params, x = _sample_inputs(compiled, batch)
        if params is None:
            params = sample_params
    elif params is None:
        params = compiled.init(torch.Generator().manual_seed(0))
    log = TensorLog()
    with _build.recording() as rec, log:
        compiled.apply(params, x)
    if _on_card(compiled):
        torch.cuda.synchronize(compiled.device)
    escape, shapes, banned = _check_int32_escape(compiled, log.seen, batch)
    checks = (
        _check_launches(compiled, batch, dict(rec)),
        escape,
        _check_plan_smem(compiled, batch),
        _check_trace_bound(compiled, max_batch),
        _check_donation(),
    )
    return AuditReport(
        spec_name=compiled.spec.name, backend=compiled.backend,
        device=str(compiled.device), batch=batch, checks=checks,
        int32_shapes=shapes, banned_shapes=banned, launches=dict(rec))
