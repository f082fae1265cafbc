"""The compile passes: BNNSpec -> executable plan.

The counterpart of ``repro.graph.passes``.  ``build_plan`` runs the
lowering pipeline over a validated spec and returns a tuple of
:class:`PlanStep`:

  (2) threshold folding  — every BNThreshold is fused into its
      producer's threshold->pack epilogue (gamma<0 row negation happens
      at param-bind time through core.bnn_layers.fold_*);
  (3) dense-run segmentation — contiguous thresholded BinaryDense runs
      are greedily packed into fused_mlp launches under the Hopper
      shared-memory rule (kernels.fused_mlp.stack_plan), falling back to
      chained per-layer launches;
  (4) conv impl selection — kernels.ops.plan_conv_launch, shared with
      dispatch.

  (4b) the residual family — a RealConv (and the max pool a Bi-Real
      stem takes, ``args["pool"]``: ``ir.STEM_POOL`` or None) becomes
      one ``stem_conv`` launch and each ResidualBinaryConv a
      ``residual_conv`` step: one launch of
      ``packed_conv``'s fused kernel, the -1 padded dot of the conv's
      mainloop kept in shared memory and the residual epilogue on it,
      which writes the float stream and the packed signs of the next
      half-step's sign (``sign_next``), so no int32 dot reaches device
      memory and no pack runs between half-steps; a projection shortcut
      is one ``shortcut_conv`` launch before it, whose map the fused
      kernel reads as an identity shortcut;

  (5) tuning keys — every planned kernel launch whose plan is looked
      up in the tuning table (``kernels.autotune``) records its key:
      ``plan_dense_launch`` / ``plan_conv_launch`` give the GEMM and
      conv keys, a fused stack keys as ``("fused_binary_mlp", "cuda",
      m, k0, ns)``; the stem, the half-steps and the projection
      shortcuts take their rule alone and record none;

  (6) entry epilogues (:func:`entry_epilogues`, run last, and again by
      ``CompiledBNN.split`` over each half) — an integer conv followed
      by a binarize without a flatten hands its alpha on: to the
      ``entry_conv`` kernel, which packs the signs in its epilogue, on
      a kernel backend where the kernel takes the shape (the binarize
      then launches nothing), else to that binarize's pack; any other
      integer conv (a float pool follows, or the plan ends) keeps its
      alpha multiply.

Every step carries a human-readable ``detail`` string, shown by
``CompiledBNN.describe()``, and ``launches``: the launch counts of
``kernels._build`` its launch adds on a kernel backend at the plan's
batch.  The plan is computed for a ``batch`` row hint; the fused-stack
fit is re-checked at run time with the actual rows, and both outcomes
are bit-identical.  Fused stacks and direct convs record the shared
memory a block of their launch claims (``args["smem_bytes"]``), which
``CompiledBNN.audit`` re-derives.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Sequence, Tuple

from repro_torch.graph.ir import (Binarize, BinaryConv, BinaryDense,
                                  BNNSpec, BNThreshold, GlobalAvgPool,
                                  IntegerEntry, Logits, MaxPool, RealConv,
                                  RealDense, ResidualBinaryConv, STEM_POOL)
from repro_torch.kernels import entry_conv as kentry
from repro_torch.kernels.fused_mlp import stack_plan
from repro_torch.kernels.ops import plan_conv_launch, plan_dense_launch
from repro_torch.kernels.packed import get_backend
from repro_torch.kernels.packed_conv import smem_bytes as conv_smem_bytes
from repro_torch.kernels.residual import (STEM_POOL_COLS,
                                          residual_tile_plan)

__all__ = ["PlanStep", "batches_tuning_keys", "build_plan",
           "entry_epilogues", "fused_key", "plan_tuning_keys"]


@dataclass(frozen=True)
class PlanStep:
    """One executable step + the lowering decision that produced it.

    kind: integer_conv | float_pool | binarize | binary_conv |
          packed_pool | flatten | fused_stack | dense | logits |
          real_conv | residual_conv | global_pool | real_dense
    args: static operands for the executor (param indices, geometry,
          impl choices);  keys: the tuning keys of the step's launch;
    launches: the ``kernels._build`` launch counts the step adds on a
          kernel backend at the plan's batch, one name a launch.
    """
    kind: str
    name: str
    args: dict = field(default_factory=dict)
    detail: str = ""
    keys: Tuple[tuple, ...] = ()
    launches: Tuple[str, ...] = ()

    def __str__(self) -> str:
        return f"{self.kind:<13s} {self.name:<18s} {self.detail}"


def _fmt_kb(b: int) -> str:
    return f"{b / 1024:.1f}KB"


def fused_key(m: int, k0: int, ns) -> tuple:
    """The tuning key of a fused-stack launch of ``m`` rows."""
    return ("fused_binary_mlp", "cuda", m, k0, tuple(ns))


def _segment_dense_run(run, k0: int, batch: int):
    """Pass 3: greedily grow fused segments over a contiguous run of
    thresholded dense layers; each segment must fit one launch under
    the Hopper rule (two shared-memory activation buffers of 16 rows
    beside the weight ring, at most 8 layers)."""
    steps = []
    i = 0
    while i < len(run):
        ns, j = [], i
        sp = None
        while j < len(run):
            cand = ns + [run[j][1].n_out]
            trial = stack_plan(batch, k0, cand)
            if not trial["fits"]:
                break
            ns, sp, j = cand, trial, j + 1
        if j - i <= 1:
            fc_idx, nd, _ = run[i]
            why = ("layer alone exceeds one launch's shared memory"
                   if j == i else "segment of one")
            d = plan_dense_launch(batch, nd.n_out, nd.n_in, pack_out=True)
            steps.append(PlanStep(
                "dense", nd.name,
                {"fc_idx": fc_idx, "thresholded": True, "pack_out": True},
                f"{nd.n_in}->{nd.n_out} popcount_gemm launch ({why}; "
                f"threshold->pack fused)", (d["key"],), ("popcount_gemm",)))
            k0 = nd.n_out
            i += 1
        else:
            idxs = tuple(fc for fc, _, _ in run[i:j])
            names = " -> ".join(str(nd.n_out) for _, nd, _ in run[i:j])
            steps.append(PlanStep(
                "fused_stack", run[i][1].name,
                {"fc_indices": idxs, "smem_bytes": sp["smem_bytes"]},
                f"fused_mlp over {j - i} layers ({k0}->{names}), "
                f"row tiles of BM={sp['bm']} rows, each on a cluster of "
                f"CS={sp['cs']} blocks that split every layer's output "
                f"words and exchange activations through distributed "
                f"shared memory ({_fmt_kb(sp['smem_bytes'])} shared "
                f"memory per block), 1 launch vs {j - i} chained",
                (fused_key(batch, k0, ns),), ("fused_binary_mlp",)))
            k0 = run[j - 1][1].n_out
            i = j
    return steps


def _dense_nodes(spec: BNNSpec):
    """fc-index-ordered BinaryDense nodes (the indices build_plan
    records)."""
    return [nd for nd in spec.nodes if isinstance(nd, BinaryDense)]


def plan_tuning_keys(spec: BNNSpec, plan: Tuple[PlanStep, ...],
                     batch: int, backend: Optional[str] = None
                     ) -> Tuple[tuple, ...]:
    """The tuning keys an existing plan's launches resolve to at a
    *different* batch size: the same plan structure (segment boundaries,
    conv impls), only the row terms rescaled through the same plan_*
    twins dispatch consults.  The serving engine warms the tuning table
    per dispatch level this way while serving ONE compiled plan."""
    dn = _dense_nodes(spec)
    conv_nodes = spec.conv_nodes
    keys = []
    for s in plan:
        if s.kind == "binary_conv":
            nd = conv_nodes[s.args["conv_idx"]]
            d = plan_conv_launch(
                nd.h_in, nd.w_in, nd.c_in, nd.c_out, nd.kh, nd.kw,
                stride=s.args["stride"], padding=s.args["pad"],
                backend=backend, pack_out=True, impl=s.args["impl"],
                nb=batch)
            keys.append(d["key"])
        elif s.kind == "dense":
            nd = dn[s.args["fc_idx"]]
            d = plan_dense_launch(batch, nd.n_out, nd.n_in, backend=backend,
                                  pack_out=s.args["pack_out"])
            keys.append(d["key"])
        elif s.kind == "fused_stack":
            nds = [dn[j] for j in s.args["fc_indices"]]
            keys.append(fused_key(batch, nds[0].n_in,
                                  [nd.n_out for nd in nds]))
    return tuple(keys)


def batches_tuning_keys(spec: BNNSpec, plan: Tuple[PlanStep, ...],
                        batches: Sequence[int],
                        backend: Optional[str] = None
                        ) -> Tuple[tuple, ...]:
    """Deduplicated union of ``plan_tuning_keys`` over many batch sizes,
    in first-seen order: the serving engine's prewarm set over its
    (bucket, valid) dispatch grid, where many levels share a row count
    and so a key."""
    keys, seen = [], set()
    for b in batches:
        for k in plan_tuning_keys(spec, plan, b, backend=backend):
            if k not in seen:
                seen.add(k)
                keys.append(k)
    return tuple(keys)


def build_plan(spec: BNNSpec, backend: Optional[str] = None,
               batch: int = 1,
               conv_impl: str = "auto") -> Tuple[PlanStep, ...]:
    """Run passes 2-6 over a validated spec (see module docstring)."""
    if conv_impl not in ("auto", "direct", "im2col"):
        raise ValueError(f"conv_impl must be 'auto', 'direct', or "
                         f"'im2col', got {conv_impl!r}")
    steps = []
    conv_i = fc_i = stem_i = res_i = head_i = 0
    domain = "float" if len(spec.input_shape) == 3 else "packed_flat"
    h, w = (spec.input_shape[:2] if domain == "float" else (0, 0))
    nodes = spec.nodes
    i = 0
    while i < len(nodes):
        nd = nodes[i]
        if isinstance(nd, IntegerEntry):      # detail, launches: pass 6
            steps.append(PlanStep(
                "integer_conv", nd.name,
                {"conv_idx": conv_i, "stride": nd.stride, "pad": nd.pad}))
            conv_i += 1
            h, w = nd.h_out, nd.w_out
        elif isinstance(nd, Binarize):          # detail, launches: pass 6
            steps.append(PlanStep("binarize", nd.name,
                                  {"flatten": nd.flatten}))
            domain = "packed_flat" if nd.flatten else "packed_conv"
        elif isinstance(nd, BinaryConv):
            d = plan_conv_launch(
                h, w, nd.c_in, nd.c_out, nd.kh, nd.kw, stride=nd.stride,
                padding=nd.pad, backend=backend, pack_out=True,
                impl=conv_impl, nb=batch)
            thr = nodes[i + 1]         # BNThreshold, by validation
            tiles = d.get("tiles")
            why = "forced" if conv_impl != "auto" else (
                f"b1 tensor-core implicit GEMM, tile {tiles['bm']}x"
                f"{tiles['bn']}")
            args = {"conv_idx": conv_i, "stride": nd.stride, "pad": nd.pad,
                    "impl": d["impl"]}
            if tiles is not None:
                args["smem_bytes"] = conv_smem_bytes(
                    tiles["bm"], tiles["bn"], nd.kh * nd.kw * d["c32"],
                    d["c32"])
            steps.append(PlanStep(
                "binary_conv", nd.name, args,
                f"packed conv {nd.c_in}->{nd.c_out} k{nd.kh} "
                f"s{nd.stride} p{nd.pad}, impl={d['impl']} ({why}); "
                f"{thr.name} folded into the threshold->pack epilogue",
                (d["key"],), ("packed_conv2d" if d["impl"] == "direct"
                              else "popcount_gemm",)))
            conv_i += 1
            h, w = nd.h_out, nd.w_out
            i += 1                     # consume the fused BNThreshold
        elif isinstance(nd, MaxPool):
            if domain == "packed_conv":
                steps.append(PlanStep(
                    "packed_pool", nd.name,
                    {"window": nd.window, "stride": nd.stride},
                    f"max {nd.window}x{nd.window}/s{nd.stride} as "
                    f"bitwise OR on packed words (sign is monotonic)"))
            else:
                steps.append(PlanStep(
                    "float_pool", nd.name,
                    {"window": nd.window, "stride": nd.stride},
                    f"float max-pool {nd.window}x{nd.window}"
                    f"/s{nd.stride}"))
            h = (h - nd.window) // nd.stride + 1
            w = (w - nd.window) // nd.stride + 1
        elif isinstance(nd, BinaryDense):
            if domain == "packed_conv":
                steps.append(PlanStep(
                    "flatten", f"flatten@{nd.name}", {"n_in": nd.n_in},
                    f"word-level reshape [N,H,W,C/32] -> [N, "
                    f"{nd.n_in}/32] (no unpacking; C%32==0 required)"))
                domain = "packed_flat"
            # gather the maximal contiguous thresholded dense run
            run, k0 = [], nd.n_in
            while i < len(nodes) and isinstance(nodes[i], BinaryDense) \
                    and i + 1 < len(nodes) \
                    and isinstance(nodes[i + 1], BNThreshold):
                run.append((fc_i, nodes[i], nodes[i + 1]))
                fc_i += 1
                i += 2                 # skip the fused BNThreshold
            if run:
                steps.extend(_segment_dense_run(run, k0, batch))
            if i < len(nodes) and isinstance(nodes[i], BinaryDense):
                tail = nodes[i]        # un-thresholded (Logits) tail
                d = plan_dense_launch(batch, tail.n_out, tail.n_in,
                                      backend=backend, pack_out=False)
                steps.append(PlanStep(
                    "dense", tail.name,
                    {"fc_idx": fc_i, "thresholded": False,
                     "pack_out": False},
                    f"{tail.n_in}->{tail.n_out} popcount_gemm int32 dot "
                    f"(no threshold: classifier head)", (d["key"],),
                    ("popcount_gemm",)))
                fc_i += 1
                i += 1
            continue                   # i already advanced past the run
        elif isinstance(nd, BNThreshold):
            raise AssertionError(f"{nd.name}: BNThreshold not consumed "
                                 f"by its producer (validate() should "
                                 f"have caught this)")
        elif isinstance(nd, RealConv):
            sign_next = i + 1 < len(nodes) and \
                isinstance(nodes[i + 1], ResidualBinaryConv)
            pool = STEM_POOL if nd.pool else None
            if pool and get_backend(backend).uses_kernels and \
                    nd.conv_hw()[1] > STEM_POOL_COLS:
                raise ValueError(f"{nd.name}: the pooled stem kernel takes "
                                 f"conv rows of at most {STEM_POOL_COLS} "
                                 f"columns, got {nd.conv_hw()[1]}")
            steps.append(PlanStep(
                "real_conv", nd.name,
                {"stem_idx": stem_i, "stride": nd.stride, "pad": nd.pad,
                 "pool": pool, "sign_next": sign_next},
                f"float32 conv {nd.c_in}->{nd.c_out} k{nd.kh} s{nd.stride} "
                f"p{nd.pad} (zero pad, taps summed in a fixed order) + BN"
                + (" + max pool {0}x{0}/s{1} p{2} (-inf pad)".format(*pool)
                   if pool else "")
                + " on the stem_conv kernel"
                + ("; writes the next half-step's packed signs" if sign_next
                   else ""), launches=("stem_conv",)))
            stem_i += 1
            h, w = nd.h_out, nd.w_out
        elif isinstance(nd, ResidualBinaryConv):
            c32 = -(-nd.c_in // 32)
            k32 = nd.k * nd.k * c32
            tiles = residual_tile_plan(batch * nd.h_out * nd.w_out,
                                       nd.c_out, k32)
            sign_next = i + 1 < len(nodes) and \
                isinstance(nodes[i + 1], ResidualBinaryConv)
            proj = nd.shortcut == "projection"
            sc = ("projection shortcut (2x2 average, float 1x1 conv, BN) on "
                  "the shortcut_conv kernel, then read as identity"
                  if proj else f"{nd.shortcut} shortcut")
            steps.append(PlanStep(
                "residual_conv", nd.name,
                {"res_idx": res_i, "k": nd.k, "stride": nd.stride,
                 "pad": nd.pad, "shortcut": nd.shortcut,
                 "sign_next": sign_next,
                 "smem_bytes": conv_smem_bytes(tiles["bm"], tiles["bn"],
                                               k32, c32)},
                f"packed conv {nd.c_in}->{nd.c_out} k{nd.k} s{nd.stride} "
                f"p{nd.pad} (b1 tensor-core implicit GEMM, tile "
                f"{tiles['bm']}x{tiles['bn']}) with the residual epilogue "
                f"on its tile, one residual_conv launch: "
                f"{'zero-pad correction, ' if nd.pad else ''}BN, {sc}"
                + (", RPReLU" if nd.rprelu else ", no activation")
                + (", the next half-step's packed signs" if sign_next
                   else ""),
                launches=("shortcut_conv", "residual_conv") if proj
                else ("residual_conv",)))
            res_i += 1
            h, w = nd.h_out, nd.w_out
        elif isinstance(nd, GlobalAvgPool):
            steps.append(PlanStep(
                "global_pool", nd.name, {},
                "float32 mean over the spatial axes"))
        elif isinstance(nd, RealDense):
            steps.append(PlanStep(
                "real_dense", nd.name, {"head_idx": head_i},
                f"float32 dense {nd.n_in}->{nd.n_out} + bias (cuBLAS, TF32 "
                f"off)"))
            head_i += 1
        elif isinstance(nd, Logits):
            steps.append(PlanStep(
                "logits", nd.name, {},
                f"int32 dot -> float32 logits [{nd.classes}]"
                if isinstance(nodes[i - 1], BinaryDense) else
                f"float32 logits [{nd.classes}]"))
        i += 1
    return entry_epilogues(spec, steps, backend)


# pass 6: an integer conv's epilogue -> how its detail ends
_ENTRY_NOTES = {
    "entry_conv": "on the entry_conv kernel: alpha*sign(w), signs packed "
                  "in its epilogue (the binarize passes them on)",
    "alpha_to_pack": "sign(w) on F.conv2d (cuDNN on the card), alpha left "
                     "to the pack",
    "alpha": "alpha*sign(w) on F.conv2d (cuDNN on the card)",
}


def entry_epilogues(spec: BNNSpec, steps: Sequence[PlanStep],
                    backend: Optional[str] = None) -> Tuple[PlanStep, ...]:
    """Pass 6 over ``steps`` as they stand (a whole plan, or a part of
    one): each integer_conv step's ``args["epilogue"]``, from the step
    after it (see module docstring), and each binarize step's
    ``args["packed"]`` (the entry_conv kernel before it packed the
    signs) and ``args["scale_conv"]`` (the index of the conv whose
    alpha its pack takes, or None), from the step before it; both
    kinds' detail and launches follow.  Other steps are kept."""
    uses_kernels = get_backend(backend).uses_kernels
    out = []
    for i, s in enumerate(steps):
        if s.kind == "integer_conv":
            nd = spec.conv_nodes[s.args["conv_idx"]]
            nxt = steps[i + 1] if i + 1 < len(steps) else None
            to_pack = nxt is not None and nxt.kind == "binarize" \
                and not nxt.args["flatten"]
            if to_pack and uses_kernels and kentry.supports(
                    (1, nd.h_in, nd.w_in, nd.c_in),
                    (nd.kh, nd.kw, nd.c_in, nd.c_out), nd.stride, nd.pad):
                ep = "entry_conv"
            else:
                ep = "alpha_to_pack" if to_pack else "alpha"
            s = replace(s, args={**s.args, "epilogue": ep},
                        detail=f"float NHWC conv {nd.c_in}->{nd.c_out} "
                               f"k{nd.kh} s{nd.stride} p{nd.pad} (full "
                               f"float32, real zero padding), "
                               + _ENTRY_NOTES[ep],
                        launches=("entry_conv",) if ep == "entry_conv"
                        else ())
        elif s.kind == "binarize":
            prev = out[-1] if out and out[-1].kind == "integer_conv" \
                else None
            ep = prev.args["epilogue"] if prev else "alpha"
            scale = prev.args["conv_idx"] if ep == "alpha_to_pack" else None
            if ep == "entry_conv":
                detail = f"nothing to launch: {prev.name} packed the signs"
            elif s.args["flatten"]:
                detail = "flatten + sign+pack to 1 bit/value"
            else:
                detail = "sign+pack NHWC channels to 1 bit/value" + (
                    f", {prev.name}'s alpha taken in" if scale is not None
                    else "")
            s = replace(s, args={**s.args, "packed": ep == "entry_conv",
                                 "scale_conv": scale}, detail=detail,
                        launches=() if ep == "entry_conv" else ("pack",))
        out.append(s)
    return tuple(out)
