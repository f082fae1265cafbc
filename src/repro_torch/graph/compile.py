"""compile(spec) -> CompiledBNN: the packed executable on the card.

The counterpart of ``repro.graph.compile``: a declarative
:class:`~repro_torch.graph.ir.BNNSpec` goes in, and the
:class:`CompiledBNN` that comes out runs it (``init`` / ``apply``) on
the hand-written Hopper kernels, with ``describe`` / ``launch_count``
/ ``traffic`` for inspection.  ``apply`` is bit-identical to the
reference's on the same params (``repro_torch.convert`` carries them
across).

``tulip_mapping`` / ``table3_rows`` bridge the spec into the TULIP-PE
mapping model (``core/mapping.py``), as the reference's do.

The entry point runs on the card unless the caller asks for the CPU:
``compile(..., device=None)`` means ``"cuda"`` and raises on a host
without one.  With ``device="cpu"`` every kernel wrapper takes its
plain torch version.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.bnn_layers import (FoldedThreshold, binary_conv,
                                         binary_weight_conv,
                                         fold_to_channel_thresholds,
                                         maxpool_packed, sign_weight_conv)
from repro_torch.core.mapping import (TULIP, YODANN, ArchParams, map_conv,
                                     map_fc, table3_rows)
from repro_torch.core.schedules import compare_fragment, maxpool_fragment
from repro_torch.core.workloads import Workload
from repro_torch.graph.ir import (BinaryConv, BinaryDense, BNNSpec,
                                  IntegerEntry, MaxPool, from_dense_stack,
                                  from_workload, spec_to_workload)
from repro_torch.graph.passes import PlanStep, build_plan
from repro_torch.kernels import ops as kops
from repro_torch.kernels.fused_mlp import fused_binary_mlp
from repro_torch.kernels.packed import (WORD, PackedArray, get_backend,
                                        resolve_device)

__all__ = ["CompiledBNN", "compile", "compile_dense_stack",
           "serve_folded_stack"]


def _maxpool_float(x: torch.Tensor, window: int, stride: int
                   ) -> torch.Tensor:
    """VALID max-pool of float NHWC activations."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


def _bind_dense(p: Dict[str, Any]) -> Tuple[PackedArray, Any]:
    """Pass 2 at param-bind time: a FoldedThreshold param is rewritten
    to the fused per-channel form (gamma<0 flips absorbed into the
    weight words, T' = 1 - T)."""
    wp, t = p["wp"], p.get("t")
    if isinstance(t, FoldedThreshold):
        wp, t = fold_to_channel_thresholds(wp, t)
    return wp, t


class CompiledBNN:
    """The executable artifact ``compile`` returns.

    ``plan`` is the tuple of :class:`~repro_torch.graph.passes.PlanStep`
    (every lowering decision, human-readable via ``describe()``)."""

    def __init__(self, spec: BNNSpec, plan: Tuple[PlanStep, ...],
                 backend: str, device: torch.device, batch: int):
        self.spec = spec
        self.plan = plan
        self.backend = backend
        self.device = device
        self.batch = batch

    def describe(self) -> str:
        head = (f"compiled {self.spec.name} "
                f"(input {self.spec.input_shape}, backend {self.backend}, "
                f"device {self.device}, batch hint {self.batch}): "
                f"{len(self.plan)} steps, "
                f"{self.launch_count()} kernel launches "
                f"(layer by layer: {self.legacy_launch_count()})")
        return "\n".join([head] + [f"  {s}" for s in self.plan])

    def launch_count(self) -> int:
        """Kernel launches per forward pass under this plan (the float
        entry conv, pools and reshapes are no kernels of the port)."""
        return sum(s.kind in ("binarize", "binary_conv", "dense",
                              "fused_stack") for s in self.plan)

    def legacy_launch_count(self) -> int:
        """Launches of a layer-by-layer chain: every fused_stack
        segment unrolls to one launch per layer."""
        return sum(len(s.args["fc_indices"]) if s.kind == "fused_stack"
                   else s.kind in ("binarize", "binary_conv", "dense")
                   for s in self.plan)

    def split(self, step: str) -> Tuple["CompiledBNN", "CompiledBNN"]:
        """Cut the plan before the named step: the head runs the steps
        before it, the tail the rest, so ``tail.apply(params,
        head.apply(params, x))`` is ``apply(params, x)``.  Cutting at
        the first binarize step separates the float entry layers, whose
        sums depend on the order, from the exact binary tail."""
        names = [s.name for s in self.plan]
        if step not in names:
            raise ValueError(f"no plan step {step!r}; steps: {names}")
        i = names.index(step)
        return tuple(CompiledBNN(self.spec, plan, self.backend, self.device,
                                 self.batch)
                     for plan in (self.plan[:i], self.plan[i:]))

    def with_backend(self, backend: Optional[str]) -> "CompiledBNN":
        """Recompile this spec for another backend: the same device and
        batch hint, the plan derived again under that backend's rules.
        Every backend is bit-identical on the same inputs, which makes
        this a CPU server's fallback (on the card the server reruns the
        same kernels eagerly instead)."""
        if get_backend(backend).name == self.backend:
            return self
        return compile(self.spec, backend=backend, device=self.device,
                       batch=self.batch)

    # -------------------------------------------------------------- #
    def init(self, generator: torch.Generator, threshold_range: int = 3,
             dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
        """Random packed serving parameters for the spec, on
        ``self.device``, drawn from ``generator`` — the same tree and
        shapes as the reference's ``CompiledBNN.init``: integer entries
        keep float latent weights + alpha; binary convs hold
        channel-packed filters [KH, KW, C, F] (axis 2) + per-channel
        int32 thresholds standing in for folded BN; dense layers hold
        [N, K] PackedArrays, thresholded ones a ``t`` vector.  The
        numbers differ from the reference's (another generator); the
        tests carry the reference's params across instead."""
        gdev = generator.device

        def normal(*shape):
            return torch.randn(shape, generator=generator, dtype=dtype,
                               device=gdev).to(self.device)

        def thresholds(n):
            return torch.randint(-threshold_range, threshold_range + 1,
                                 (n,), generator=generator, dtype=WORD,
                                 device=gdev).to(self.device)

        params: Dict[str, Any] = {"conv": [], "fc": []}
        for nd in self.spec.conv_nodes:
            w = normal(nd.kh, nd.kw, nd.c_in, nd.c_out)
            if isinstance(nd, IntegerEntry):
                alpha = torch.mean(torch.abs(w.to(torch.float32)),
                                   dim=(0, 1, 2))
                params["conv"].append({"w": w, "alpha": alpha})
            else:
                params["conv"].append({"wf": PackedArray.pack(w, axis=2),
                                       "t": thresholds(nd.c_out)})
        for nd in self.spec.dense_nodes:
            w = normal(nd.n_out, nd.n_in)
            p = {"wp": PackedArray.pack(w, axis=-1)}
            if self.spec.thresholded(nd):
                p["t"] = thresholds(nd.n_out)
            params["fc"].append(p)
        return params

    def _alpha_in_pack(self, i: int) -> bool:
        """Whether the integer conv at plan step ``i`` leaves its alpha
        multiply to the pack of the next step: only where that step is
        a binarize without a flatten (the scale is per channel, the
        packed axis), so ``x * alpha > 0`` is the same float32 product
        the separate pass would have formed, and one pass over the
        activation is saved.  A float pool after the conv (AlexNet), or
        no next step (a head cut off by ``split``), keeps the multiply."""
        nxt = self.plan[i + 1] if i + 1 < len(self.plan) else None
        return nxt is not None and nxt.kind == "binarize" \
            and not nxt.args["flatten"]

    # -------------------------------------------------------------- #
    def apply(self, params: Dict[str, Any], x: Any,
              valid_rows: Optional[int] = None) -> Any:
        """Execute the plan.  ``x``: float NHWC for image specs, a
        PackedArray [..., K0] for dense-entry specs, on ``self.device``.
        Inter-layer activations stay 1-bit: on "cuda" every binary step
        packs in its kernel's epilogue.

        ``valid_rows`` keeps only the first rows of the batch (the
        ragged last bucket of bucketed serving); bit-identical to
        ``apply(params, x)[:valid_rows]``."""
        be = self.backend
        h: Any = x if valid_rows is None else kops.mask_rows(x, valid_rows)
        scale = None         # an entry conv's alpha, left to the pack
        for i, step in enumerate(self.plan):
            a = step.args
            if step.kind == "integer_conv":
                p = params["conv"][a["conv_idx"]]
                if self._alpha_in_pack(i):
                    h = sign_weight_conv(h, p["w"], stride=a["stride"],
                                         padding=a["pad"])
                    scale = p["alpha"]
                else:
                    h = binary_weight_conv(h, p["w"], stride=a["stride"],
                                           padding=a["pad"],
                                           alpha=p["alpha"])
            elif step.kind == "float_pool":
                h = _maxpool_float(h, a["window"], a["stride"])
            elif step.kind == "binarize":
                if a["flatten"]:
                    h = h.reshape(h.shape[0], -1)
                h = kops.binarize_pack(h, backend=be, scale=scale)
                scale = None
            elif step.kind == "binary_conv":
                p = params["conv"][a["conv_idx"]]
                h = binary_conv(h, p["wf"], fold=p["t"],
                                stride=a["stride"], padding=a["pad"],
                                pack_out=True, backend=be, impl=a["impl"])
            elif step.kind == "packed_pool":
                h = maxpool_packed(h, a["window"], a["stride"])
            elif step.kind == "flatten":
                if h.length % 32:
                    raise ValueError(
                        f"flattening needs C % 32 == 0 to keep the "
                        f"word layout contiguous, got C={h.length}")
                nb = h.words.shape[0]
                spatial = h.words.shape[1] * h.words.shape[2]
                h = PackedArray(h.words.reshape(nb, -1),
                                length=spatial * h.length, axis=-1)
                if h.length != a["n_in"]:
                    raise ValueError(f"flattened width {h.length} != "
                                     f"{step.name} n_in={a['n_in']}")
            elif step.kind == "fused_stack":
                ws, ts = [], []
                for j in a["fc_indices"]:
                    wp, t = _bind_dense(params["fc"][j])
                    ws.append(wp)
                    ts.append(t)
                h = fused_binary_mlp(h, ws, ts, backend=be)
            elif step.kind == "dense":
                wp, t = _bind_dense(params["fc"][a["fc_idx"]])
                h = kops.binary_binary_dense(
                    h, wp, threshold=t if a["thresholded"] else None,
                    pack_out=a["pack_out"], backend=be)
            elif step.kind == "logits":
                h = h.to(torch.float32)
            else:                      # pragma: no cover
                raise AssertionError(f"unknown plan step {step.kind}")
        return h

    # -------------------------------------------------------------- #
    def traffic(self, batch: int = 1) -> Dict[str, Any]:
        """Static device-memory byte model of one forward pass:
        activation and weight bytes moved by the packed datapath vs a
        bf16 NHWC baseline, per layer and total."""
        layers = []
        for nd in self.spec.conv_nodes:
            n_in = batch * nd.h_in * nd.w_in * nd.c_in
            n_w = nd.kh * nd.kw * nd.c_in * nd.c_out
            if isinstance(nd, IntegerEntry):
                a_p, a_b = 2 * n_in, 2 * n_in
                w_p, w_b = n_w // 8 or n_w, 2 * n_w
            else:
                a_p, a_b = n_in // 8, 2 * n_in
                w_p, w_b = n_w // 8, 2 * n_w
            layers.append({"name": nd.name, "packed_bytes": a_p + w_p,
                           "bf16_bytes": a_b + w_b})
        for nd in self.spec.dense_nodes:
            n_in, n_w = batch * nd.n_in, nd.n_in * nd.n_out
            layers.append({"name": nd.name,
                           "packed_bytes": n_in // 8 + n_w // 8,
                           "bf16_bytes": 2 * n_in + 2 * n_w})
        packed = sum(d["packed_bytes"] for d in layers)
        bf16 = sum(d["bf16_bytes"] for d in layers)
        return {"layers": layers, "packed_bytes": packed,
                "bf16_bytes": bf16,
                "ratio_bf16_over_packed": bf16 / packed}

    # -------------------------------------------------------------- #
    def tulip_mapping(self, arch: ArchParams = TULIP) -> List[dict]:
        """Bridge the spec into the TULIP-PE schedule model: one row
        per mapped layer with the core/mapping.py LayerMapping (P, Z,
        refetch product) plus representative core/schedules.py
        fragment cycle counts (the bit-serial threshold compare for
        binary nodes, the OR-reduce for pools)."""
        wl = spec_to_workload(self.spec)
        rows: List[dict] = []
        conv_i = fc_i = 0
        for nd in self.spec.nodes:
            if isinstance(nd, (IntegerEntry, BinaryConv)):
                m = map_conv(wl.conv[conv_i], arch)
                conv_i += 1
                rows.append({"node": nd.name, "kind": "conv",
                             "mapping": m,
                             "cmp_cycles": _cmp_cycles(m.node_inputs)
                             if m.uses_pe else None})
            elif isinstance(nd, BinaryDense):
                m = map_fc(wl.fc[fc_i], arch)
                fc_i += 1
                rows.append({"node": nd.name, "kind": "dense",
                             "mapping": m,
                             "cmp_cycles": _cmp_cycles(m.node_inputs)
                             if m.uses_pe else None})
            elif isinstance(nd, MaxPool):
                frag = maxpool_fragment(
                    0, list(range(nd.window * nd.window)))
                rows.append({"node": nd.name, "kind": "pool",
                             "mapping": None,
                             "pool_cycles": frag.n_cycles()})
        return rows

    def table3_rows(self, arch_a: ArchParams = YODANN,
                    arch_b: ArchParams = TULIP) -> List[dict]:
        """The paper's Table III straight from the spec — identical to
        core.mapping.table3_rows on the source Workload."""
        return table3_rows(spec_to_workload(self.spec), arch_a, arch_b)


def _cmp_cycles(node_inputs: int) -> int:
    """Cycles of the bit-serial comparator that applies the folded-BN
    threshold to a ``node_inputs``-wide popcount sum (paper Fig 5(a)):
    one cycle per accumulator bit + the carry reset."""
    bits = min(16, node_inputs.bit_length() + 1)
    return compare_fragment(0, 1, list(range(bits)),
                            const=0).n_cycles()


# ------------------------------------------------------------------ #
# the front door                                                       #
# ------------------------------------------------------------------ #
def compile(spec: Union[BNNSpec, Workload], backend: Optional[str] = None,
            device: Union[str, torch.device, None] = None, batch: int = 1,
            conv_impl: str = "auto") -> CompiledBNN:
    """Compile a BNNSpec (or a paper Workload, lowered first) into a
    CompiledBNN.

    backend: "cuda" (default: the hand-written kernels) | "torch" (the
    plain oracles); device: where ``init`` puts params — None means the
    card, and a host without one raises; batch: the row hint the plan
    is computed for; conv_impl: force "direct"/"im2col"."""
    dev = resolve_device(device)
    be = get_backend(backend).name
    if isinstance(spec, Workload):
        spec = from_workload(spec)
    spec.validate()
    plan = build_plan(spec, backend=be, batch=batch, conv_impl=conv_impl)
    return CompiledBNN(spec, plan, be, dev, batch)


def compile_dense_stack(k0: int, ns: Sequence[int],
                        thresholded: Optional[Sequence[bool]] = None,
                        name: str = "mlp", backend: Optional[str] = None,
                        device: Union[str, torch.device, None] = None,
                        batch: int = 1,
                        per_channel: Optional[Sequence[bool]] = None
                        ) -> CompiledBNN:
    """compile() for a fully-binary MLP stack spec."""
    return compile(from_dense_stack(k0, ns, thresholded, name=name,
                                    per_channel=per_channel),
                   backend=backend, device=device, batch=batch)


def serve_folded_stack(xp: PackedArray,
                       layers: Sequence[Tuple[PackedArray, Any]],
                       backend: Optional[str] = None) -> PackedArray:
    """Serve (wp [N, K] PackedArray, FoldedThreshold) layer pairs —
    ``quantize_for_serving``'s output — through the compiled pipeline on
    xp's device: the folds are rewritten to per-channel thresholds at
    param-bind time and the stack runs under the plan's fused-stack
    segmentation.  The engine behind the deprecated
    ``core.bnn_layers.bnn_mlp_serve_folded`` shim."""
    if not isinstance(xp, PackedArray):
        raise ValueError("serve_folded_stack takes a PackedArray input")
    ws = [wp.move_pack_axis_last() for wp, _ in layers]
    rows = 1
    for d in xp.move_pack_axis_last().words.shape[:-1]:
        rows *= int(d)
    cb = compile_dense_stack(ws[0].length, [w.words.shape[0] for w in ws],
                             backend=backend, device=xp.words.device,
                             batch=rows)
    params = {"fc": [{"wp": w, "t": fold}
                     for w, (_, fold) in zip(ws, layers)]}
    return cb.apply(params, xp)
