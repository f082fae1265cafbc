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

The residual family (ReActNet, Bi-Real Net: ``RealConv``,
``ResidualBinaryConv``, ``GlobalAvgPool``, ``RealDense``) has params in
its published form (float latent weights, batch-norm statistics, RSign
and RPReLU biases, PReLU slopes, projection shortcuts' float 1x1
weights), which :meth:`CompiledBNN.bind` turns once into what the
kernels read: packed signs, the zero-padding correction and the
per-channel tables of ``kernels.residual``.  ``init`` draws and binds.

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
                                  IntegerEntry, MaxPool, ResidualBinaryConv,
                                  from_dense_stack, from_workload,
                                  spec_to_workload)
from repro_torch.graph.passes import (PlanStep, batches_tuning_keys,
                                      build_plan, entry_epilogues,
                                      plan_tuning_keys)
from repro_torch.kernels import entry_conv as kentry
from repro_torch.kernels import ops as kops
from repro_torch.kernels import residual as kres
from repro_torch.kernels.fused_mlp import fused_binary_mlp
from repro_torch.kernels.packed import (WORD, PackedArray, get_backend,
                                        resolve_device)
from repro_torch.kernels.ref import full_fp32

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
    (every lowering decision, human-readable via ``describe()``);
    ``tuning_keys`` are the tuning-table keys of its launches
    (``kernels.autotune``)."""

    def __init__(self, spec: BNNSpec, plan: Tuple[PlanStep, ...],
                 backend: str, device: torch.device, batch: int):
        self.spec = spec
        self.plan = plan
        self.backend = backend
        self.device = device
        self.batch = batch
        self.tuning_keys: Tuple[tuple, ...] = tuple(
            k for s in plan for k in s.keys)

    def describe(self) -> str:
        head = (f"compiled {self.spec.name} "
                f"(input {self.spec.input_shape}, backend {self.backend}, "
                f"device {self.device}, batch hint {self.batch}): "
                f"{len(self.plan)} steps, "
                f"{self.launch_count()} kernel launches "
                f"(layer by layer: {self.legacy_launch_count()})")
        lines = [f"  {s}" for s in self.plan]
        if self.spec.residual_nodes:
            lines.append(f"  ({len(self.spec.residual_nodes)} half-steps, "
                         f"one residual_conv launch each, after a "
                         f"shortcut_conv launch where the shortcut is a "
                         f"projection "
                         f"(packed_conv_kernel_residual_epilogue: the "
                         f"int32 dot stays on chip); the float stream stays "
                         f"float32, the signs between half-steps 1 bit)")
        return "\n".join([head] + lines)

    def launch_count(self) -> int:
        """Kernel launches per forward pass under this plan: the sum of
        its steps' ``launches`` (a float entry conv on cuDNN, pools,
        reshapes and the real dense head are no kernels of the port)."""
        return sum(len(s.launches) for s in self.plan)

    def legacy_launch_count(self) -> int:
        """Launches of a layer-by-layer chain: every fused_stack
        segment unrolls to one launch per layer, and a residual
        half-step's conv and epilogue are two (after its projection
        shortcut's, if any)."""
        return sum(len(s.args["fc_indices"]) if s.kind == "fused_stack"
                   else len(s.launches) + 1 if s.kind == "residual_conv"
                   else len(s.launches) for s in self.plan)

    def tuning_keys_for_batch(self, batch: int) -> Tuple[tuple, ...]:
        """The tuning keys this plan's launches resolve to at another
        batch size: the SAME plan (segment boundaries, conv impls), only
        the row terms rescaled.  Equal to a fresh ``compile(batch=)``'s
        keys."""
        if batch == self.batch:
            return self.tuning_keys
        return plan_tuning_keys(self.spec, self.plan, batch,
                                backend=self.backend)

    def tuning_keys_for_batches(self, batches: Sequence[int]
                                ) -> Tuple[tuple, ...]:
        """Deduplicated union of ``tuning_keys_for_batch`` over many
        batch sizes, the serving engine's prewarm set: one call covers
        every (bucket, valid) level of ``serving.bucketing.dispatch_grid``
        (``BNNServer(prewarm=True)`` hands it to
        ``kernels.autotune.warm``)."""
        return batches_tuning_keys(self.spec, self.plan, batches,
                                   backend=self.backend)

    def audit(self, params: Optional[Dict[str, Any]] = None, x: Any = None,
              batch: Optional[int] = None, max_batch: int = 64) -> Any:
        """Design-rule check this artifact (``repro_torch.analysis.audit``):
        the launches of one eager ``apply`` against ``launch_count``, no
        int32 activation of a plan-derived shape on the card, the shared
        memory the plan's launches claim re-derived at ``batch``, and the
        server's graphs within ``trace_bound``.  Raises
        :class:`~repro_torch.analysis.audit.AuditError` on any violation;
        returns the :class:`AuditReport` otherwise."""
        from repro_torch.analysis.audit import audit_compiled
        return audit_compiled(self, params=params, x=x, batch=batch,
                              max_batch=max_batch).raise_if_failed()

    def split(self, step: str) -> Tuple["CompiledBNN", "CompiledBNN"]:
        """Cut the plan before the named step: the head runs the steps
        before it, the tail the rest, so ``tail.apply(params,
        head.apply(params, x))`` is ``apply(params, x)``.  Cutting at
        the first binarize step separates the float entry layers, whose
        sums depend on the order, from the exact binary tail.  Each half
        takes its entry epilogues again (``passes.entry_epilogues``): a
        head that ends at an entry conv keeps its alpha multiply."""
        names = [s.name for s in self.plan]
        if step not in names:
            raise ValueError(f"no plan step {step!r}; steps: {names}")
        i = names.index(step)
        return tuple(CompiledBNN(self.spec,
                                 entry_epilogues(self.spec, plan,
                                                 self.backend),
                                 self.backend, self.device, self.batch)
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

    def to(self, device: Union[str, torch.device]) -> "CompiledBNN":
        """The same plan for another device (a serving mesh builds one
        per distinct device it spans); ``self`` when it is the same."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        return CompiledBNN(self.spec, self.plan, self.backend, dev,
                           self.batch)

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
        if self.spec.residual_nodes or self.spec.stem_nodes:
            params = self.bind(self.draw_residual(generator, dtype))
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

    def draw_residual(self, generator: torch.Generator,
                      dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
        """Random params of the residual family's nodes in their
        published form (what :meth:`bind` takes), on ``self.device``,
        drawn from ``generator``: normal weights; batch-norm statistics
        scaled to the conv's output (var: the variance its sum has over
        random inputs, times U[0.5, 2]; mean: U[-0.5, 0.5] of its
        standard deviation); gamma U[0.5, 1.5], beta U[-0.5, 0.5]; the
        RSign and RPReLU biases U[-0.2, 0.2], PReLU slopes U[0.05,
        0.35] (half-steps with ``rprelu`` only); a projection shortcut's
        ``proj`` (``w`` [C_in, C_out] and its batch norm, over unit
        inputs); a head of normals over sqrt(n_in) with a bias U[-0.1,
        0.1]."""
        gdev = generator.device

        def normal(*shape):
            return torch.randn(shape, generator=generator, dtype=dtype,
                               device=gdev).to(self.device)

        def uniform(n, lo, hi):
            u = torch.rand((n,), generator=generator, dtype=dtype,
                           device=gdev).to(self.device)
            return lo + (hi - lo) * u

        def bn(n, var_of_sum):
            sd = var_of_sum.sqrt()
            return {"mean": uniform(n, -0.5, 0.5) * sd,
                    "var": uniform(n, 0.5, 2.0) * var_of_sum,
                    "gamma": uniform(n, 0.5, 1.5),
                    "beta": uniform(n, -0.5, 0.5)}

        out: Dict[str, Any] = {"conv": [], "fc": [], "stem": [], "res": [],
                               "head": []}
        for nd in self.spec.stem_nodes:
            w = normal(nd.kh, nd.kw, nd.c_in, nd.c_out)
            out["stem"].append({"w": w,
                                **bn(nd.c_out, (w * w).sum(dim=(0, 1, 2)))})
        for nd in self.spec.residual_nodes:
            w = normal(nd.k, nd.k, nd.c_in, nd.c_out)
            alpha = w.abs().mean(dim=(0, 1, 2))
            p = {"b_in": uniform(nd.c_in, -0.2, 0.2)} if nd.rprelu else {}
            p.update(w=w, **bn(nd.c_out, alpha * alpha * nd.k * nd.k *
                               nd.c_in))
            if nd.rprelu:
                p.update(move_a=uniform(nd.c_out, -0.2, 0.2),
                         slope=uniform(nd.c_out, 0.05, 0.35),
                         move_b=uniform(nd.c_out, -0.2, 0.2))
            if nd.shortcut == "projection":
                pw = normal(nd.c_in, nd.c_out)
                p["proj"] = {"w": pw, **bn(nd.c_out, (pw * pw).sum(dim=0))}
            out["res"].append(p)
        for nd in self.spec.head_nodes:
            out["head"].append({"w": normal(nd.n_out, nd.n_in) /
                                float(nd.n_in) ** 0.5,
                                "b": uniform(nd.n_out, -0.1, 0.1)})
        return out

    def bind(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """The residual family's params as the kernels read them, from
        their published form (a new tree; the other keys are kept):

        * ``stem[i]``: ``w`` [KH, KW, C, F] float, BN ``mean``, ``var``,
          ``gamma``, ``beta`` -> ``w`` and ``table`` [5, F]
          (``kernels.residual.stem_table``, with the next RSign's bias);
        * ``res[i]``: ``b_in`` [C_in] (its RSign's bias), ``w`` [K, K,
          C_in, C_out] float latent weights (a doubling half-step's two
          1x1 convs concatenated on the output axis), BN ``mean``,
          ``var``, ``gamma``, ``beta``, the RPReLU's ``move_a``,
          ``slope``, ``move_b`` [C_out] -> ``wf`` (sign(w) packed on the
          channel axis), ``corr`` (the zero-padding correction; a 1x1
          conv has none) and ``table`` [9, F]
          (``kernels.residual.epilogue_table``: alpha = mean |w| of each
          output channel, the next half-step's RSign bias); a half-step
          without ``rprelu`` (Bi-Real Net) has no RSign or RPReLU
          params and takes the neutral ones
          (``kernels.residual.neutral_table``); a projection shortcut's
          ``proj`` (``w`` [C_in, C_out], BN ``mean``, ``var``,
          ``gamma``, ``beta``) -> ``proj_w`` and ``proj_table`` [4, F]
          (``kernels.residual.shortcut_table``);
        * ``head[i]``: ``w`` [N_out, N_in], ``b`` [N_out], as they are.

        Other specs' params are returned as they are."""
        res_nodes = self.spec.residual_nodes
        if not res_nodes and not self.spec.stem_nodes:
            return params
        b_in = [p["b_in"] if nd.rprelu else None
                for nd, p in zip(res_nodes, params["res"])]

        def next_bias(nd):
            """The RSign bias of the half-step after ``nd``, if one is."""
            nxt = self.spec.nodes[self.spec.nodes.index(nd) + 1]
            return b_in[res_nodes.index(nxt)] \
                if isinstance(nxt, ResidualBinaryConv) else None

        out = dict(params)
        out["stem"] = [{"w": p["w"].to(torch.float32).contiguous(),
                        "table": kres.stem_table(p["mean"], p["var"],
                                                 p["gamma"], p["beta"],
                                                 next_bias(nd))}
                       for nd, p in zip(self.spec.stem_nodes, params["stem"])]
        out["res"] = []
        for nd, p in zip(res_nodes, params["res"]):
            w = p["w"].to(torch.float32)
            wf = PackedArray.pack(w, axis=2)
            alpha = w.abs().mean(dim=(0, 1, 2))
            if nd.rprelu:
                table = kres.epilogue_table(
                    alpha, p["mean"], p["var"], p["gamma"], p["beta"],
                    p["move_a"], p["slope"], p["move_b"], next_bias(nd))
            else:
                table = kres.neutral_table(alpha, p["mean"], p["var"],
                                           p["gamma"], p["beta"],
                                           next_bias(nd))
            q = {"wf": wf, "table": table}
            if nd.shortcut == "projection":
                pr = p["proj"]
                q["proj_w"] = pr["w"].to(torch.float32).contiguous()
                q["proj_table"] = kres.shortcut_table(
                    pr["mean"], pr["var"], pr["gamma"], pr["beta"])
            if nd.pad:
                q["corr"] = kres.zero_pad_correction(wf.unpack(torch.float32))
            out["res"].append(q)
        out["head"] = [{"w": p["w"].to(torch.float32).contiguous(),
                        "b": p["b"].to(torch.float32).contiguous()}
                       for p in params["head"]]
        return out

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
        bits = None          # the next half-step's RSign words
        plain = not get_backend(be).uses_kernels
        for step in self.plan:
            a = step.args
            if step.kind == "real_conv":
                p = params["stem"][a["stem_idx"]]
                stem = kres.stem_conv_plain if plain else kres.stem_conv
                h, bits = stem(h, p["w"], p["table"], stride=a["stride"],
                               pad=a["pad"], pool=a["pool"],
                               write_bits=a["sign_next"])
            elif step.kind == "residual_conv":
                nd = self.spec.residual_nodes[a["res_idx"]]
                p = params["res"][a["res_idx"]]
                signs = PackedArray(bits, length=nd.c_in, axis=-1)
                sc, shortcut = h, a["shortcut"]
                if shortcut == "projection":
                    proj = kres.shortcut_conv_plain if plain \
                        else kres.shortcut_conv
                    sc = proj(h, p["proj_w"], p["proj_table"])
                    shortcut = "identity"
                kw = dict(shortcut=shortcut, stride=a["stride"],
                          pad=a["pad"], write_bits=a["sign_next"])
                conv = kres.residual_conv_plain if plain \
                    else kres.residual_conv
                h, bits = conv(signs, p["wf"], p.get("corr"), p["table"], sc,
                               **kw)
            elif step.kind == "global_pool":
                h = h.mean(dim=(1, 2))
            elif step.kind == "real_dense":
                p = params["head"][a["head_idx"]]
                with full_fp32():
                    h = F.linear(h, p["w"], p["b"])
            elif step.kind == "integer_conv":
                p = params["conv"][a["conv_idx"]]
                if a["epilogue"] == "entry_conv":
                    h = PackedArray(
                        kentry.entry_conv(h, p["w"], p["alpha"],
                                          stride=a["stride"],
                                          padding=a["pad"]),
                        length=p["w"].shape[3], axis=-1)
                elif a["epilogue"] == "alpha_to_pack":
                    h = sign_weight_conv(h, p["w"], stride=a["stride"],
                                         padding=a["pad"])
                else:
                    h = binary_weight_conv(h, p["w"], stride=a["stride"],
                                           padding=a["pad"],
                                           alpha=p["alpha"])
            elif step.kind == "float_pool":
                h = _maxpool_float(h, a["window"], a["stride"])
            elif step.kind == "binarize":
                if a["packed"]:
                    continue                   # entry_conv packed it
                if a["flatten"]:
                    h = h.reshape(h.shape[0], -1)
                scale = None if a["scale_conv"] is None \
                    else params["conv"][a["scale_conv"]]["alpha"]
                h = kops.binarize_pack(h, backend=be, scale=scale)
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
        layers += self._residual_traffic(batch)
        packed = sum(d["packed_bytes"] for d in layers)
        bf16 = sum(d["bf16_bytes"] for d in layers)
        return {"layers": layers, "packed_bytes": packed,
                "bf16_bytes": bf16,
                "ratio_bf16_over_packed": bf16 / packed}

    def _residual_traffic(self, batch: int) -> List[Dict[str, Any]]:
        """The residual family's layers in :meth:`traffic`: the stem
        reads float pixels and writes the float stream and the signs; a
        half-step reads the signs and the packed weights, reads the
        shortcut and writes the stream and the next signs (its int32
        dot stays in the fused kernel's shared memory); the head reads
        the stream and float weights; a projection shortcut reads the
        stream and its float weights and writes its map, which the
        half-step reads.  The bf16 baseline keeps every activation in
        bf16."""
        layers = []
        for nd in self.spec.stem_nodes:
            n_in = batch * nd.h_in * nd.w_in * nd.c_in
            n_out = batch * nd.h_out * nd.w_out * nd.c_out
            n_w = nd.kh * nd.kw * nd.c_in * nd.c_out
            layers.append({"name": nd.name,
                           "packed_bytes": 4 * (n_in + n_w + n_out)
                           + n_out // 8,
                           "bf16_bytes": 2 * (n_in + n_w + n_out)})
        for nd in self.spec.residual_nodes:
            n_in = batch * nd.h_in * nd.w_in * nd.c_in
            n_out = batch * nd.h_out * nd.w_out * nd.c_out
            n_w = nd.k * nd.k * nd.c_in * nd.c_out
            n_sc = n_in if nd.shortcut == "avgpool" else \
                n_in + nd.c_in * nd.c_out + 2 * n_out \
                if nd.shortcut == "projection" else \
                n_out // (2 if nd.shortcut == "duplicate" else 1)
            layers.append({"name": nd.name,
                           "packed_bytes": n_in // 8 + n_w // 8
                           + 4 * n_sc + 4 * n_out + n_out // 8,
                           "bf16_bytes": 2 * (n_in + n_w + n_sc + n_out)})
        for nd in self.spec.head_nodes:
            last = self.spec.residual_nodes[-1] if self.spec.residual_nodes \
                else self.spec.stem_nodes[-1]
            n_pool = batch * last.h_out * last.w_out * nd.n_in
            n_w = nd.n_in * nd.n_out
            layers.append({"name": nd.name,
                           "packed_bytes": 4 * (n_pool + n_w),
                           "bf16_bytes": 2 * (n_pool + n_w)})
        return layers

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
