"""Execute a compiled BNNSpec on the TULIP-PE mesh model (DESIGN §14).

The port of ``repro.sim.simulator``.  ``simulate(compiled, params, x)``
walks the SAME plan :meth:`repro_torch.graph.compile.CompiledBNN.apply`
executes, but runs it the way the silicon would, on ``compiled.device``
(the card unless the compiled was made for the CPU):

* **integer entry layers** (``integer_conv`` / ``float_pool``) run on
  the MAC-coprocessor model — the same torch functions apply uses
  (``binary_weight_conv``: the cuDNN conv of ``sign_weight_conv`` times
  alpha in float32, the product apply's pack forms in its load;
  ``_maxpool_float``), so the float boundary into the packed domain is
  bit-identical by construction;
* **binary layers** run as the architectural schedule: the IFM set is
  sliced into P partial-sum passes and the OFMs into Z batches of
  ``ofm_batch`` (core/mapping.py), and the partial integer dots are
  accumulated pass by pass in exact integer arithmetic (a float32
  product of +-1 operands on the device: every partial sum is an
  integer below 2**24, exact in any order, with or without TF32).  The
  loop trip counts are *measured* into a
  :class:`repro_torch.core.energy.UnitCounts` row and priced by the
  same ``conv_report`` / ``fc_report`` formulas the closed-form model
  uses — if the measured row differs from the mapping prediction,
  ``counts_match_mapping`` goes False (tests gate on it);
* **PE-program fidelity** is checked by sampling output nodes per
  binary layer (the reference's ``np.random.default_rng(seed)`` draw,
  so the same seed checks the same nodes) and pushing their actual
  product bits, moved to the host, through the REAL micro-op programs —
  ``core.adder_tree.schedule_tree`` schedules run on
  ``core.tulip_pe.run_numpy``, chunked to the mesh capacity, with the
  ``>= T`` compare executed on-PE when a single chunk fits (and by the
  host accumulate/compare path otherwise, exactly the multi-pass
  structure the cycle model charges for).  One sampled program per
  simulate() is re-run on ``run_torch`` on the compiled's device as a
  numpy/torch twin check (``run_torch_crosschecked``).

Units: cycles at ``CellSpecs.freq_hz``, seconds, Joules, um^2; logits
are a float32 tensor on the compiled's device and must equal the
``CompiledBNN.apply`` oracle bit for bit (``oracle_bit_identical``).
On ``"cuda"`` the oracle runs the port's Hopper kernels, so the check
holds them against an exact integer schedule written without their
tiling.

Failure modes: raises on plan steps it does not know (the walker and
apply must not drift apart), on PackedArray layout violations, and on
an input that is not on the compiled's device (no silent CPU run of a
card's compiled); the fidelity/parity gates are *recorded*, not raised,
so a DSE sweep can report a broken config instead of dying on it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.adder_tree import make_ext_inputs
from repro_torch.core.bnn_layers import (FoldedThreshold,
                                         binary_weight_conv,
                                         fold_conv_to_channel_thresholds,
                                         fold_to_channel_thresholds)
from repro_torch.core.energy import (CellSpecs, LayerReport, SystemParams,
                                     UnitCounts, conv_counts, conv_report,
                                     fc_counts, fc_report)
from repro_torch.core.mapping import LayerMapping, map_conv, map_fc
from repro_torch.core.tulip_pe import read_value, run_numpy, run_torch
from repro_torch.core.workloads import Workload
from repro_torch.graph.compile import CompiledBNN, _maxpool_float
from repro_torch.graph.ir import spec_to_workload
from repro_torch.kernels.ops import conv_padding
from repro_torch.kernels.packed import PackedArray
from repro_torch.sim.mesh import MeshConfig

__all__ = ["SimLayer", "SimResult", "simulate"]

I8, I32, F32 = torch.int8, torch.int32, torch.float32


@dataclass
class SimLayer:
    """One executed conv/fc layer: measured schedule counts, the
    mapping-model prediction they must equal, and the priced report."""

    name: str
    kind: str                    # "conv" | "fc"
    uses_pe: bool
    measured: UnitCounts
    predicted: UnitCounts
    report: LayerReport
    pe_nodes_checked: int
    pe_nodes_passed: int

    @property
    def counts_match(self) -> bool:
        return self.measured == self.predicted


@dataclass
class SimResult:
    """What one mesh execution of a compiled spec produced.

    ``logits`` covers the whole input batch; cycle/energy totals price
    ONE classification (the schedule counts are batch-invariant — the
    mesh processes images one at a time, §V-A)."""

    workload: str
    arch_name: str
    config: MeshConfig
    batch: int
    logits: torch.Tensor
    layers: List[SimLayer]
    oracle_bit_identical: Optional[bool]
    run_torch_crosschecked: bool
    area_um2: float

    @property
    def counts_match_mapping(self) -> bool:
        return all(ly.counts_match for ly in self.layers)

    @property
    def pe_nodes_checked(self) -> int:
        return sum(ly.pe_nodes_checked for ly in self.layers)

    @property
    def pe_programs_ok(self) -> bool:
        return all(ly.pe_nodes_passed == ly.pe_nodes_checked
                   for ly in self.layers)

    @property
    def wall_cycles(self) -> float:
        return sum(ly.report.wall_cycles for ly in self.layers)

    @property
    def busy_cycles(self) -> float:
        return sum(ly.report.busy_cycles for ly in self.layers)

    @property
    def time_s(self) -> float:
        return sum(ly.report.time_s for ly in self.layers)

    @property
    def energy_per_class_j(self) -> float:
        return sum(ly.report.energy_j for ly in self.layers)

    def conv_pz(self) -> List[Dict[str, Any]]:
        """Measured per-conv-layer P / Z / P*Z — the Table III columns
        as the simulator ran them (compare to ``table3_rows()``)."""
        return [{"layer": ly.name, "P": ly.measured.P,
                 "Z": ly.measured.n_batches,
                 "PZ": ly.measured.P * ly.measured.n_batches}
                for ly in self.layers if ly.kind == "conv"]


# ------------------------------------------------------------------ #
# exact pm1 integer helpers                                            #
# ------------------------------------------------------------------ #
def _pm1(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, 1, -1).to(I8)


def _unpack_pm1(p: PackedArray) -> torch.Tensor:
    return p.unpack(I8)


def _exact_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """pm1 x pm1 integer GEMM as a float32 product on the device: every
    partial sum is an integer below 2**24 (no pass is wider than K =
    8192), so it is exact in any order, TF32 or not."""
    return torch.matmul(a.to(F32), b.to(F32)).round().to(I32)


def _threshold_vec(t: Any, n_out: int, device: torch.device
                   ) -> torch.Tensor:
    tv = torch.as_tensor(t, device=device).to(I32).reshape(-1)
    if tv.numel() == 1:
        tv = tv.expand(n_out).contiguous()
    return tv


def _patches(x: torch.Tensor, kh: int, kw: int, stride: int,
             pad_h: int, pad_w: int) -> torch.Tensor:
    """im2col in the sign domain: [B, HO, WO, KH*KW, C] pm1 int8
    patches with -1 spatial padding (the only border a pm1 bit code
    encodes — same rule as kernels.ref's sign conv)."""
    b, h, w, c = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, pad_w, pad_w, pad_h, pad_h),
                                 value=-1)
    ho = (h + 2 * pad_h - kh) // stride + 1
    wo = (w + 2 * pad_w - kw) // stride + 1
    pat = torch.empty((b, ho, wo, kh * kw, c), dtype=I8, device=x.device)
    for i in range(kh):
        for j in range(kw):
            pat[:, :, :, i * kw + j, :] = xp[
                :, i:i + (ho - 1) * stride + 1:stride,
                j:j + (wo - 1) * stride + 1:stride, :]
    return pat


def _host_bits(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    """One node's product bits (1 = the pm1 product was +1), on the
    host for the numpy PE interpreter."""
    return ((a * b) > 0).to(I32).cpu().numpy()


# ------------------------------------------------------------------ #
# the PE-program fidelity sampler                                      #
# ------------------------------------------------------------------ #
class _PEChecker:
    """Runs sampled nodes' product bits through real scheduled
    programs on the numpy PE interpreter (one torch twin run total, on
    ``device``)."""

    def __init__(self, mesh: MeshConfig, samples_per_layer: int,
                 seed: int, device: torch.device) -> None:
        self.mesh = mesh
        self.per_layer = samples_per_layer
        self.rng = np.random.default_rng(seed)
        self.device = device
        self.torch_checked = False

    def _twin(self, program: Any, ext: np.ndarray, want: np.ndarray,
              part: int, what: str) -> None:
        """Re-run one program on run_torch; its regs (part 0) or hist
        (part 2) must equal run_numpy's."""
        got = run_torch(program, ext, device=self.device)[part]
        if not np.array_equal(got.cpu().numpy(), want):
            raise AssertionError(f"run_torch diverged from run_numpy on a "
                                 f"scheduled {what} program")
        self.torch_checked = True

    def _popcount_on_pe(self, bits: np.ndarray) -> int:
        """Chunk one node's product bits through popcount programs;
        returns the accumulated popcount."""
        mesh, off, total = self.mesh, 0, 0
        for size in mesh.chunk_sizes(bits.shape[0]):
            sched = mesh.node_schedule(size)
            ext = make_ext_inputs(sched.ext_layout,
                                  bits[None, off:off + size],
                                  sched.cycles, n_ext=mesh.n_ext)
            regs, _, _ = run_numpy(sched.program, ext)
            total += int(read_value(regs, sched.result_neuron,
                                    sched.result_bits)[0])
            if not self.torch_checked:
                self._twin(sched.program, ext, regs, 0, "popcount")
            off += size
        return total

    def check_node(self, bits: np.ndarray, t_int: int,
                   want_plus: bool) -> bool:
        """One output node: bits are its n product bits (1 = the pm1
        product was +1), t_int the integer-dot threshold, want_plus
        the layer's decision.  The integer test y >= t is the
        popcount test pc >= ceil((t + n) / 2) (y = 2 pc - n)."""
        n = int(bits.shape[0])
        t_pc = -((-(t_int + n)) // 2)
        chunks = self.mesh.chunk_sizes(n)
        if len(chunks) == 1 and 1 <= t_pc <= n:
            # single tree: the bit-serial >= compare runs ON the PE
            sched = self.mesh.node_schedule(n, threshold=t_pc)
            ext = make_ext_inputs(sched.ext_layout, bits[None, :],
                                  sched.cycles, n_ext=self.mesh.n_ext)
            _, _, hist = run_numpy(sched.program, ext, trace=True)
            if (hist is None or sched.cmp_result_cycle is None
                    or sched.cmp_neuron is None):
                raise AssertionError("a compare schedule without its "
                                     "result cycle")
            got = bool(hist[0, sched.cmp_result_cycle, sched.cmp_neuron])
            if not self.torch_checked:
                self._twin(sched.program, ext, hist, 2, "compare")
        else:
            # multi-chunk accumulate (Fig 4(c)); host-side compare,
            # the same structure the chunked cycle model charges
            got = self._popcount_on_pe(bits) >= t_pc
        return got == want_plus

    def sample(self, n_total: int) -> np.ndarray:
        take = min(self.per_layer, n_total)
        return self.rng.choice(n_total, size=take, replace=False)


# ------------------------------------------------------------------ #
# layer executors                                                      #
# ------------------------------------------------------------------ #
def _measure_conv(m: LayerMapping, p_trips: int, z_trips: int,
                  mesh: MeshConfig, cells: CellSpecs) -> UnitCounts:
    return UnitCounts(m.uses_pe, p_trips, z_trips,
                      mesh.unit_cycles(m.node_inputs,
                                       accumulate=(p_trips > 1),
                                       uses_pe=m.uses_pe, spec=cells),
                      m.ifm_per_pass, m.n_units, m.ofm_batch)


def _run_binary_conv(pat: torch.Tensor, w: torch.Tensor, m: LayerMapping
                     ) -> Tuple[torch.Tensor, int, int]:
    """The architectural conv loop: accumulate channel-slice partial
    dots over P passes for each of Z OFM batches.  Returns the exact
    int32 pre-threshold activation and the measured trip counts.  Only
    one pass's slice of the patches is ever float32."""
    b, ho, wo, kk, c = pat.shape
    f = w.shape[-1]
    wk = w.reshape(kk, c, f)
    y = torch.zeros((b, ho, wo, f), dtype=I32, device=pat.device)
    rows = pat.reshape(b * ho * wo, kk, c)
    p_trips = z_trips = 0
    for f0 in range(0, f, m.ofm_batch):
        f1 = min(f0 + m.ofm_batch, f)
        z_trips += 1
        passes = 0
        for c0 in range(0, c, m.ifm_per_pass):
            c1 = min(c0 + m.ifm_per_pass, c)
            passes += 1
            a = rows[:, :, c0:c1].reshape(b * ho * wo, kk * (c1 - c0))
            wslab = wk[:, c0:c1, f0:f1].reshape(kk * (c1 - c0), f1 - f0)
            y[..., f0:f1] += _exact_dot(a, wslab).reshape(
                b, ho, wo, f1 - f0)
        p_trips = passes
    return y, p_trips, z_trips


def _run_dense(x: torch.Tensor, w: torch.Tensor, m: LayerMapping
               ) -> Tuple[torch.Tensor, int, int]:
    """FC twin of the conv loop: stream K in resident-buffer chunks
    (P passes), produce N in ofm_batch slices (Z batches)."""
    b, k = x.shape
    n = w.shape[0]
    y = torch.zeros((b, n), dtype=I32, device=x.device)
    p_trips = z_trips = 0
    for n0 in range(0, n, m.ofm_batch):
        n1 = min(n0 + m.ofm_batch, n)
        z_trips += 1
        passes = 0
        for k0 in range(0, k, m.ifm_per_pass):
            k1 = min(k0 + m.ifm_per_pass, k)
            passes += 1
            y[:, n0:n1] += _exact_dot(x[:, k0:k1], w[n0:n1, k0:k1].T)
        p_trips = passes
    return y, p_trips, z_trips


def _bind_conv(p: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    wf, t = p["wf"], p["t"]
    if isinstance(t, FoldedThreshold):
        wf, t = fold_conv_to_channel_thresholds(wf, t)
    w = _unpack_pm1(wf)
    return w, _threshold_vec(t, w.shape[-1], w.device)


def _bind_fc(p: Dict[str, Any]) -> Tuple[torch.Tensor, Optional[Any]]:
    wp, t = p["wp"], p.get("t")
    if isinstance(t, FoldedThreshold):
        wp, t = fold_to_channel_thresholds(wp, t)
    return _unpack_pm1(wp), t


# ------------------------------------------------------------------ #
# the simulator                                                        #
# ------------------------------------------------------------------ #
def simulate(compiled: CompiledBNN, params: Dict[str, Any], x: Any,
             mesh: Optional[MeshConfig] = None,
             cells: Optional[CellSpecs] = None,
             system: Optional[SystemParams] = None,
             pe_samples: int = 4, seed: int = 0,
             check_oracle: bool = True) -> SimResult:
    """Execute ``compiled`` on the mesh; see the module docstring.

    x: float NHWC batch for image specs, a PackedArray for dense-entry
    specs — the exact ``apply`` input, on ``compiled.device``.
    ``pe_samples`` output nodes per binary layer run through real PE
    programs (0 disables the fidelity sampler); ``check_oracle=False``
    skips the apply() run (the DSE driver compares against one shared
    oracle instead)."""
    mesh = mesh or MeshConfig()
    cells = cells or CellSpecs()
    system = system or SystemParams()
    arch = mesh.arch()
    dev = compiled.device
    xdev = (x.words if isinstance(x, PackedArray) else x).device
    if xdev.type != dev.type or dev.index not in (None, xdev.index):
        raise ValueError(f"x is on {xdev}, the compiled runs on {dev}")
    wl: Workload = spec_to_workload(compiled.spec)
    checker = _PEChecker(mesh, pe_samples, seed, dev)
    layers: List[SimLayer] = []

    h: Any = x
    if isinstance(h, PackedArray):
        h = _unpack_pm1(h)

    for step in compiled.plan:
        a = step.args
        if step.kind == "integer_conv":
            # MAC coprocessor: the same torch op apply runs (float math
            # must be bit-identical, so it is not re-partitioned)
            layer = wl.conv[a["conv_idx"]]
            p = params["conv"][a["conv_idx"]]
            h = binary_weight_conv(h, p["w"], stride=a["stride"],
                                   padding=a["pad"], alpha=p["alpha"])
            m = map_conv(layer, arch)
            c = _measure_conv(m, m.P, math.ceil(layer.z2 / m.ofm_batch),
                              mesh, cells)
            layers.append(SimLayer(
                layer.name, "conv", False, c, c,
                conv_report(layer, arch, cells, system, c), 0, 0))
        elif step.kind == "float_pool":
            h = _maxpool_float(h, a["window"], a["stride"])
        elif step.kind == "binarize":
            if a["flatten"]:
                h = h.reshape(h.shape[0], -1)
            h = _pm1(h)
        elif step.kind == "binary_conv":
            layer = wl.conv[a["conv_idx"]]
            w, tvec = _bind_conv(params["conv"][a["conv_idx"]])
            kh, kw = w.shape[0], w.shape[1]
            pad_h, pad_w = conv_padding(a["pad"], kh, kw)
            pat = _patches(h, kh, kw, a["stride"], pad_h, pad_w)
            m = map_conv(layer, arch)
            y, p_trips, z_trips = _run_binary_conv(pat, w, m)
            checked = passed = 0
            if m.uses_pe and pe_samples:
                kkc = pat.shape[3] * pat.shape[4]
                flat = pat.reshape(-1, kkc)
                wn = w.reshape(kkc, -1)
                y2 = y.reshape(-1, y.shape[-1])
                for idx in checker.sample(flat.shape[0] * y.shape[-1]):
                    r, f = divmod(int(idx), y.shape[-1])
                    bits = _host_bits(flat[r], wn[:, f])
                    want = bool(y2[r, f] >= tvec[f])
                    checked += 1
                    passed += checker.check_node(bits, int(tvec[f]),
                                                 want)
            del pat
            c = _measure_conv(m, p_trips, z_trips, mesh, cells)
            layers.append(SimLayer(
                layer.name, "conv", m.uses_pe, c,
                conv_counts(layer, arch, mesh.pe_node_cycles, cells),
                conv_report(layer, arch, cells, system, c),
                checked, passed))
            h = _pm1(y - tvec.reshape(1, 1, 1, -1) + 1)  # y >= t
        elif step.kind == "packed_pool":
            win, s = a["window"], a["stride"]
            ho = (h.shape[1] - win) // s + 1
            wo = (h.shape[2] - win) // s + 1
            out = torch.full((h.shape[0], ho, wo, h.shape[3]), -1,
                             dtype=I8, device=h.device)
            for i in range(win):
                for j in range(win):
                    out = torch.maximum(
                        out, h[:, i:i + (ho - 1) * s + 1:s,
                               j:j + (wo - 1) * s + 1:s, :])
            h = out
        elif step.kind == "flatten":
            if h.shape[-1] % 32:
                raise ValueError("flattening needs C % 32 == 0 to "
                                 "match the packed word layout")
            h = h.reshape(h.shape[0], -1)
            if h.shape[1] != a["n_in"]:
                raise ValueError(f"flattened width {h.shape[1]} != "
                                 f"{step.name} n_in={a['n_in']}")
        elif step.kind in ("dense", "fused_stack"):
            idxs = (a["fc_indices"] if step.kind == "fused_stack"
                    else [a["fc_idx"]])
            for j in idxs:
                layer = wl.fc[j]
                w, t = _bind_fc(params["fc"][j])
                thresholded = (t is not None
                               and (step.kind == "fused_stack"
                                    or a["thresholded"]))
                m = map_fc(layer, arch)
                y, p_trips, z_trips = _run_dense(h, w, m)
                checked = passed = 0
                if m.uses_pe and pe_samples and thresholded:
                    tvec = _threshold_vec(t, w.shape[0], w.device)
                    for idx in checker.sample(y.shape[0] * y.shape[1]):
                        r, f = divmod(int(idx), y.shape[1])
                        bits = _host_bits(h[r], w[f])
                        checked += 1
                        passed += checker.check_node(
                            bits, int(tvec[f]), bool(y[r, f] >= tvec[f]))
                uc = (mesh.pe_node_cycles(m.node_inputs,
                                          accumulate=(p_trips > 1),
                                          compare=True)
                      if m.uses_pe else 0)
                c = UnitCounts(m.uses_pe, p_trips, z_trips, uc,
                               m.ifm_per_pass, m.n_units, m.ofm_batch)
                layers.append(SimLayer(
                    layer.name, "fc", m.uses_pe, c,
                    fc_counts(layer, arch, mesh.pe_node_cycles),
                    fc_report(layer, arch, cells, system, c),
                    checked, passed))
                if thresholded:
                    tvec = _threshold_vec(t, w.shape[0], w.device)
                    h = _pm1(y - tvec.reshape(1, -1) + 1)
                else:
                    h = y
        elif step.kind == "logits":
            h = h.to(I32).to(F32)
        else:                          # pragma: no cover
            raise AssertionError(f"unknown plan step {step.kind}")

    logits = h.to(F32)
    oracle_ok: Optional[bool] = None
    if check_oracle:
        ref = compiled.apply(params, x)
        if isinstance(ref, PackedArray):   # spec ends in a packed layer
            ref = ref.unpack(I8)
        oracle_ok = bool(torch.equal(logits, ref.to(F32)))
    return SimResult(
        workload=compiled.spec.name, arch_name=arch.name, config=mesh,
        batch=int(logits.shape[0]), logits=logits, layers=layers,
        oracle_bit_identical=oracle_ok,
        run_torch_crosschecked=checker.torch_checked,
        area_um2=mesh.area_um2(cells))
