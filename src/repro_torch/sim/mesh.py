"""The configurable TULIP-PE mesh model (DESIGN.md §14).

A copy of ``repro.sim.mesh``: the port imports nothing of the
JAX package.

A :class:`MeshConfig` is one point in the hardware design space the
paper's §V-C comparison implicitly fixes: how many TULIP-PEs sit next
to the 32-MAC coprocessor, how much local register memory each PE's
four neurons carry, and which schedule variant the controller streams.
The simulator (repro_torch.sim.simulator) executes a compiled plan against a
config; the DSE driver (repro_torch.sim.dse) sweeps configs and Pareto-ranks
them.

Axes and their physical meaning:

* ``n_pes`` — parallel PEs, which is also the OFM batch size the
  architectural schedule produces per IFM refetch (core/mapping.py:
  ``ofm_batch_pe``).  More PEs cut the refetch product P*Z (Table III)
  at the cost of area; ``n_pes = 0`` degenerates to the YodaNN MAC
  baseline.
* ``reg_bits`` — bits per neuron register (the paper's PE has 4 x 16).
  The RPO schedule's live storage is bounded by (L^2+L)/2 + 1 bits for
  an N-input tree with L = floor(log2 N) (paper §III-B), so a smaller
  register file caps the adder-tree size a PE can schedule without
  spilling; wider nodes split into more accumulation chunks (Fig 4(c))
  and cost more cycles.  The capacity is additionally clamped at 1023
  inputs — the 10-bit accumulator of the paper's §IV-C design, fixed
  by the bit-serial comparator — so ``tree_capacity(16) == 1023``
  matches ``core.energy.pe_cycles``'s CAP exactly.
* ``schedule`` — ``"compact"`` (greedy list scheduling with resource /
  hazard overlap, the default core/adder_tree.py mode) or ``"naive"``
  (strictly sequential fragments).  Both produce *real* micro-op
  programs; cycle counts are measured program lengths, not estimates.

Area proxy: the PE's register file (4 x 16 latch bits) is modelled as
``REG_AREA_FRACTION`` of the 1530 um^2 Table II PE and scales linearly
with ``reg_bits``; everything else (neurons, muxes, control) is
invariant.  The proxy exists to rank configs, not to re-floorplan the
chip — it reuses Fig 7's memory/control blocks unchanged.

Failure modes: ``tree_capacity`` raises ValueError below 6 register
bits (a single leaf's 2-bit result plus ripple-add working set no
longer fits); ``pe_node_cycles`` is exact for any ``n >= 1``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

from repro_torch.core.adder_tree import (ScheduleResult, schedule_tree,
                                   storage_bound)
from repro_torch.core.energy import CellSpecs, mac_cycles
from repro_torch.core.mapping import TULIP, YODANN, ArchParams

# the paper's §IV-C accumulator is 10 bits: one adder tree sums at
# most 1023 product bits regardless of how much register storage the
# RPO bound would admit (the bit-serial comparator is sized for it)
ACCUMULATOR_CAP = 1023

# fraction of the Table II 1530 um^2 PE attributed to the 4 x 16-bit
# latch register file (64 latch bits at ~12 um^2/bit in 40 nm)
REG_AREA_FRACTION = 0.5

SCHEDULES = ("compact", "naive")


def tree_capacity(reg_bits: int) -> int:
    """Max adder-tree inputs a PE with ``reg_bits``-bit registers can
    schedule: the largest N whose §III-B storage bound fits in the
    4 * reg_bits available latch bits, clamped to the 10-bit
    accumulator (1023).  ``tree_capacity(16) == 1023`` — the CAP the
    default energy model chunks with."""
    if reg_bits < 6:
        raise ValueError(f"reg_bits={reg_bits}: a TULIP-PE needs >= 6 "
                         f"bits per register to hold even one leaf sum")
    cap, n = 1, 1
    # storage_bound depends only on floor(log2 n): if 2^k fits, the
    # whole band up to 2^(k+1)-1 fits
    while n <= ACCUMULATOR_CAP and storage_bound(n) <= 4 * reg_bits:
        cap = min(2 * n - 1, ACCUMULATOR_CAP)
        n *= 2
    return cap


@lru_cache(maxsize=None)
def _tree(n: int, threshold: int | None, compact: bool,
          n_ext: int) -> ScheduleResult:
    """Cached real schedule for an n-input tree (optionally with the
    on-PE `>= threshold` compare fragment appended)."""
    return schedule_tree(n, threshold=threshold, compact=compact,
                         n_ext=n_ext)


@dataclass(frozen=True)
class MeshConfig:
    """One design point: PE count x register bits x schedule variant.

    The default is the paper's TULIP chip (256 PEs, 4 x 16-bit
    registers, compacted schedules); ``mac_baseline()`` is the YodaNN
    configuration every energy ratio is measured against."""

    n_pes: int = 256
    reg_bits: int = 16
    schedule: str = "compact"
    n_macs: int = 32
    n_ext: int = 4

    def __post_init__(self) -> None:
        if self.schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}, "
                             f"got {self.schedule!r}")
        if self.n_pes < 0 or self.n_macs <= 0:
            raise ValueError("n_pes must be >= 0 and n_macs > 0")
        if self.n_pes:
            tree_capacity(self.reg_bits)    # raises if registers too small

    @property
    def name(self) -> str:
        if not self.n_pes:
            return "mac-baseline"
        return f"pe{self.n_pes}-r{self.reg_bits}-{self.schedule}"

    @property
    def compact(self) -> bool:
        return self.schedule == "compact"

    @property
    def capacity(self) -> int:
        """Adder-tree input capacity at this register size."""
        return tree_capacity(self.reg_bits)

    @classmethod
    def mac_baseline(cls) -> "MeshConfig":
        """The YodaNN-style all-MAC chip (n_pes = 0)."""
        return cls(n_pes=0)

    # ---------------------------------------------------------------- #
    def arch(self) -> ArchParams:
        """The core/mapping.py architecture this mesh schedules as.
        ``ofm_batch_pe`` IS the PE count: one OFM per PE per batch."""
        if not self.n_pes:
            return YODANN
        if self.n_pes == TULIP.n_pes and self.n_macs == TULIP.n_macs:
            return TULIP
        return ArchParams(self.name, n_macs=self.n_macs,
                          n_pes=self.n_pes, ofm_batch_pe=self.n_pes)

    def node_schedule(self, n: int,
                      threshold: int | None = None) -> ScheduleResult:
        """The real micro-op schedule for one <= capacity chunk —
        exactly what the simulator feeds to core.tulip_pe.run_numpy."""
        if n > self.capacity:
            raise ValueError(f"{n}-input chunk exceeds capacity "
                             f"{self.capacity} at reg_bits={self.reg_bits}")
        return _tree(n, threshold, self.compact, self.n_ext)

    def chunk_sizes(self, n: int) -> list[int]:
        """Even split of an n-input node into <= capacity chunks whose
        partial popcounts accumulate on the PE (paper Fig 4(c))."""
        cap = self.capacity
        if n <= cap:
            return [n]
        chunks = math.ceil(n / cap)
        per = math.ceil(n / chunks)
        sizes, left = [], n
        for _ in range(chunks):
            take = min(per, left)
            sizes.append(take)
            left -= take
        return sizes

    def pe_node_cycles(self, n_inputs: int, accumulate: bool = False,
                       compare: bool = False) -> int:
        """TULIP-PE cycles for an n-input popcount node under THIS
        config — the ``pe_cycles_fn`` hook for core.energy.evaluate.
        Identical to core.energy.pe_cycles at the default config (the
        parity is asserted by tests/test_sim.py); the tree term is the
        measured length of the real scheduled program."""
        sizes = self.chunk_sizes(n_inputs)
        if len(sizes) == 1:
            base = self.node_schedule(n_inputs).cycles
            extra = 0
            if accumulate:      # fold the partial into the running sum
                width = max(1, n_inputs.bit_length())
                extra += 2 * (width + 2)
            if compare:
                extra += n_inputs.bit_length() + 2
            return base + extra
        total = sum(self.pe_node_cycles(s, accumulate=True)
                    for s in sizes)
        if compare:
            total += 16 + 2
        return total

    def unit_cycles(self, node_inputs: int, accumulate: bool,
                    uses_pe: bool, spec: CellSpecs | None = None) -> int:
        """Per-output-node unit cycles: PE schedule or MAC anchor."""
        if uses_pe:
            return self.pe_node_cycles(node_inputs, accumulate=accumulate,
                                       compare=True)
        return mac_cycles(node_inputs, spec or CellSpecs())

    # ---------------------------------------------------------------- #
    def pe_area_um2(self, spec: CellSpecs | None = None) -> float:
        """Table II PE area with the register file scaled to reg_bits."""
        spec = spec or CellSpecs()
        reg = REG_AREA_FRACTION * spec.pe_area_um2
        fixed = spec.pe_area_um2 - reg
        return fixed + reg * (self.reg_bits / 16.0)

    def area_um2(self, spec: CellSpecs | None = None) -> float:
        """Chip area proxy: units + Fig 7 memory/control, mirroring
        core.energy.chip_area_um2 with the scaled PE."""
        spec = spec or CellSpecs()
        if self.n_pes:
            units = (self.n_pes * self.pe_area_um2(spec)
                     + self.n_macs * spec.smac_area_um2)
        else:
            units = self.n_macs * spec.mac_area_um2
        return units + spec.mem_area_um2 + spec.ctrl_area_um2
