"""Micro-op ISA for the TULIP-PE (paper §IV-A, Fig 3).

A copy of ``repro.core.isa``: the port imports nothing of the
JAX package.

A TULIP-PE is 4 fully-connected [2,1,1,1;T] neurons (N1..N4), each with a
16-bit local register built from latches.  Per clock cycle the controller
(the "reconfigurable sequence generator" of §IV-E) drives, for each neuron:

  * the input-mux selects for its four ports a, b, c, d,
  * per-port inversion flags (the LIN/RIN on/off-set mapping),
  * the threshold T (T = 0 encodes HOLD: the output latch keeps its value),
  * an optional write of the neuron output into one bit of its own register.

Structural constraints modeled after the paper:
  * ports **b and c are shared buses** across all four neurons ("All 4
    neurons of a TULIP-PE share their inputs b and c");
  * a register can only be read by *its own* neuron (local registers), and
    values are shared by *broadcasting* them through the neuron;
  * the full adder is a **cascade of two neurons** — i.e. a neuron may read
    the value another neuron computes *in the same cycle* (combinational
    chaining inside the 2.3 ns period; two 384 ps cell delays fit).  A
    same-cycle ("fresh") read is only legal from a neuron at a strictly
    smaller `stage`, which the validator enforces (no combinational loops).

Source encoding (integers):
  0           -> constant 0
  1           -> constant 1
  2 + k       -> output of neuron k (k in 0..3)
  6 + ch      -> external input channel ch (ch in 0..n_ext-1)
  EXT_BASE+16 + bit -> own register bit (ports a/d only)

Failure modes — ``Program.validate()`` (run by ``pack()``, so every
execution path hits it) rejects structurally impossible programs
rather than silently mis-simulating them:

* a register source on a shared bus (registers are neuron-local;
  values travel only by broadcasting through a neuron) — bus
  conflicts cannot be expressed at all: each cycle carries exactly
  one ``bus_b``/``bus_c`` source;
* a ``fresh`` read (direct or via a bus) from a neuron at an equal
  or later ``stage`` — a combinational loop the silicon cannot form;
* thresholds outside 0..6 (0 is HOLD; 1..6 are the reachable
  [2,1,1,1;T] configurations of the mixed-signal cell), and any
  out-of-bounds external channel, register bit, or write bit.

Cycle counts are the unit of time everywhere downstream: one
``Cycle`` == one clock tick; ``core.energy`` converts them to seconds
and Joules, never this module.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

ZERO = 0
ONE = 1
NEURON_BASE = 2
EXT_BASE = 6
REG_BASE = 22         # 6 + 16 ext channels max
N_NEURONS = 4
N_REG_BITS = 16
HOLD = 0              # thr == 0 means hold output latch

N_PORTS = 4           # a, b, c, d
PORT_A, PORT_B, PORT_C, PORT_D = range(4)


def N(k: int, fresh: bool = False) -> "Src":
    return Src(NEURON_BASE + k, fresh)


def EXT(ch: int) -> "Src":
    return Src(EXT_BASE + ch)


def REG(bit: int) -> "Src":
    return Src(REG_BASE + bit)


@dataclass(frozen=True)
class Src:
    code: int
    fresh: bool = False
    inv: bool = False

    def __invert__(self) -> "Src":
        return Src(self.code, self.fresh, not self.inv)

    @property
    def is_neuron(self) -> bool:
        return NEURON_BASE <= self.code < EXT_BASE

    @property
    def is_reg(self) -> bool:
        return self.code >= REG_BASE

    @property
    def is_ext(self) -> bool:
        return EXT_BASE <= self.code < REG_BASE


Z = Src(ZERO)


@dataclass
class NeuronOp:
    """One neuron's configuration for one cycle."""
    a: Src = Z
    d: Src = Z
    # b/c come from the shared buses; per-neuron we only keep enable+invert
    b_en: bool = False
    b_inv: bool = False
    c_en: bool = False
    c_inv: bool = False
    thr: int = HOLD
    stage: int = 0
    write_bit: Optional[int] = None   # write own output to register bit


@dataclass
class Cycle:
    bus_b: Src = Z
    bus_c: Src = Z
    neurons: List[NeuronOp] = field(
        default_factory=lambda: [NeuronOp() for _ in range(N_NEURONS)])
    label: str = ""


@dataclass
class Program:
    cycles: List[Cycle] = field(default_factory=list)
    n_ext: int = 4

    def __len__(self) -> int:
        return len(self.cycles)

    # ---- packed representation for the vectorized simulators ------------
    def pack(self) -> dict:
        T = len(self.cycles)

        def arr(*s):
            return np.zeros(s, dtype=np.int32)

        out = {
            "bus_src": arr(T, 2), "bus_fresh": arr(T, 2), "bus_inv": arr(T, 2),
            "sel": arr(T, N_NEURONS, 2),       # ports a, d
            "sel_fresh": arr(T, N_NEURONS, 2),
            "sel_inv": arr(T, N_NEURONS, 2),
            "bc_en": arr(T, N_NEURONS, 2),     # ports b, c enables
            "bc_inv": arr(T, N_NEURONS, 2),
            "thr": arr(T, N_NEURONS),
            "stage": arr(T, N_NEURONS),
            "wr_en": arr(T, N_NEURONS),
            "wr_bit": arr(T, N_NEURONS),
        }
        for t, cy in enumerate(self.cycles):
            for j, bus in enumerate((cy.bus_b, cy.bus_c)):
                out["bus_src"][t, j] = bus.code
                out["bus_fresh"][t, j] = int(bus.fresh)
                out["bus_inv"][t, j] = int(bus.inv)
            for n, op in enumerate(cy.neurons):
                for j, s in enumerate((op.a, op.d)):
                    out["sel"][t, n, j] = s.code
                    out["sel_fresh"][t, n, j] = int(s.fresh)
                    out["sel_inv"][t, n, j] = int(s.inv)
                out["bc_en"][t, n, 0] = int(op.b_en)
                out["bc_en"][t, n, 1] = int(op.c_en)
                out["bc_inv"][t, n, 0] = int(op.b_inv)
                out["bc_inv"][t, n, 1] = int(op.c_inv)
                out["thr"][t, n] = op.thr
                out["stage"][t, n] = op.stage
                out["wr_en"][t, n] = int(op.write_bit is not None)
                out["wr_bit"][t, n] = op.write_bit or 0
        return out

    def validate(self) -> None:
        """Enforce the structural constraints described in the docstring."""
        for t, cy in enumerate(self.cycles):
            for bus, name in ((cy.bus_b, "b"), (cy.bus_c, "c")):
                if bus.is_reg:
                    raise ValueError(
                        f"cycle {t}: bus {name} cannot read a register "
                        "directly (local registers broadcast via neurons)")
                if bus.is_ext and bus.code - EXT_BASE >= self.n_ext:
                    raise ValueError(f"cycle {t}: bus {name} ext channel OOB")
            stages = [op.stage for op in cy.neurons]
            for n, op in enumerate(cy.neurons):
                if not (0 <= op.thr <= 6):
                    raise ValueError(f"cycle {t} N{n+1}: thr {op.thr} out of "
                                     "range (cell supports T in 0..6)")
                for s, pname in ((op.a, "a"), (op.d, "d")):
                    if s.is_ext and s.code - EXT_BASE >= self.n_ext:
                        raise ValueError(f"cycle {t} N{n+1}.{pname}: ext OOB")
                    if s.is_reg and not (0 <= s.code - REG_BASE < N_REG_BITS):
                        raise ValueError(f"cycle {t} N{n+1}.{pname}: reg OOB")
                    if s.is_neuron and s.fresh:
                        src_n = s.code - NEURON_BASE
                        if stages[src_n] >= op.stage:
                            raise ValueError(
                                f"cycle {t} N{n+1}.{pname}: fresh read of "
                                f"N{src_n+1} requires stage[{src_n}] < "
                                f"stage[{n}] (combinational order)")
                for bus, en in ((cy.bus_b, op.b_en), (cy.bus_c, op.c_en)):
                    if en and bus.is_neuron and bus.fresh:
                        src_n = bus.code - NEURON_BASE
                        if stages[src_n] >= op.stage:
                            raise ValueError(
                                f"cycle {t} N{n+1}: fresh bus read of "
                                f"N{src_n+1} violates stage order")
                if op.write_bit is not None and not (
                        0 <= op.write_bit < N_REG_BITS):
                    raise ValueError(f"cycle {t} N{n+1}: write bit OOB")


class ProgramBuilder:
    """Convenience builder used by the schedule generators."""

    def __init__(self, n_ext: int = 4):
        self.program = Program(n_ext=n_ext)

    def cycle(self, label: str = "") -> Cycle:
        cy = Cycle(label=label)
        self.program.cycles.append(cy)
        return cy

    def last(self) -> Cycle:
        return self.program.cycles[-1]

    def neuron(self, cy: Cycle, n: int, *, a: Src = Z, d: Src = Z,
               b: Optional[bool] = None, b_inv: bool = False,
               c: Optional[bool] = None, c_inv: bool = False,
               thr: int = HOLD, stage: int = 0,
               write_bit: Optional[int] = None) -> None:
        op = cy.neurons[n]
        op.a, op.d = a, d
        op.b_en = bool(b)
        op.b_inv = b_inv
        op.c_en = bool(c)
        op.c_inv = c_inv
        op.thr = thr
        op.stage = stage
        op.write_bit = write_bit

    def finish(self) -> Program:
        self.program.validate()
        return self.program
