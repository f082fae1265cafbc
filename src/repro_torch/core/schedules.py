"""Micro-op schedules for the TULIP-PE primitives (paper §IV-C, §IV-D).

A copy of ``repro.core.schedules``: the port imports nothing of the
JAX package.

Each builder returns a :class:`Fragment` — a short micro-op program plus
the resource/hazard metadata (neuron busy intervals, bus and external-
channel usage, register reads/writes) that the RPO list scheduler in
``adder_tree.py`` uses to place fragments on the global timeline (and,
with compaction enabled, to overlap non-conflicting fragments).

Conventions:
  * operands are stored little-endian in a neuron's local register;
  * a value is *broadcast* by its owning neuron reading its own register
    bit on port d with T=1 (identity);
  * the full adder is the 2-neuron cascade: carry = MAJ on the carry
    neuron (stage 1), sum = [2,1,1,1;3] with a = ~carry_out (fresh) on the
    sum neuron (stage 2) — 1 cycle per bit.

Invariants the scheduler (and therefore ``repro_torch.sim``) relies on:

* A fragment's ``cycles`` list is its exact cycle cost at placement;
  builders never emit variable-latency ops.  The hazard lists
  (``reg_reads``/``reg_writes``, neuron busy intervals, bus/ext
  usage) must cover *every* access a fragment performs — an
  undeclared hazard is the one failure mode compaction cannot detect,
  so builders are written against it and the tests in
  tests/test_tulip_core.py run compact vs naive placements against
  each other across tree sizes.
* Operand widths are in bits, little-endian, and grow as
  ``ceil(log2(n))+1`` up the adder tree; the popcount of n inputs
  therefore needs the ``storage_bound(n)`` register bits that
  ``adder_tree`` budgets and ``sim.mesh.tree_capacity`` inverts into
  a per-PE fan-in capacity.
* Fragments assume registers start zeroed unless preloaded via
  ``run_*``'s ``init_regs``; external bits are consumed at the exact
  cycles recorded in the ext layout (``make_ext_inputs`` materializes
  that timetable).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.isa import (EXT, HOLD, N, N_NEURONS, REG, Z, Cycle,
                            NeuronOp, Program, Src)


@dataclass
class FragCycle:
    """One cycle of a fragment: per-neuron ops + bus requirements."""
    neurons: Dict[int, NeuronOp] = field(default_factory=dict)
    bus_b: Optional[Src] = None
    bus_c: Optional[Src] = None
    ext: Dict[int, int] = field(default_factory=dict)  # channel -> input id
    label: str = ""


@dataclass
class Fragment:
    cycles: List[FragCycle] = field(default_factory=list)
    # register hazards: (t, neuron, bit)
    reg_reads: List[Tuple[int, int, int]] = field(default_factory=list)
    reg_writes: List[Tuple[int, int, int]] = field(default_factory=list)
    # which (neuron, cycle-range) latches carry live state
    label: str = ""

    def neuron_busy(self) -> Dict[int, Tuple[int, int]]:
        """Neuron n is occupied [first, last] cycle it is configured.

        A neuron whose latch carries state between its uses must not be
        touched by another fragment in between, so we occupy the full
        first..last span.
        """
        busy: Dict[int, Tuple[int, int]] = {}
        for t, cy in enumerate(self.cycles):
            for n in cy.neurons:
                if n in busy:
                    busy[n] = (busy[n][0], t)
                else:
                    busy[n] = (t, t)
        return busy

    def n_cycles(self) -> int:
        return len(self.cycles)


def _op(cy: FragCycle, n: int, *, a: Src = Z, d: Src = Z,
        b: bool = False, b_inv: bool = False,
        c: bool = False, c_inv: bool = False,
        thr: int = HOLD, stage: int = 0, write_bit: Optional[int] = None):
    cy.neurons[n] = NeuronOp(a=a, d=d, b_en=b, b_inv=b_inv, c_en=c,
                             c_inv=c_inv, thr=thr, stage=stage,
                             write_bit=write_bit)


# ------------------------------------------------------------------ #
# addition: dst = x + y  (paper Fig 4(a)/(b))                          #
# ------------------------------------------------------------------ #
def add_fragment(bx: int, by: int, ns: int, nc: int,
                 xbits: Sequence[int], ybits: Sequence[int],
                 dst_bits: Sequence[int]) -> Fragment:
    """Ripple add of two register operands.

    bx/by broadcast operand bits from their own registers; nc accumulates
    the carry; ns produces sum bits into its own register at dst_bits.
    len(dst_bits) == max(len(x), len(y)) + 1.
    """
    assert len({bx, by, ns, nc}) == 4, "roles must be distinct neurons"
    k = max(len(xbits), len(ybits))
    assert len(dst_bits) == k + 1
    f = Fragment(label=f"add{k}")

    # reset carry: nc fires T=1 with all-zero inputs -> 0
    cy = FragCycle(label="rst")
    _op(cy, nc, thr=1, stage=0)
    f.cycles.append(cy)

    for i in range(k):
        cy = FragCycle(label=f"bit{i}")
        cy.bus_b = N(bx, fresh=True)
        cy.bus_c = N(by, fresh=True)
        # broadcasters (stage 0) read their own register bit (or 0)
        if i < len(xbits):
            _op(cy, bx, d=REG(xbits[i]), thr=1, stage=0)
            f.reg_reads.append((len(f.cycles), bx, xbits[i]))
        else:
            _op(cy, bx, thr=1, stage=0)           # broadcast 0
        if i < len(ybits):
            _op(cy, by, d=REG(ybits[i]), thr=1, stage=0)
            f.reg_reads.append((len(f.cycles), by, ybits[i]))
        else:
            _op(cy, by, thr=1, stage=0)
        # carry (stage 1): MAJ(x_i, y_i, c_i);  d = own previous = c_i
        _op(cy, nc, b=True, c=True, d=N(nc), thr=2, stage=1)
        # sum (stage 2): a = ~carry_out (fresh), d = carry_in (prev)
        _op(cy, ns, a=~N(nc, fresh=True), b=True, c=True, d=N(nc),
            thr=3, stage=2, write_bit=dst_bits[i])
        f.reg_writes.append((len(f.cycles), ns, dst_bits[i]))
        f.cycles.append(cy)

    # store carry-out as msb
    cy = FragCycle(label="msb")
    _op(cy, ns, d=N(nc), thr=1, stage=0, write_bit=dst_bits[k])
    f.reg_writes.append((len(f.cycles), ns, dst_bits[k]))
    f.cycles.append(cy)
    return f


# ------------------------------------------------------------------ #
# leaf: dst = x + y + z, three 1-bit external inputs (Fig 2(b) inset)  #
# ------------------------------------------------------------------ #
def leaf_fragment(ns: int, nc: int, input_ids: Sequence[int],
                  dst_bits: Sequence[int],
                  ext_channels: Sequence[int] = (0, 1, 2)) -> Fragment:
    """Sum of up to 3 external 1-bit inputs -> 2-bit result in ns's reg."""
    assert ns != nc and 1 <= len(input_ids) <= 3 and len(dst_bits) == 2
    f = Fragment(label=f"leaf{len(input_ids)}")
    ch = list(ext_channels)[:len(input_ids)]

    cy = FragCycle(label="sum")
    for c_, iid in zip(ch, input_ids):
        cy.ext[c_] = iid
    srcs = [EXT(c_) for c_ in ch] + [Z] * (3 - len(ch))
    cy.bus_b, cy.bus_c = srcs[0], srcs[1]
    # carry (stage 0) = MAJ(x,y,z)
    _op(cy, nc, b=True, c=True, d=srcs[2], thr=2, stage=0)
    # sum (stage 1) = x + y + z - 2*carry >= 1
    _op(cy, ns, a=~N(nc, fresh=True), b=True, c=True, d=srcs[2],
        thr=3, stage=1, write_bit=dst_bits[0])
    f.reg_writes.append((0, ns, dst_bits[0]))
    f.cycles.append(cy)

    cy = FragCycle(label="msb")
    _op(cy, ns, d=N(nc), thr=1, stage=0, write_bit=dst_bits[1])
    f.reg_writes.append((1, ns, dst_bits[1]))
    f.cycles.append(cy)
    return f


# ------------------------------------------------------------------ #
# accumulate: acc_new = acc + ext_value  (paper Fig 4(c))              #
# ------------------------------------------------------------------ #
def accumulate_fragment(bacc: int, ns: int, nc: int,
                        acc_bits: Sequence[int], in_width: int,
                        dst_bits: Sequence[int],
                        ext_channel: int = 0,
                        input_ids: Optional[Sequence[int]] = None) -> Fragment:
    """Add a bit-serial external operand to the accumulator held in bacc's
    register; result lands in ns's register (storage alternates between
    registers across successive accumulations, as in Fig 4(c))."""
    assert len({bacc, ns, nc}) == 3
    k = max(len(acc_bits), in_width)
    assert len(dst_bits) == k + 1
    f = Fragment(label=f"acc{k}")

    cy = FragCycle(label="rst")
    _op(cy, nc, thr=1, stage=0)
    f.cycles.append(cy)

    for i in range(k):
        cy = FragCycle(label=f"bit{i}")
        cy.bus_b = N(bacc, fresh=True)
        cy.bus_c = EXT(ext_channel) if i < in_width else Z
        if i < in_width:
            cy.ext[ext_channel] = (input_ids[i] if input_ids is not None
                                   else -1)
        if i < len(acc_bits):
            _op(cy, bacc, d=REG(acc_bits[i]), thr=1, stage=0)
            f.reg_reads.append((len(f.cycles), bacc, acc_bits[i]))
        else:
            _op(cy, bacc, thr=1, stage=0)
        _op(cy, nc, b=True, c=i < in_width, d=N(nc), thr=2, stage=1)
        _op(cy, ns, a=~N(nc, fresh=True), b=True, c=i < in_width, d=N(nc),
            thr=3, stage=2, write_bit=dst_bits[i])
        f.reg_writes.append((len(f.cycles), ns, dst_bits[i]))
        f.cycles.append(cy)

    cy = FragCycle(label="msb")
    _op(cy, ns, d=N(nc), thr=1, stage=0, write_bit=dst_bits[k])
    f.reg_writes.append((len(f.cycles), ns, dst_bits[k]))
    f.cycles.append(cy)
    return f


# ------------------------------------------------------------------ #
# comparison: z = (x > y), bit-serial LSB->MSB (paper Fig 5(a))        #
# ------------------------------------------------------------------ #
def compare_fragment(bx: int, nz: int, xbits: Sequence[int],
                     const: Optional[int] = None,
                     by: Optional[int] = None,
                     ybits: Optional[Sequence[int]] = None,
                     out_bit: Optional[int] = None) -> Fragment:
    """z_i = x_i if x_i != y_i else z_{i-1};  y is either a register
    operand broadcast by `by` or a schedule-time constant (batch-norm
    threshold folded into the comparison, paper §IV-D)."""
    assert (const is None) != (ybits is None and by is None) or const is not None
    k = len(xbits)
    f = Fragment(label=f"cmp{k}")

    cy = FragCycle(label="rst")
    _op(cy, nz, thr=1, stage=0)
    f.cycles.append(cy)

    for i in range(k):
        cy = FragCycle(label=f"bit{i}")
        cy.bus_b = N(bx, fresh=True)
        _op(cy, bx, d=REG(xbits[i]), thr=1, stage=0)
        f.reg_reads.append((len(f.cycles), bx, xbits[i]))
        if const is not None:
            ybit = (const >> i) & 1
            cy.bus_c = Src(1) if ybit else Z
        else:
            cy.bus_c = N(by, fresh=True)
            if i < len(ybits):
                _op(cy, by, d=REG(ybits[i]), thr=1, stage=0)
                f.reg_reads.append((len(f.cycles), by, ybits[i]))
            else:
                _op(cy, by, thr=1, stage=0)
        wb = out_bit if (i == k - 1 and out_bit is not None) else None
        _op(cy, nz, b=True, c=True, c_inv=True, d=N(nz), thr=2, stage=1,
            write_bit=wb)
        if wb is not None:
            f.reg_writes.append((len(f.cycles), nz, wb))
        f.cycles.append(cy)
    return f


# ------------------------------------------------------------------ #
# max-pool: OR of external inputs (paper Fig 5(b))                     #
# ------------------------------------------------------------------ #
def maxpool_fragment(n: int, input_ids: Sequence[int],
                     out_bit: Optional[int] = None,
                     n_ext: int = 4) -> Fragment:
    """OR-reduce a pooling window delivered on the external channels;
    window size 4 is a single cycle ([2,1,1,1;1]); larger windows chain
    through the output latch (3 new inputs per cycle)."""
    f = Fragment(label=f"max{len(input_ids)}")
    ids = list(input_ids)
    first = True
    while ids:
        take = ids[:4] if first else ids[:3]
        ids = ids[len(take):]
        cy = FragCycle(label="or")
        chans = list(range(len(take)))
        for c_, iid in zip(chans, take):
            cy.ext[c_] = iid
        srcs = [EXT(c_) for c_ in chans] + [Z] * (4 - len(take))
        if first:
            cy.bus_b, cy.bus_c = srcs[1], srcs[2]
            _op(cy, n, a=srcs[0], b=True, c=True, d=srcs[3], thr=1, stage=0)
        else:
            cy.bus_b, cy.bus_c = srcs[0], srcs[1]
            # running OR: a = own latch (weight 2, fine for OR)
            _op(cy, n, a=N(n), b=True, c=True, d=srcs[2], thr=1, stage=0)
        wb = out_bit if (not ids and out_bit is not None) else None
        if wb is not None:
            cy.neurons[n].write_bit = wb
            f.reg_writes.append((len(f.cycles), n, wb))
        f.cycles.append(cy)
        first = False
    return f


# ------------------------------------------------------------------ #
# RELU: out_i = cmp AND x_i  (paper §IV-D, [1,1;2])                    #
# ------------------------------------------------------------------ #
def relu_fragment(bx: int, nz: int, nr: int, xbits: Sequence[int],
                  dst_bits: Sequence[int]) -> Fragment:
    """Gate the value broadcast by bx with the comparator result held in
    nz's latch; AND = [1,1;2] on ports b,c."""
    assert len({bx, nz, nr}) == 3 and len(dst_bits) == len(xbits)
    f = Fragment(label=f"relu{len(xbits)}")
    for i, (xb, db) in enumerate(zip(xbits, dst_bits)):
        cy = FragCycle(label=f"bit{i}")
        cy.bus_b = N(bx, fresh=True)
        cy.bus_c = N(nz)              # comparator result, held
        _op(cy, bx, d=REG(xb), thr=1, stage=0)
        f.reg_reads.append((i, bx, xb))
        _op(cy, nr, b=True, c=True, thr=2, stage=1, write_bit=db)
        f.reg_writes.append((i, nr, db))
        # nz must hold its value: occupy it
        _op(cy, nz, thr=HOLD, stage=0)
        f.cycles.append(cy)
    return f


# ------------------------------------------------------------------ #
# copy: move bits between registers via broadcast                      #
# ------------------------------------------------------------------ #
def copy_fragment(bx: int, nd: int, xbits: Sequence[int],
                  dst_bits: Sequence[int]) -> Fragment:
    assert bx != nd and len(xbits) == len(dst_bits)
    f = Fragment(label=f"copy{len(xbits)}")
    for i, (xb, db) in enumerate(zip(xbits, dst_bits)):
        cy = FragCycle(label=f"bit{i}")
        cy.bus_b = N(bx, fresh=True)
        _op(cy, bx, d=REG(xb), thr=1, stage=0)
        f.reg_reads.append((i, bx, xb))
        _op(cy, nd, b=True, thr=1, stage=1, write_bit=db)
        f.reg_writes.append((i, nd, db))
        f.cycles.append(cy)
    return f


def fragments_to_program(frags: Sequence[Fragment], starts: Sequence[int],
                         n_ext: int = 4) -> Tuple[Program, Dict[int, Tuple[int, int]]]:
    """Merge placed fragments into a Program.

    Returns (program, ext_layout) where ext_layout maps input id ->
    (cycle, channel) for building the external input array.
    """
    total = max(s + f.n_cycles() for f, s in zip(frags, starts)) if frags else 0
    cycles = [Cycle() for _ in range(total)]
    ext_layout: Dict[int, Tuple[int, int]] = {}
    for f, s in zip(frags, starts):
        for dt, fc in enumerate(f.cycles):
            cy = cycles[s + dt]
            for n, op in fc.neurons.items():
                if cy.neurons[n].thr != HOLD or cy.neurons[n].write_bit is not None:
                    raise ValueError(
                        f"neuron N{n+1} double-booked at cycle {s+dt}")
                cy.neurons[n] = op
            if fc.bus_b is not None and fc.bus_b != Z:
                if cy.bus_b != Z and cy.bus_b != fc.bus_b:
                    raise ValueError(f"bus b conflict at cycle {s+dt}")
                cy.bus_b = fc.bus_b
            if fc.bus_c is not None and fc.bus_c != Z:
                if cy.bus_c != Z and cy.bus_c != fc.bus_c:
                    raise ValueError(f"bus c conflict at cycle {s+dt}")
                cy.bus_c = fc.bus_c
            for ch, iid in fc.ext.items():
                if iid >= 0:
                    ext_layout[iid] = (s + dt, ch)
            if fc.label and not cy.label:
                cy.label = f.label + ":" + fc.label
    prog = Program(cycles=cycles, n_ext=n_ext)
    prog.validate()
    return prog, ext_layout
