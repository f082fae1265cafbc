"""Adder-tree decomposition and RPO scheduling (paper §III, §IV-B).

A copy of ``repro.core.adder_tree``: the port imports nothing of the
JAX package.

A BNN node computes ``popcount(xnor(x, w)) >= T`` over N inputs.  The
N-input popcount is decomposed into a balanced binary tree whose leaves
sum 3 product bits and whose internal nodes are bounded-width ripple adds
executed on a TULIP-PE (4 neurons, 4x16-bit local registers).

Scheduling is reverse post-order (RPO): a node runs after its left and
right subtrees, which provably bounds live intermediate storage to
``(L^2 + L)/2 + 1`` bits with ``L = floor(log2 N)`` (§III-B).

Two placement modes:
  * ``compact=False`` — fragments strictly sequential (one op at a time);
  * ``compact=True``  — greedy earliest-start list scheduling with full
    resource (neurons / buses / ext channels) and register read/write
    hazard tracking; non-conflicting fragments overlap (e.g. a leaf's
    msb-store cycle hides under the next leaf's compute cycle).

The paper reports 441 cycles for a 288-input node; our reconstructed
schedule lands in the same regime (naive > paper > compacted), and the
exact figures are reported in benchmarks/table2.py.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.isa import N_NEURONS, N_REG_BITS, Program, Src
from repro_torch.core.schedules import (Fragment, add_fragment, compare_fragment,
                                  copy_fragment, fragments_to_program,
                                  leaf_fragment)


# ------------------------------------------------------------------ #
# tree construction                                                    #
# ------------------------------------------------------------------ #
@dataclass
class TreeNode:
    inputs: Optional[List[int]] = None       # leaf: product-bit ids
    left: Optional["TreeNode"] = None
    right: Optional["TreeNode"] = None
    n_inputs: int = 0

    @property
    def is_leaf(self) -> bool:
        return self.inputs is not None

    @property
    def width(self) -> int:
        """Bits needed for the node's maximum value (= its input count)."""
        return max(1, self.n_inputs.bit_length())

    def depth(self) -> int:
        if self.is_leaf:
            return 0
        return 1 + max(self.left.depth(), self.right.depth())


def build_tree(n_inputs: int, leaf_size: int = 3) -> TreeNode:
    assert 1 <= n_inputs
    ids = list(range(n_inputs))
    leaves = [TreeNode(inputs=ids[i:i + leaf_size],
                       n_inputs=len(ids[i:i + leaf_size]))
              for i in range(0, n_inputs, leaf_size)]

    def merge(nodes: List[TreeNode]) -> TreeNode:
        if len(nodes) == 1:
            return nodes[0]
        mid = (len(nodes) + 1) // 2
        l, r = merge(nodes[:mid]), merge(nodes[mid:])
        return TreeNode(left=l, right=r, n_inputs=l.n_inputs + r.n_inputs)

    return merge(leaves)


def storage_bound(n_inputs: int) -> int:
    """Paper §III-B: (floor(log2 N)^2 + floor(log2 N))/2 + 1 bits."""
    L = int(math.floor(math.log2(max(n_inputs, 2))))
    return (L * L + L) // 2 + 1


# ------------------------------------------------------------------ #
# register allocator + storage accounting                              #
# ------------------------------------------------------------------ #
class _Value:
    """Handle to a live intermediate result (mutated on relocation)."""
    __slots__ = ("neuron", "bits")

    def __init__(self, neuron: int, bits: List[int]):
        self.neuron, self.bits = neuron, bits


class RegAllocator:
    def __init__(self):
        self.free: List[List[int]] = [list(range(N_REG_BITS))
                                      for _ in range(N_NEURONS)]
        self.in_use = 0
        self.peak = 0

    def capacity(self, n: int) -> int:
        return len(self.free[n])

    def alloc(self, n: int, k: int) -> List[int]:
        if len(self.free[n]) < k:
            raise MemoryError(
                f"register R{n+1} out of bits (need {k}, have "
                f"{len(self.free[n])}); node too large for one TULIP-PE")
        bits = [self.free[n].pop(0) for _ in range(k)]
        self.in_use += k
        self.peak = max(self.peak, self.in_use)
        return bits

    def release(self, n: int, bits: Sequence[int]) -> None:
        for b in bits:
            self.free[n].append(b)
        self.free[n].sort()
        self.in_use -= len(bits)


# ------------------------------------------------------------------ #
# global timeline for compacting list scheduler                        #
# ------------------------------------------------------------------ #
class Timeline:
    def __init__(self):
        self.neuron_busy: List[List[Tuple[int, int]]] = [[] for _ in range(N_NEURONS)]
        self.bus: Dict[Tuple[int, int], Src] = {}   # (cycle, bus) -> src
        self.ext: Dict[int, set] = {}               # cycle -> channels
        self.last_write: Dict[Tuple[int, int], int] = {}
        self.last_read: Dict[Tuple[int, int], int] = {}
        self.end = 0

    def feasible(self, frag: Fragment, s: int) -> bool:
        for n, (b0, b1) in frag.neuron_busy().items():
            for (o0, o1) in self.neuron_busy[n]:
                if s + b0 <= o1 and o0 <= s + b1:
                    return False
        for dt, fc in enumerate(frag.cycles):
            t = s + dt
            for j, bsrc in enumerate((fc.bus_b, fc.bus_c)):
                if bsrc is not None and bsrc.code != 0:
                    cur = self.bus.get((t, j))
                    if cur is not None and cur != bsrc:
                        return False
            if fc.ext:
                used = self.ext.get(t, set())
                if used & set(fc.ext):
                    return False
        for (t, n, bit) in frag.reg_reads:
            w = self.last_write.get((n, bit))
            if w is not None and s + t <= w:
                return False
        for (t, n, bit) in frag.reg_writes:
            r = self.last_read.get((n, bit))
            if r is not None and s + t < r:
                return False
            w = self.last_write.get((n, bit))
            if w is not None and s + t <= w:
                return False
        return True

    def place(self, frag: Fragment, s: int) -> None:
        for n, (b0, b1) in frag.neuron_busy().items():
            self.neuron_busy[n].append((s + b0, s + b1))
        for dt, fc in enumerate(frag.cycles):
            t = s + dt
            for j, bsrc in enumerate((fc.bus_b, fc.bus_c)):
                if bsrc is not None and bsrc.code != 0:
                    self.bus[(t, j)] = bsrc
            if fc.ext:
                self.ext.setdefault(t, set()).update(fc.ext)
        for (t, n, bit) in frag.reg_reads:
            self.last_read[(n, bit)] = max(self.last_read.get((n, bit), -1), s + t)
        for (t, n, bit) in frag.reg_writes:
            self.last_write[(n, bit)] = max(self.last_write.get((n, bit), -1), s + t)
        self.end = max(self.end, s + frag.n_cycles())


# ------------------------------------------------------------------ #
# RPO scheduling of a full popcount tree (+ optional threshold cmp)    #
# ------------------------------------------------------------------ #
@dataclass
class ScheduleResult:
    program: Program
    ext_layout: Dict[int, Tuple[int, int]]   # input id -> (cycle, channel)
    result_neuron: int
    result_bits: List[int]
    cycles: int
    peak_storage_bits: int        # allocator peak (fragment-granular)
    fine_peak_bits: int           # bit-serial accounting (paper §III-B)
    n_ops: int
    cmp_result_cycle: Optional[int] = None   # predicate on result_neuron trace
    cmp_neuron: Optional[int] = None


class _FineAccount:
    """Bit-serial storage accounting matching the paper's §III-B model:
    an operand bit is freed the cycle it is consumed by the ripple add,
    and a result bit is counted from the cycle it is produced."""

    def __init__(self):
        self.cur = 0
        self.peak = 0

    def bump(self, d: int) -> None:
        self.cur += d
        self.peak = max(self.peak, self.cur)

    def leaf(self, width: int) -> None:
        self.bump(width)

    def add(self, kx: int, ky: int, out_width: int) -> None:
        k = max(kx, ky)
        for i in range(k):          # read x_i, y_i; write dst_i
            self.bump(1)            # dst bit appears ...
            self.bump(-(i < kx) - (i < ky))  # ... operand bits retire
        self.bump(1)                # msb (carry out)
        self.bump(out_width - (k + 1))  # release provably-zero msbs

    def compare(self, k: int) -> None:
        self.bump(-k)               # result bits retire as compared


def schedule_tree(n_inputs: int, threshold: Optional[int] = None,
                  compact: bool = True, leaf_size: int = 3,
                  n_ext: int = 4) -> ScheduleResult:
    """Schedule an N-input popcount (optionally followed by `>= T`).

    n_ext: external input channels on the PE.  The paper's interface is
    narrow (we model 4); with >= 6 channels two leaves can stream their
    product bits concurrently on disjoint neuron pairs — a PE-interface
    design-space point explored in benchmarks/table2.py.
    """
    tree = build_tree(n_inputs, leaf_size=leaf_size)
    alloc = RegAllocator()
    acct = _FineAccount()
    frags: List[Fragment] = []
    placements: List[int] = []
    tl = Timeline()
    seq_cursor = [0]

    def place(frag: Fragment) -> int:
        if compact:
            hint = 0
            for (t, n, bit) in frag.reg_reads:
                w = tl.last_write.get((n, bit))
                if w is not None:
                    hint = max(hint, w + 1 - t)
            s = hint
            while not tl.feasible(frag, s):
                s += 1
        else:
            s = seq_cursor[0]
        tl.place(frag, s)
        seq_cursor[0] = max(seq_cursor[0], s + frag.n_cycles())
        frags.append(frag)
        placements.append(s)
        return s

    live: List[_Value] = []   # all currently-allocated intermediate results

    def alloc_value(n: int, k: int) -> "_Value":
        v = _Value(n, alloc.alloc(n, k))
        live.append(v)
        return v

    def free_value(v: "_Value") -> None:
        alloc.release(v.neuron, v.bits)
        live.remove(v)

    def relocate(v: "_Value", exclude: set) -> None:
        """Copy a live value to a different register (spill path)."""
        nt = _pick_neuron(alloc, len(v.bits), exclude=exclude | {v.neuron})
        dst = alloc.alloc(nt, len(v.bits))
        place(copy_fragment(v.neuron, nt, v.bits, dst))
        alloc.release(v.neuron, v.bits)
        v.neuron, v.bits = nt, dst

    def make_room(target: int, need: int, pinned: set) -> bool:
        """Spill pending results off `target` until `need` bits are free.

        Pending results (ancestors' completed left-subtree sums) may live
        on any register; only the current operands (`pinned` values) are
        immovable.  Moves smallest-first.
        """
        pend = sorted((v for v in live
                       if v.neuron == target and id(v) not in pinned),
                      key=lambda v: len(v.bits))
        for v in pend:
            if alloc.capacity(target) >= need:
                return True
            try:
                relocate(v, exclude={target})
            except MemoryError:
                continue
        return alloc.capacity(target) >= need

    leaf_counter = [0]

    def visit(node: TreeNode, avoid: Optional[int]) -> "_Value":
        """Schedule the subtree; return the result value handle."""
        if node.is_leaf:
            # capacity-first keeps the four 16-bit registers balanced
            prefer = {avoid} if avoid is not None else set()
            try:
                ns = _pick_neuron(alloc, 2, prefer_not=prefer)
            except MemoryError:
                for t in range(N_NEURONS):
                    if make_room(t, 2, pinned=set()):
                        break
                ns = _pick_neuron(alloc, 2, prefer_not=prefer)
            # alternate the carry neuron and (with a wide-enough PE
            # interface) the ext channels so consecutive leaves occupy
            # disjoint resources and the list scheduler overlaps them
            parity = leaf_counter[0] % 2
            leaf_counter[0] += 1
            nc_cands = [i for i in range(N_NEURONS) if i != ns]
            nc = nc_cands[-1] if parity else nc_cands[0]
            chans = (3, 4, 5) if (parity and n_ext >= 6) else (0, 1, 2)
            v = alloc_value(ns, 2)
            frag = leaf_fragment(ns, nc, node.inputs, v.bits,
                                 ext_channels=chans)
            place(frag)
            if node.n_inputs == 1:  # msb always 0 for 1-input leaf
                alloc.release(ns, [v.bits[1]])
                v.bits = v.bits[:1]
            acct.leaf(len(v.bits))
            return v

        vx = visit(node.left, avoid=None)
        vy = visit(node.right, avoid=vx.neuron)
        if vy.neuron == vx.neuron:  # siblings collided: move one
            relocate(vy, exclude={vx.neuron})
        pinned = {id(vx), id(vy)}
        k = max(len(vx.bits), len(vy.bits))
        others = [i for i in range(N_NEURONS)
                  if i not in (vx.neuron, vy.neuron)]
        cand = [i for i in others if alloc.capacity(i) >= k + 1]
        if not cand:
            for t in sorted(others, key=lambda i: -alloc.capacity(i)):
                if make_room(t, k + 1, pinned):
                    break
            cand = [i for i in others if alloc.capacity(i) >= k + 1]
            if not cand:
                raise MemoryError("node too large for one TULIP-PE")
        cand.sort(key=lambda i: (i == avoid, -alloc.capacity(i)))
        ns = cand[0]
        nc = next(i for i in others if i != ns)
        vd = alloc_value(ns, k + 1)
        frag = add_fragment(vx.neuron, vy.neuron, ns, nc,
                            vx.bits, vy.bits, vd.bits)
        place(frag)
        acct.add(len(vx.bits), len(vy.bits), node.width)
        free_value(vx)
        free_value(vy)
        needed = node.width
        if len(vd.bits) > needed:   # provably-zero msbs: free immediately
            alloc.release(ns, vd.bits[needed:])
            vd.bits = vd.bits[:needed]
        return vd

    vroot = visit(tree, avoid=None)
    rn, rbits = vroot.neuron, vroot.bits

    cmp_cycle = cmp_neuron = None
    if threshold is not None:
        # popcount >= T  <=>  popcount > T - 1 ; clamp for degenerate T
        const = max(threshold - 1, -1)
        if const < 0:
            const = 0  # popcount >= 0 is trivially true; cmp vs -1 ~ x > -1
        nz = next(i for i in range(N_NEURONS) if i != rn)
        frag = compare_fragment(rn, nz, rbits, const=const)
        s = place(frag)
        acct.compare(len(rbits))
        cmp_cycle = s + frag.n_cycles() - 1
        cmp_neuron = nz

    program, ext_layout = fragments_to_program(frags, placements,
                                               n_ext=n_ext)
    return ScheduleResult(
        program=program, ext_layout=ext_layout, result_neuron=rn,
        result_bits=rbits, cycles=len(program),
        peak_storage_bits=alloc.peak, fine_peak_bits=acct.peak,
        n_ops=len(frags), cmp_result_cycle=cmp_cycle, cmp_neuron=cmp_neuron)


def _pick_neuron(alloc: RegAllocator, need: int, exclude: set = frozenset(),
                 prefer_not: set = frozenset()) -> int:
    order = sorted((i for i in range(N_NEURONS) if i not in exclude),
                   key=lambda i: (i in prefer_not, -alloc.capacity(i)))
    for i in order:
        if alloc.capacity(i) >= need:
            return i
    raise MemoryError("no register with free bits")


def make_ext_inputs(layout: Dict[int, Tuple[int, int]], bits: np.ndarray,
                    n_cycles: int, n_ext: int = 4) -> np.ndarray:
    """Build the [batch, T, n_ext] external stream for a scheduled tree.

    bits: [batch, n_inputs] product bits (XNOR of activation and weight).
    """
    bits = np.asarray(bits, dtype=np.int32)
    B = bits.shape[0]
    ext = np.zeros((B, n_cycles, n_ext), np.int32)
    for iid, (t, ch) in layout.items():
        ext[:, t, ch] = bits[:, iid]
    return ext
