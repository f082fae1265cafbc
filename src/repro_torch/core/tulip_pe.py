"""Cycle-accurate TULIP-PE simulator.

The port of ``repro.core.tulip_pe``.  Two interchangeable backends,
tested against each other:

  * ``run_numpy``  — batched numpy interpreter (reference semantics),
    copied from the reference.
  * ``run_torch``  — the twin of the reference's ``run_jax``: one
    program, packed once into tensors on the device, broadcast to a
    batch of PEs that each run on their own data (the paper's SIMD
    organization, §IV-E: "The control signals are broadcast to all the
    processing units").

Cycle semantics (see isa.py for the structural model):
  1. registers are read as of cycle start; writes land at end of cycle;
  2. neuron-output reads default to the *previous* cycle's latched value
     (edge-triggered flip-flop, paper §II); ``fresh`` reads see the value
     computed this cycle by an earlier-`stage` neuron (the paper's
     "cascade of two binary neurons" full adder);
  3. thr == 0 (HOLD) keeps the output latch unchanged.

Contract (what the rest of the stack relies on):

* Shapes/units: ``ext`` is ``[batch, T, n_ext]`` 0/1 bits with
  ``T >= len(program)`` (a short ext is a scheduling bug, not a
  runtime condition); registers are ``[batch, 4, 16]`` int32 0/1;
  outputs are the latched neuron bits ``[batch, 4]``.  One list entry
  of ``program`` == one clock cycle; there is no implicit stall, flush,
  or retiming — cycle counts read off ``len(program)`` are the numbers
  ``core.energy`` charges and ``repro_torch.sim`` measures.
* ``run_numpy`` and ``run_torch`` are bit-equivalent on every program
  (tests/test_torch_tulip_core.py holds both, and the reference's
  ``run_jax``, on scheduled and random programs; ``repro_torch.sim``
  re-asserts it on sampled real workload nodes).
* A neuron computes ``out = (2a + b + c + d >= thr)`` — the
  [2,1,1,1;T] cell.  Anything larger must be built from programs
  (adder_tree.py); thresholds past the cell's are rejected by
  ``Program.validate``, not here.
* ``trace=True`` (numpy) / the returned ``hist`` (torch) expose the
  per-cycle latched outputs — the only way to read a result that a
  schedule leaves on a neuron output mid-program (e.g. the on-PE
  compare bit at ``ScheduleResult.cmp_result_cycle``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.isa import (EXT_BASE, N_NEURONS, N_REG_BITS,
                                  NEURON_BASE, REG_BASE, Program)
from repro_torch.core.threshold import PORT_WEIGHTS
from repro_torch.kernels.packed import resolve_device

MAX_STAGES = 4


# --------------------------------------------------------------------- #
# numpy reference interpreter                                            #
# --------------------------------------------------------------------- #
def run_numpy(program: Program, ext: np.ndarray,
              init_regs: Optional[np.ndarray] = None,
              trace: bool = False):
    """Execute `program` on a batch of PEs (reference interpreter).

    ext:  [batch, T, n_ext] int/bool external input bits; T must cover
          ``len(program)`` cycles (asserted).
    init_regs: optional [batch,4,16] starting register file (copied,
          never mutated) — used to preload operands instead of
          spending cycles loading them through a neuron.
    returns (regs [batch,4,16], outs [batch,4], trace [batch,T,4] or
          None) — final registers, final latched outputs, and (with
          ``trace=True``) every cycle's latched outputs.

    Within a cycle, neurons evaluate in ascending ``stage`` order so a
    ``fresh`` read observes the same-cycle value of an earlier-stage
    neuron (the combinational cascade); ties keep program order.
    """
    p = program.pack()
    ext = np.asarray(ext, dtype=np.int32)
    assert ext.ndim == 3 and ext.shape[1] >= len(program), \
        f"ext {ext.shape} too short for {len(program)} cycles"
    B = ext.shape[0]
    regs = (np.zeros((B, N_NEURONS, N_REG_BITS), np.int32)
            if init_regs is None else np.asarray(init_regs, np.int32).copy())
    prev = np.zeros((B, N_NEURONS), np.int32)
    hist = np.zeros((B, len(program), N_NEURONS), np.int32) if trace else None

    for t in range(len(program)):
        cur = prev.copy()
        order = np.argsort(p["stage"][t], kind="stable")
        for n in order:
            vals = []
            # ports a, d
            for j in (0, 1):
                code = p["sel"][t, n, j]
                v = _resolve_np(code, p["sel_fresh"][t, n, j], cur, prev,
                                ext[:, t], regs[:, n])
                vals.append(v ^ p["sel_inv"][t, n, j])
            # ports b, c from shared buses
            for j in (0, 1):
                if p["bc_en"][t, n, j]:
                    code = p["bus_src"][t, j]
                    v = _resolve_np(code, p["bus_fresh"][t, j], cur, prev,
                                    ext[:, t], regs[:, n])
                    v = v ^ p["bus_inv"][t, j] ^ p["bc_inv"][t, n, j]
                else:
                    v = np.zeros(B, np.int32)
                vals.append(v)
            a, d, b, c = vals
            thr = p["thr"][t, n]
            if thr > 0:
                cur[:, n] = (2 * a + b + c + d >= thr).astype(np.int32)
            # thr == 0: hold (cur already = prev)
        for n in range(N_NEURONS):
            if p["wr_en"][t, n]:
                regs[:, n, p["wr_bit"][t, n]] = cur[:, n]
        prev = cur
        if trace:
            hist[:, t] = cur
    return regs, prev, hist


def _resolve_np(code: int, fresh: int, cur, prev, ext_t, my_regs):
    B = cur.shape[0]
    if code == 0:
        return np.zeros(B, np.int32)
    if code == 1:
        return np.ones(B, np.int32)
    if code < EXT_BASE:
        k = code - NEURON_BASE
        return (cur if fresh else prev)[:, k]
    if code < REG_BASE:
        return ext_t[:, code - EXT_BASE]
    return my_regs[:, code - REG_BASE]


# --------------------------------------------------------------------- #
# torch interpreter (SIMD over PEs: one program, a batch of data)         #
# --------------------------------------------------------------------- #
def _port_sources(p: dict, n_ext: int):
    """Every (cycle, neuron, port) read of a packed program as flat
    arrays: the source code, its fresh flag, its inversion (the
    neuron's own XORed with the bus's on ports b and c), whether the
    port is enabled, and the port's weight in the [2,1,1,1] cell."""
    T = p["thr"].shape[0]
    shape = (T, N_NEURONS)
    code, fresh, inv, en, w = [], [], [], [], []
    a, b, c, d = PORT_WEIGHTS
    for j, wt in ((0, a), (1, d)):                     # ports a, d
        code.append(p["sel"][:, :, j])
        fresh.append(p["sel_fresh"][:, :, j])
        inv.append(p["sel_inv"][:, :, j])
        en.append(np.ones(shape, np.int32))
        w.append(np.full(shape, wt, np.int32))
    for j, wt in ((0, b), (1, c)):                     # buses b, c
        code.append(np.broadcast_to(p["bus_src"][:, None, j], shape))
        fresh.append(np.broadcast_to(p["bus_fresh"][:, None, j], shape))
        inv.append(p["bus_inv"][:, None, j] ^ p["bc_inv"][:, :, j])
        en.append(p["bc_en"][:, :, j])
        w.append(np.full(shape, wt, np.int32))
    code, fresh, inv, en, w = (np.stack(arr, -1) for arr in
                               (code, fresh, inv, en, w))
    ext_ch = code - EXT_BASE
    if np.any((code >= EXT_BASE) & (code < REG_BASE) & (ext_ch >= n_ext)):
        raise ValueError(f"program reads an external channel past the "
                         f"{n_ext} of ext")
    return code, fresh, inv, en, w


def _pack_torch(program: Program, n_ext: int, device) -> dict:
    """The program as per-cycle linear maps on the device.

    A port's value is a 0/1 read v XORed with its inversion i, and
    ``v ^ i == i + (1 - 2i) v``, so a neuron's weighted input sum is
    linear in the values it reads:  ``sum_p w_p (v_p ^ i_p) =
    bias + sum_p coef_p v_p``, with ``coef = w (1 - 2i)`` and ``bias =
    sum_p w_p i_p`` over its enabled ports (a disabled bus port reads 0
    and adds nothing).  The reads split into the values fixed for the
    cycle — previous outputs, external channels, the registers as of
    cycle start, the constant 1 (folded into the bias) — and this
    cycle's fresh outputs, so per cycle

        sum = bias + rest @ m_rest + cur @ m_cur

    with ``rest = [prev(4), ext(n_ext), regs(4 x 16)]``.  Every term is
    a small integer, exact in float32 in any order."""
    p = program.pack()
    T = len(program)
    code, fresh, inv, en, w = _port_sources(p, n_ext)
    coef = (w * (1 - 2 * inv) * en).astype(np.float32)
    bias = (w * inv * en).sum(-1).astype(np.float32)
    n_rest = N_NEURONS + n_ext + N_NEURONS * N_REG_BITS
    m_rest = np.zeros((T, n_rest, N_NEURONS), np.float32)
    m_cur = np.zeros((T, N_NEURONS, N_NEURONS), np.float32)
    t_i, n_i, _ = np.indices(code.shape)
    ones = code == 1
    bias += np.where(ones, coef, 0).sum(-1)
    nrn = (code >= NEURON_BASE) & (code < EXT_BASE)
    cur_rd = nrn & (fresh != 0)
    np.add.at(m_cur, (t_i[cur_rd], code[cur_rd] - NEURON_BASE,
                      n_i[cur_rd]), coef[cur_rd])
    prev_rd = nrn & (fresh == 0)
    np.add.at(m_rest, (t_i[prev_rd], code[prev_rd] - NEURON_BASE,
                       n_i[prev_rd]), coef[prev_rd])
    ext_rd = (code >= EXT_BASE) & (code < REG_BASE)
    np.add.at(m_rest, (t_i[ext_rd], N_NEURONS + code[ext_rd] - EXT_BASE,
                       n_i[ext_rd]), coef[ext_rd])
    reg_rd = code >= REG_BASE                # a neuron reads its own
    np.add.at(m_rest, (t_i[reg_rd], N_NEURONS + n_ext
                       + n_i[reg_rd] * N_REG_BITS + code[reg_rd] - REG_BASE,
                       n_i[reg_rd]), coef[reg_rd])

    # a neuron updates only at its own stage, and only with thr > 0
    # (HOLD keeps the latch, which is what ``cur`` starts the cycle as)
    fires = p["thr"] > 0
    upd = np.stack([(p["stage"] == s) & fires for s in range(MAX_STAGES)],
                   1)                                     # [T, S, 4]
    passes = [tuple(int(s) for s in np.flatnonzero(upd[t].any(-1)))
              for t in range(T)]
    wr = np.zeros((T, N_NEURONS, N_NEURONS * N_REG_BITS), np.float32)
    tw, nw = np.nonzero(p["wr_en"])
    wr[tw, nw, nw * N_REG_BITS + p["wr_bit"][tw, nw]] = 1.0
    keep = 1.0 - wr.sum(1)
    dev = torch.device(device)

    def put(a):
        return torch.as_tensor(a, device=dev)

    return {"passes": passes,
            "writes": [bool(b) for b in p["wr_en"].any(-1)],
            "m_rest": put(m_rest), "m_cur": put(m_cur), "bias": put(bias),
            "thr": put(p["thr"].astype(np.float32)), "upd": put(upd),
            "wr": put(wr), "keep": put(keep)}


def run_torch(program: Program, ext, init_regs=None, device=None):
    """The torch twin of :func:`run_numpy` (the reference's ``run_jax``)
    — bit-equivalent.

    ext: [batch, T, n_ext] 0/1 bits (numpy or tensor), T covering
    ``len(program)``; init_regs: optional [batch, 4, 16] starting
    registers.  Returns (regs [batch, 4, 16], outs [batch, 4], hist
    [batch, T, 4]) as int32 tensors on ``device`` (None: the card); hist
    holds every cycle's latched outputs.

    The program is packed once (:func:`_pack_torch`), then each cycle is
    a few tensor ops over the whole batch: the cycle's fixed reads
    through ``m_rest``, then one pass per stage at which some neuron
    fires, in ascending order — every neuron's sum from the outputs of
    the passes before (``m_cur``), updated only where the neuron sits at
    that stage — then the register write-back.  A stage no neuron fires
    at would leave every output as it is, so it takes no pass."""
    dev = resolve_device(device)
    ext = torch.as_tensor(ext, device=dev).to(torch.float32)
    T = len(program)
    if ext.ndim != 3 or ext.shape[1] < T:
        raise ValueError(f"ext {tuple(ext.shape)} too short for {T} "
                         f"cycles")
    pk = _pack_torch(program, ext.shape[2], dev)
    B = ext.shape[0]
    if init_regs is None:
        regs = torch.zeros(B, N_NEURONS * N_REG_BITS, device=dev)
    else:
        regs = torch.as_tensor(init_regs, device=dev).to(
            torch.float32).reshape(B, N_NEURONS * N_REG_BITS)
    prev = torch.zeros(B, N_NEURONS, device=dev)
    hist = []
    for t in range(T):
        cur = prev
        if pk["passes"][t]:
            rest = torch.cat([prev, ext[:, t], regs], 1)
            base = torch.addmm(pk["bias"][t], rest, pk["m_rest"][t])
            for s in pk["passes"][t]:
                fire = torch.addmm(base, cur, pk["m_cur"][t]) >= pk["thr"][t]
                cur = torch.where(pk["upd"][t, s], fire, cur)
        if pk["writes"][t]:
            regs = torch.addmm(regs * pk["keep"][t], cur, pk["wr"][t])
        prev = cur
        hist.append(cur)
    i32 = torch.int32
    hist_t = (torch.stack(hist, 1) if hist
              else torch.zeros(B, 0, N_NEURONS, device=dev))
    return (regs.reshape(B, N_NEURONS, N_REG_BITS).to(i32), prev.to(i32),
            hist_t.to(i32))


def read_value(regs: np.ndarray, neuron: int, bits) -> np.ndarray:
    """Decode an unsigned integer stored little-endian in a register."""
    regs = np.asarray(regs)
    acc = np.zeros(regs.shape[0], dtype=np.int64)
    for i, b in enumerate(bits):
        acc += regs[:, neuron, b].astype(np.int64) << i
    return acc


def write_value(regs: np.ndarray, neuron: int, bits, values) -> None:
    """Preload an integer into register bits (batched, in place)."""
    values = np.asarray(values, dtype=np.int64)
    for i, b in enumerate(bits):
        regs[:, neuron, b] = (values >> i) & 1
