"""Threshold-logic algebra (paper §II).

A copy of ``repro.core.threshold``: the port imports nothing of the
JAX package.

A Boolean function f(x1..xn) is a *threshold function* if there exist
integer weights w_i and a threshold T such that

    f(x) = 1  <=>  sum_i w_i x_i >= T.

The TULIP hardware neuron is the fixed-weight instance  [2, 1, 1, 1; T]
over ports (a, b, c, d), with per-port input inversion (realized in
hardware by the LIN/RIN mapping) and a runtime-programmable T.

This module is the pure functional model used by the cycle-accurate PE
simulator and by the tests (exhaustive truth tables).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Sequence

import numpy as np

# the hardware cell's port weights (paper §IV-A)
PORT_WEIGHTS = (2, 1, 1, 1)  # a, b, c, d


def neuron_eval(a, b, c, d, T: int):
    """[2a + b + c + d >= T] — vectorized over numpy/bool inputs."""
    s = 2 * np.asarray(a, dtype=np.int32) + np.asarray(b, dtype=np.int32) \
        + np.asarray(c, dtype=np.int32) + np.asarray(d, dtype=np.int32)
    return s >= T


@dataclass(frozen=True)
class ThresholdFn:
    """General threshold function (W; T) over n inputs."""
    weights: tuple
    T: int

    def __call__(self, *xs) -> bool:
        assert len(xs) == len(self.weights)
        return sum(w * int(x) for w, x in zip(self.weights, xs)) >= self.T

    def truth_table(self):
        n = len(self.weights)
        return {bits: self(*bits)
                for bits in itertools.product((0, 1), repeat=n)}


# --- the paper's primitive ops as neuron configurations -------------------
# Each entry documents which (port-assignment, inversion, T) realizes the op
# on the [2,1,1,1] cell.  These are the configurations the scheduler emits.

def carry_fn(x, y, cin):
    """Full-adder carry = MAJ(x,y,cin) = [0,1,1,1; 2] on ports (b,c,d)."""
    return neuron_eval(0, x, y, cin, T=2)


def sum_fn(x, y, cin, cout):
    """Full-adder sum = x ^ y ^ cin = [2,1,1,1; 3] with a = NOT cout.

    Identity: x + y + cin - 2*cout in {0 -> 0, 1 -> 1}; with a = ~cout:
    2(1-cout) + x + y + cin >= 3  <=>  x + y + cin - 2 cout >= 1.
    """
    return neuron_eval(1 - np.asarray(cout, np.int32), x, y, cin, T=3)


def cmp_step_fn(x, y, z_prev):
    """Sequential-comparator bit step (paper §IV-D, Fig 5a inset):

        z_i = x_i        if x_i != y_i
            = z_{i-1}    otherwise
    == [0,1,1,1; 2] on (b=x, c=~y, d=z_prev).
    """
    return neuron_eval(0, x, 1 - np.asarray(y, np.int32), z_prev, T=2)


def or4_fn(a, b, c, d):
    """Max-pool = OR = [2,1,1,1; 1]."""
    return neuron_eval(a, b, c, d, T=1)


def and2_fn(x, y):
    """RELU gating AND = [1,1; 2] (ports b,c; a,d grounded)."""
    return neuron_eval(0, x, y, 0, T=2)


def identity_fn(x):
    """Broadcast/copy = [.,.,.,1; 1] (port d)."""
    return neuron_eval(0, 0, 0, x, T=1)


def popcount_threshold(bits: Sequence[int], T: int) -> bool:
    """The BNN node predicate the whole machine computes: sum(bits) >= T."""
    return int(np.sum(np.asarray(bits, dtype=np.int64))) >= T


def bnn_node_reference(x_bits: np.ndarray, w_bits: np.ndarray, T: int):
    """Reference for a binary neuron with +-1 weights encoded as bits.

    products = XNOR(x, w); output = [popcount(products) >= T].
    Vectorized over leading batch dims of x_bits.
    """
    x = np.asarray(x_bits, dtype=np.int32)
    w = np.asarray(w_bits, dtype=np.int32)
    prod = 1 - (x ^ w)   # XNOR
    return prod.sum(axis=-1) >= T
