"""The least time of Bi-Real Net's float layers: the stem (conv, batch
norm, max pool and the first sign) and the projection shortcuts.

Each bound counts the work the inputs need, whatever implements it:
operations at the card's float32 peak outside the tensor cores, a
multiply-add counted as 2, or bytes at the memory's bandwidth,
whichever is longer, summed over the layers.

* a stem (a ``real_conv`` row, with the ``maxpool`` row after it):
  ``2 * k^2 * c_in * c_out`` operations an output of the conv; bytes:
  the pixels in (4 bytes each, float32 as the pool holds them), the map
  after the pool out (4 bytes an element) and, where a binary conv
  follows, one bit an element of it for that conv's sign;
* a projection (a binary ``conv`` row whose ``shortcut`` is
  ``projection``: the 2x2 average, a 1x1 conv, batch norm):
  ``2 * c_in * c_out`` operations an output pixel; bytes: the input map
  in and the projected map out, 4 bytes an element.

Weights (read once a launch, not an image) and per-channel tables are
left out: each count is a floor.  The stated precision (no FMA) caps a
stem's reading at about 50%: its products and sums issue one operation
each, where the peak counts a multiply-add as one instruction.
"""
from __future__ import annotations

from typing import Dict, Sequence

from portbench.counts import HBM_BYTES_PER_S

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores
FP32_FLOP_PER_S = 67e12


def _bound_s(ops: float, nbytes: float) -> float:
    return max(ops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def stem_s_per_image(layers: Sequence[Dict]) -> float:
    """The least seconds one image's stems take."""
    total = 0.0
    for i, ly in enumerate(layers):
        if ly["op"] != "real_conv":
            continue
        ops = 2 * ly["k"] ** 2 * ly["c_in"] * ly["c_out"] * ly["out_hw"] ** 2
        out_hw = ly["out_hw"]
        if i + 1 < len(layers) and layers[i + 1]["op"] == "maxpool":
            out_hw = layers[i + 1]["out_hw"]
        n_out = out_hw ** 2 * ly["c_out"]
        nxt = next((r for r in layers[i + 1:] if r["op"] != "maxpool"), None)
        bits = nxt is not None and nxt["op"] == "conv" and \
            nxt.get("kind") == "binary"
        nbytes = 4 * ly["in_hw"] ** 2 * ly["c_in"] + 4 * n_out + \
            (n_out / 8 if bits else 0)
        total += _bound_s(ops, nbytes)
    return total


def projection_s_per_image(layers: Sequence[Dict]) -> float:
    """The least seconds one image's projection shortcuts take."""
    total = 0.0
    for ly in layers:
        if ly["op"] != "conv" or ly.get("shortcut") != "projection":
            continue
        out = ly["out_hw"] ** 2
        ops = 2 * ly["c_in"] * ly["c_out"] * out
        nbytes = 4 * (ly["in_hw"] ** 2 * ly["c_in"] + out * ly["c_out"])
        total += _bound_s(ops, nbytes)
    return total


def stem_bound_s(layers: Sequence[Dict], rows: int) -> float:
    return rows * stem_s_per_image(layers)


def projection_bound_s(layers: Sequence[Dict], rows: int) -> float:
    return rows * projection_s_per_image(layers)
