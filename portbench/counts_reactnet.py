"""The least bytes of ReActNet's residual epilogue, and the least time
they take at the memory's bandwidth.

A residual half-step's epilogue (``layer`` a binary ``conv`` row of the
table, whatever implements it) must read the conv's int32 dot and the
shortcut, and write the float32 stream and, where another half-step
follows, one bit an element for that half-step's sign:

* the dot: 4 bytes an output element;
* the shortcut: 4 bytes an element of the map it reads: the output's
  (identity), the twice larger input map (a 2x2 average: four elements
  an output), or the half-width input map once (a doubling, whose two
  halves add the same map);
* the stream: 4 bytes an output element;
* the next sign: 1 bit an output element.

The per-channel tables and corrections (a few KB a layer) are left
out: the count is a floor.
"""
from __future__ import annotations

from typing import Dict, Sequence

from portbench.counts import HBM_BYTES_PER_S


def _half_steps(layers: Sequence[Dict]):
    return [ly for ly in layers
            if ly["op"] == "conv" and ly.get("kind") == "binary"]


def shortcut_elems(layer: Dict) -> int:
    """Elements of the shortcut map one image's epilogue reads."""
    out = layer["out_hw"] ** 2
    if layer["shortcut"] == "avgpool":
        return layer["in_hw"] ** 2 * layer["c_in"]
    if layer["shortcut"] == "duplicate":
        return out * layer["c_in"]
    return out * layer["c_out"]


def epilogue_bytes(layers: Sequence[Dict]) -> float:
    """The least bytes one image's residual epilogues move."""
    steps = _half_steps(layers)
    total = 0.0
    for i, ly in enumerate(steps):
        n_out = ly["out_hw"] ** 2 * ly["c_out"]
        total += 4 * n_out + 4 * shortcut_elems(ly) + 4 * n_out
        if i + 1 < len(steps):
            total += n_out / 8
    return total


def epilogue_bound_s(layers: Sequence[Dict], rows: int) -> float:
    """The least seconds ``rows`` images' residual epilogues take at the
    memory's bandwidth."""
    return rows * epilogue_bytes(layers) / HBM_BYTES_PER_S
