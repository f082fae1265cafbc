"""The yardstick's arithmetic: operations and bytes of a layer, the
card's peaks, and the least time any implementation needs.

The operation count is the TULIP paper's §V-C count, copied from the
program's ``core/workloads.py`` (``ConvLayer.ops``, ``FCLayer.ops``) so
that a change to the program cannot move it: a conv layer is
``2 * c_in * k^2 * out^2 * c_out`` multiply-accumulates plus one
compare per output, a dense layer ``2 * n_in * n_out + n_out``.

Every bound counts the work the inputs need, whatever implements it,
so that no faster implementation can read above its peak:

* operations go at the fastest published rate of their arithmetic:
  int8 dense tensor-core ops for the integer layers, and for the 1-bit
  layers 8x that rate, an assumption (H100's data sheet lists no binary
  rate; 8x is A100's published binary : int8 ratio, 4,992 : 624);
* bytes are only what any implementation must move: a layer's inputs
  (1 bit each after the binarize, 1 byte before it, 8-bit pixels the
  least a pixel takes), its output after the max-pool that follows it
  (1 bit where the next layer takes bits, else 1 byte), and its weights
  once (1 bit each).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

# NVIDIA H100 SXM data sheet: 1,979 TOP/s dense int8, 3.35 TB/s HBM3
INT8_OPS_PER_S = 1979e12
B1_OPS_PER_S = 8 * INT8_OPS_PER_S          # assumed, see above
HBM_BYTES_PER_S = 3.35e12


def layer_ops(layer: Dict) -> int:
    """The paper's operation count of one conv or dense layer, one
    image."""
    if layer["op"] == "conv":
        outputs = layer["out_hw"] ** 2 * layer["c_out"]
        return 2 * layer["c_in"] * layer["k"] ** 2 * outputs + outputs
    if layer["op"] == "dense":
        return 2 * layer["n_in"] * layer["n_out"] + layer["n_out"]
    return 0


def is_integer(layer: Dict) -> bool:
    return layer["op"] == "conv" and layer["kind"] == "integer"


def compute_layers(layers: Sequence[Dict]) -> List[Dict]:
    """The conv and dense layers, in order (pools do no counted work)."""
    return [ly for ly in layers if ly["op"] in ("conv", "dense")]


def total_ops(layers: Sequence[Dict]) -> int:
    return sum(layer_ops(ly) for ly in layers)


def least_s_per_image(layers: Sequence[Dict]) -> float:
    """Seconds an image takes at the peaks: integer layers at the int8
    rate, binary layers at the assumed binary rate."""
    return sum(layer_ops(ly) / (INT8_OPS_PER_S if is_integer(ly)
                                else B1_OPS_PER_S)
               for ly in compute_layers(layers))


def _act_bytes(layers: Sequence[Dict], i: int) -> float:
    """The least bytes one image's input and output of compute layer
    ``layers[i]`` (an index into the whole table) take; an output that
    a max-pool follows counts pooled, as a fused pool would write it."""
    layer = layers[i]
    if layer["op"] == "conv":
        n_in = layer["in_hw"] ** 2 * layer["c_in"]
        hw = layer["out_hw"]
        if i + 1 < len(layers) and layers[i + 1]["op"] == "maxpool":
            pool = layers[i + 1]
            hw = (hw - pool["window"]) // pool["stride"] + 1
        n_out = hw ** 2 * layer["c_out"]
    else:
        n_in, n_out = layer["n_in"], layer["n_out"]
    in_bits = 8 if is_integer(layer) else 1
    nxt = next((ly for ly in layers[i + 1:] if ly["op"] != "maxpool"), None)
    out_bits = 8 if nxt is not None and is_integer(nxt) else 1
    return (n_in * in_bits + n_out * out_bits) / 8


def _weight_bytes(layer: Dict) -> float:
    if layer["op"] == "conv":
        return layer["k"] ** 2 * layer["c_in"] * layer["c_out"] / 8
    return layer["n_in"] * layer["n_out"] / 8


def bound_s(layers: Sequence[Dict], rows: int, integer: bool) -> float:
    """The least seconds ``rows`` images take through the integer
    (``integer=True``) or the binary conv layers of ``layers``: each
    layer's operations at their peak or its bytes at the memory's
    bandwidth, whichever is longer, summed over the layers."""
    total = 0.0
    for i, layer in enumerate(layers):
        if layer["op"] != "conv" or is_integer(layer) != integer:
            continue
        peak = INT8_OPS_PER_S if integer else B1_OPS_PER_S
        ops_s = rows * layer_ops(layer) / peak
        bytes_s = (rows * _act_bytes(layers, i) + _weight_bytes(layer)) \
            / HBM_BYTES_PER_S
        total += max(ops_s, bytes_s)
    return total
