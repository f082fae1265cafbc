"""Carry the reference's parameters into the port.

``params_from_numpy(tree, device)`` takes the JAX params tree with every
leaf as numpy — each PackedArray given as ``{"words": uint32 ndarray,
"length": int, "axis": int}`` (optionally ``"values"``) — and returns
the port's tree: PackedArrays of int32 words with the same bit
pattern, and tensors for every other array, on ``device``.  The caller
does the unwrapping; the port never sees a JAX object.  bfloat16
leaves (numpy arrays of the ``ml_dtypes`` bfloat16 dtype, which torch
cannot read) are carried bit for bit through their uint16 pattern.
A NamedTuple with the fields ``(T, flip)`` is the reference's
``FoldedThreshold`` (folded batch norm, from ``quantize_for_serving``):
it becomes the port's ``FoldedThreshold``, T int32 and flip bool, which
the binary conv and dense layers rewrite at bind time.  A NamedTuple
with the fields ``(step, m, v)`` is the reference's AdamW ``OptState``:
it becomes the port's ``repro_torch.optim.OptState``, so a training
state (params, bn_state, opt) crosses whole.  Both are known by their
fields, so nothing of the reference is imported.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.bnn_layers import FoldedThreshold
from repro_torch.kernels.packed import PM1, PackedArray, from_uint32
from repro_torch.optim.adamw import OptState

__all__ = ["params_from_numpy"]

_PACKED_KEYS = {"words", "length", "axis"}


def params_from_numpy(tree: Any, device: Any = "cuda") -> Any:
    """Convert a numpy params tree (dicts, lists, tuples, arrays) into
    the port's tree on ``device``."""
    if isinstance(tree, dict):
        if _PACKED_KEYS <= set(tree):
            return PackedArray(from_uint32(tree["words"], device),
                               length=int(tree["length"]),
                               axis=int(tree["axis"]),
                               values=tree.get("values", PM1))
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        if tree._fields == FoldedThreshold._fields:
            return FoldedThreshold(
                T=torch.tensor(np.asarray(tree.T), dtype=torch.int32,
                               device=device),
                flip=torch.tensor(np.asarray(tree.flip), dtype=torch.bool,
                                  device=device))
        if tree._fields == OptState._fields:
            return OptState(*(params_from_numpy(v, device) for v in tree))
        return type(tree)(*(params_from_numpy(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        if tree.dtype.name == "bfloat16":
            bits = np.ascontiguousarray(tree).view(np.uint16).copy()
            return torch.from_numpy(bits).view(torch.bfloat16).to(device)
        return torch.tensor(tree, device=device)
    raise TypeError(f"unexpected params leaf {type(tree).__name__}")
