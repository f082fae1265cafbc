"""Offline weight packing: latent weights -> TULIP serving layout.

The port of ``repro.models.quantize``.  Rewrites the parameter tree so
every binarizable projection is stored as {name}_p (a PackedArray:
int32 words holding the reference's uint32 bit pattern, 32 weights a
word over the input dim, logical length + negative pack axis) +
{name}_alpha (per-output-channel XNOR-Net scale).  ``dense()`` /
``moe_apply`` dispatch on the packed keys, so the same model code
serves both layouts.

The reference vmaps the walk over the weight-stacked cycle params;
here the walk sees the leading [n_cycles] axis (``lead`` = 1) and packs
over axis -2 directly, which gives the same words, the same
[n_cycles, K/32, N] shape and the same pack axis (-2).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.kernels.packed import PackedArray

# 2-D weights packed over their input dim; selected by key name
_PACK2D = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
           "in_proj", "out_proj", "gate_proj"}
# MoE expert weights [E, K, N] packed over K
_PACK3D = {"w_gate", "w_up", "w_down"}


def _pack(w: torch.Tensor, keepdim: bool):
    """bit = [w > 0] over axis -2 (the K of [.., K, N]); alpha = mean
    |w| over it, in float32, cast to w's dtype."""
    alpha = torch.mean(torch.abs(w.to(torch.float32)), dim=-2,
                       keepdim=keepdim).to(w.dtype)
    return PackedArray.pack(w, axis=-2), alpha


def _walk(node: Any, path: str, lead: int) -> Any:
    """``lead``: the leading stacked axes every leaf carries (1 inside
    ``layers``, 0 elsewhere), which the shape rules look past."""
    if isinstance(node, dict):
        out: Dict[str, Any] = {}
        in_moe = path.endswith("/moe")
        for k, v in node.items():
            p = f"{path}/{k}"
            if isinstance(v, (dict, list, tuple)):
                out[k] = _walk(v, p, lead)
            elif isinstance(v, torch.Tensor) and k in _PACK2D \
                    and v.ndim - lead == 2 and v.shape[lead] % 32 == 0 \
                    and not in_moe:
                out[k + "_p"], out[k + "_alpha"] = _pack(v, keepdim=False)
            elif isinstance(v, torch.Tensor) and k in _PACK3D \
                    and v.ndim - lead == 3 and v.shape[lead + 1] % 32 == 0:
                out[k + "_p"], out[k + "_alpha"] = _pack(v, keepdim=True)
            else:
                out[k] = v
        return out
    if isinstance(node, tuple):
        return tuple(_walk(v, f"{path}/{i}", lead)
                     for i, v in enumerate(node))
    if isinstance(node, list):
        return [_walk(v, f"{path}/{i}", lead) for i, v in enumerate(node)]
    return node


def pack_model_params(params: Any) -> Any:
    """Pack every binarizable projection; stacked (cycle) params keep
    their leading layer dim."""
    out = dict(params)

    def pack_stack(stack):
        s = dict(stack)
        s["layers"] = tuple(_walk(blk, "/layers", 1)
                            for blk in stack["layers"])
        s["rem"] = tuple(_walk(b, "/rem", 0) for b in stack["rem"])
        return s

    out["decoder"] = pack_stack(params["decoder"])
    if "encoder" in params:
        enc = dict(params["encoder"])
        enc["stack"] = pack_stack(params["encoder"]["stack"])
        out["encoder"] = enc
    return out
