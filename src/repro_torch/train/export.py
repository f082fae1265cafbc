"""Export a trained STE checkpoint into the packed serving artifact —
the port of ``repro.train.export``.

The fold-at-export rule: training owns float32 latent weights and float
BN; serving owns packed sign words and integer per-channel thresholds.
The ONLY bridge between the two is this module — it rewrites (params,
bn_state) from train/models.py into the CompiledBNN param layout
through the exact-fold machinery (``core.bnn_layers.
quantize_for_serving`` / ``quantize_conv_for_serving``), so the folded
packed forward is sign-identical to the training eval forward, and
:func:`check_sign_identity` asserts it — on the card, through the
port's kernels.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import graph
from repro_torch.core.bnn_layers import (quantize_conv_for_serving,
                                         quantize_for_serving)
from repro_torch.graph.ir import BinaryConv, BNNSpec, IntegerEntry
from repro_torch.kernels.ops import binarize_pack
from repro_torch.kernels.packed import PackedArray, resolve_device
from repro_torch.serving.placement import replicate
from repro_torch.train.models import BN_EPS, train_forward

__all__ = ["export_serving_params", "export_compiled", "check_sign_identity"]


@torch.no_grad()
def export_serving_params(spec: BNNSpec, params: Dict[str, Any],
                          bn_state: Dict[str, Any]) -> Dict[str, Any]:
    """Latent/BN training params -> packed serving params in the
    CompiledBNN layout, on the params' device.  Integer entries keep
    their float weights + alpha; thresholded binary conv/dense layers
    fold the BN running statistics (mu, sqrt(var)) into a
    FoldedThreshold with the alpha scale absorbed; the terminal dense
    packs the bare weight signs (its serving output is the raw int32
    dot)."""
    out: Dict[str, Any] = {"conv": [], "fc": []}
    for i, nd in enumerate(spec.conv_nodes):
        p = params["conv"][i]
        if isinstance(nd, IntegerEntry):
            alpha = torch.mean(torch.abs(p["w"].to(torch.float32)),
                               dim=(0, 1, 2))
            out["conv"].append({"w": p["w"], "alpha": alpha})
        else:
            assert isinstance(nd, BinaryConv)
            bn = bn_state["conv"][i]
            wf, fold = quantize_conv_for_serving(
                p["w"], bn["mu"], torch.sqrt(bn["var"]), p["gamma"],
                p["beta"], eps=BN_EPS)
            out["conv"].append({"wf": wf, "t": fold})
    for j, nd in enumerate(spec.dense_nodes):
        p = params["fc"][j]
        if spec.thresholded(nd):
            bn = bn_state["fc"][j]
            wp, fold = quantize_for_serving(
                p["w"], bn["mu"], torch.sqrt(bn["var"]), p["gamma"],
                p["beta"], eps=BN_EPS)
            out["fc"].append({"wp": wp, "t": fold})
        else:
            wb = torch.where(p["w"] > 0, 1.0, -1.0)
            out["fc"].append({"wp": PackedArray.pack(wb, axis=-1)})
    return out


def export_compiled(spec: BNNSpec, params: Dict[str, Any],
                    bn_state: Dict[str, Any], backend: Optional[str] = None,
                    batch: int = 1, device: Any = None
                    ) -> Tuple[graph.CompiledBNN, Dict[str, Any]]:
    """The whole train->serve bridge in one call: fold the checkpoint
    and compile its spec for ``device`` (None: the card, where the
    default ``"cuda"`` backend launches the port's kernels).  The
    returned pair, the serving params on the compiled device, drops
    straight into ``BNNServer(cb, sparams)``."""
    cb = graph.compile(spec, backend=backend, device=device, batch=batch)
    return cb, replicate(export_serving_params(spec, params, bn_state),
                         cb.device)


def _serving_input(spec: BNNSpec, x: torch.Tensor, backend: Optional[str]
                   ) -> Any:
    """Image specs take float NHWC on both sides; dense-entry specs
    take float rows in training and their sign-pack in serving."""
    if len(spec.input_shape) == 1:
        return binarize_pack(x, backend=backend)
    return x


@torch.no_grad()
def check_sign_identity(spec: BNNSpec, params: Dict[str, Any],
                        bn_state: Dict[str, Any], x: Any,
                        backend: Optional[str] = None,
                        cb: Optional[graph.CompiledBNN] = None,
                        sparams: Optional[Dict[str, Any]] = None,
                        device: Any = None) -> Dict[str, float]:
    """Assert the folded packed serving forward is sign-identical to the
    training eval forward on ``x`` (moved to ``device``, None: the card;
    ``cb``'s device when one is given) — logits EXACTLY equal (both
    sides produce the same integer-valued dot for the terminal layer),
    argmax agreement 1.0.  Returns the comparison stats; raises
    AssertionError on any divergence."""
    dev = cb.device if cb is not None else resolve_device(device)
    x = torch.as_tensor(x).to(dev)
    eval_logits, _ = train_forward(spec, params, bn_state, x, train=False)
    if cb is None or sparams is None:
        cb, sparams = export_compiled(spec, params, bn_state,
                                      backend=backend, batch=x.shape[0],
                                      device=dev)
    served = cb.apply(sparams, _serving_input(spec, x, cb.backend))
    ev = eval_logits.cpu()
    sv = served.to(ev.dtype).cpu()
    if sv.shape != ev.shape or not torch.equal(sv, ev):
        delta = float((sv - ev).abs().max()) if sv.shape == ev.shape \
            else float("nan")
        raise AssertionError(
            f"folded packed serving forward diverges from the training "
            f"eval forward (max abs logit delta {delta})")
    agree = float(torch.mean((sv.argmax(-1) == ev.argmax(-1))
                             .to(torch.float32)))
    if agree != 1.0:
        raise AssertionError(f"argmax agreement {agree} != 1.0")
    return {
        "rows": int(ev.shape[0]),
        "argmax_agreement": agree,
        "max_abs_logit_delta": float((sv - ev).abs().max()),
    }
