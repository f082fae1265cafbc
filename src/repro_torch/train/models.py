"""Trainable STE forward over a BNNSpec — the port of
``repro.train.models``.

One spec, three executions: the compiler lowers a
:class:`~repro_torch.graph.ir.BNNSpec` to the packed serving
executable; this module walks the SAME node chain in the float
straight-through-estimator domain — float32 latent weights,
``ste_sign`` forwards (Courbariaux et al., the paper's §II recipe),
float batch norm — so a trained checkpoint folds into the packed
datapath with *sign-identical* activations.

Every convention mirrors the serving datapath exactly (the eval forward
is the contract ``train.export.check_sign_identity`` compares):

  * binarize / pack bit = ``x > 0`` (eval; training uses ste_sign,
    which differs only at exactly 0);
  * folded-BN compare = ``BN(s) >= 0`` (ties go to +1, matching
    ``apply_folded``'s ``s >= T``);
  * weight sign at eval and export = ``w > 0``;
  * binary-conv spatial padding = -1, integer-entry padding = 0;
  * max-pool over pm1 activations = the packed OR; its gradient goes
    to the first maximum of a window, as the reference's does;
  * the eval forward computes the integer entry conv with the serving
    conv itself, as the "cuda" backend's ``CompiledBNN.apply`` does:
    where a binarize follows and the kernel takes the shape, the
    ``kernels.entry_conv`` kernel (its packed signs of ``acc * alpha``,
    unpacked to +-1 here), else ``core.bnn_layers.sign_weight_conv``
    (cuDNN in full float32 on the card) times alpha, signed with
    ``> 0``, which is what the serving pack does with the alpha in its
    load — another kernel, padding or layout could sum in another
    order, and a near-zero sum change sign.

Activations are NHWC, as in the reference; the convs see NCHW views.
Every conv runs in full float32 (TF32 off).  Batch norm is written out:
the population variance, running statistics ``momentum * old + (1 -
momentum) * new`` (the opposite of ``nn.BatchNorm``'s convention), eps
inside the sqrt.

Params mirror the CompiledBNN layout (``{"conv": [...], "fc": [...]}``)
with latent float weights and BN gamma/beta in place of packed words
and folded thresholds; BN running statistics live in a parallel
``bn_state`` tree (not gradient-updated).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.binarize import ste_sign
from repro_torch.core.bnn_layers import sign_weight_conv
from repro_torch.graph.ir import (Binarize, BinaryConv, BinaryDense,
                                  BNNSpec, BNThreshold, IntegerEntry,
                                  Logits, MaxPool, RESIDUAL_NODES)
from repro_torch.kernels import entry_conv as kentry
from repro_torch.kernels.packed import resolve_device, unpack_words
from repro_torch.kernels.ref import full_fp32

__all__ = ["init_train_state", "train_forward", "clip_mask_for",
           "BN_EPS", "BN_MOMENTUM"]

BN_EPS = 1e-5  # must match the export fold's eps
BN_MOMENTUM = 0.9


def _pm1(cond: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return torch.where(cond, 1.0, -1.0).to(like.dtype)


def _sign(x: torch.Tensor, train: bool) -> torch.Tensor:
    """Training: ste_sign.  Eval: the serving pack convention ``x > 0``."""
    return ste_sign(x) if train else _pm1(x > 0, x)


def _sign_ge(x: torch.Tensor, train: bool) -> torch.Tensor:
    """Post-BN sign: ``>= 0`` ties to +1, matching apply_folded's
    integer ``s >= T`` compare (ste_sign already signs >= 0 to +1)."""
    return ste_sign(x) if train else _pm1(x >= 0, x)


def _wsign(w: torch.Tensor, train: bool) -> torch.Tensor:
    """Latent-weight sign: export packs ``w > 0``, so eval does too;
    training keeps the STE gradient."""
    return ste_sign(w) if train else _pm1(w > 0, w)


def _conv(x: torch.Tensor, wb: torch.Tensor, stride: int, pad: int,
          pad_value: float) -> torch.Tensor:
    """NHWC x HWIO conv with a symmetric pad of ``pad_value`` (-1 for the
    packed binary domain, 0 for the real-input entry), full float32."""
    xc = x.permute(0, 3, 1, 2)
    wc = wb.permute(3, 2, 0, 1)
    with full_fp32():
        if pad and pad_value != 0.0:
            xc = F.pad(xc, (pad, pad, pad, pad), value=pad_value)
            y = F.conv2d(xc, wc, stride=stride)
        else:
            y = F.conv2d(xc, wc, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _batch_norm(s: torch.Tensor, bn: Dict[str, torch.Tensor],
                p: Dict[str, torch.Tensor], train: bool, momentum: float
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """BN over every axis but the channel axis (-1).  Training uses the
    batch statistics (population variance) and returns updated running
    statistics; eval uses the running statistics — the numbers the
    export fold consumes."""
    if train:
        axes = tuple(range(s.ndim - 1))
        mu = torch.mean(s, dim=axes)
        var = torch.mean(torch.square(s - mu), dim=axes)
        new_bn = {
            "mu": momentum * bn["mu"] + (1 - momentum) * mu.detach(),
            "var": momentum * bn["var"] + (1 - momentum) * var.detach(),
        }
    else:
        mu, var = bn["mu"], bn["var"]
        new_bn = bn
    y = p["gamma"] * (s - mu) / torch.sqrt(var + BN_EPS) + p["beta"]
    return y, new_bn


def _maxpool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


# ------------------------------------------------------------------ #
# state init                                                           #
# ------------------------------------------------------------------ #
def init_train_state(generator: torch.Generator, spec: BNNSpec,
                     dtype: torch.dtype = torch.float32,
                     device: Any = None
                     ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, bn_state) for a spec on ``device`` (None: the card).
    Weights are drawn from ``generator`` (on its own device, then moved,
    so one seed gives the same state on the CPU and the card), conv
    nodes first, then dense nodes, each N(0, 1) / sqrt(fan_in) — the
    reference's shapes and scales (its numbers come from jax.random,
    which torch cannot reproduce).  Thresholded conv/dense layers carry
    BN gamma (1) and beta (0); bn_state mirrors them with running mu
    (0) and var (1), and holds ``{}`` for the other layers."""
    dev = resolve_device(device)

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=dtype,
                        device=generator.device)
        return (w / torch.sqrt(torch.tensor(fan_in, dtype=dtype))).to(dev)

    def bn_pair(n):
        return ({"gamma": torch.ones(n, dtype=dtype, device=dev),
                 "beta": torch.zeros(n, dtype=dtype, device=dev)},
                {"mu": torch.zeros(n, dtype=torch.float32, device=dev),
                 "var": torch.ones(n, dtype=torch.float32, device=dev)})

    params: Dict[str, Any] = {"conv": [], "fc": []}
    bn_state: Dict[str, Any] = {"conv": [], "fc": []}
    for nd in spec.conv_nodes:
        p = {"w": normal((nd.kh, nd.kw, nd.c_in, nd.c_out),
                         nd.kh * nd.kw * nd.c_in)}
        b: Dict[str, Any] = {}
        if isinstance(nd, BinaryConv) and spec.thresholded(nd):
            gb, b = bn_pair(nd.c_out)
            p.update(gb)
        params["conv"].append(p)
        bn_state["conv"].append(b)
    for nd in spec.dense_nodes:
        p = {"w": normal((nd.n_out, nd.n_in), nd.n_in)}
        b = {}
        if spec.thresholded(nd):
            gb, b = bn_pair(nd.n_out)
            p.update(gb)
        params["fc"].append(p)
        bn_state["fc"].append(b)
    return params, bn_state


def clip_mask_for(params: Dict[str, Any]) -> Dict[str, Any]:
    """The optim.adamw clip_mask: clamp latent sign weights to [-1, 1]
    (keeps the STE window active) but never BN gamma/beta (the folded
    thresholds must be free to grow past the clamp)."""
    return {
        "conv": [{k: k == "w" for k in p} for p in params["conv"]],
        "fc": [{k: k == "w" for k in p} for p in params["fc"]],
    }


# ------------------------------------------------------------------ #
# the forward                                                          #
# ------------------------------------------------------------------ #
def train_forward(spec: BNNSpec, params: Dict[str, Any],
                  bn_state: Dict[str, Any], x: torch.Tensor, *,
                  train: bool, binarize: bool = True,
                  momentum: float = BN_MOMENTUM
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Walk spec.nodes in the float STE domain; returns (logits,
    new_bn_state).  ``x``: float NHWC for image specs, float [B, K] for
    dense-entry specs (the serving side sees their sign-pack).

    ``binarize=False`` is the float32-latent diagnostic twin: the same
    graph, but weights stay latent floats and activations pass through
    a tanh instead of the sign — the accuracy ceiling the binarized net
    is measured against.  The residual family (ReActNet, Bi-Real Net)
    is served, not trained here: its nodes are refused."""
    for nd in spec.nodes:
        if isinstance(nd, RESIDUAL_NODES):
            raise ValueError(
                f"{spec.name}: {nd.name} ({type(nd).__name__}) is a node of "
                f"the residual family, which train_forward does not train "
                f"(it walks IntegerEntry, BinaryConv and BinaryDense chains)")
    conv_i = fc_i = 0
    new_bn = {"conv": list(bn_state["conv"]), "fc": list(bn_state["fc"])}

    def act(v):
        return _sign(v, train) if binarize else torch.tanh(v)

    def act_ge(v):
        return _sign_ge(v, train) if binarize else torch.tanh(v)

    def alpha_of(w, dims):
        return torch.mean(torch.abs(w), dim=dims).detach()

    h = x
    if isinstance(spec.nodes[0], BinaryDense):
        h = act(h)  # dense entry: sign the input
    for k, nd in enumerate(spec.nodes):
        if isinstance(nd, IntegerEntry):
            p = params["conv"][conv_i]
            # alpha over (kh, kw, c_in): matches binary_weight_conv
            alpha = alpha_of(p["w"], (0, 1, 2))
            nxt = spec.nodes[k + 1] if k + 1 < len(spec.nodes) else None
            if binarize and not train and isinstance(nxt, Binarize) \
                    and not nxt.flatten and kentry.supports(
                        h.shape, p["w"].shape, nd.stride, nd.pad):
                # the Binarize after it leaves these +-1 values as they are
                h = unpack_words(kentry.entry_conv(
                    h, p["w"], alpha, stride=nd.stride, padding=nd.pad),
                    dtype=h.dtype)
            elif binarize and not train:
                h = sign_weight_conv(h, p["w"], stride=nd.stride,
                                     padding=nd.pad) * alpha
            else:
                wb = _wsign(p["w"], train) if binarize else p["w"]
                h = _conv(h, wb, nd.stride, nd.pad, 0.0) * alpha
            conv_i += 1
        elif isinstance(nd, Binarize):
            if nd.flatten:
                h = h.reshape(h.shape[0], -1)
            h = act(h)
        elif isinstance(nd, BinaryConv):
            # validate() guarantees every BinaryConv is thresholded
            p = params["conv"][conv_i]
            wb = _wsign(p["w"], train) if binarize else p["w"]
            s = _conv(h, wb, nd.stride, nd.pad, -1.0)
            if binarize:  # alpha [F]: the fold absorbs it
                s = s * alpha_of(p["w"], (0, 1, 2))
            y, new_bn["conv"][conv_i] = _batch_norm(
                s, bn_state["conv"][conv_i], p, train, momentum)
            h = act_ge(y)
            conv_i += 1
        elif isinstance(nd, MaxPool):
            h = _maxpool(h, nd.window, nd.stride)
        elif isinstance(nd, BinaryDense):
            if h.ndim > 2:
                h = h.reshape(h.shape[0], -1)
            p = params["fc"][fc_i]
            wb = _wsign(p["w"], train) if binarize else p["w"]
            s = h @ wb.T  # w [N, K]: rows are outputs
            if spec.thresholded(nd):
                if binarize:  # alpha [N] per output row
                    s = s * alpha_of(p["w"], 1)
                y, new_bn["fc"][fc_i] = _batch_norm(
                    s, bn_state["fc"][fc_i], p, train, momentum)
                h = act_ge(y)
            else:
                # terminal layer: the raw pm1 dot, no alpha — serving
                # emits the int32 popcount dot as float logits verbatim
                h = s
            fc_i += 1
        elif isinstance(nd, (BNThreshold, Logits)):
            pass  # fused into the producer above
        else:  # pragma: no cover
            raise AssertionError(f"unknown node {nd!r}")
    return h.to(torch.float32), new_bn

