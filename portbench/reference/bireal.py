"""The plain reference of Bi-Real Net (family ``bireal``).

Written from the layer table of a configuration and the published
equations (Liu et al., "Bi-Real Net: Enhancing the Performance of 1-bit
CNNs with Improved Representational Capability and Advanced Training
Algorithm", ECCV 2018, arXiv:1808.00278; the public code's
``birealnet.py``) and nothing else: it imports torch alone, no part of
the program under test, and takes none of its state.  float32
throughout, TF32 off for products and convolutions.

The layers, on NHWC float32 activations:

* ``real_conv`` (the stem's conv1 and bn1): ``x = bn(conv(img, w))``,
  real weights [K, K, C, F], zero padding; the taps are summed from 0
  in the order (kh, kw, c), each product and each sum rounded to
  float32; no activation follows;
* ``maxpool``: the max over each window, its pad -inf (``MaxPool2d``);
* ``conv`` with ``kind`` "binary" (a ``BasicBlock``): ``a = sign(x)``;
  ``d = conv(a, sign(w))`` with zero padding, summed exactly as
  integers; ``u = bn(d * alpha)`` with ``alpha = mean |w|`` of each
  output channel; ``o = u + r`` with ``r`` the shortcut (``identity``:
  x; ``projection``, the ``downsample``: ``bn(conv1x1(avg(x)))``, the
  2x2 average ``(((x00 + x01) + x10) + x11) * 0.25`` and the 1x1 conv
  summed from 0 in channel order, each product and sum rounded to
  float32); no activation after the add;
* ``avgpool`` (global): the mean over the spatial axes;
* ``real_dense``: ``y = x @ w.T + b``, the logits.

``bn(v) = ((v - mean) * (1 / sqrt(var + eps))) * gamma + beta``, each
operation rounded on its own in that order, eps = 1e-5.

Departures from the public code, each stated in the configuration's
``assumed``:

* the sign: ``x > 0`` is +1, anything else -1 (the public code's
  ``torch.sign`` gives 0 at exactly 0);
* batch norm is written out unfolded, as above, where torch's
  ``BatchNorm2d`` in eval mode folds it into one multiply-add;
* the binary conv is ``alpha * (integer dot)`` with one rounding, where
  the public code convolves with the float weights ``alpha * sign(w)``;
* the stem's taps and the projection's channels are summed in a stated
  order, where cuDNN chooses its own.

``precision`` picks how the float sums run, so that the same code is
both the reference and its control:

* ``"exact"`` (the reference): as above, and the global pool and the
  head in float64, rounded to float32 at the end;
* ``"tf32"``: the stem as one cuDNN convolution, the projections as one
  matrix product each, the pool and head in float32, TF32 on for all;
* ``"bf16"``: the stem's, the projections' and the head's operands and
  outputs rounded to bfloat16;
* ``"fp8"``: the pixels rounded to float8 e4m3, the rest exact;
* ``"int4"``: the pixels cut to 4 bits (16 levels over 0..255), the
  rest exact;
* ``"fp32_cudnn"``: the stem as one cuDNN convolution in float32 with
  TF32 off (cuDNN's own order of the taps), the rest exact;
* ``"fp32_fma"``: the stem's taps in the stated order, each one fused
  multiply-add (the product exact in float64, the sum rounded to
  float32 from there), the rest exact.

``weights`` holds one dict per ``real_conv``, ``conv`` and
``real_dense`` row of the table, in order:

* real_conv: ``w`` [K, K, C, F], ``mean``, ``var``, ``gamma``,
  ``beta`` [F];
* conv: ``w`` [K, K, C_in, C_out], ``mean``, ``var``, ``gamma``,
  ``beta`` [C_out]; a projection row also ``proj``: ``w`` [C_in,
  C_out], ``mean``, ``var``, ``gamma``, ``beta`` [C_out];
* real_dense: ``w`` [N_out, N_in], ``b`` [N_out].
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

PRECISIONS = ("exact", "tf32", "bf16", "fp8", "int4", "fp32_cudnn",
              "fp32_fma")
BN_EPS = 1e-5
# how far a logit of an implementation whose float stream is this
# reference's bit for bit may lie from this reference's, over the
# image's largest logit magnitude: the order of its float32 sums in the
# global pool (49 terms) and the head (512 terms), which this reference
# sums in float64
LOGIT_REL_TOL = 1e-4


@contextlib.contextmanager
def _tf32(on: bool):
    """Set both TF32 switches for the block (a float32 convolution runs
    in TF32 by default on the card; the reference states it)."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def _sign(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v > 0, 1.0, -1.0).to(torch.float32)


def _pixels(x: torch.Tensor, precision: str) -> torch.Tensor:
    """The stem's pixels as the precision holds them."""
    if precision == "fp8":
        return x.to(torch.float8_e4m3fn).to(torch.float32)
    if precision == "int4":
        return torch.round(x / 17.0) * 17.0
    return x.to(torch.float32)


def _bn(v: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    inv = 1.0 / torch.sqrt(p["var"].to(torch.float32) + BN_EPS)
    v = (v - p["mean"]) * inv
    return v * p["gamma"] + p["beta"]


def _stem(x: torch.Tensor, p: Dict[str, torch.Tensor], layer: Dict,
          precision: str) -> torch.Tensor:
    """The real conv of NHWC ``x`` and its batch norm."""
    w = p["w"].to(torch.float32)
    k, s, pad = layer["k"], layer["stride"], layer["pad"]
    ho = layer["out_hw"]
    if precision in ("tf32", "bf16", "fp32_cudnn"):
        dt = torch.bfloat16 if precision == "bf16" else torch.float32
        with _tf32(precision == "tf32"):
            y = F.conv2d(x.permute(0, 3, 1, 2).to(dt),
                         w.permute(3, 2, 0, 1).to(dt), stride=s, padding=pad)
        return _bn(y.to(torch.float32).permute(0, 2, 3, 1), p)
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    acc = torch.zeros(x.shape[0], ho, ho, w.shape[3], dtype=torch.float32,
                      device=x.device)
    for i in range(k):
        for j in range(k):
            win = xp[:, i:i + (ho - 1) * s + 1:s, j:j + (ho - 1) * s + 1:s]
            for c in range(w.shape[2]):
                if precision == "fp32_fma":
                    acc = (acc.double() + win[..., c:c + 1].double()
                           * w[i, j, c].double()).float()
                else:
                    acc = acc + win[..., c:c + 1] * w[i, j, c]
    return _bn(acc, p)


def _maxpool(x: torch.Tensor, layer: Dict) -> torch.Tensor:
    """The max pool of NHWC ``x`` (MaxPool2d: the pad counts as -inf)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), layer["window"],
                     layer["stride"], layer["pad"])
    return y.permute(0, 2, 3, 1)


def _projection(x: torch.Tensor, p: Dict[str, torch.Tensor],
                precision: str) -> torch.Tensor:
    """The downsample shortcut of NHWC ``x``: 2x2 average, 1x1 conv, BN."""
    a = x[:, 0::2, 0::2] + x[:, 0::2, 1::2]
    a = a + x[:, 1::2, 0::2]
    a = (a + x[:, 1::2, 1::2]) * 0.25
    w = p["w"].to(torch.float32)
    if precision in ("tf32", "bf16"):
        dt = torch.bfloat16 if precision == "bf16" else torch.float32
        with _tf32(precision == "tf32"):
            y = torch.matmul(a.to(dt), w.to(dt))
        return _bn(y.to(torch.float32), p)
    acc = torch.zeros(*a.shape[:3], w.shape[1], dtype=torch.float32,
                      device=x.device)
    for c in range(w.shape[0]):
        acc = acc + a[..., c:c + 1] * w[c]
    return _bn(acc, p)


def _half_step(x: torch.Tensor, p: Dict[str, torch.Tensor], layer: Dict,
               precision: str = "exact") -> torch.Tensor:
    """One binary block of NHWC ``x``."""
    a = _sign(x).permute(0, 3, 1, 2)
    w = p["w"].to(torch.float32)
    alpha = w.abs().mean(dim=(0, 1, 2))
    with _tf32(False):
        d = F.conv2d(a, _sign(w).permute(3, 2, 0, 1),
                     stride=layer["stride"], padding=layer["pad"])
    # an integer far below 2**24: rounding takes off whatever a
    # transform-based algorithm added
    d = torch.round(d).permute(0, 2, 3, 1)
    u = _bn(d * alpha, p)
    kind = layer["shortcut"]
    if kind == "identity":
        return u + x
    if kind != "projection":
        raise ValueError(f"{layer['name']}: unknown shortcut {kind!r}")
    return u + _projection(x, p["proj"], precision)


def _head(x: torch.Tensor, p: Dict[str, torch.Tensor],
          precision: str) -> torch.Tensor:
    """The global pool's output through the real dense layer."""
    w, b = p["w"], p["b"]
    if precision in ("tf32", "bf16"):
        dt = torch.bfloat16 if precision == "bf16" else torch.float32
        with _tf32(precision == "tf32"):
            y = F.linear(x.to(dt), w.to(dt), b.to(dt))
        return y.to(torch.float32)
    y = F.linear(x.to(torch.float64), w.to(torch.float64),
                 b.to(torch.float64))
    return y.to(torch.float32)


def forward(layers: Sequence[Dict], weights: List[Dict[str, torch.Tensor]],
            x: torch.Tensor, precision: str = "exact") -> torch.Tensor:
    """Logits [N, classes] float32 of NHWC images ``x``."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    h = _pixels(x, precision)
    i = 0
    for layer in layers:
        op = layer["op"]
        if op == "maxpool":
            h = _maxpool(h, layer)
            continue
        if op == "avgpool":
            if precision in ("tf32", "bf16"):
                h = h.mean(dim=(1, 2))
            else:
                h = h.to(torch.float64).mean(dim=(1, 2))
            continue
        p = weights[i]
        i += 1
        if op == "real_conv":
            h = _stem(h, p, layer, precision)
        elif op == "conv" and layer["kind"] == "binary":
            h = _half_step(h, p, layer, precision)
        elif op == "real_dense":
            return _head(h, p, precision)
        else:
            raise ValueError(f"unknown layer op {op!r}")
    raise ValueError("the layer table ends without a real_dense layer")


def logits(layers: Sequence[Dict], weights: List[Dict[str, torch.Tensor]],
           x: torch.Tensor, precision: str = "exact",
           block: int = 32) -> torch.Tensor:
    """``forward`` in blocks of ``block`` images, so that it fits beside
    what the run still holds."""
    with torch.no_grad():
        return torch.cat([forward(layers, weights, x[i:i + block], precision)
                          for i in range(0, x.shape[0], block)])
