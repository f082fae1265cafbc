"""The plain reference of a binarized network (family ``bnn``).

Written from the layer table of a configuration file and nothing else:
it imports no part of the program under test and takes none of its
state.  It gets the float weights, the int32 thresholds and the images
the benchmark made, and works out the signs and the alphas itself.

Semantics (the TULIP paper's datapath, XNOR-Net's boundary layers):

* an ``integer`` conv takes real-valued NHWC input against sign(w)
  (``w > 0`` is +1, anything else -1), zero spatial padding, times
  ``alpha = mean |w|`` over (kh, kw, c_in) of each output channel;
* the first ``binary`` layer binarizes its input: ``x > 0`` is +1;
* a ``binary`` conv sums +-1 products with -1 spatial padding (the
  only border a 1-bit code holds) and keeps ``sum >= t`` per channel;
* a max-pool is the float max before the binarize and the max of +-1
  values (an OR of the bits) after it;
* every dense layer but the last keeps ``sum >= t``; the last one's sum
  is the logits, as float32; the flatten is NHWC order.

``precision`` picks how the float stages run, so that the same code is
both the reference and its control:

* ``"exact"`` (the reference): the integer convs in float64 (rounded to
  the integer sum where the input is integer-valued), the +-1 layers in
  float32 with TF32 off, each sum rounded to the integer it is (a +-1
  sum is an integer far below 2**24; rounding removes the error of a
  transform-based conv algorithm);
* ``"tf32"``: the integer convs in float32 with TF32 on;
* ``"bf16"``: the integer convs' operands and output rounded to
  bfloat16;
* ``"fp8"``: the entry conv's pixels rounded to float8 e4m3, the rest
  exact;
* ``"int4"``: the entry conv's pixels cut to 4 bits (16 levels over
  0..255), the rest exact.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

PRECISIONS = ("exact", "tf32", "bf16", "fp8", "int4")


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


def _sign(w: torch.Tensor) -> torch.Tensor:
    return torch.where(w > 0, 1.0, -1.0).to(torch.float32)


def _pixels(x: torch.Tensor, precision: str) -> torch.Tensor:
    """The entry conv's pixels as the precision holds them."""
    if precision == "fp8":
        return x.to(torch.float8_e4m3fn).to(torch.float32)
    if precision == "int4":
        return torch.round(x / 17.0) * 17.0
    return x


def _integer_conv(h: torch.Tensor, w: torch.Tensor, layer: Dict,
                  precision: str) -> torch.Tensor:
    """sign(w) conv of NCHW ``h``, times alpha; float32 out."""
    wb = _sign(w).permute(3, 2, 0, 1)          # [F, C, KH, KW]
    stride, pad = layer["stride"], layer["pad"]
    if precision == "exact":
        alpha = w.to(torch.float64).abs().mean(dim=(0, 1, 2))
        y = F.conv2d(h.to(torch.float64), wb.to(torch.float64),
                     stride=stride, padding=pad)
        if bool((h == torch.round(h)).all()):
            # integer inputs against +-1 sum to integers: rounding takes
            # off whatever a transform-based algorithm (Winograd, FFT)
            # added, so an exact zero stays zero
            y = torch.round(y)
        return (y * alpha[None, :, None, None]).to(torch.float32)
    alpha = w.to(torch.float32).abs().mean(dim=(0, 1, 2))
    if precision == "bf16":
        y = F.conv2d(h.to(torch.bfloat16), wb.to(torch.bfloat16),
                     stride=stride, padding=pad)
        return (y * alpha.to(torch.bfloat16)[None, :, None, None]
                ).to(torch.float32)
    with _tf32(precision == "tf32"):
        y = F.conv2d(h.to(torch.float32), wb, stride=stride, padding=pad)
    return y * alpha[None, :, None, None]


def _binary_conv(h: torch.Tensor, w: torch.Tensor, t: torch.Tensor,
                 layer: Dict) -> torch.Tensor:
    """+-1 NCHW ``h`` against sign(w), -1 padding, ``sum >= t``.  The
    sum is an integer far below 2**24; cuDNN may take a transform-based
    algorithm whose float32 result is off by a little, so it is rounded
    back to that integer before the compare."""
    pad = layer["pad"]
    if pad:
        h = F.pad(h, (pad, pad, pad, pad), value=-1.0)
    with _tf32(False):
        y = F.conv2d(h, _sign(w).permute(3, 2, 0, 1), stride=layer["stride"])
    return torch.where(torch.round(y) >= t.to(torch.float32)
                       [None, :, None, None], 1.0, -1.0)


def forward(layers: Sequence[Dict], weights: List[Dict[str, torch.Tensor]],
            x: torch.Tensor, precision: str = "exact") -> torch.Tensor:
    """Logits [N, classes] float32 of NHWC images ``x``.

    ``weights`` holds one entry per ``conv`` and ``dense`` layer of the
    table, in order: ``{"w": ...}`` for an integer conv (w [KH, KW, C,
    F]), ``{"w", "t"}`` for a binary conv, ``{"w": [N, K]}`` plus ``"t"``
    for every dense layer but the last."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    # the pixels as the precision holds them, NCHW
    h = _pixels(x, precision).permute(0, 3, 1, 2)
    conv_precision = precision if precision in ("tf32", "bf16") else "exact"
    binary = False
    dense = [ly for ly in layers if ly["op"] == "dense"]
    i = 0
    for layer in layers:
        op = layer["op"]
        if op == "maxpool":
            h = F.max_pool2d(h, layer["window"], layer["stride"])
            continue
        p = weights[i]
        i += 1
        if op == "conv" and layer["kind"] == "integer":
            if binary:
                raise ValueError(f"{layer['name']}: an integer conv after "
                                 f"a binary layer")
            h = _integer_conv(h, p["w"], layer, conv_precision)
            continue
        if not binary:
            h = torch.where(h > 0, 1.0, -1.0)
            binary = True
        if op == "conv":
            h = _binary_conv(h, p["w"], p["t"], layer)
        elif op == "dense":
            if h.ndim == 4:                    # NHWC flatten
                h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
            with _tf32(False):
                y = torch.round(h @ _sign(p["w"]).t())
            if layer is dense[-1]:
                return y.to(torch.float32)
            h = torch.where(y >= p["t"].to(torch.float32)[None, :], 1.0,
                            -1.0)
        else:
            raise ValueError(f"unknown layer op {op!r}")
    raise ValueError("the layer table ends without a dense layer")


def logits(layers: Sequence[Dict], weights: List[Dict[str, torch.Tensor]],
           x: torch.Tensor, precision: str = "exact",
           block: int = 128) -> torch.Tensor:
    """``forward`` in blocks of ``block`` images, so that it fits beside
    what the run still holds."""
    with torch.no_grad():
        return torch.cat([forward(layers, weights, x[i:i + block], precision)
                          for i in range(0, x.shape[0], block)])
