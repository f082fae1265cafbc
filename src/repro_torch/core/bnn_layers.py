"""The serving half of the binarized layers (paper §IV-D threshold folding).

The counterpart of the serving functions of ``repro.core.bnn_layers``:
BN folded into an integer threshold, the gamma<0 sign flip absorbed
into the weights, the binary conv, the float entry conv and the packed
OR-pool.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import binary_conv2d, conv_padding
from repro_torch.kernels.packed import WORD, PackedArray
from repro_torch.kernels.ref import full_fp32

__all__ = ["FoldedThreshold", "binary_conv", "binary_weight_conv",
           "fold_conv_to_channel_thresholds", "fold_to_channel_thresholds",
           "maxpool_packed", "sign_weight_conv"]


class FoldedThreshold(NamedTuple):
    """Integer thresholds T (one per channel) + sign flip for gamma < 0."""
    T: torch.Tensor          # int32 [channels]
    flip: torch.Tensor       # bool  [channels] (output inverted where gamma<0)


def _negate_packed_rows(words: torch.Tensor, length: int, word_axis: int,
                        flip: torch.Tensor, chan_axis: int) -> torch.Tensor:
    """Bitwise-NOT the words of flipped output channels, masked so pad
    bits stay 0 (the PackedArray contract the closed form needs).
    ``word_axis`` is the packed-word axis, ``chan_axis`` the
    output-channel axis ``flip`` indexes."""
    ndim = words.ndim
    word_axis %= ndim
    chan_axis %= ndim
    nw = words.shape[word_axis]
    # per-word mask of the valid bits (int64, then the int32 pattern)
    valid = torch.clamp(length - 32 * torch.arange(nw, dtype=torch.int64),
                        0, 32)
    mask = ((torch.ones_like(valid) << valid) - 1).to(torch.int64)
    mask = torch.where(mask >= 2 ** 31, mask - 2 ** 32, mask).to(WORD)
    shape = [1] * ndim
    shape[word_axis] = nw
    flipped = (~words) & mask.to(words.device).reshape(shape)
    fshape = [1] * ndim
    fshape[chan_axis] = flip.shape[0]
    return torch.where(flip.to(words.device).reshape(fshape), flipped, words)


def _fold_tvec(fold: FoldedThreshold) -> torch.Tensor:
    return torch.where(fold.flip, 1 - fold.T, fold.T).to(WORD)


def fold_to_channel_thresholds(wp: PackedArray, fold: FoldedThreshold
                               ) -> Tuple[PackedArray, torch.Tensor]:
    """Rewrite (wp [N, K], FoldedThreshold) into the fused-kernel form:
    negating every weight of a flipped channel negates its integer dot,
    and for integers ``s < T  <=>  -s >= 1 - T``, so each channel
    becomes a plain ``>= T'`` test with T' = 1 - T where flipped."""
    wp = wp.move_pack_axis_last()
    words = _negate_packed_rows(wp.words, wp.length, word_axis=-1,
                                flip=fold.flip, chan_axis=0)
    return wp.with_words(words), _fold_tvec(fold).to(words.device)


def fold_conv_to_channel_thresholds(wf: PackedArray, fold: FoldedThreshold
                                    ) -> Tuple[PackedArray, torch.Tensor]:
    """Conv twin of fold_to_channel_thresholds: wf is a PackedArray
    filter [KH, KW, C, F] packed over C (axis -2); fold indexes F."""
    if wf.ndim != 4 or wf.axis != -2:
        raise ValueError(f"expected [KH, KW, C, F] packed on axis -2, "
                         f"got ndim={wf.ndim} axis={wf.axis}")
    words = _negate_packed_rows(wf.words, wf.length, word_axis=-2,
                                flip=fold.flip, chan_axis=-1)
    return wf.with_words(words), _fold_tvec(fold).to(words.device)


def binary_conv(xp: PackedArray, wf: PackedArray,
                fold: Union[FoldedThreshold, int, torch.Tensor, None] = None,
                stride: int = 1, padding="same", pack_out: bool = False,
                backend: Optional[str] = None, impl: str = "auto"):
    """Serve one binary conv layer: packed NHWC acts x packed filters.

    fold: a FoldedThreshold (rewritten to the fused per-channel form),
    a plain integer/per-channel threshold, or None (raw int32 dot)."""
    thr = fold
    if isinstance(fold, FoldedThreshold):
        wf, thr = fold_conv_to_channel_thresholds(wf, fold)
    return binary_conv2d(xp, wf, stride=stride, padding=padding,
                         threshold=thr, pack_out=pack_out,
                         backend=backend, impl=impl)


def sign_weight_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                     padding="same") -> torch.Tensor:
    """The first-layer conv before its alpha: real-valued NHWC input
    against sign(w), w [KH, KW, C, F], real zero padding.  Plain XLA in
    the reference, so cuDNN computes it here, in full float32 (TF32 off).
    Returns float32 [N, HO, WO, F] (an NHWC view of cuDNN's output,
    which follows the channels-last input)."""
    kh, kw = w.shape[0], w.shape[1]
    pad_h, pad_w = conv_padding(padding, kh, kw)
    wb = torch.where(w > 0, 1.0, -1.0).to(torch.float32)
    with full_fp32():
        y = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2),
                     wb.permute(3, 2, 0, 1), stride=stride,
                     padding=(pad_h, pad_w))
    return y.permute(0, 2, 3, 1)


def binary_weight_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                       padding="same",
                       alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """First-layer ("integer") conv: real-valued NHWC input against
    alpha * sign(w) (:func:`sign_weight_conv`, then one float32
    multiply by alpha [F]).  Returns float32 [N, HO, WO, F]."""
    if alpha is None:
        alpha = torch.mean(torch.abs(w.to(torch.float32)), dim=(0, 1, 2))
    return sign_weight_conv(x, w, stride, padding) * alpha


def maxpool_packed(xp: PackedArray, window: int = 2,
                   stride: Optional[int] = None) -> PackedArray:
    """Max-pool on channel-packed +-1 NHWC activations: in the sign
    domain max == logical OR, so the pool ORs the window's words — 32
    channels per op, no unpacking, pad bits stay 0."""
    if xp.ndim != 4 or xp.axis != -1:
        raise ValueError(f"expected [N, H, W, C] packed on the channel "
                         f"axis, got ndim={xp.ndim} axis={xp.axis}")
    s = window if stride is None else stride
    words = xp.words
    h, w = words.shape[1], words.shape[2]
    ho = (h - window) // s + 1
    wo = (w - window) // s + 1
    if ho <= 0 or wo <= 0:
        raise ValueError(f"pool window {window} stride {s} empties the "
                         f"{h}x{w} input")
    out = None
    for i in range(window):
        for j in range(window):
            win = words[:, i:i + (ho - 1) * s + 1:s,
                        j:j + (wo - 1) * s + 1:s, :]
            out = win if out is None else out | win
    return xp.with_words(out.contiguous())
