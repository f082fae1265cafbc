"""Binarized layers with integer threshold folding (paper §IV-D).

The port of ``repro.core.bnn_layers``.  The paper folds batch
normalization into the neuron threshold T: instead of computing
BN(popcount_affine(x)) and taking its sign, the comparison constant of
the sequential comparator is adjusted so that

    sign(gamma * (s - mu) / sigma + beta)  ==  [s >= T_int]

for the integer-valued popcount-sum s (``fold_bn_threshold``).  Training
owns float BN (``bnn_dense_train``, ``bn_reference``); export folds it
(``quantize_for_serving``, ``quantize_conv_for_serving``); serving
absorbs the gamma<0 sign flip into the weights (the
``fold_*_to_channel_thresholds`` rewrites) and runs the binary conv,
the float entry conv and the packed OR-pool.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core.binarize import (binarize_weights, ste_sign,
                                       xnor_popcount_dot)
from repro_torch.kernels.entry_conv import sign_weight_conv
from repro_torch.kernels.ops import binary_conv2d
from repro_torch.kernels.packed import WORD, PackedArray

__all__ = ["FoldedThreshold", "apply_folded", "binary_conv",
           "binary_weight_conv", "bn_reference", "bnn_dense_serve_folded",
           "bnn_dense_train", "bnn_mlp_serve_folded",
           "fold_bn_threshold", "fold_conv_to_channel_thresholds",
           "fold_to_channel_thresholds", "maxpool_packed",
           "quantize_conv_for_serving", "quantize_for_serving",
           "sign_weight_conv"]

F32 = torch.float32


class FoldedThreshold(NamedTuple):
    """Integer thresholds T (one per channel) + sign flip for gamma < 0."""
    T: torch.Tensor          # int32 [channels]
    flip: torch.Tensor       # bool  [channels] (output inverted where gamma<0)


def _int32_saturating(v: torch.Tensor) -> torch.Tensor:
    """float -> int32 as the reference's conversion does it: values past
    the int32 range saturate, NaN becomes 0 (a plain ``.to(int32)`` of
    an out-of-range float is undefined)."""
    hi, lo = v >= 2.0 ** 31, v < -2.0 ** 31
    t = torch.where(hi | lo | torch.isnan(v), 0.0, v).to(torch.int32)
    t = torch.where(hi, 2 ** 31 - 1, t)
    return torch.where(lo, -2 ** 31, t).to(torch.int32)


def fold_bn_threshold(mu, sigma, gamma, beta, n_inputs: int,
                      eps: float = 1e-5) -> FoldedThreshold:
    """Fold BN(s) >= 0 into s >= T for integer popcount-dot s in
    [-n, n] with parity of n (s = 2*popcount - n steps by 2).

    BN(s) >= 0  <=>  gamma * (s - mu)/sqrt(sigma^2+eps) + beta >= 0
      gamma > 0:  s >= mu - beta * sqrt(..)/gamma   -> T = ceil(rhs)
      gamma < 0:  s <= rhs                          -> flip + T = floor+1
    """
    mu = torch.as_tensor(mu, dtype=F32)
    sd = torch.sqrt(torch.as_tensor(sigma, dtype=F32) ** 2 + eps)
    gamma = torch.as_tensor(gamma, dtype=F32)
    beta = torch.as_tensor(beta, dtype=F32)
    rhs = mu - beta * sd / torch.where(gamma == 0, 1e-12, gamma)
    pos = gamma > 0
    # s takes values of parity n (mod 2); ceil to the next representable
    t_pos = _int32_saturating(torch.ceil(rhs))
    t_neg = _int32_saturating(torch.floor(rhs) + 1)
    return FoldedThreshold(T=torch.where(pos, t_pos, t_neg), flip=~pos)


def apply_folded(s: torch.Tensor, fold: FoldedThreshold) -> torch.Tensor:
    """[s >= T] with per-channel flip; returns +-1 activations."""
    ge = s >= fold.T
    out = torch.where(fold.flip, ~ge, ge)
    return torch.where(out, 1.0, -1.0)


def bn_reference(s, mu, sigma, gamma, beta, eps: float = 1e-5):
    sd = torch.sqrt(torch.as_tensor(sigma, dtype=F32) ** 2 + eps)
    return gamma * (s - mu) / sd + beta


# ------------------------------------------------------------------ #
# functional binarized dense layer                                     #
# ------------------------------------------------------------------ #
def bnn_dense_train(x, w, mu, sigma, gamma, beta,
                    binarize_acts: bool = True, eps: float = 1e-5):
    """Training path: STE sign, float BN, sign activation.
    x: [..., K], w: [N, K] latent weights."""
    xb = ste_sign(x) if binarize_acts else x
    wb, alpha = binarize_weights(w, axis=1)
    s = torch.einsum("...k,nk->...n", xb, wb)
    y = bn_reference(s * alpha[:, 0], mu, sigma, gamma, beta, eps)
    return ste_sign(y)


def bnn_dense_serve_folded(xp, wp, fold: FoldedThreshold,
                           n: Optional[int] = None):
    """Inference path: packed XNOR-popcount + integer threshold.
    xp, wp: PackedArray (n inferred) or raw int32 words + explicit n;
    wp rows are output channels ([N, K] packed over K)."""
    return apply_folded(xnor_popcount_dot(xp, wp, n), fold)


def bnn_mlp_serve_folded(xp: PackedArray, layers,
                         backend: Optional[str] = None) -> PackedArray:
    """DEPRECATED shim over the graph compiler
    (``repro_torch.graph.compile.serve_folded_stack``): ``layers`` is a
    sequence of (wp PackedArray [N, K], FoldedThreshold) pairs as
    ``quantize_for_serving`` makes them; each fold is rewritten to the
    per-channel form at bind time and the stack runs under the compiled
    plan, on xp's device."""
    from repro_torch.graph.compile import serve_folded_stack

    return serve_folded_stack(xp, layers, backend=backend)


def _fold_scaled(alpha: torch.Tensor, mu, sigma, gamma, beta, n: int,
                 eps: float) -> FoldedThreshold:
    """The fold with the per-channel alpha scale absorbed into BN's
    statistics: BN(alpha*s) >= 0 folds with mu/alpha, sd/alpha."""
    a = torch.where(alpha == 0, 1e-12, alpha)
    sd = torch.sqrt(torch.as_tensor(sigma, dtype=F32) ** 2 + eps)
    return fold_bn_threshold(torch.as_tensor(mu) / a, sd / a, gamma, beta,
                             n, eps=0.0)


def quantize_for_serving(w, mu, sigma, gamma, beta, eps: float = 1e-5):
    """Convert a trained binarized dense layer ``w [N, K]`` to the
    integer serving form: (PackedArray [N, K] packed over K, pad bits
    -1 and masked by the logical length, and the folded threshold, the
    alpha scale absorbed)."""
    n = w.shape[1]
    wb = torch.where(w > 0, 1.0, -1.0)
    alpha = torch.mean(torch.abs(w), dim=1)
    return PackedArray.pack(wb, axis=1), \
        _fold_scaled(alpha, mu, sigma, gamma, beta, n, eps)


def quantize_conv_for_serving(w, mu, sigma, gamma, beta,
                              eps: float = 1e-5):
    """Conv twin of :func:`quantize_for_serving`: ``w [KH, KW, C, F]``
    -> (channel-packed PackedArray filter, axis 2, and the folded
    per-output-channel threshold, alpha = mean |w| over the KH*KW*C
    taps absorbed).  The pair drops into CompiledBNN conv params as
    ``{"wf": wf, "t": fold}``."""
    kh, kw, c_in, _f = w.shape
    wb = torch.where(w > 0, 1.0, -1.0)
    alpha = torch.mean(torch.abs(w), dim=(0, 1, 2))
    return PackedArray.pack(wb, axis=2), \
        _fold_scaled(alpha, mu, sigma, gamma, beta, kh * kw * c_in, eps)


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
    # per-word mask of the valid bits (int64, then the int32 pattern),
    # made on the words' device: a copy from the host cannot be part of
    # a CUDA graph's capture
    valid = torch.clamp(length - 32 * torch.arange(nw, dtype=torch.int64,
                                                   device=words.device),
                        0, 32)
    mask = ((torch.ones_like(valid) << valid) - 1).to(torch.int64)
    mask = torch.where(mask >= 2 ** 31, mask - 2 ** 32, mask).to(WORD)
    shape = [1] * ndim
    shape[word_axis] = nw
    flipped = (~words) & mask.reshape(shape)
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
