"""Binarization primitives: sign with a straight-through estimator,
XNOR-Net weight scaling, and the bit-packing facade.

The port of ``repro.core.binarize``.  Training uses the straight-through
estimator of Courbariaux et al. (the BNN formulation the paper builds
on): forward sign, backward the identity clipped to |x| <= 1 on the
latent full-precision weights.  The packing itself lives in one place,
``repro_torch.kernels.packed``; ``pack_bits`` / ``unpack_bits`` /
``popcount_u32`` here delegate to it.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels.packed import (PackedArray, pack_words,
                                        popcount_u32, unpack_words)

__all__ = ["ste_sign", "binarize_weights", "pack_bits", "unpack_bits",
           "popcount_u32", "xnor_popcount_dot", "sign_dot_reference",
           "PackedArray"]


# ------------------------------------------------------------------ #
# sign with straight-through estimator                                 #
# ------------------------------------------------------------------ #
class _STESign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (torch.abs(x) <= 1.0).to(g.dtype)


def ste_sign(x: torch.Tensor) -> torch.Tensor:
    """sign(x) in {-1, +1} (``x >= 0`` -> +1); gradient = identity
    clipped to |x| <= 1, the bound included."""
    return _STESign.apply(x)


def binarize_weights(w: torch.Tensor, per_channel_scale: bool = True,
                     axis: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """XNOR-Net-style: w ~ alpha * sign(w), alpha = mean |w| per output
    channel (detached).  Returns (sign in {-1,1} as w.dtype, alpha)."""
    wb = ste_sign(w)
    if per_channel_scale:
        alpha = torch.mean(torch.abs(w), dim=axis, keepdim=True)
    else:
        alpha = torch.mean(torch.abs(w))
    return wb, alpha.detach().to(w.dtype)


# ------------------------------------------------------------------ #
# bit packing facade — canonical impl in repro_torch.kernels.packed    #
# ------------------------------------------------------------------ #
def pack_bits(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack a +-1 (or 0/1) tensor into int32 words (the uint32 bit
    pattern) along ``axis``; a non-multiple-of-32 axis is zero-padded to
    the word boundary, zeros packing to bit 0 == -1."""
    return pack_words(x, axis=axis)


def unpack_bits(words: torch.Tensor, axis: int = -1,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of pack_bits: words -> +-1 values of ``dtype``."""
    return unpack_words(words, axis=axis, dtype=dtype)


# ------------------------------------------------------------------ #
# packed binary dot                                                    #
# ------------------------------------------------------------------ #
def xnor_popcount_dot(xp: Union[PackedArray, torch.Tensor],
                      wp: Union[PackedArray, torch.Tensor],
                      n: Optional[int] = None) -> torch.Tensor:
    """Binary dot product from packed operands.

    xp: [..., K/32] and wp: [N, K/32], as PackedArray (n inferred from
    the logical length) or raw int32 words (explicit n required).
    Returns [..., N] int32 equal to sum(sign_x * sign_w) over the n
    valid bits, ``dot = 2 * (pc - (K_packed - n)) - n`` with pc the
    popcount of XNOR (zero pad bits XNOR to 1 and are subtracted).
    Operands with different word counts are zero-padded to a common
    width; different logical lengths raise."""
    lengths = [a.length for a in (xp, wp) if isinstance(a, PackedArray)]
    if n is not None:
        lengths.append(n)
    if len(set(lengths)) > 1:
        raise ValueError(f"contraction length mismatch: {lengths}")
    n = lengths[0] if lengths else None
    if isinstance(xp, PackedArray):
        xp = xp.move_pack_axis_last().words
    if isinstance(wp, PackedArray):
        wp = wp.move_pack_axis_last().words
    if n is None:
        raise ValueError("n is required with raw packed words")
    kw = max(xp.shape[-1], wp.shape[-1])

    def pad(a):
        if a.shape[-1] == kw:
            return a
        return torch.nn.functional.pad(a, (0, kw - a.shape[-1]))

    xnor = ~(pad(xp)[..., None, :] ^ pad(wp))     # [..., N, K/32]
    pc = popcount_u32(xnor).sum(dim=-1, dtype=torch.int32)
    return 2 * (pc - (32 * kw - n)) - n


def sign_dot_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Oracle: dot of sign(x), sign(w) rows in full precision."""
    xs = torch.where(x > 0, 1.0, -1.0)
    ws = torch.where(w > 0, 1.0, -1.0)
    return torch.einsum("...k,nk->...n", xs, ws)
