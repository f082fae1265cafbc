"""Plain torch oracles for the Hopper kernels (the exactness targets).

Counterpart of ``repro.kernels.ref``; built on the canonical
pack/unpack/popcount primitives of ``kernels.packed``.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.packed import (WORD, pack_words, popcount_u32,
                                        unpack_words)


@contextlib.contextmanager
def full_fp32():
    """Run float32 convolutions and products in full float32 on the
    card: cuDNN defaults to TF32 (``cudnn.allow_tf32`` is True), which
    keeps about three decimal digits and can flip a sign near zero, and
    a caller may have turned TF32 on for cuBLAS."""
    cd = torch.backends.cudnn
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with cd.flags(enabled=cd.enabled, benchmark=cd.benchmark,
                      deterministic=cd.deterministic, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm


def xnor_gemm_ref(x: torch.Tensor, wp: torch.Tensor, alpha: torch.Tensor,
                  threshold=None) -> torch.Tensor:
    """x: [M, K] float; wp: [K/32, N] int32 words packed over K; alpha:
    [N].  Returns float32 ``y = (x @ unpack(wp)) * alpha``, or with a
    threshold (scalar or [N]) ``where(y >= threshold, 1., -1.)``."""
    w = unpack_words(wp, axis=0, dtype=torch.float32)     # [K, N] +-1
    y = (x.to(torch.float32) @ w) * alpha.to(torch.float32)
    if threshold is not None:
        y = torch.where(y >= threshold, 1.0, -1.0)
    return y


def popcount_gemm_ref(xp: torch.Tensor, wp: torch.Tensor,
                      k: int) -> torch.Tensor:
    """xp: [M, K32], wp: [N, K32] int32 words.  Returns int32 [M, N] =
    the signed dot over the k valid bits (pad bits are 0 on both sides
    and cancel through the closed form).  One [M, N] XNOR plane per
    word, so memory stays at one plane."""
    if xp.shape[-1] != wp.shape[-1]:
        raise ValueError(f"packed K mismatch: {xp.shape[-1]} vs "
                         f"{wp.shape[-1]} words")
    pc = torch.zeros(xp.shape[0], wp.shape[0], dtype=WORD,
                     device=xp.device)
    for t in range(xp.shape[-1]):
        pc += popcount_u32(~(xp[:, t, None] ^ wp[None, :, t]))
    k_packed = 32 * xp.shape[-1]
    return 2 * (pc - (k_packed - k)) - k


def pack_ref(x: torch.Tensor) -> torch.Tensor:
    """x: [M, K] -> [M, ceil(K/32)] int32 words (the canonical packer)."""
    return pack_words(x, axis=-1)


def sign_conv2d_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                    pad: int = 0, pad_w: Optional[int] = None
                    ) -> torch.Tensor:
    """Dense sign-domain conv2d oracle.

    x: [N, H, W, C] +-1 values; w: [KH, KW, C, F] +-1 values.  Spatial
    padding is **-1 padding** (the only border a pm1 bit code can
    represent), ``pad`` pixels per side (``pad_w`` overrides W); the
    conv itself is VALID with the given stride.  Returns the exact
    int32 dot [N, HO, WO, F]: +-1 sums are integers far below 2**24,
    exact in full float32."""
    pad_w = pad if pad_w is None else pad_w
    xc = x.to(torch.float32).permute(0, 3, 1, 2)
    if pad or pad_w:
        xc = F.pad(xc, (pad_w, pad_w, pad, pad), value=-1.0)
    wc = w.to(torch.float32).permute(3, 2, 0, 1)
    with full_fp32():
        y = F.conv2d(xc, wc, stride=stride)
    return torch.round(y).to(WORD).permute(0, 2, 3, 1).contiguous()
