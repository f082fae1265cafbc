"""Fully-binary GEMM: packed activations x packed weights (XNOR-popcount).

The counterpart of ``repro.kernels.popcount_gemm.popcount_gemm``; the
kernel is ``csrc/popcount_gemm.cu``.  Outputs: the int32 signed dot,
+-1 after a scalar or per-channel threshold, or (``pack_out``) the
decisions packed into words with columns >= ``valid_n`` zeroed, so the
int32 [M, N] never reaches device memory.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.packed import WORD, pack_words
from repro_torch.kernels.ref import popcount_gemm_ref

__all__ = ["check_threshold_args", "popcount_gemm", "popcount_gemm_plain",
           "threshold_mode"]


def check_threshold_args(threshold: Optional[int],
                         threshold_vec: Optional[torch.Tensor], n: int,
                         pack_out: bool, device: torch.device) -> None:
    """Shared validation of the threshold operands of the GEMM and conv
    kernels."""
    if threshold is not None and threshold_vec is not None:
        raise ValueError("pass either threshold or threshold_vec, not both")
    if pack_out and threshold is None and threshold_vec is None:
        raise ValueError("pack_out requires a threshold "
                         "(binary output to pack)")
    if threshold_vec is not None:
        if threshold_vec.dtype != WORD or threshold_vec.ndim != 1 \
                or threshold_vec.shape[0] < n:
            raise ValueError(f"threshold_vec must be int32 [>= {n}], got "
                             f"{threshold_vec.dtype} "
                             f"{tuple(threshold_vec.shape)}")
        if threshold_vec.device != device or \
                not threshold_vec.is_contiguous():
            raise ValueError("threshold_vec must be contiguous on the "
                             "operands' device")


def threshold_mode(threshold: Optional[int],
                   threshold_vec: Optional[torch.Tensor]) -> int:
    """The C entry points' threshold mode (csrc/binary.cuh)."""
    if threshold_vec is not None:
        return 2
    return 0 if threshold is None else 1


def apply_threshold_plain(dot: torch.Tensor, threshold: Optional[int],
                          threshold_vec: Optional[torch.Tensor],
                          pack_out: bool, valid_n: int) -> torch.Tensor:
    """The epilogue of the GEMM and conv kernels, in plain torch, on a
    [..., N] dot."""
    if threshold is None and threshold_vec is None:
        return dot
    n = dot.shape[-1]
    thr = threshold if threshold_vec is None else threshold_vec[:n]
    bit = dot >= thr
    if not pack_out:
        return torch.where(bit, 1, -1).to(WORD)
    col = torch.arange(n, device=dot.device)
    return pack_words((bit & (col < valid_n)).to(torch.int8), axis=-1)


def popcount_gemm_plain(xp: torch.Tensor, wp: torch.Tensor, k: int,
                        threshold: Optional[int] = None,
                        threshold_vec: Optional[torch.Tensor] = None,
                        pack_out: bool = False,
                        valid_n: Optional[int] = None) -> torch.Tensor:
    """The plain torch version: the oracle dot, then the epilogue."""
    n = wp.shape[0]
    dot = popcount_gemm_ref(xp, wp, k)
    return apply_threshold_plain(dot, threshold, threshold_vec, pack_out,
                                 n if valid_n is None else valid_n)


def popcount_gemm(xp: torch.Tensor, wp: torch.Tensor, k: int,
                  threshold: Optional[int] = None,
                  threshold_vec: Optional[torch.Tensor] = None,
                  pack_out: bool = False,
                  valid_n: Optional[int] = None) -> torch.Tensor:
    """xp: int32 words [M, K32]; wp: int32 words [N, K32]; k = valid bit
    count.  Returns int32 [M, N] (the signed dot, or +-1 with a
    threshold), or with ``pack_out`` int32 words [M, ceil(N/32)].  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    if xp.ndim != 2 or wp.ndim != 2 or xp.shape[1] != wp.shape[1]:
        raise ValueError(f"popcount_gemm takes [M, K32] x [N, K32], got "
                         f"{tuple(xp.shape)} x {tuple(wp.shape)}")
    m, k32 = xp.shape
    n = wp.shape[0]
    if not 0 < k <= 32 * k32:
        raise ValueError(f"k={k} outside (0, {32 * k32}]")
    valid_n = n if valid_n is None else valid_n
    check_threshold_args(threshold, threshold_vec, n, pack_out, xp.device)
    if xp.device.type == "cpu":
        return popcount_gemm_plain(xp, wp, k, threshold, threshold_vec,
                                   pack_out, valid_n)
    _build.require_cuda_tensor(xp, "popcount_gemm")
    for t, name in ((xp, "xp"), (wp, "wp")):
        if t.dtype != WORD or not t.is_contiguous() or t.device != xp.device:
            raise ValueError(f"popcount_gemm: {name} must be contiguous "
                             f"int32 words on {xp.device}")
    shape = (m, (n + 31) // 32) if pack_out else (m, n)
    out = torch.empty(shape, dtype=WORD, device=xp.device)
    _build.POPCOUNT_GEMM.launch(
        xp.device, _build.ptr(xp), _build.ptr(wp), _build.ptr(threshold_vec),
        _build.ptr(out), m, n, k32, k,
        threshold_mode(threshold, threshold_vec),
        0 if threshold is None else int(threshold), int(pack_out), valid_n)
    return out
