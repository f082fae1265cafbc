"""Binary-weight GEMM: float activations x packed weights.

The counterpart of ``repro.kernels.xnor_gemm.xnor_gemm``; the kernel is
``csrc/xnor_gemm.cu``.  ``x`` is float32 or bfloat16 [M, K], the
weights are int32 words [K/32, N] packed over K (bit b of word j is row
32*j + b), ``alpha`` [N] is read as float32.  The sum runs in float32
over all of K and is scaled by ``alpha`` once.  Outputs: ``y`` in
x's dtype; +-1 in x's dtype after ``y >= T`` (T a float scalar or a
float32 [N] vector); or, with ``pack_out``, the decisions packed into
int32 words [M, ceil(N/32)] with columns >= ``valid_n`` zeroed — the
float->binary boundary layer of a fully-binary stack.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.packed import WORD, pack_words
from repro_torch.kernels.popcount_gemm import threshold_mode
from repro_torch.kernels.ref import xnor_gemm_ref

__all__ = ["xnor_gemm", "xnor_gemm_plain"]

# the C entry point's dtype codes for x (csrc/xnor_gemm.cu)
X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_args(x: torch.Tensor, wp: torch.Tensor, alpha: torch.Tensor,
                threshold: Optional[float],
                threshold_vec: Optional[torch.Tensor],
                pack_out: bool) -> None:
    if x.ndim != 2 or wp.ndim != 2:
        raise ValueError(f"xnor_gemm takes x [M, K] and wp [K/32, N], got "
                         f"{tuple(x.shape)} and {tuple(wp.shape)}")
    if x.shape[1] != 32 * wp.shape[0]:
        raise ValueError(f"K {x.shape[1]} vs packed {32 * wp.shape[0]}: "
                         f"x's contraction dim must equal 32x the packed "
                         f"word count")
    if x.dtype not in X_DTYPES:
        raise TypeError(f"xnor_gemm takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    n = wp.shape[1]
    if alpha.numel() != n:
        raise ValueError(f"alpha has {alpha.numel()} entries for N={n}")
    if threshold is not None and threshold_vec is not None:
        raise ValueError("pass either threshold or threshold_vec, not both")
    if pack_out and threshold is None and threshold_vec is None:
        raise ValueError("pack_out requires a threshold "
                         "(binary output to pack)")
    if threshold_vec is not None and (
            threshold_vec.dtype != torch.float32 or threshold_vec.ndim != 1
            or threshold_vec.shape[0] < n
            or threshold_vec.device != x.device):
        raise ValueError(f"threshold_vec must be float32 [>= {n}] on "
                         f"{x.device}, got {threshold_vec.dtype} "
                         f"{tuple(threshold_vec.shape)} on "
                         f"{threshold_vec.device}")


def xnor_gemm_plain(x: torch.Tensor, wp: torch.Tensor, alpha: torch.Tensor,
                    threshold: Optional[float] = None,
                    threshold_vec: Optional[torch.Tensor] = None,
                    pack_out: bool = False,
                    valid_n: Optional[int] = None) -> torch.Tensor:
    """The plain torch version: the float32 oracle, then the epilogue."""
    n = wp.shape[1]
    y = xnor_gemm_ref(x, wp, alpha)
    if threshold is None and threshold_vec is None:
        return y.to(x.dtype)
    bit = y >= (threshold if threshold_vec is None else threshold_vec[:n])
    if not pack_out:
        return torch.where(bit, 1.0, -1.0).to(x.dtype)
    col = torch.arange(n, device=y.device)
    valid_n = n if valid_n is None else valid_n
    return pack_words((bit & (col < valid_n)).to(torch.int8), axis=-1)


def xnor_gemm(x: torch.Tensor, wp: torch.Tensor, alpha: torch.Tensor,
              threshold: Optional[float] = None,
              threshold_vec: Optional[torch.Tensor] = None,
              pack_out: bool = False,
              valid_n: Optional[int] = None) -> torch.Tensor:
    """x: float32/bf16 [M, K]; wp: int32 words [K/32, N]; alpha: [N].
    Returns [M, N] in x.dtype (y, or +-1 with a threshold), or with
    ``pack_out`` int32 words [M, ceil(N/32)].  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel."""
    _check_args(x, wp, alpha, threshold, threshold_vec, pack_out)
    m, n = x.shape[0], wp.shape[1]
    valid_n = n if valid_n is None else valid_n
    if x.device.type == "cpu":
        return xnor_gemm_plain(x, wp, alpha, threshold, threshold_vec,
                               pack_out, valid_n)
    _build.require_cuda_tensor(x, "xnor_gemm")
    if wp.dtype != WORD or not wp.is_contiguous() or wp.device != x.device:
        raise ValueError(f"xnor_gemm: wp must be contiguous int32 words on "
                         f"{x.device}")
    x = x.contiguous()
    if x.data_ptr() % 16:              # the kernel reads 16-byte chunks
        x = x.clone()
    alpha = alpha.reshape(-1).to(device=x.device,
                                 dtype=torch.float32).contiguous()
    if threshold_vec is not None:
        threshold_vec = threshold_vec.contiguous()
    if pack_out:
        out = torch.empty(m, (n + 31) // 32, dtype=WORD, device=x.device)
    else:
        out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    _build.XNOR_GEMM.launch(
        x.device, _build.ptr(x), X_DTYPES[x.dtype], _build.ptr(wp),
        _build.ptr(alpha), _build.ptr(threshold_vec), _build.ptr(out), m, n,
        wp.shape[0], threshold_mode(threshold, threshold_vec),
        0.0 if threshold is None else float(threshold),
        int(pack_out), valid_n)
    return out
