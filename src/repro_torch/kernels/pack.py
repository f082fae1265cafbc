"""Binarize + bit-pack activations: float32 [M, K] -> words [M, K/32].

The counterpart of ``repro.kernels.pack.pack``; the kernel is
``csrc/pack.cu``.  Any K is accepted: the kernel masks the ragged last
word, whose pad bits are 0 as in the canonical packer.  An optional
float32 ``scale[K]`` is multiplied in before the compare (the alpha of a
float entry conv, taken in the pack's load in place of a separate pass):
bit = ``x * scale > 0``, the same float32 product as torch's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.packed import WORD
from repro_torch.kernels.ref import pack_ref

__all__ = ["PATHS", "pack", "pack_path", "pack_plain"]

# the kernel's paths (csrc/pack.cu), fastest first
PATHS = ("flat", "rows")


def pack_plain(x: torch.Tensor,
               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain torch version (the canonical packer, after torch's
    multiply by ``scale``)."""
    return pack_ref(x if scale is None else x * scale)


def pack_path(k: int, x_ptr: int, scale_ptr: Optional[int] = None) -> str:
    """The kernel path for a row length ``k`` and the operands' addresses:
    "flat" (16-byte loads over the flat array) where K % 32 == 0 and both
    are 16-byte aligned, else "rows" (4-byte loads, one thread a word)."""
    aligned = x_ptr % 16 == 0 and (scale_ptr is None or scale_ptr % 16 == 0)
    return "flat" if aligned and k % 32 == 0 else "rows"


def _check_scale(scale: Optional[torch.Tensor], x: torch.Tensor) -> None:
    if scale is None:
        return
    if scale.shape != (x.shape[-1],) or scale.dtype != torch.float32 \
            or scale.device != x.device or not scale.is_contiguous():
        raise ValueError(f"pack: scale must be contiguous float32 "
                         f"[{x.shape[-1]}] on {x.device}, got {scale.dtype} "
                         f"{tuple(scale.shape)} on {scale.device}")


def pack(x: torch.Tensor,
         scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: float32 [M, K] -> int32 words [M, ceil(K/32)], bit b of word j
    = ``x[:, 32*j + b] > 0``, or with ``scale`` (float32 [K])
    ``x[:, c] * scale[c] > 0``.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel on the path of :func:`pack_path`."""
    if x.ndim != 2:
        raise ValueError(f"pack takes [M, K], got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        _check_scale(scale, x)
        return pack_plain(x, scale)
    _build.require_cuda_tensor(x, "pack")
    return _launch(x, scale, pack_path(x.shape[1], x.data_ptr(),
                                       _build.ptr(scale)))


def _launch(x: torch.Tensor, scale: Optional[torch.Tensor],
            path: str) -> torch.Tensor:
    """The kernel on a CUDA operand with the path given, one of
    ``PATHS``: :func:`pack` passes its choice, and the checks on the card
    pass every path the operands allow.  A path they do not allow is
    refused by the kernel's entry point (raises)."""
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    if x.device.type != "cuda":
        raise ValueError(f"pack's kernel takes CUDA tensors, got device "
                         f"{x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"pack kernel takes float32, got {x.dtype}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError("pack kernel takes a contiguous [M, K] tensor")
    _check_scale(scale, x)
    m, k = x.shape
    kw = (k + 31) // 32
    if m * kw >= 2 ** 31:
        raise ValueError(f"pack's kernel takes fewer than 2^31 words, got "
                         f"{m * kw}")
    out = torch.empty(m, kw, dtype=WORD, device=x.device)
    _build.PACK.launch(x.device, _build.ptr(x), _build.ptr(scale),
                       _build.ptr(out), m, k, kw, PATHS.index(path),
                       _build.device_sms(x.device))
    return out
