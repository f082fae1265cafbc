"""Binarize + bit-pack activations: float32 [M, K] -> words [M, K/32].

The counterpart of ``repro.kernels.pack.pack``; the kernel is
``csrc/pack.cu``.  Any K is accepted: the kernel masks the ragged last
word, whose pad bits are 0 as in the canonical packer.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.packed import WORD
from repro_torch.kernels.ref import pack_ref

__all__ = ["pack", "pack_plain"]


def pack_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain torch version (the canonical packer)."""
    return pack_ref(x)


def pack(x: torch.Tensor) -> torch.Tensor:
    """x: float32 [M, K] -> int32 words [M, ceil(K/32)], bit b of word j
    = ``x[:, 32*j + b] > 0``.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel."""
    if x.ndim != 2:
        raise ValueError(f"pack takes [M, K], got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return pack_plain(x)
    _build.require_cuda_tensor(x, "pack")
    if x.dtype != torch.float32:
        raise TypeError(f"pack kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("pack kernel takes a contiguous tensor")
    m, k = x.shape
    kw = (k + 31) // 32
    out = torch.empty(m, kw, dtype=WORD, device=x.device)
    _build.PACK.launch(x.device, _build.ptr(x), _build.ptr(out), m, k, kw)
    return out
