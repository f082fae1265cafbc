"""The float entry conv with its sign bits packed in the epilogue:
float32 NHWC x against sign(w), times alpha, signed and packed over the
channels, in one launch (``csrc/entry_conv.cu``).

Bit b of word j of pixel (n, oy, ox) is ``acc * alpha[32*j + b] > 0``
in float32, acc the window's sum of ``x * where(w > 0, 1, -1)`` with a
real zero pad: the words that ``sign_weight_conv`` and then the pack
with ``scale=alpha`` give, without the float32 map between them.  Sums
of integer pixels are exact in any order, so there the words equal the
two steps' bit for bit; other inputs may differ where a sum is within
float32 rounding of 0.

The kernel takes the shapes of :func:`plan` (C <= 16, K <= 7, stride 1
or 2, a pad below the window, F % 32 == 0, shared memory that a block
may have); ``graph.compile`` sends it only those and keeps the two
steps elsewhere.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.fused_mlp import SMEM_BYTES
from repro_torch.kernels.ops import conv_padding
from repro_torch.kernels.pack import pack_plain
from repro_torch.kernels.packed import WORD
from repro_torch.kernels.ref import full_fp32

__all__ = ["entry_conv", "entry_conv_plain", "plan", "sign_weight_conv",
           "supports"]

WARPS = 4                  # a block of the kernel: 4 warps, each one word
PIX = 4                    # output pixels of a row a thread
PASSES = 4                 # most passes of a block's threads over a tile


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def plan(h: int, w: int, c: int, f: int, kh: int, kw: int, stride: int,
         pad_h: int, pad_w: int) -> Optional[dict]:
    """The kernel's launch geometry for a conv of this shape, or None
    where the kernel does not take it.  ``wb``: words a block owns (the
    largest of 4, 2, 1 dividing F/32 whose shared memory fits); ``gx``:
    thread groups along a tile row (a power of two, a group PIX pixels);
    ``passes``: of the block's threads over a tile (the most, up to
    PASSES, that the image's rows use and the shared memory holds);
    ``th`` x ``tw``: the tile of output pixels; ``smem``: bytes."""
    if not (1 <= c <= 16 and 1 <= kh <= 7 and 1 <= kw <= 7
            and stride in (1, 2) and f >= 32 and f % 32 == 0
            and 0 <= pad_h < kh and 0 <= pad_w < kw):
        return None
    ho = (h + 2 * pad_h - kh) // stride + 1
    wo = (w + 2 * pad_w - kw) // stride + 1
    if ho < 1 or wo < 1:
        return None
    taps = kh * kw * c
    for wb in (4, 2, 1):
        if (f // 32) % wb:
            continue
        groups = 32 * WARPS // wb
        gx = min(_pow2_at_least(-(-wo // PIX)), groups, 16)
        thb, tw = groups // gx, PIX * gx     # rows of a pass, columns
        pwr = (tw - 1) * stride + kw
        pitch = pwr + (1 - pwr) % 4
        for passes in range(min(PASSES, -(-ho // thb)), 0, -1):
            th = passes * thb
            ph = (th - 1) * stride + kh
            smem = 4 * (taps * wb * 32 + wb * 32 + th * tw * wb
                        + 2 * c * ph * pitch + taps + 1)
            if smem <= SMEM_BYTES:
                return dict(wb=wb, gx=gx, passes=passes, th=th, tw=tw,
                            ho=ho, wo=wo, smem=smem)
    return None


def _plan_of(x_shape: Tuple[int, ...], w_shape: Tuple[int, ...],
             stride: int, padding: Union[str, int]
             ) -> Tuple[int, int, Optional[dict]]:
    _, h, w, c = x_shape
    kh, kw, _, f = w_shape
    pad_h, pad_w = conv_padding(padding, kh, kw)
    return pad_h, pad_w, plan(h, w, c, f, kh, kw, stride, pad_h, pad_w)


def supports(x_shape: Tuple[int, ...], w_shape: Tuple[int, ...],
             stride: int, padding: Union[str, int]) -> bool:
    """Whether the kernel takes a conv of input ``[N, H, W, C]`` and
    weights ``[KH, KW, C, F]`` (from the shapes alone)."""
    return _plan_of(x_shape, w_shape, stride, padding)[2] is not None


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


def entry_conv_plain(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
                     stride: int = 1, padding: Union[str, int] = "same"
                     ) -> torch.Tensor:
    """The plain version: the two steps the kernel replaces,
    :func:`sign_weight_conv` (cuDNN in full float32 on the card) and the
    pack with ``scale=alpha``."""
    y = sign_weight_conv(x, w, stride=stride, padding=padding)
    f = y.shape[-1]
    words = pack_plain(y.reshape(-1, f), alpha.to(torch.float32))
    return words.reshape(*y.shape[:-1], words.shape[-1])


def entry_conv(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
               stride: int = 1, padding: Union[str, int] = "same"
               ) -> torch.Tensor:
    """x float [N, H, W, C] (NHWC), w float [KH, KW, C, F] (latent: the
    sign is taken here), alpha float [F] -> int32 words [N, HO, WO,
    F/32], bit b of word j = ``conv(x, sign(w))[..., 32j+b] * alpha >
    0``.  A shape the kernel does not take (:func:`plan`) raises, on
    any device; a CPU tensor takes the plain version, a CUDA tensor
    launches the kernel."""
    if x.ndim != 4 or w.ndim != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"entry_conv takes x [N, H, W, C] and w [KH, KW, "
                         f"C, F], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    pad_h, pad_w, p = _plan_of(x.shape, w.shape, stride, padding)
    if p is None:
        raise ValueError(f"entry_conv's kernel does not take x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}, stride "
                         f"{stride}, padding {padding!r}")
    if x.device.type == "cpu":
        return entry_conv_plain(x, w, alpha, stride, padding)
    _build.require_cuda_tensor(x, "entry_conv")
    return _launch(x, w, alpha, stride, pad_h, pad_w, p)


def _launch(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
            stride: int, pad_h: int, pad_w: int, p: dict) -> torch.Tensor:
    """The kernel on CUDA operands with the plan ``p`` of :func:`plan`."""
    f = w.shape[3]
    x = x.to(torch.float32).contiguous()
    w = w.to(torch.float32).contiguous()
    alpha = alpha.to(device=x.device, dtype=torch.float32).contiguous()
    if w.device != x.device or alpha.shape != (f,):
        raise ValueError(f"entry_conv: w and alpha [{f}] must be on "
                         f"{x.device}, got w on {w.device}, alpha "
                         f"{tuple(alpha.shape)}")
    n, h, wi, c = x.shape
    if x.numel() >= 2 ** 31 or n * p["ho"] * p["wo"] * (f // 32) >= 2 ** 31:
        raise ValueError("entry_conv's kernel takes fewer than 2^31 input "
                         "floats and output words")
    out = torch.empty((n, p["ho"], p["wo"], f // 32), dtype=WORD,
                      device=x.device)
    if n == 0:
        return out
    _build.ENTRY_CONV.launch(
        x.device, _build.ptr(x), _build.ptr(w), _build.ptr(alpha),
        _build.ptr(out), n, h, wi, c, f, w.shape[0], w.shape[1], stride,
        pad_h, pad_w, p["ho"], p["wo"], p["wb"], p["gx"], p["passes"],
        _build.device_sms(x.device))
    return out
