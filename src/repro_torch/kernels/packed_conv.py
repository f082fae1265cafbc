"""Binary conv2d on channel-packed NHWC words.

The counterpart of ``repro.kernels.packed_conv``; the direct kernel is
``csrc/packed_conv.cu``.  Layout (as in the reference): activations are
``[N, H, W, C32]`` words, spatial "same" padding is **-1 padding** (all
zero words), filters are ``[KH*KW*C32, F]`` words in tap-major order,
and the closed form ``dot = 2*(pc - (K_p - K)) - K`` with
``K = KH*KW*C`` cancels the per-tap channel pad bits.

The kernel is an implicit GEMM on the tensor cores: N*HO*WO pixels by F
filters over the KH*KW*C32 words of each window, b1 ``mma.sync`` with
AND-popcount, ``dot = K - 2*(pc_x + pc_w) + 4*popc(x & w)``, one
launch per call.  Its output tile is chosen here, by :func:`tile_plan`.

``im2col_words`` is the fallback: a word-granularity patch matrix that
drops into ``popcount_gemm``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, autotune
from repro_torch.kernels.packed import WORD, popcount_u32
from repro_torch.kernels.popcount_gemm import (apply_threshold_plain,
                                               check_threshold_args,
                                               threshold_mode)

__all__ = ["im2col_words", "out_size", "packed_conv2d",
           "packed_conv2d_plain", "pad_words_spatial", "smem_bytes",
           "tile_plan"]

MMA_WORDS = 8           # K of one b1 m16n8k256 MMA, in words
KS_WORDS = 16           # K of one shared-memory stage, in words
# the kernel's output tiles (BM pixels x BN filters), largest first
TILES = ((128, 128), (64, 128), (64, 64))
H100_SMS = 132


def tile_plan(m: int, f: int, k32: int, sms: int = H100_SMS,
              pack_out: bool = False, tuned: bool = True,
              tiles: Tuple[Tuple[int, int], ...] = TILES) -> dict:
    """The launch plan of a conv with ``m`` output pixels, ``f`` filters
    and ``k32`` = KH*KW*C32 words per window.

    The tile is the tuning table's entry for ``("packed_conv[+pack]",
    "cuda", m, f, k32)`` where it has one (``tuned``; ``kernels.autotune``),
    else the rule: the largest of ``tiles`` (``TILES``, or a kernel's
    own subset of them) whose grid has at least half as many blocks as
    the card has SMs.  Each tile in ``TILES`` halves
    the one before, so the next has twice the blocks: from that point on
    it would not spread the work over more SMs, and the larger tile
    loads each word for more MMAs.  Where no grid is that large (batch
    1), the smallest tile spreads the work furthest.  ``python -m
    repro_torch.conv_tiles`` times every tile at the main paths' convs
    beside this choice.  K is zero-padded to ``k_words``, a multiple of
    the MMA depth (8 words).  Returns ``bm``, ``bn``, ``k_words``, the
    grid (pixel tiles, filter tiles) and its block count."""
    hit = autotune.get_table().get(
        ("packed_conv+pack" if pack_out else "packed_conv", "cuda", m, f,
         k32)) if tuned else None
    for bm, bn in ((hit["bm"], hit["bn"]),) if hit else tiles:
        grid = (-(-m // bm), -(-f // bn))
        if 2 * grid[0] * grid[1] >= sms:
            break
    return {"bm": bm, "bn": bn, "k_words": -(-k32 // MMA_WORDS) * MMA_WORDS,
            "grid": grid, "blocks": grid[0] * grid[1]}


def smem_bytes(bm: int, bn: int, k32: int, c32: int) -> int:
    """Dynamic shared memory of one block of tile (bm, bn) over ``k32``
    = KH*KW*C32 words of K (``csrc/packed_conv.cu``): a ring of 4 stages
    of 16 words of K (pixel rows of 20 words, weight rows of BN + 8), the
    counts pc_x [BM] and pc_w [BN], and the gather table, one int a
    chunk of K (4-word chunks where C32 % 4 == 0, else words)."""
    stage = bm * (KS_WORDS + 4) + KS_WORDS * (bn + 8)
    fixed = 4 * (4 * stage + bm + bn)
    stages = -(-(-(-k32 // MMA_WORDS) * MMA_WORDS) // KS_WORDS)
    return fixed + 4 * stages * (KS_WORDS // (4 if c32 % 4 == 0 else 1))


def out_size(n: int, k: int, stride: int, pad: int) -> int:
    """Output extent of a VALID conv over the padded extent."""
    return (n + 2 * pad - k) // stride + 1


def pad_words_spatial(xw: torch.Tensor, pad_h: int, pad_w: int
                      ) -> torch.Tensor:
    """Zero-word spatial padding of [N, H, W, C32] — a zero word decodes
    to 32 pixels of -1, the exactly-representable pm1 border."""
    if pad_h == 0 and pad_w == 0:
        return xw
    return F.pad(xw, (0, 0, pad_w, pad_w, pad_h, pad_h))


def _window(xw: torch.Tensor, i: int, j: int, stride: int, ho: int,
            wo: int) -> torch.Tensor:
    """The (i, j) tap's words for every output pixel -> [N, HO, WO, C32]."""
    return xw[:, i:i + (ho - 1) * stride + 1:stride,
              j:j + (wo - 1) * stride + 1:stride, :]


def im2col_words(xw: torch.Tensor, kh: int, kw: int, stride: int,
                 ho: int, wo: int) -> torch.Tensor:
    """Word-granularity im2col: [N, H_pad, W_pad, C32] -> patch matrix
    [N*HO*WO, KH*KW*C32] in the filters' tap-major word order."""
    cols = [_window(xw, i, j, stride, ho, wo)
            for i in range(kh) for j in range(kw)]
    patches = torch.stack(cols, dim=-2)       # [N, HO, WO, KH*KW, C32]
    return patches.reshape(xw.shape[0] * ho * wo, kh * kw * xw.shape[-1])


def packed_conv2d_plain(xw: torch.Tensor, ww: torch.Tensor, *, kh: int,
                        kw: int, c: int, stride: int, ho: int, wo: int,
                        threshold: Optional[int] = None,
                        threshold_vec: Optional[torch.Tensor] = None,
                        pack_out: bool = False,
                        valid_f: Optional[int] = None) -> torch.Tensor:
    """The plain torch version: one [N*HO*WO, F] XNOR plane per (tap,
    word), the closed form, then the epilogue."""
    n, _, _, c32 = xw.shape
    f = ww.shape[1]
    pc = torch.zeros(n * ho * wo, f, dtype=WORD, device=xw.device)
    for i in range(kh):
        for j in range(kw):
            xm = _window(xw, i, j, stride, ho, wo).reshape(-1, c32)
            base = (i * kw + j) * c32
            for t in range(c32):
                pc += popcount_u32(~(xm[:, t, None] ^ ww[None, base + t]))
    k = kh * kw * c
    dot = 2 * (pc - (32 * kh * kw * c32 - k)) - k
    y = apply_threshold_plain(dot, threshold, threshold_vec, pack_out,
                              f if valid_f is None else valid_f)
    return y.reshape(n, ho * wo, -1)


def packed_conv2d(xw: torch.Tensor, ww: torch.Tensor, *, kh: int, kw: int,
                  c: int, stride: int, ho: int, wo: int,
                  threshold: Optional[int] = None,
                  threshold_vec: Optional[torch.Tensor] = None,
                  pack_out: bool = False,
                  valid_f: Optional[int] = None) -> torch.Tensor:
    """Direct (im2col-free) binary conv2d on packed words.

    xw: int32 words [N, H_pad, W_pad, C32], spatial padding applied as
    zero words; ww: int32 words [KH*KW*C32, F], tap-major; c: logical
    channel count; ho, wo: the output extent.  Returns int32
    [N, HO*WO, F] (the dot, or +-1 with a threshold), or with
    ``pack_out`` int32 words [N, HO*WO, ceil(F/32)].  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel with the plan
    of :func:`tile_plan`."""
    if xw.ndim != 4 or ww.ndim != 2:
        raise ValueError(f"packed_conv2d takes [N, H, W, C32] x "
                         f"[KH*KW*C32, F], got {tuple(xw.shape)} x "
                         f"{tuple(ww.shape)}")
    n, h_pad, w_pad, c32 = xw.shape
    taps_words, f = ww.shape
    if taps_words != kh * kw * c32:
        raise ValueError(f"filter has {taps_words} words per output "
                         f"channel, expected KH*KW*C32 = {kh * kw * c32}")
    if not 0 < c <= 32 * c32:
        raise ValueError(f"c={c} outside (0, {32 * c32}]")
    if (ho - 1) * stride + kh > h_pad or (wo - 1) * stride + kw > w_pad \
            or ho < 1 or wo < 1:
        raise ValueError(f"output {ho}x{wo} does not fit a {h_pad}x{w_pad} "
                         f"input with a {kh}x{kw} stride-{stride} window")
    valid_f = f if valid_f is None else valid_f
    check_threshold_args(threshold, threshold_vec, f, pack_out, xw.device)
    args = dict(kh=kh, kw=kw, c=c, stride=stride, ho=ho, wo=wo,
                threshold=threshold, threshold_vec=threshold_vec,
                pack_out=pack_out, valid_f=valid_f)
    if xw.device.type == "cpu":
        return packed_conv2d_plain(xw, ww, **args)
    _build.require_cuda_tensor(xw, "packed_conv2d")
    p = tile_plan(n * ho * wo, f, taps_words, _build.device_sms(xw.device),
                  pack_out)
    return _launch(xw, ww, (p["bm"], p["bn"]), **args)


def _launch(xw: torch.Tensor, ww: torch.Tensor, tile: Tuple[int, int],
            *, kh: int, kw: int, c: int, stride: int, ho: int, wo: int,
            threshold: Optional[int] = None,
            threshold_vec: Optional[torch.Tensor] = None,
            pack_out: bool = False,
            valid_f: Optional[int] = None) -> torch.Tensor:
    """The kernel on CUDA operands whose shapes :func:`packed_conv2d`
    checked, with the tile ``(BM, BN)`` given, one of ``TILES``:
    :func:`packed_conv2d` passes its plan, and the checks on the card
    pass every tile in turn."""
    if tuple(tile) not in TILES:
        raise ValueError(f"tile must be one of {TILES}, got {tile}")
    if xw.device.type != "cuda":
        raise ValueError(f"packed_conv2d's kernel takes CUDA tensors, got "
                         f"device {xw.device}")
    for t, name in ((xw, "xw"), (ww, "ww")):
        if t.dtype != WORD or not t.is_contiguous() or t.device != xw.device:
            raise ValueError(f"packed_conv2d: {name} must be contiguous "
                             f"int32 words on {xw.device}")
    n, h_pad, w_pad, c32 = xw.shape
    f = ww.shape[1]
    valid_f = f if valid_f is None else valid_f
    if threshold_vec is not None:
        threshold_vec = threshold_vec.contiguous()
    m = n * ho * wo
    if m >= 2 ** 31:
        raise ValueError(f"packed_conv2d's kernel takes fewer than 2^31 "
                         f"output pixels, got {m}")
    out = torch.empty((n, ho * wo, (f + 31) // 32 if pack_out else f),
                      dtype=WORD, device=xw.device)
    if m == 0 or f == 0:
        return out
    bm, bn = tile
    _build.PACKED_CONV.launch(
        xw.device, _build.ptr(xw), _build.ptr(ww), _build.ptr(threshold_vec),
        _build.ptr(out), n, h_pad, w_pad, c32, kh, kw, stride, ho, wo, f,
        kh * kw * c, threshold_mode(threshold, threshold_vec),
        0 if threshold is None else int(threshold), int(pack_out), valid_f,
        bm, bn)
    return out
