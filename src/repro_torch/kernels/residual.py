"""The float side of a residual binary network (ReActNet): the epilogue
of a residual half-step and the real-valued stem, each one launch that
writes the float stream and the packed signs of the next learned-
threshold sign (``csrc/residual_epilogue.cu``).

A half-step ``out = rprelu(bn(alpha * conv0(sign(x + b_in), sign(w)))
+ shortcut(x))`` runs as two launches: ``packed_conv2d``'s
un-thresholded mode (the int32 dot, -1 padding) and
:func:`residual_epilogue`, which adds the zero-padding correction
(:func:`zero_pad_correction`) and does the rest.  Every float operation
is rounded on its own and in the order the docstring of
:func:`residual_epilogue_plain` spells, so the kernel, its plain
version and the plain reference (``repro_torch/reference/reactnet.py``)
give the same bits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.packed import WORD
from repro_torch.kernels.ref import pack_ref

__all__ = ["BN_EPS", "SHORTCUTS", "border_classes", "epilogue_table",
           "residual_epilogue", "residual_epilogue_plain", "stem_conv",
           "stem_conv_plain", "stem_table", "zero_pad_correction"]

BN_EPS = 1e-5                          # torch's BatchNorm2d default
SHORTCUTS = ("identity", "avgpool", "duplicate")


def _inv_std(var: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(var + eps), each operation correctly rounded (IEEE), so
    that every device and the reference compute the same number."""
    return 1.0 / torch.sqrt(var.to(torch.float32) + BN_EPS)


def epilogue_table(alpha, mean, var, gamma, beta, move_a, slope, move_b,
                   b_next: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-channel table [9, F] float32 of :func:`residual_epilogue`:
    alpha, BN mean, 1/sqrt(var + eps), gamma, beta, the RPReLU's bias
    before, its slope, its bias after, and the next RSign's bias (0
    where no sign follows)."""
    if b_next is None:
        b_next = torch.zeros_like(mean)
    rows = (alpha, mean, _inv_std(var), gamma, beta, move_a, slope, move_b,
            b_next)
    return torch.stack([r.to(torch.float32) for r in rows]).contiguous()


def stem_table(mean, var, gamma, beta,
               b_next: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-channel table [5, F] float32 of :func:`stem_conv`: BN
    mean, 1/sqrt(var + eps), gamma, beta and the next RSign's bias."""
    if b_next is None:
        b_next = torch.zeros_like(mean)
    rows = (mean, _inv_std(var), gamma, beta, b_next)
    return torch.stack([r.to(torch.float32) for r in rows]).contiguous()


def zero_pad_correction(signs: torch.Tensor) -> torch.Tensor:
    """int32 [16, F]: what a zero-padded conv adds over a -1 padded one
    at each border class, from the +-1 weights ``signs`` [K, K, C, F] of
    a conv with a pad of 1.  Class ``(top + 2*bottom) * 4 + (left +
    2*right)`` flags the window's first/last row and column as padded; a
    padded tap adds ``sum_c signs[tap, c, f]`` (its -1 pad had taken it
    off)."""
    k = signs.shape[0]
    if signs.ndim != 4 or signs.shape[1] != k:
        raise ValueError(f"zero_pad_correction takes square [K, K, C, F] "
                         f"signs, got {tuple(signs.shape)}")
    tap = signs.to(torch.float32).sum(dim=2).round().to(WORD)   # [K, K, F]
    rows = []
    for cls in range(16):
        rt, rb = cls // 4 & 1, cls // 8 & 1
        ct, cb = cls & 1, cls // 2 & 1
        pad = torch.zeros(k, k, dtype=torch.bool, device=signs.device)
        if rt:
            pad[0] = True
        if rb:
            pad[k - 1] = True
        if ct:
            pad[:, 0] = True
        if cb:
            pad[:, k - 1] = True
        rows.append((tap * pad[:, :, None].to(WORD)).sum(dim=(0, 1)))
    return torch.stack(rows).to(WORD).contiguous()


def border_classes(ho: int, wo: int, h_in: int, w_in: int, k: int,
                   stride: int, pad: int, device=None) -> torch.Tensor:
    """int64 [HO, WO]: each output pixel's border class (the row of
    :func:`zero_pad_correction`), as the kernel works it out."""
    y0 = torch.arange(ho, device=device) * stride - pad
    x0 = torch.arange(wo, device=device) * stride - pad
    rc = (y0 < 0).long() + 2 * (y0 + k - 1 >= h_in).long()
    cc = (x0 < 0).long() + 2 * (x0 + k - 1 >= w_in).long()
    return rc[:, None] * 4 + cc[None, :]


def _shortcut_plain(sc: torch.Tensor, shortcut: str, f: int) -> torch.Tensor:
    if shortcut == "identity":
        return sc
    if shortcut == "duplicate":
        return torch.cat([sc, sc], dim=-1)[..., :f]
    s = sc[:, 0::2, 0::2] + sc[:, 0::2, 1::2]
    s = s + sc[:, 1::2, 0::2]
    s = s + sc[:, 1::2, 1::2]
    return s * 0.25


def residual_epilogue_plain(dot: torch.Tensor, corr: Optional[torch.Tensor],
                            table: torch.Tensor, sc: torch.Tensor, *,
                            shortcut: str, k: int, stride: int, pad: int,
                            h_in: int, w_in: int, write_bits: bool = True
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version, in the kernel's order: ``d = dot +
    corr[class]``; ``v = ((float(d) * alpha - mean) * inv) * gamma +
    beta``; ``o = v + shortcut``; ``o = o + move_a``; ``o = where(o > 0,
    o, o * slope)``; ``o = o + move_b``; bits ``o + b_next > 0``."""
    n, ho, wo, f = dot.shape
    d = dot
    if corr is not None:
        cls = border_classes(ho, wo, h_in, w_in, k, stride, pad, dot.device)
        d = d + corr[cls]
    alpha, mean, inv, gamma, beta, move_a, slope, move_b, b_next = table
    v = d.to(torch.float32) * alpha
    v = (v - mean) * inv
    v = v * gamma + beta
    o = v + _shortcut_plain(sc, shortcut, f)
    o = o + move_a
    o = torch.where(o > 0, o, o * slope)
    o = o + move_b
    if not write_bits:
        return o, None
    words = pack_ref((o + b_next).reshape(-1, f))
    return o, words.reshape(n, ho, wo, f // 32)


def _check(dot, corr, table, sc, shortcut, k, pad):
    if dot.ndim != 4 or dot.dtype != WORD:
        raise ValueError(f"residual_epilogue takes the int32 dot [N, HO, WO, "
                         f"F], got {dot.dtype} {tuple(dot.shape)}")
    n, ho, wo, f = dot.shape
    if f % 32:
        raise ValueError(f"residual_epilogue takes F % 32 == 0, got {f}")
    if shortcut not in SHORTCUTS:
        raise ValueError(f"shortcut must be one of {SHORTCUTS}, got "
                         f"{shortcut!r}")
    want = {"identity": (n, ho, wo, f), "avgpool": (n, 2 * ho, 2 * wo, f),
            "duplicate": (n, ho, wo, f // 2)}[shortcut]
    if tuple(sc.shape) != want or sc.dtype != torch.float32:
        raise ValueError(f"a {shortcut} shortcut is float32 {want}, got "
                         f"{sc.dtype} {tuple(sc.shape)}")
    if tuple(table.shape) != (9, f):
        raise ValueError(f"table must be [9, {f}], got {tuple(table.shape)}")
    if (corr is None) != (pad == 0) or (corr is not None and (
            tuple(corr.shape) != (16, f) or pad != 1 or k != 3)):
        raise ValueError("a 3x3 conv with a pad of 1 takes corr [16, F]; a "
                         "conv without a pad takes none")
    for t in (corr, table, sc):
        if t is not None and t.device != dot.device:
            raise ValueError(f"residual_epilogue: operands on {t.device} "
                             f"and {dot.device}")


def residual_epilogue(dot: torch.Tensor, corr: Optional[torch.Tensor],
                      table: torch.Tensor, sc: torch.Tensor, *,
                      shortcut: str, k: int, stride: int, pad: int,
                      h_in: int, w_in: int, write_bits: bool = True
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """dot int32 [N, HO, WO, F] (packed_conv2d's -1 padded dot); corr
    int32 [16, F] for a 3x3 conv with a pad of 1, else None; table
    float32 [9, F] (:func:`epilogue_table`); sc the float32 shortcut
    (identity [N, HO, WO, F], avgpool [N, 2HO, 2WO, F], duplicate [N, HO,
    WO, F/2]); ``h_in``, ``w_in`` the conv's input extent.  Returns the
    float32 stream [N, HO, WO, F] and, with ``write_bits``, the next
    RSign's int32 words [N, HO, WO, F/32].  A CPU tensor takes the plain
    version, a CUDA tensor launches the kernel."""
    _check(dot, corr, table, sc, shortcut, k, pad)
    args = dict(shortcut=shortcut, k=k, stride=stride, pad=pad, h_in=h_in,
                w_in=w_in, write_bits=write_bits)
    if dot.device.type == "cpu":
        return residual_epilogue_plain(dot, corr, table, sc, **args)
    _build.require_cuda_tensor(dot, "residual_epilogue")
    n, ho, wo, f = dot.shape
    m = n * ho * wo
    if m * f >= 2 ** 31 or sc.numel() >= 2 ** 31:
        raise ValueError("residual_epilogue's kernel takes fewer than 2^31 "
                         "elements")
    dot = dot.contiguous()
    sc = sc.contiguous()
    table = table.to(torch.float32).contiguous()
    if corr is not None:
        corr = corr.to(WORD).contiguous()
    out = torch.empty((n, ho, wo, f), dtype=torch.float32, device=dot.device)
    bits = torch.empty((n, ho, wo, f // 32), dtype=WORD,
                       device=dot.device) if write_bits else None
    if m == 0:
        return out, bits
    _build.RESIDUAL_EPILOGUE.launch(
        dot.device, _build.ptr(dot), _build.ptr(corr), _build.ptr(table),
        _build.ptr(sc), _build.ptr(out), _build.ptr(bits), m, ho, wo, f,
        h_in, w_in, k, stride, pad, sc.shape[-1], SHORTCUTS.index(shortcut))
    return out, bits


def stem_conv_plain(x: torch.Tensor, w: torch.Tensor, table: torch.Tensor,
                    *, stride: int, pad: int, write_bits: bool = True
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version, in the kernel's order: ``acc = 0``, then ``acc
    = acc + x_tap * w_tap`` over the taps (kh, kw, c) of a zero-padded
    window; ``v = ((acc - mean) * inv) * gamma + beta``; bits ``v +
    b_next > 0``."""
    n, h, wi, c = x.shape
    kh, kw, _, f = w.shape
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (wi + 2 * pad - kw) // stride + 1
    xp = torch.nn.functional.pad(x.to(torch.float32),
                                 (0, 0, pad, pad, pad, pad))
    acc = torch.zeros(n, ho, wo, f, dtype=torch.float32, device=x.device)
    for i in range(kh):
        for j in range(kw):
            win = xp[:, i:i + (ho - 1) * stride + 1:stride,
                     j:j + (wo - 1) * stride + 1:stride]
            for ch in range(c):
                acc = acc + win[..., ch:ch + 1] * w[i, j, ch]
    mean, inv, gamma, beta, b_next = table
    v = (acc - mean) * inv
    v = v * gamma + beta
    if not write_bits:
        return v, None
    words = pack_ref((v + b_next).reshape(-1, f))
    return v, words.reshape(n, ho, wo, f // 32)


def stem_conv(x: torch.Tensor, w: torch.Tensor, table: torch.Tensor, *,
              stride: int, pad: int, write_bits: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x float32 NHWC [N, H, W, 3], w float32 [3, 3, 3, F] (real
    weights), table float32 [5, F] (:func:`stem_table`).  Returns the
    batch-normed float32 map [N, HO, WO, F] and, with ``write_bits``,
    the next RSign's int32 words [N, HO, WO, F/32].  A CPU tensor takes
    the plain version, a CUDA tensor launches the kernel."""
    if x.ndim != 4 or w.ndim != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"stem_conv takes x [N, H, W, C] and w [KH, KW, C, "
                         f"F], got {tuple(x.shape)} and {tuple(w.shape)}")
    kh, kw, c, f = w.shape
    if (kh, kw, c) != (3, 3, 3) or f % 32 or tuple(table.shape) != (5, f):
        raise ValueError(f"stem_conv takes w [3, 3, 3, F] with F % 32 == 0 "
                         f"and a table [5, F], got w {tuple(w.shape)}, table "
                         f"{tuple(table.shape)}")
    args = dict(stride=stride, pad=pad, write_bits=write_bits)
    if x.device.type == "cpu":
        return stem_conv_plain(x, w, table, **args)
    _build.require_cuda_tensor(x, "stem_conv")
    n, h, wi, _ = x.shape
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (wi + 2 * pad - kw) // stride + 1
    if x.numel() >= 2 ** 31 or n * ho * wo * f >= 2 ** 31:
        raise ValueError("stem_conv's kernel takes fewer than 2^31 "
                         "elements")
    x = x.to(torch.float32).contiguous()
    w = w.to(device=x.device, dtype=torch.float32).contiguous()
    table = table.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty((n, ho, wo, f), dtype=torch.float32, device=x.device)
    bits = torch.empty((n, ho, wo, f // 32), dtype=WORD,
                       device=x.device) if write_bits else None
    if n == 0:
        return out, bits
    _build.STEM_CONV.launch(
        x.device, _build.ptr(x), _build.ptr(w), _build.ptr(table),
        _build.ptr(out), _build.ptr(bits), n, h, wi, c, f, kh, kw, stride,
        pad, ho, wo)
    return out, bits
