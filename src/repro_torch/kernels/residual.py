"""The float side of a residual binary network (ReActNet, Bi-Real
Net): a residual half-step and the real-valued stem, each one launch
that writes the float stream and the packed signs of the next sign, and
Bi-Real Net's projection shortcut.

A half-step ``out = rprelu(bn(alpha * conv0(sign(x + b_in), sign(w)))
+ shortcut(x))`` runs as one launch, :func:`residual_conv`:
``packed_conv.cu``'s mainloop (the -1 padded dot on the b1 tensor
cores) with the residual epilogue on the block's own tile, which adds
the zero-padding correction (:func:`zero_pad_correction`) and does the
rest, so that the int32 dot never reaches device memory.  Its plain
version, :func:`residual_conv_plain`, is ``packed_conv2d_plain``'s -1
padded dot, then :func:`residual_epilogue_plain`.  A Bi-Real half-step
is the same launch with the neutral parameters (RSign bias 0, PReLU
slope 1, shifts 0), exact: ``x + 0``, ``x * 1`` and ``x + 0`` give
``x`` up to the sign of a zero, which no sign reads.  The stem is
:func:`stem_conv` (``csrc/stem_conv.cu``: ReActNet's 3x3, or Bi-Real
Net's 7x7 with its max pool), the projection shortcut
:func:`shortcut_conv` (``csrc/shortcut_conv.cu``), whose map the
half-step then reads as an identity shortcut.  Every float operation is
rounded on its own and in the order the docstring of
:func:`residual_epilogue_plain` spells (``csrc/residual.cuh``), so the
kernels, their plain versions and the plain reference
(``repro_torch/reference/reactnet.py``) give the same bits.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import packed_conv as kconv
from repro_torch.kernels.fused_mlp import SM_SMEM_BYTES, SMEM_BYTES
from repro_torch.kernels.packed import WORD, PackedArray
from repro_torch.kernels.ref import pack_ref

__all__ = ["BN_EPS", "RESIDUAL_TILES", "SHORTCUTS", "border_classes",
           "epilogue_table", "neutral_table", "residual_conv",
           "residual_conv_plain", "residual_epilogue_plain",
           "residual_tile_plan", "shortcut_conv", "shortcut_conv_plain",
           "shortcut_table", "stem_conv", "stem_conv_plain", "stem_plan",
           "stem_pool_plan", "stem_pool_smem", "stem_smem", "stem_table",
           "zero_pad_correction"]

BN_EPS = 1e-5                          # torch's BatchNorm2d default
SHORTCUTS = ("identity", "avgpool", "duplicate")
# the fused kernel's tiles, largest first (of packed_conv.TILES)
RESIDUAL_TILES = ((64, 128), (64, 64))
# the stem kernel (csrc/stem_conv.cu): STEM_BLOCKS blocks an SM of
# STEM_THREADS, a thread STEM_PIX neighbouring pixels of a row x STEM_CH
# channels
STEM_THREADS, STEM_BLOCKS, STEM_PIX, STEM_CH = 128, 2, 4, 4
STEM_PASSES = 8            # most passes of a block's threads over a tile
STEM_COLS = 128            # most output columns a tile
# the pooled stem kernel (csrc/stem_conv.cu, stem_conv_pool_kernel),
# which takes the one conv and pool of graph.ir.POOLED_STEM and
# graph.ir.STEM_POOL: its blocks an SM; the widest conv row (16 lanes x
# 7 columns)
STEM_POOL_BLOCKS = 2
STEM_POOL_COLS = 112


def residual_tile_plan(m: int, f: int, k32: int,
                       sms: int = kconv.H100_SMS) -> dict:
    """The fused half-step's launch plan: ``packed_conv.tile_plan``'s
    rule over :data:`RESIDUAL_TILES`, or over 64x64 alone where F <= 64
    (no tile wider than the filters).  The tuning table is not read: its
    ``packed_conv`` entries were timed on the kernel that writes the
    int32 dot, not on this one.  Timed tile by tile at ReActNet-A's 26
    half-steps on the H100, 128-row tiles ran slowest: with half as many
    blocks an SM, one block's epilogue overlaps less of another's
    mainloop."""
    tiles = RESIDUAL_TILES if f > 64 else RESIDUAL_TILES[1:]
    return kconv.tile_plan(m, f, k32, sms, tuned=False, tiles=tiles)


def _inv_std(var: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(var + eps), each operation correctly rounded (IEEE), so
    that every device and the reference compute the same number."""
    return 1.0 / torch.sqrt(var.to(torch.float32) + BN_EPS)


def epilogue_table(alpha, mean, var, gamma, beta, move_a, slope, move_b,
                   b_next: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-channel table [9, F] float32 of :func:`residual_conv`:
    alpha, BN mean, 1/sqrt(var + eps), gamma, beta, the RPReLU's bias
    before, its slope, its bias after, and the next RSign's bias (0
    where no sign follows)."""
    if b_next is None:
        b_next = torch.zeros_like(mean)
    rows = (alpha, mean, _inv_std(var), gamma, beta, move_a, slope, move_b,
            b_next)
    return torch.stack([r.to(torch.float32) for r in rows]).contiguous()


def neutral_table(alpha, mean, var, gamma, beta,
                  b_next: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`epilogue_table` of a half-step without RPReLU (Bi-Real
    Net): shifts 0 and a PReLU slope of 1."""
    zero = torch.zeros_like(mean)
    return epilogue_table(alpha, mean, var, gamma, beta, zero,
                          torch.ones_like(mean), zero, b_next)


def shortcut_table(mean, var, gamma, beta) -> torch.Tensor:
    """The per-channel table [4, F] float32 of :func:`shortcut_conv`: BN
    mean, 1/sqrt(var + eps), gamma, beta."""
    rows = (mean, _inv_std(var), gamma, beta)
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
    """The half-step's epilogue on ``packed_conv2d_plain``'s -1 padded
    int32 dot [N, HO, WO, F], in the fused kernel's order
    (``csrc/residual.cuh``): ``d = dot + corr[class]``; ``v = ((float(d)
    * alpha - mean) * inv) * gamma + beta``; ``o = v + shortcut``; ``o =
    o + move_a``; ``o = where(o > 0, o, o * slope)``; ``o = o +
    move_b``; bits ``o + b_next > 0``."""
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


def _conv_operands(xp: PackedArray, wf: PackedArray, stride: int,
                   pad: int) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """The conv's words as ``packed_conv2d`` takes them (the RSign's
    words with the -1 spatial pad, the filters tap-major) and its
    geometry."""
    n, h, w, c32 = xp.words.shape
    k, f = wf.words.shape[0], wf.words.shape[-1]
    xw = kconv.pad_words_spatial(xp.words, pad, pad).contiguous()
    ww = wf.words.reshape(k * k * c32, f).contiguous()
    return xw, ww, dict(kh=k, kw=k, c=xp.length, stride=stride,
                        ho=kconv.out_size(h, k, stride, pad),
                        wo=kconv.out_size(w, k, stride, pad))


def _check_conv(xp, wf, corr, table, sc, shortcut, stride, pad):
    if not isinstance(xp, PackedArray) or not isinstance(wf, PackedArray):
        raise ValueError("residual_conv takes PackedArray signs and filters")
    if xp.ndim != 4 or xp.axis != -1:
        raise ValueError(f"residual_conv takes signs [N, H, W, C] packed "
                         f"on the channel axis, got ndim={xp.ndim} "
                         f"axis={xp.axis}")
    if wf.ndim != 4 or wf.axis != -2 or \
            wf.words.shape[0] != wf.words.shape[1]:
        raise ValueError(f"residual_conv takes square filters [K, K, C, F] "
                         f"packed on the channel axis (-2), got "
                         f"{tuple(wf.words.shape)} axis={wf.axis}")
    if table.dtype != torch.float32:
        raise ValueError(f"residual_conv takes a float32 table, got "
                         f"{table.dtype}")
    if corr is not None and corr.dtype != WORD:
        raise ValueError(f"residual_conv takes an int32 correction, got "
                         f"{corr.dtype}")
    if xp.length != wf.length or xp.n_words != wf.n_words:
        raise ValueError(f"channel mismatch: signs C={xp.length} vs "
                         f"filters C={wf.length}")
    if wf.words.device != xp.words.device:
        raise ValueError(f"residual_conv: operands on {wf.words.device} and "
                         f"{xp.words.device}")
    n, h, w, _ = xp.words.shape
    k, f = wf.words.shape[0], wf.words.shape[-1]
    ho, wo = kconv.out_size(h, k, stride, pad), kconv.out_size(w, k, stride,
                                                                pad)
    if ho < 1 or wo < 1:
        raise ValueError(f"empty output: {h}x{w} conv {k}x{k} stride "
                         f"{stride} pad {pad}")
    if f % 32:
        raise ValueError(f"residual_conv takes F % 32 == 0, got {f}")
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
        if t is not None and t.device != xp.words.device:
            raise ValueError(f"residual_conv: operands on {t.device} and "
                             f"{xp.words.device}")


def residual_conv_plain(xp: PackedArray, wf: PackedArray,
                        corr: Optional[torch.Tensor], table: torch.Tensor,
                        sc: torch.Tensor, *, shortcut: str, stride: int,
                        pad: int, write_bits: bool = True
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version: the chain of plain versions,
    ``packed_conv2d_plain``'s -1 padded dot, then
    :func:`residual_epilogue_plain`."""
    xw, ww, geo = _conv_operands(xp, wf, stride, pad)
    n, h, w, _ = xp.words.shape
    dot = kconv.packed_conv2d_plain(xw, ww, **geo).reshape(
        n, geo["ho"], geo["wo"], -1)
    return residual_epilogue_plain(dot, corr, table, sc, shortcut=shortcut,
                                   k=geo["kh"], stride=stride, pad=pad,
                                   h_in=h, w_in=w, write_bits=write_bits)


def residual_conv(xp: PackedArray, wf: PackedArray,
                  corr: Optional[torch.Tensor], table: torch.Tensor,
                  sc: torch.Tensor, *, shortcut: str, stride: int, pad: int,
                  write_bits: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One residual half-step in one launch: the binary conv of the
    RSign's signs ``xp`` (int32 words [N, H, W, C] packed on the channel
    axis) by the filters ``wf`` ([K, K, C, F] packed on axis -2; K = 3
    with a pad of 1, or 1 with none), then the residual epilogue with
    the correction ``corr`` [16, F] (3x3 only), the table ``table`` [9,
    F] (:func:`epilogue_table`) and the float32 shortcut ``sc``
    (identity [N, HO, WO, F], avgpool [N, 2HO, 2WO, F], duplicate [N,
    HO, WO, F/2]).  Returns the float32 stream [N, HO, WO, F] and, with
    ``write_bits``, the next RSign's int32 words [N, HO, WO, F/32].  A
    CPU tensor takes the plain version (:func:`residual_conv_plain`,
    bit for bit the kernel's), a CUDA tensor launches
    ``packed_conv_kernel_residual_epilogue`` with the tile of
    :func:`residual_tile_plan`; launch count ``"residual_conv"``."""
    _check_conv(xp, wf, corr, table, sc, shortcut, stride, pad)
    args = dict(shortcut=shortcut, stride=stride, pad=pad,
                write_bits=write_bits)
    if xp.words.device.type == "cpu":
        return residual_conv_plain(xp, wf, corr, table, sc, **args)
    _build.require_cuda_tensor(xp.words, "residual_conv")
    xw, ww, geo = _conv_operands(xp, wf, stride, pad)
    plan = residual_tile_plan(xp.words.shape[0] * geo["ho"] * geo["wo"],
                              ww.shape[1], ww.shape[0],
                              _build.device_sms(xw.device))
    return _launch_residual_conv(xw, ww, corr, table, sc,
                                 (plan["bm"], plan["bn"]), geo, **args)


def _launch_residual_conv(xw: torch.Tensor, ww: torch.Tensor,
                          corr: Optional[torch.Tensor], table: torch.Tensor,
                          sc: torch.Tensor, tile: Tuple[int, int], geo: dict,
                          *, shortcut: str, stride: int, pad: int,
                          write_bits: bool = True
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The fused kernel on CUDA operands that :func:`residual_conv`
    checked and laid out (``_conv_operands``), with the tile ``(BM,
    BN)`` given, one of ``packed_conv.TILES``: :func:`residual_conv`
    passes its plan, and the checks on the card pass every tile."""
    if tuple(tile) not in kconv.TILES:
        raise ValueError(f"tile must be one of {kconv.TILES}, got {tile}")
    n, h_pad, w_pad, c32 = xw.shape
    f = ww.shape[1]
    ho, wo = geo["ho"], geo["wo"]
    m = n * ho * wo
    if m * f >= 2 ** 31 or sc.numel() >= 2 ** 31:
        raise ValueError("residual_conv's kernel takes fewer than 2^31 "
                         "elements")
    if ww.data_ptr() % 16:
        ww = ww.clone()                    # 16-byte weight copies
    sc = sc.contiguous()
    table = table.contiguous()
    if corr is not None:
        corr = corr.contiguous()
    out = torch.empty((n, ho, wo, f), dtype=torch.float32, device=xw.device)
    bits = torch.empty((n, ho, wo, f // 32), dtype=WORD,
                       device=xw.device) if write_bits else None
    if m == 0:
        return out, bits
    _build.RESIDUAL_CONV.launch(
        xw.device, _build.ptr(xw), _build.ptr(ww), _build.ptr(corr),
        _build.ptr(table), _build.ptr(sc), _build.ptr(out), _build.ptr(bits),
        n, h_pad, w_pad, c32, geo["kh"], geo["kw"], stride, ho, wo, f,
        geo["kh"] * geo["kw"] * geo["c"], pad, sc.shape[-1],
        SHORTCUTS.index(shortcut), *tile)
    return out, bits


def _max_pool_plain(v: torch.Tensor, window: int, stride: int,
                    pad: int) -> torch.Tensor:
    """The max over each ``window`` x ``window`` window of NHWC ``v``
    (stride ``stride``, a pad of ``pad`` that counts as -inf)."""
    n, h, w, f = v.shape
    ho = (h + 2 * pad - window) // stride + 1
    wo = (w + 2 * pad - window) // stride + 1
    vp = torch.nn.functional.pad(v, (0, 0, pad, pad, pad, pad),
                                 value=float("-inf"))
    out = None
    for i in range(window):
        for j in range(window):
            win = vp[:, i:i + (ho - 1) * stride + 1:stride,
                     j:j + (wo - 1) * stride + 1:stride]
            out = win if out is None else torch.maximum(out, win)
    return out


def stem_conv_plain(x: torch.Tensor, w: torch.Tensor, table: torch.Tensor,
                    *, stride: int, pad: int,
                    pool: Optional[Tuple[int, int, int]] = None,
                    write_bits: bool = True
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version, in the kernels' order: ``acc = 0``, then ``acc
    = acc + x_tap * w_tap`` over the taps (kh, kw, c) of a zero-padded
    window; ``v = ((acc - mean) * inv) * gamma + beta``; with ``pool``
    (window, stride, pad) the max over each window of ``v``, its pad
    -inf; bits ``v + b_next > 0``."""
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
    if pool is not None:
        v = _max_pool_plain(v, *pool)
    if not write_bits:
        return v, None
    words = pack_ref((v + b_next).reshape(-1, f))
    return v, words.reshape(*v.shape[:3], f // 32)


def stem_smem(rows: int, cols: int, stride: int) -> int:
    """Shared-memory bytes of the stem kernel's two staged tiles: each
    ``(rows - 1) * stride + 3`` input rows, a row three copies (one a
    tap column) of ``cols`` pixels x 3 float32 channels."""
    return 2 * 4 * ((rows - 1) * stride + 3) * 9 * cols


@functools.lru_cache(maxsize=256)
def stem_plan(n: int, h: int, w: int, f: int, stride: int, pad: int,
              sms: int = kconv.H100_SMS) -> dict:
    """The stem kernel's launch plan for x [n, h, w, 3] and F filters.
    ``slab``: channels a block owns (the largest of 128, 64, 32 dividing
    F); ``cols``: output columns a tile (a multiple of STEM_PIX, at most
    STEM_COLS, the tiles of a row as even as that allows); ``rows``:
    output rows a tile, the one whose waves of tiles over STEM_BLOCKS
    blocks an SM (``STEM_BLOCKS * sms`` / slabs blocks) cost the fewest
    passes, a tile counted as its passes plus one for its staging, up to
    STEM_PASSES passes and the shared memory of one of STEM_BLOCKS
    blocks on an SM (ties: the taller tile); ``passes``, ``tiles`` and
    ``smem`` (bytes) follow.  Timed at ReActNet-A's stem, 4-row tiles
    ran faster than 2, 5, 6 or 8 rows."""
    ho = (h + 2 * pad - 3) // stride + 1
    wo = (w + 2 * pad - 3) // stride + 1
    slab = next(s for s in (128, 64, 32) if f % s == 0)
    groups = STEM_THREADS * STEM_CH // slab     # pixel groups of a pass
    # the shared memory of a block, STEM_BLOCKS of them an SM (1 KB
    # reserved a block)
    most = min(SMEM_BYTES, SM_SMEM_BYTES // STEM_BLOCKS - 1024)
    tiles_x = -(-wo // STEM_COLS)
    cols = STEM_PIX * -(-wo // (tiles_x * STEM_PIX))
    gcols = cols // STEM_PIX
    blocks = max(1, STEM_BLOCKS * sms // max(1, f // slab))
    best = None
    for rows in range(1, ho + 1):
        passes = -(-rows * gcols // groups)
        smem = stem_smem(rows, cols, stride)
        if passes > STEM_PASSES or smem > most:
            break
        tiles = n * -(-ho // rows) * tiles_x
        cost = -(-tiles // min(blocks, tiles)) * (passes + 1)
        if best is None or cost <= best[0]:
            best = (cost, dict(ho=ho, wo=wo, slab=slab, rows=rows,
                               cols=cols, passes=passes, tiles=tiles,
                               smem=smem))
    return best[1]


def stem_pool_smem(wo: int, slab: int) -> int:
    """Shared-memory bytes of a block of the pooled stem kernel: a ring of
    16 staged input rows, each two parity arrays of ``3 * (wo + 3)``
    floats padded to 4 mod 8, and two rows of ``wo`` conv pixels x
    ``slab`` channels (the pair's last row and the rows' max)."""
    ap = 3 * (wo + 3)
    ap += (4 - ap % 8) % 8
    return 4 * (16 * 2 * ap + 2 * slab * wo)


@functools.lru_cache(maxsize=256)
def stem_pool_plan(n: int, h: int, w: int, f: int,
                   sms: int = kconv.H100_SMS) -> dict:
    """The pooled stem kernel's launch plan for x [n, h, w, 3] and F
    filters (the conv and pool of ``graph.ir.POOLED_STEM`` and
    ``STEM_POOL``).  ``slab``: channels a block owns (64 where F allows,
    else 32; a warp 8); ``band``: pooled rows a block walks, the one
    whose waves of tiles over STEM_POOL_BLOCKS blocks an SM cost the
    fewest steps, a tile counted as its band plus the pair a band below
    the top sums first (ties: the taller band); ``bands``, ``tiles``,
    ``threads`` and ``smem`` (bytes) follow, and the extents ``ho``,
    ``wo`` (the conv's), ``ph``, ``pw`` (the pool's)."""
    from repro_torch.graph.ir import POOLED_STEM, STEM_POOL
    (k, stride, pad), (pk, ps, pp) = POOLED_STEM, STEM_POOL
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    ph = (ho + 2 * pp - pk) // ps + 1
    pw = (wo + 2 * pp - pk) // ps + 1
    slab = 64 if f % 64 == 0 else 32
    blocks = STEM_POOL_BLOCKS * sms
    best = None
    for band in range(1, ph + 1):
        bands = -(-ph // band)
        tiles = n * bands * (f // slab)
        cost = -(-tiles // blocks) * (band + 1)
        if best is None or cost <= best[0]:
            best = (cost, dict(ho=ho, wo=wo, ph=ph, pw=pw, slab=slab,
                               band=band, bands=bands, tiles=tiles,
                               threads=4 * slab,
                               smem=stem_pool_smem(wo, slab)))
    return best[1]


def _check_stem(x, w, table, stride, pad, pool):
    from repro_torch.graph.ir import POOLED_STEM, STEM_POOL
    if x.ndim != 4 or w.ndim != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"stem_conv takes x [N, H, W, C] and w [KH, KW, C, "
                         f"F], got {tuple(x.shape)} and {tuple(w.shape)}")
    kh, kw, c, f = w.shape
    if kh != kw or c != 3 or f % 32 or tuple(table.shape) != (5, f):
        raise ValueError(f"stem_conv takes w [K, K, 3, F] (K x K square) "
                         f"with F % 32 == 0 and a table [5, F], got w "
                         f"{tuple(w.shape)}, table {tuple(table.shape)}")
    if pool is None:
        if kh != 3:
            raise ValueError(f"stem_conv takes w [3, 3, 3, F] without a "
                             f"pool (ReActNet's stem), got w "
                             f"{tuple(w.shape)}")
    elif ((kh, stride, pad), tuple(pool)) != (POOLED_STEM, STEM_POOL):
        raise ValueError(f"stem_conv takes w [7, 7, 3, F] at stride 2 pad 3 "
                         f"with a pool (3, 2, 1) (Bi-Real Net's stem), got w "
                         f"{tuple(w.shape)} stride {stride} pad {pad}, pool "
                         f"{tuple(pool)}")


def stem_conv(x: torch.Tensor, w: torch.Tensor, table: torch.Tensor, *,
              stride: int, pad: int,
              pool: Optional[Tuple[int, int, int]] = None,
              write_bits: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x float32 NHWC [N, H, W, 3], w float32 [K, K, 3, F] (real
    weights), table float32 [5, F] (:func:`stem_table`): ReActNet's 3x3
    stem without a pool, or Bi-Real Net's 7x7 stride-2 pad-3 stem with
    ``pool`` = (3, 2, 1), the 3x3 stride-2 max pool after its batch
    norm (``graph.ir.STEM_POOL``).  Returns the batch-normed (and pooled)
    float32 map [N, HO, WO, F] and, with ``write_bits``, the next sign's
    int32 words [N, HO, WO, F/32].  A CPU tensor takes the plain version,
    a CUDA tensor launches the kernel: ``stem_conv_bn_sign_kernel`` on the
    tiles of :func:`stem_plan`, or ``stem_conv_pool_kernel`` on the bands
    of :func:`stem_pool_plan` (conv rows at most STEM_POOL_COLS wide);
    launch count ``"stem_conv"``."""
    _check_stem(x, w, table, stride, pad, pool)
    kh, kw, c, f = w.shape
    args = dict(stride=stride, pad=pad, pool=pool, write_bits=write_bits)
    if x.device.type == "cpu":
        return stem_conv_plain(x, w, table, **args)
    _build.require_cuda_tensor(x, "stem_conv")
    n, h, wi, _ = x.shape
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (wi + 2 * pad - kw) // stride + 1
    if x.numel() >= 2 ** 31 or n * ho * wo * f >= 2 ** 31:
        raise ValueError("stem_conv's kernel takes fewer than 2^31 "
                         "elements")
    if pool is not None and wo > STEM_POOL_COLS:
        raise ValueError(f"stem_conv's pooled kernel takes conv rows of at "
                         f"most {STEM_POOL_COLS} columns, got {wo}")
    x = x.to(torch.float32).contiguous()
    w = w.to(device=x.device, dtype=torch.float32).contiguous()
    table = table.to(device=x.device, dtype=torch.float32).contiguous()
    if w.data_ptr() % 16:
        w = w.clone()                      # 16-byte loads of 4 channels
    if table.data_ptr() % 16:
        table = table.clone()
    sms = _build.device_sms(x.device)
    if pool is not None:
        p = stem_pool_plan(n, h, wi, f, sms)
        ho, wo = p["ph"], p["pw"]
    out = torch.empty((n, ho, wo, f), dtype=torch.float32, device=x.device)
    bits = torch.empty((n, ho, wo, f // 32), dtype=WORD,
                       device=x.device) if write_bits else None
    if n * ho * wo == 0:
        return out, bits
    if pool is not None:
        _build.STEM_CONV_POOL.launch(
            x.device, _build.ptr(x), _build.ptr(w), _build.ptr(table),
            _build.ptr(out), _build.ptr(bits), n, h, wi, f, p["slab"],
            p["band"])
        return out, bits
    p = stem_plan(n, h, wi, f, stride, pad, sms)
    _build.STEM_CONV.launch(
        x.device, _build.ptr(x), _build.ptr(w), _build.ptr(table),
        _build.ptr(out), _build.ptr(bits), n, h, wi, c, f, kh, kw, stride,
        pad, ho, wo, p["rows"], p["cols"], p["slab"], sms)
    return out, bits


def shortcut_conv_plain(x: torch.Tensor, w: torch.Tensor,
                        table: torch.Tensor) -> torch.Tensor:
    """The plain version, in the kernel's order: ``a = (((x00 + x01) +
    x10) + x11) * 0.25`` over each 2x2 window; ``acc = 0``, then ``acc =
    acc + a_c * w_c`` over the channels c in order; ``((acc - mean) *
    inv) * gamma + beta``."""
    a = _shortcut_plain(x.to(torch.float32), "avgpool", w.shape[1])
    acc = torch.zeros(*a.shape[:3], w.shape[1], dtype=torch.float32,
                      device=x.device)
    for ch in range(w.shape[0]):
        acc = acc + a[..., ch:ch + 1] * w[ch]
    mean, inv, gamma, beta = table
    v = (acc - mean) * inv
    return v * gamma + beta


def shortcut_conv(x: torch.Tensor, w: torch.Tensor, table: torch.Tensor
                  ) -> torch.Tensor:
    """The projection shortcut of a half-step that doubles its width at
    stride 2 (Bi-Real Net): the 2x2 average of the float32 stream x [N,
    H, W, C] (H, W even), a float 1x1 conv by w [C, F] and its batch norm
    (table [4, F], :func:`shortcut_table`); returns float32 [N, H/2, W/2,
    F].  A CPU tensor takes the plain version, a CUDA tensor launches
    ``shortcut_conv_kernel`` (C % 16 == 0, F % 64 == 0); launch count
    ``"shortcut_conv"``."""
    if x.ndim != 4 or w.ndim != 2 or x.shape[3] != w.shape[0]:
        raise ValueError(f"shortcut_conv takes x [N, H, W, C] and w [C, F], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    n, h, wi, c = x.shape
    f = w.shape[1]
    if h % 2 or wi % 2 or tuple(table.shape) != (4, f):
        raise ValueError(f"shortcut_conv takes an even map and a table [4, "
                         f"{f}], got {h}x{wi} and {tuple(table.shape)}")
    if x.device.type == "cpu":
        return shortcut_conv_plain(x, w, table)
    _build.require_cuda_tensor(x, "shortcut_conv")
    if c % 16 or f % 64:
        raise ValueError(f"shortcut_conv's kernel takes C % 16 == 0 and F % "
                         f"64 == 0, got C={c}, F={f}")
    if x.numel() >= 2 ** 31 or n * (h // 2) * (wi // 2) * f >= 2 ** 31:
        raise ValueError("shortcut_conv's kernel takes fewer than 2^31 "
                         "elements")
    x = x.to(torch.float32).contiguous()
    w = w.to(device=x.device, dtype=torch.float32).contiguous()
    table = table.to(device=x.device, dtype=torch.float32).contiguous()
    if w.data_ptr() % 16:
        w = w.clone()
    if table.data_ptr() % 16:
        table = table.clone()
    if x.data_ptr() % 16:
        x = x.clone()
    out = torch.empty((n, h // 2, wi // 2, f), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    _build.SHORTCUT_CONV.launch(
        x.device, _build.ptr(x), _build.ptr(w), _build.ptr(table),
        _build.ptr(out), n, h, wi, c, f)
    return out
