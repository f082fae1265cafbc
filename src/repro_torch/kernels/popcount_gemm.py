"""Fully-binary GEMM: packed activations x packed weights (XNOR-popcount).

The counterpart of ``repro.kernels.popcount_gemm.popcount_gemm``; the
kernel is ``csrc/popcount_gemm.cu``.  Outputs: the int32 signed dot,
+-1 after a scalar or per-channel threshold, or (``pack_out``) the
decisions packed into words with columns >= ``valid_n`` zeroed, so the
int32 [M, N] never reaches device memory.

The kernel sums on the b1 tensor cores (``mma.sync`` with AND-popcount,
``dot = K - 2*(pc_x + pc_w) + 4*popc(x & w)``), one launch per call;
its tile is chosen here, by :func:`tile_plan`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, autotune
from repro_torch.kernels.packed import WORD, pack_words
from repro_torch.kernels.ref import popcount_gemm_ref

__all__ = ["TILES", "check_threshold_args", "popcount_gemm",
           "popcount_gemm_plain", "threshold_mode", "tile_plan"]

MMA_WORDS = 8           # K of one b1 m16n8k256 MMA, in words
# the kernel's tiles (BM rows, BN columns, WK warps that split K), most
# work a block first; warps own 16 x 32 outputs (16 x 8 in the 8-column
# tile, which cannot pack: a word spans 4 of its blocks)
TILES = ((64, 64, 1), (64, 32, 2), (16, 32, 4), (16, 8, 4))


def tile_plan(m: int, n: int, k32: int, sms: int,
              pack_out: bool = False, tuned: bool = True) -> dict:
    """The launch plan of an [m, k32] x [n, k32] word GEMM on a card of
    ``sms`` SMs.

    The tile is the tuning table's entry for ``("popcount_gemm[+pack]",
    "cuda", m, n, k32)`` where it has one (``tuned``;
    ``kernels.autotune``), else the rule.  The rule's candidates are the
    tiles no taller than M rounded up to 16 rows (a taller one only
    multiplies zero rows) and, where ``pack_out``, whose warps own 32
    columns.  The tile is the first candidate whose
    grid has at least half as many blocks as the card has SMs: beyond
    that point a smaller tile would not spread the work over more SMs,
    and the larger one reads each word for more MMAs.  Where no grid is
    that large (AlexNet's fc8 at batch 1, BinaryNet's fc3 with N = 10),
    the last candidate spreads the work furthest.  K is zero-filled to
    ``k_words``, whole stages of ``MMA_WORDS * wk`` words.  Returns
    ``bm``, ``bn``, ``wk``, ``k_words``, the grid (row tiles, column
    tiles) and its block count."""
    hit = autotune.get_table().get(
        ("popcount_gemm+pack" if pack_out else "popcount_gemm", "cuda", m,
         n, k32)) if tuned else None
    rows = max(16, -(-m // 16) * 16)
    tiles = [(hit["bm"], hit["bn"], hit["wk"])] if hit else \
        [t for t in TILES if t[0] <= rows and (not pack_out or t[1] >= 32)]
    for bm, bn, wk in tiles:
        grid = (-(-m // bm), -(-n // bn))
        if 2 * grid[0] * grid[1] >= sms:
            break
    stage = MMA_WORDS * wk
    return {"bm": bm, "bn": bn, "wk": wk,
            "k_words": -(-k32 // stage) * stage, "grid": grid,
            "blocks": grid[0] * grid[1]}


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
    p = tile_plan(m, n, k32, _build.device_sms(xp.device), pack_out)
    return _launch(xp, wp, k, (p["bm"], p["bn"], p["wk"]), threshold,
                   threshold_vec, pack_out, valid_n)


def _launch(xp: torch.Tensor, wp: torch.Tensor, k: int,
            tile: Tuple[int, int, int], threshold: Optional[int] = None,
            threshold_vec: Optional[torch.Tensor] = None,
            pack_out: bool = False,
            valid_n: Optional[int] = None) -> torch.Tensor:
    """The kernel on CUDA operands whose shapes :func:`popcount_gemm`
    checked, with the tile ``(BM, BN, WK)`` given, one of ``TILES``:
    :func:`popcount_gemm` passes its plan, and the checks on the card
    pass every tile in turn (pack_out refuses the 8-column tile)."""
    if tuple(tile) not in TILES:
        raise ValueError(f"tile must be one of {TILES}, got {tile}")
    if pack_out and tile[1] < 32:
        raise ValueError(f"pack_out needs a tile of >= 32 columns, got "
                         f"{tile}")
    if xp.device.type != "cuda":
        raise ValueError(f"popcount_gemm's kernel takes CUDA tensors, got "
                         f"device {xp.device}")
    for t, name in ((xp, "xp"), (wp, "wp")):
        if t.dtype != WORD or not t.is_contiguous() or t.device != xp.device:
            raise ValueError(f"popcount_gemm: {name} must be contiguous "
                             f"int32 words on {xp.device}")
    m, k32 = xp.shape
    n = wp.shape[0]
    valid_n = n if valid_n is None else valid_n
    if -(-n // tile[1]) > 65535:
        raise ValueError(f"popcount_gemm's kernel takes at most 65535 "
                         f"column tiles, got N={n}")
    if threshold_vec is not None:
        threshold_vec = threshold_vec.contiguous()
    shape = (m, (n + 31) // 32) if pack_out else (m, n)
    out = torch.empty(shape, dtype=WORD, device=xp.device)
    _build.POPCOUNT_GEMM.launch(
        xp.device, _build.ptr(xp), _build.ptr(wp), _build.ptr(threshold_vec),
        _build.ptr(out), m, n, k32, k,
        threshold_mode(threshold, threshold_vec),
        0 if threshold is None else int(threshold), int(pack_out), valid_n,
        *tile)
    return out
