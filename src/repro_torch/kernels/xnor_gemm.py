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

The kernel runs every multiply-accumulate on the tensor cores (bf16
``mma.sync``; float32 x as three exact bf16 pieces).  Its output tile
is chosen here, by :func:`tile_plan`, and passed to the C entry point;
``ops.plan_dense_launch(op="xnor_gemm")`` reports the same plan.  With
K split in parts a call launches two kernels (the parts, then their
sum), and both are counted.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, autotune
from repro_torch.kernels.packed import WORD, pack_words
from repro_torch.kernels.popcount_gemm import threshold_mode
from repro_torch.kernels.ref import xnor_gemm_ref

__all__ = ["tile_plan", "xnor_gemm", "xnor_gemm_plain"]

# the C entry point's dtype codes for x (csrc/xnor_gemm.cu)
X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's output tiles (BM rows x BN columns) and the relative cost
# of their work on the H100 for bf16 and for float32 x: device time per
# multiply-accumulate against the 64 x 128 tile (whose blocks of 8 warps
# of 32 x 32 run two to an SM), from plan searches on the card
TILES = {(64, 128): (1.0, 1.0), (64, 64): (1.3, 1.3),
         (16, 128): (1.0, 1.0), (16, 64): (1.0, 1.4)}
MAX_SPLITS = 8          # parts of K at most (each needs M*N*4 of scratch)
MIN_SPLIT_WORDS = 16    # words of K per part at least
H100_SMS = 132
MAC_PER_US = 1.03e6     # bf16 multiply-accumulates per microsecond per SM
BYTES_PER_US = 3.0e6    # device memory, for the partial sums
REDUCE_US = 2.0         # the second pass's launch


def tile_plan(m: int, n: int, k32: int, sms: int = H100_SMS,
              planes: int = 1, pack_out: bool = False,
              tuned: bool = True) -> dict:
    """The launch plan of an [m, 32*k32] x [32*k32, n] xnor_gemm.

    The plan is the tuning table's entry for ``("xnor_gemm[+pack]",
    "cuda", m, n, k32)`` (``"xnor_gemm_f32[+pack]"`` where ``planes`` is
    3) where it has one (``tuned``; ``kernels.autotune``), else the
    rule's.  BM is 16 for m <= 16, else 64; BN is 64 or 128; K may be
    split into ``splits`` parts, each a block of its own, whose float32 partial
    sums a second pass adds in a fixed order.  The plan minimises a cost
    model: blocks run in rounds of one per SM, so the time is the number
    of rounds times one block's work (BM * BN * K / splits
    multiply-accumulates, times ``planes``: 3 for float32 x), plus the
    partial sums' traffic and the second pass.  Returns ``bm``,
    ``bn``, ``splits``, the grid (row tiles, column tiles, splits), its
    block count, ``waves`` (blocks over ``sms``, rounded up) and the
    model's ``est_us``."""
    op = ("xnor_gemm" if planes == 1 else "xnor_gemm_f32") + \
        ("+pack" if pack_out else "")
    hit = autotune.get_table().get((op, "cuda", m, n, k32)) \
        if tuned else None
    cands = [(hit["bm"], hit["bn"])] if hit else \
        [(16, 128), (16, 64)] if m <= 16 else [(64, 128), (64, 64)]
    best = None
    for bm, bn in cands:
        gm, gn = -(-m // bm), -(-n // bn)
        for splits in range(1, MAX_SPLITS + 1):
            if hit and splits != hit["splits"]:
                continue
            if not hit and splits > 1 and \
                    -(-k32 // splits) < MIN_SPLIT_WORDS:
                break
            blocks = gm * gn * splits
            waves = -(-blocks // sms)
            words = -(-k32 // splits)
            est = waves * bm * bn * 32 * words * planes \
                * TILES[bm, bn][planes > 1] / MAC_PER_US
            if splits > 1:
                est += splits * m * n * 8 / BYTES_PER_US + REDUCE_US
            if best is None or est < best["est_us"] - 1e-9:
                best = {"bm": bm, "bn": bn, "splits": splits,
                        "grid": (gm, gn, splits), "blocks": blocks,
                        "waves": waves, "est_us": est}
    return best


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
    plain version; a CUDA tensor launches the kernel with the plan of
    :func:`tile_plan`."""
    _check_args(x, wp, alpha, threshold, threshold_vec, pack_out)
    valid_n = wp.shape[1] if valid_n is None else valid_n
    if x.device.type == "cpu":
        return xnor_gemm_plain(x, wp, alpha, threshold, threshold_vec,
                               pack_out, valid_n)
    _build.require_cuda_tensor(x, "xnor_gemm")
    p = tile_plan(x.shape[0], wp.shape[1], wp.shape[0],
                  _build.device_sms(x.device),
                  planes=3 if x.dtype == torch.float32 else 1,
                  pack_out=pack_out)
    return _launch(x, wp, alpha, (p["bm"], p["bn"], p["splits"]),
                   threshold, threshold_vec, pack_out, valid_n)


def _launch(x: torch.Tensor, wp: torch.Tensor, alpha: torch.Tensor,
            tile: Tuple[int, int, int], threshold: Optional[float] = None,
            threshold_vec: Optional[torch.Tensor] = None,
            pack_out: bool = False,
            valid_n: Optional[int] = None) -> torch.Tensor:
    """The kernel on checked CUDA operands with the tile ``(BM, BN,
    splits)`` given, (BM, BN) one of ``TILES``: :func:`xnor_gemm` passes
    its plan, and the checks on the card pass every tile in turn."""
    if len(tile) != 3 or tuple(tile[:2]) not in TILES \
            or not 1 <= tile[2] <= MAX_SPLITS:
        raise ValueError(f"tile must be (BM, BN, splits) with (BM, BN) in "
                         f"{tuple(TILES)} and 1 <= splits <= {MAX_SPLITS}, "
                         f"got {tile}")
    if x.device.type != "cuda":
        raise ValueError(f"xnor_gemm's kernel takes CUDA tensors, got "
                         f"device {x.device}")
    if wp.dtype != WORD or not wp.is_contiguous() or wp.device != x.device:
        raise ValueError(f"xnor_gemm: wp must be contiguous int32 words on "
                         f"{x.device}")
    m, n = x.shape[0], wp.shape[1]
    valid_n = n if valid_n is None else valid_n
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
    if m == 0 or n == 0:
        return out
    bm, bn, splits = tile
    partial = None if splits == 1 else torch.empty(
        splits * m * n, dtype=torch.float32, device=x.device)
    _build.XNOR_GEMM.launch(
        x.device, _build.ptr(x), X_DTYPES[x.dtype], _build.ptr(wp),
        _build.ptr(alpha), _build.ptr(threshold_vec), _build.ptr(out), m, n,
        wp.shape[0], threshold_mode(threshold, threshold_vec),
        0.0 if threshold is None else float(threshold),
        int(pack_out), valid_n, bm, bn, splits, _build.ptr(partial),
        kernels=1 if splits == 1 else 2)
    return out
