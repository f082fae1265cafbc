"""Public wrappers for the binarized-compute kernels.

The counterpart of ``repro.kernels.ops``.  Dispatch goes through the
port's backend registry (``kernels.packed``): ``"cuda"`` calls the kernel
wrappers — which launch the Hopper kernel for a CUDA tensor and take
the plain version for a CPU tensor — and ``"torch"`` runs the plain
oracles of ``kernels.ref``, as the reference's ``"xla"`` backend runs
its jnp oracles.  Both are bit-identical.

With ``pack_out=True`` the threshold+bitpack epilogue runs inside the
kernel, which emits packed words directly, so the inter-layer activation
never exists in device memory as int32.

The Hopper kernels mask their own ragged edges, so nothing is padded
beyond a whole word of K.  Each kernel's launch plan comes from the
tuning table (``kernels.autotune``) where it has an entry, else from
the kernel's rule; ``plan_dense_launch`` / ``plan_conv_launch`` give
the tuning keys.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.pack import pack as _pack_kernel
from repro_torch.kernels.pack import pack_plain as _pack_plain
from repro_torch.kernels.packed import (WORD, PackedArray, get_backend,
                                        round_up)
from repro_torch.kernels.packed_conv import (im2col_words, out_size,
                                             packed_conv2d,
                                             pad_words_spatial)
from repro_torch.kernels.packed_conv import tile_plan as conv_tile_plan
from repro_torch.kernels.popcount_gemm import popcount_gemm
from repro_torch.kernels.xnor_gemm import tile_plan, xnor_gemm

__all__ = ["binarize_pack", "binary_binary_dense", "binary_conv2d",
           "binary_dense", "classify_threshold", "conv_padding",
           "kernel_threshold", "mask_rows", "plan_conv_launch",
           "plan_dense_launch"]

Packable = Union[PackedArray, torch.Tensor]
Threshold = Union[int, float, np.ndarray, torch.Tensor]


def _adopt_rows(a: Packable, k: Optional[int]) -> PackedArray:
    """Normalize to the row-major packed layout ([..., K/32], axis -1);
    raw int32 words need an explicit ``k``."""
    if isinstance(a, PackedArray):
        if k is not None and a.length != k:
            raise ValueError(f"explicit k={k} disagrees with "
                             f"PackedArray.length={a.length}")
        return a.move_pack_axis_last()
    if k is None:
        raise ValueError("raw packed words need an explicit k")
    return PackedArray(a, length=k, axis=-1)


def classify_threshold(threshold: Optional[Threshold], n: int,
                       device=None
                       ) -> Tuple[Optional[Union[int, float]],
                                  Optional[torch.Tensor]]:
    """THE threshold scalar-vs-vector rule (every consumer must agree):
    python/numpy scalars stay scalars; anything array-like becomes a
    per-channel [n] tensor (0-d arrays broadcast)."""
    if threshold is None:
        return None, None
    if isinstance(threshold, (int, np.integer)):
        return int(threshold), None
    if isinstance(threshold, (float, np.floating)):
        return float(threshold), None
    arr = torch.as_tensor(threshold, device=device)
    if arr.ndim == 0:
        arr = arr.expand(n)
    arr = arr.reshape(-1)
    if arr.shape[0] != n:
        raise ValueError(f"per-channel threshold has {arr.shape[0]} "
                         f"entries for N={n}")
    return None, arr


def kernel_threshold(threshold: Optional[Threshold], n: int, device
                     ) -> Tuple[Optional[int], Optional[torch.Tensor]]:
    """classify_threshold in the kernels' operand form: an integer
    scalar (``dot >= t`` equals ``dot >= ceil(t)`` for the integer dot)
    or a contiguous int32 vector on ``device`` (per-channel thresholds
    carry int32 semantics on every backend, as in the reference)."""
    thr, tvec = classify_threshold(threshold, n, device)
    if tvec is not None:
        return None, tvec.to(device=device, dtype=WORD).contiguous()
    return (None if thr is None else int(math.ceil(thr))), None


def _threshold_plain(y: torch.Tensor, threshold: Optional[Threshold],
                     n: int) -> torch.Tensor:
    """The oracle backends' post-hoc threshold: +-1 int32."""
    thr_s, tvec = classify_threshold(threshold, n, y.device)
    thr = thr_s if tvec is None else tvec.to(device=y.device, dtype=WORD)
    return torch.where(y >= thr, 1, -1).to(WORD)


def mask_rows(x: Packable, valid_m: int) -> Packable:
    """Keep only the first ``valid_m`` rows of a batch (leading axis):
    the ragged last bucket of bucketed serving stops paying for its pad
    rows.  Rows are independent, so the kept rows are bit-identical."""
    rows = int((x.words if isinstance(x, PackedArray) else x).shape[0])
    if not 1 <= valid_m <= rows:
        raise ValueError(f"valid_m must be in [1, {rows}], got {valid_m}")
    if valid_m == rows:
        return x
    if isinstance(x, PackedArray):
        return x.with_words(x.words[:valid_m])
    return x[:valid_m]


def binarize_pack(x: torch.Tensor, backend: Optional[str] = None,
                  scale: Optional[torch.Tensor] = None) -> PackedArray:
    """sign+pack along the last axis -> PackedArray (length=x.shape[-1]);
    any length is accepted.  ``scale`` ([K]) is multiplied in first, in
    float32: bit = ``x * scale > 0`` (the "cuda" kernel takes it in its
    load, the "torch" backend through ``pack_plain``)."""
    be = get_backend(backend)
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    if scale is not None:
        scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    if be.uses_kernels:
        words = _pack_kernel(x2.to(torch.float32).contiguous(), scale)
    else:
        words = _pack_plain(x2, scale)
    return PackedArray(words.reshape(*lead, words.shape[-1]), length=k,
                       axis=-1)


def binary_dense(x: torch.Tensor, wp: Packable, alpha: torch.Tensor,
                 threshold: Optional[Threshold] = None,
                 backend: Optional[str] = None, pack_out: bool = False):
    """Binary-weight dense: x [..., K] float x packed weights -> [..., N].

    wp: PackedArray packed over K in [K, N] orientation (words
    [K/32, N], pack axis -2) or raw int32 words [K/32, N], adopted with
    length K.  Output is x.dtype; with ``threshold`` (scalar or
    per-channel [N]), {-1,+1} in x.dtype on every backend.  Thresholds
    compare the float ``y`` in float32 (a vector is cast to float32; no
    integer rounding as for the popcount dot).  With ``pack_out=True``
    the result is a PackedArray (length N): the float->binary boundary
    layer of a fully-binary stack; on "cuda" the kernel packs in its
    epilogue."""
    if pack_out and threshold is None:
        raise ValueError("pack_out requires a threshold (binary output)")
    if not isinstance(wp, PackedArray):
        wp = PackedArray(wp, length=x.shape[-1], axis=-2)
    if wp.axis != -2:
        raise ValueError(f"binary_dense wants weights packed over K in "
                         f"[K, N] orientation (axis -2), got {wp.axis}")
    if wp.length != x.shape[-1]:
        raise ValueError(f"x K={x.shape[-1]} vs packed K={wp.length}")
    be = get_backend(backend)
    lead, k = x.shape[:-1], x.shape[-1]
    n = wp.words.shape[-1]
    x2 = x.reshape(-1, k)
    if wp.padded_length != k:
        # zeros over the pad rows of the last word: 0 * (-1) adds nothing
        x2 = torch.nn.functional.pad(x2, (0, wp.padded_length - k))
    thr, tvec = classify_threshold(threshold, n, x.device)
    if tvec is not None:
        tvec = tvec.to(device=x.device, dtype=torch.float32).contiguous()
    if not be.uses_kernels:
        y = ref.xnor_gemm_ref(x2, wp.words, alpha,
                              thr if tvec is None else tvec).to(x.dtype)
        y = y.reshape(*lead, n)
        return PackedArray.pack(y, axis=-1) if pack_out else y
    y = xnor_gemm(x2.contiguous(), wp.words.contiguous(), alpha,
                  threshold=thr, threshold_vec=tvec, pack_out=pack_out,
                  valid_n=n)
    if pack_out:
        return PackedArray(y.reshape(*lead, y.shape[-1]), length=n, axis=-1)
    return y.reshape(*lead, n)


def binary_binary_dense(xp: Packable, wp: Packable, k: Optional[int] = None,
                        threshold: Optional[Threshold] = None,
                        backend: Optional[str] = None,
                        pack_out: bool = False):
    """Fully-binary dense: packed acts x packed weights -> int32 dot.

    xp: PackedArray [..., K] packed on the last axis (or raw int32 words
    [..., K/32] with explicit k); wp: PackedArray [N, K] (or raw words
    [N, K/32]).  threshold: scalar or per-channel [N] — the output
    becomes {-1,+1} int32 on every backend.  pack_out: with a threshold,
    return a PackedArray; on "cuda" the kernel packs in its epilogue."""
    if pack_out and threshold is None:
        raise ValueError("pack_out requires a threshold (binary output)")
    xp = _adopt_rows(xp, k)
    wp = _adopt_rows(wp, k)
    if xp.length != wp.length:
        raise ValueError(f"contraction length mismatch: xp K={xp.length} "
                         f"vs wp K={wp.length}")
    k = xp.length
    be = get_backend(backend)
    nbits = be.pad_k(32 * max(xp.n_words, wp.n_words))
    xp, wp = xp.pad_to(nbits), wp.pad_to(nbits)
    lead = xp.words.shape[:-1]
    x2 = xp.words.reshape(-1, xp.n_words)
    n = wp.words.shape[0]
    if be.uses_kernels:
        thr, tvec = kernel_threshold(threshold, n, x2.device)
        y = popcount_gemm(x2.contiguous(), wp.words.contiguous(), k,
                          threshold=thr, threshold_vec=tvec,
                          pack_out=pack_out, valid_n=n)
        if pack_out:
            return PackedArray(y.reshape(*lead, y.shape[-1]), length=n,
                               axis=-1)
    else:
        y = ref.popcount_gemm_ref(x2, wp.words, k)
        if threshold is not None:
            y = _threshold_plain(y, threshold, n)
    y = y.reshape(*lead, n)
    if pack_out:
        return binarize_pack(y, backend=backend)
    return y


def plan_dense_launch(m: int, n: int, k: int, backend: Optional[str] = None,
                      pack_out: bool = False,
                      op: str = "popcount_gemm", planes: int = 1) -> dict:
    """Static twin of the GEMM dispatch: the launch geometry of an
    [m, k] x [k, n] binary GEMM, without touching any operand, and its
    tuning key (``kernels.autotune``).  Oracle backends plan under
    "cuda", the deployment target.  For ``op="xnor_gemm"`` it also
    reports the kernel's launch plan (``tiles``: ``xnor_gemm.tile_plan``
    on an H100's 132 SMs, for bf16 activations; float32 ones run three
    MMA planes, ``planes=3``, and key under ``"xnor_gemm_f32"``)."""
    be = get_backend(backend)
    kb = be if be.uses_kernels else get_backend("cuda")
    k32 = kb.pad_k(round_up(k, 32)) // 32
    base = "xnor_gemm_f32" if op == "xnor_gemm" and planes > 1 else op
    opk = base + "+pack" if pack_out else base
    d = {"op": opk, "backend": kb.name, "m": m, "n": n, "k32": k32,
         "key": (opk, kb.name, m, n, k32)}
    if op == "xnor_gemm":
        d["tiles"] = tile_plan(m, n, k32, planes=planes, pack_out=pack_out)
    return d


def conv_padding(padding: Union[str, int], kh: int, kw: int
                 ) -> Tuple[int, int]:
    """Symmetric per-side spatial pad: "same" (odd kernels; preserves
    H/W at stride 1), "valid", or an explicit int."""
    if padding == "same":
        return (kh - 1) // 2, (kw - 1) // 2
    if padding == "valid":
        return 0, 0
    if isinstance(padding, (int, np.integer)):
        return int(padding), int(padding)
    raise ValueError(f"padding must be 'same', 'valid', or an int, "
                     f"got {padding!r}")


def plan_conv_launch(h: int, w: int, c: int, f: int, kh: int, kw: int,
                     stride: int = 1, padding: Union[str, int] = "same",
                     backend: Optional[str] = None, pack_out: bool = False,
                     impl: str = "auto", c32: Optional[int] = None,
                     nb: int = 1) -> dict:
    """Static twin of the binary_conv2d dispatch: output geometry and
    the direct-vs-im2col choice.

    The port's rule: "auto" is "direct".  The Hopper direct kernel is an
    implicit GEMM on the tensor cores that gathers each stage's window
    words into shared memory and keeps no image resident, so unlike the
    TPU kernel (one whole padded image in VMEM) it has no footprint that
    could overflow shared memory; im2col only pays the KH*KW-fold patch
    matrix in device memory.  im2col runs when forced.  For "direct" it
    also reports the kernel's launch plan (``tiles``:
    ``packed_conv.tile_plan`` on an H100's 132 SMs).  The tuning key's M
    is the launch's ``nb * ho * wo`` pixels: the port's kernel tiles the
    whole batch's pixels, so its plan depends on the batch (the
    reference's per-image TPU kernel keys on ``ho * wo``).
    """
    if impl not in ("auto", "direct", "im2col"):
        raise ValueError(f"impl must be 'auto', 'direct', or 'im2col', "
                         f"got {impl!r}")
    be = get_backend(backend)
    kb = be if be.uses_kernels else get_backend("cuda")
    pad_h, pad_w = conv_padding(padding, kh, kw)
    ho = out_size(h, kh, stride, pad_h)
    wo = out_size(w, kw, stride, pad_w)
    if c32 is None:
        c32 = (c + 31) // 32
    d = {"ho": ho, "wo": wo, "pad_h": pad_h, "pad_w": pad_w, "c32": c32,
         "backend": kb.name}
    if impl == "im2col":
        g = plan_dense_launch(nb * ho * wo, f, 32 * kh * kw * c32,
                              backend=kb.name, pack_out=pack_out)
        d.update(impl="im2col", op=g["op"], key=g["key"])
    else:
        op = "packed_conv+pack" if pack_out else "packed_conv"
        d.update(impl="direct", op=op,
                 key=(op, kb.name, nb * ho * wo, f, kh * kw * c32),
                 tiles=conv_tile_plan(nb * ho * wo, f, kh * kw * c32,
                                      pack_out=pack_out))
    return d


def binary_conv2d(xp: PackedArray, wf: PackedArray, stride: int = 1,
                  padding: Union[str, int] = "same",
                  threshold: Optional[Threshold] = None,
                  backend: Optional[str] = None,
                  pack_out: bool = False, impl: str = "auto"):
    """Fully-binary conv2d: channel-packed NHWC acts x packed filters.

    xp: PackedArray [N, H, W, C] packed on the channel axis (-1);
    wf: PackedArray [KH, KW, C, F] packed on the channel axis (-2).
    Spatial padding is -1 padding (all-zero words).  threshold: scalar
    or per-channel [F] — the output becomes {-1,+1} int32.  pack_out:
    with a threshold, return channel-packed PackedArray [N, HO, WO, F].
    impl: "direct", "im2col" or "auto" (see plan_conv_launch).  The
    "torch" backend runs the dense sign-conv oracle; every path is
    bit-identical."""
    if pack_out and threshold is None:
        raise ValueError("pack_out requires a threshold (binary output)")
    if impl not in ("auto", "direct", "im2col"):
        raise ValueError(f"impl must be 'auto', 'direct', or 'im2col', "
                         f"got {impl!r}")
    if not isinstance(xp, PackedArray) or not isinstance(wf, PackedArray):
        raise ValueError("binary_conv2d takes PackedArray operands")
    if xp.ndim != 4 or xp.axis != -1:
        raise ValueError(f"activations must be [N, H, W, C] packed on "
                         f"the channel axis, got ndim={xp.ndim} "
                         f"axis={xp.axis}")
    if wf.ndim != 4 or wf.axis != -2:
        raise ValueError(f"filters must be [KH, KW, C, F] packed on the "
                         f"channel axis (-2), got ndim={wf.ndim} "
                         f"axis={wf.axis}")
    if xp.length != wf.length:
        raise ValueError(f"channel mismatch: activations C={xp.length} "
                         f"vs filters C={wf.length}")
    c = xp.length
    kh, kw, f = wf.words.shape[0], wf.words.shape[1], wf.words.shape[-1]
    nb, h, w = xp.words.shape[0], xp.words.shape[1], xp.words.shape[2]
    pad_h, pad_w = conv_padding(padding, kh, kw)
    ho = out_size(h, kh, stride, pad_h)
    wo = out_size(w, kw, stride, pad_w)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty output: {h}x{w} conv {kh}x{kw} "
                         f"stride {stride} pad {pad_h}")
    be = get_backend(backend)

    if not be.uses_kernels:
        y = ref.sign_conv2d_ref(xp.unpack(torch.float32),
                                wf.unpack(torch.float32), stride=stride,
                                pad=pad_h, pad_w=pad_w)
        if threshold is not None:
            y = _threshold_plain(y, threshold, f)
        return PackedArray.pack(y, axis=-1) if pack_out else y

    # align the word counts (odd C: both sides pad to the same C32)
    c32 = max(xp.n_words, wf.n_words)
    xp = xp.pad_to(32 * c32)
    wf = wf.pad_to(32 * c32)
    xw = pad_words_spatial(xp.words, pad_h, pad_w).contiguous()
    ww = wf.words.reshape(kh * kw * c32, f).contiguous()   # tap-major
    d = plan_conv_launch(h, w, c, f, kh, kw, stride=stride,
                         padding=padding, backend=be.name,
                         pack_out=pack_out, impl=impl, c32=c32, nb=nb)
    if d["impl"] == "im2col":
        patches = im2col_words(xw, kh, kw, stride, ho, wo)
        # length counts the valid bits; the per-tap pad bits sit
        # mid-row but the closed form only counts them
        y = binary_binary_dense(
            PackedArray(patches, length=kh * kw * c),
            PackedArray(ww.t().contiguous(), length=kh * kw * c),
            threshold=threshold, pack_out=pack_out, backend=be.name)
        if pack_out:
            return PackedArray(y.words.reshape(nb, ho, wo, y.n_words),
                               length=f, axis=-1)
        return y.reshape(nb, ho, wo, f)

    thr, tvec = kernel_threshold(threshold, f, xw.device)
    y = packed_conv2d(xw, ww, kh=kh, kw=kw, c=c, stride=stride, ho=ho,
                      wo=wo, threshold=thr, threshold_vec=tvec,
                      pack_out=pack_out, valid_f=f)
    return (PackedArray(y.reshape(nb, ho, wo, y.shape[-1]), length=f,
                        axis=-1)
            if pack_out else y.reshape(nb, ho, wo, f))
