"""A whole stack of thresholded binary dense layers in one launch.

The counterpart of ``repro.kernels.fused_mlp``; the kernel is
``csrc/fused_mlp.cu``.  The TULIP-PE schedule never lets an
intermediate activation leave the processing element; here one block
per tile of ``bm`` rows keeps its rows' packed activations in two
shared-memory buffers across the layers and streams each layer's
weights from device memory and L2 — the weights are not resident (fc1
of BinaryNet alone is 1 MiB, and a Hopper block has 227 KB).  Only the
first layer's input and the last layer's output cross device memory.

The words equal chaining ``binary_binary_dense(pack_out=True)``; the
plain version is exactly that chain of ``popcount_gemm_plain``.
``stack_plan`` is THE fused-vs-chained rule, shared with the graph
compiler's dense-run segmentation.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import binary_binary_dense, kernel_threshold
from repro_torch.kernels.packed import WORD, PackedArray, get_backend
from repro_torch.kernels.popcount_gemm import popcount_gemm_plain

__all__ = ["fused_binary_mlp", "fused_mlp_words", "fused_mlp_words_plain",
           "stack_plan"]

LayerThreshold = Union[int, torch.Tensor]

# the Hopper residency rule's constants (csrc/fused_mlp.cu)
SMEM_BYTES = 232448          # shared memory one H100 block may use
MAX_LAYERS = 8               # layers one launch takes
MAX_BM = 32                  # rows per block
N_SM = 132                   # SMs: at most one block each
TILE_BYTES = 4 * 32 * 257    # the streamed weight tile (32 words x 256+1)


def stack_plan(m: int, k0: int, ns: Sequence[int],
               w0: Optional[int] = None) -> dict:
    """Geometry + residency decision for one fused-stack launch.

    ``m`` rows of a ``k0``-bit input (``w0`` words, if padded wider)
    through layers of widths ``ns``.  The Hopper rule: a block holds the
    packed activations of ``bm`` rows in two shared-memory buffers (each
    as wide as the widest layer input) beside one streamed weight tile;
    weights and per-channel thresholds stay in device memory and cost no
    shared memory.  ``bm`` is the smallest power of two (at most 32)
    that needs no more blocks than the card has SMs — every block then
    streams the weights once, in parallel — halved until the buffers
    fit.  The stack fits when some ``bm`` >= 1 fits and it has at most 8
    layers."""
    if w0 is None:
        w0 = (k0 + 31) // 32
    # the last layer writes device memory directly, not a buffer
    buf_words = max([w0] + [(n + 31) // 32 for n in ns[:-1]])
    bm = 1                       # a power of two: the kernel's template
    while bm < MAX_BM and bm * N_SM < m:
        bm *= 2
    while bm > 1 and 8 * bm * buf_words + TILE_BYTES > SMEM_BYTES:
        bm //= 2
    smem = 8 * bm * buf_words + TILE_BYTES
    return {"bm": bm, "w0": w0, "buf_words": buf_words, "smem_bytes": smem,
            "fits": smem <= SMEM_BYTES and len(ns) <= MAX_LAYERS}


def fused_mlp_words_plain(x: torch.Tensor, ws: Sequence[torch.Tensor],
                          ks: Sequence[int],
                          thresholds: Sequence[LayerThreshold]
                          ) -> torch.Tensor:
    """The plain torch version: the chain of thresholded, packed
    popcount GEMMs the kernel fuses."""
    h = x
    for w, k, t in zip(ws, ks, thresholds):
        scalar = not isinstance(t, torch.Tensor)
        h = popcount_gemm_plain(h, w, k,
                                threshold=t if scalar else None,
                                threshold_vec=None if scalar else t,
                                pack_out=True)
    return h


def fused_mlp_words(x: torch.Tensor, ws: Sequence[torch.Tensor],
                    ks: Sequence[int],
                    thresholds: Sequence[LayerThreshold]) -> torch.Tensor:
    """x: int32 words [M, W0]; ws[l]: int32 words [N_l, KW_l] with
    KW_0 = W0 and KW_{l+1} = ceil(N_l/32); ks[l]: valid bits of layer
    l's input; thresholds[l]: int, or int32 [N_l] per channel.  Returns
    the last layer's words [M, ceil(N_L/32)].  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel with
    ``stack_plan``'s row tile."""
    if not (len(ws) == len(ks) == len(thresholds)) or not ws:
        raise ValueError(f"{len(ws)} weights, {len(ks)} ks, "
                         f"{len(thresholds)} thresholds")
    if x.ndim != 2:
        raise ValueError(f"x must be [M, W0] words, got {tuple(x.shape)}")
    kw = x.shape[1]
    for li, (w, k, t) in enumerate(zip(ws, ks, thresholds)):
        if w.ndim != 2 or w.shape[1] != kw:
            raise ValueError(f"layer {li}: weights {tuple(w.shape)} but "
                             f"the incoming activation has {kw} words")
        if not 0 < k <= 32 * kw:
            raise ValueError(f"layer {li}: k={k} outside (0, {32 * kw}]")
        if isinstance(t, torch.Tensor) and (
                t.dtype != WORD or t.shape != (w.shape[0],)):
            raise ValueError(f"layer {li}: per-channel threshold must be "
                             f"int32 [{w.shape[0]}]")
        kw = (w.shape[0] + 31) // 32
    if x.device.type == "cpu":
        return fused_mlp_words_plain(x, ws, ks, thresholds)
    _build.require_cuda_tensor(x, "fused_mlp_words")
    tensors = [x, *ws] + [t for t in thresholds
                          if isinstance(t, torch.Tensor)]
    for t in tensors:
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"fused_mlp_words: every operand must be "
                             f"contiguous on {x.device}")
    if x.dtype != WORD or any(w.dtype != WORD for w in ws):
        raise ValueError("fused_mlp_words: words must be int32")
    ns = [w.shape[0] for w in ws]
    m = x.shape[0]
    sp = stack_plan(m, ks[0], ns, w0=x.shape[1])
    if not sp["fits"]:
        raise ValueError(f"stack does not fit one launch "
                         f"({sp['smem_bytes']} B of shared memory, "
                         f"{len(ns)} layers)")
    nl = len(ws)
    out = torch.empty(m, (ns[-1] + 31) // 32, dtype=WORD, device=x.device)
    w_ptrs = (ctypes.c_void_p * nl)(*[w.data_ptr() for w in ws])
    t_ptrs = (ctypes.c_void_p * nl)(
        *[t.data_ptr() if isinstance(t, torch.Tensor) else None
          for t in thresholds])
    ints = ctypes.c_int * nl
    _build.FUSED_MLP.launch(
        x.device, _build.ptr(x), _build.ptr(out), m, x.shape[1], nl,
        ctypes.cast(w_ptrs, ctypes.c_void_p),
        ctypes.cast(t_ptrs, ctypes.c_void_p),
        ctypes.cast(ints(*ns), ctypes.c_void_p),
        ctypes.cast(ints(*[w.shape[1] for w in ws]), ctypes.c_void_p),
        ctypes.cast(ints(*ks), ctypes.c_void_p),
        ctypes.cast(ints(*[0 if isinstance(t, torch.Tensor) else int(t)
                           for t in thresholds]), ctypes.c_void_p),
        sp["bm"], sp["buf_words"])
    return out


def fused_binary_mlp(xp: Union[PackedArray, torch.Tensor],
                     weights: Sequence[PackedArray],
                     thresholds: Sequence, k: Optional[int] = None,
                     backend: Optional[str] = None) -> PackedArray:
    """Run a stack of fully-binary thresholded dense layers fused.

    xp: PackedArray [..., K0] packed on the last axis (or raw int32
    words with explicit ``k``); weights[l]: PackedArray [N_l, K_l] with
    K_l == N_{l-1}; thresholds[l]: scalar or per-channel [N_l].  Returns
    the last layer's activations as a PackedArray [..., N_L] —
    bit-identical to chaining binary_binary_dense(pack_out=True), but on
    "cuda" the stack runs in ONE launch when ``stack_plan`` says it fits
    (otherwise it chains, which only costs launches)."""
    if len(weights) != len(thresholds):
        raise ValueError(f"{len(weights)} weights vs "
                         f"{len(thresholds)} thresholds")
    if not weights:
        raise ValueError("fused_binary_mlp needs at least one layer")
    if not isinstance(xp, PackedArray):
        if k is None:
            raise ValueError("raw packed words need an explicit k")
        xp = PackedArray(xp, length=k, axis=-1)
    xp = xp.move_pack_axis_last()
    ws = [w.move_pack_axis_last() for w in weights]
    d = xp.length
    ns: List[int] = []
    for li, w in enumerate(ws):
        if w.length != d:
            raise ValueError(f"layer {li}: weight K={w.length} but the "
                             f"incoming activation width is {d}")
        d = w.words.shape[0]
        ns.append(d)
    if any(t is None for t in thresholds):
        raise ValueError("every fused layer needs a threshold "
                         "(the output must be binary to stay packed)")
    be = get_backend(backend)

    def chained() -> PackedArray:
        h = xp
        for w, t in zip(ws, thresholds):
            h = binary_binary_dense(h, w, threshold=t, pack_out=True,
                                    backend=be.name)
        return h

    if not be.uses_kernels:
        return chained()
    device = xp.words.device
    thrs = []
    for t, n in zip(thresholds, ns):
        thr, tvec = kernel_threshold(t, n, device)
        thrs.append(thr if tvec is None else tvec)
    lead = xp.words.shape[:-1]
    w0 = max(xp.n_words, ws[0].n_words)
    sp = stack_plan(xp.words[..., 0].numel(), xp.length, ns, w0=w0)
    if not sp["fits"]:
        return chained()
    x2 = xp.pad_to(32 * w0).words.reshape(-1, w0).contiguous()
    w_words = [ws[0].pad_to(32 * w0).words.contiguous()] + \
        [w.words.contiguous() for w in ws[1:]]
    ks = [xp.length] + ns[:-1]
    words = fused_mlp_words(x2, w_words, ks, thrs)
    return PackedArray(words.reshape(*lead, words.shape[-1]),
                       length=ns[-1], axis=-1)
