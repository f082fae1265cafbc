"""A whole stack of thresholded binary dense layers in one launch.

The counterpart of ``repro.kernels.fused_mlp``; the kernel is
``csrc/fused_mlp.cu``.  The TULIP-PE schedule never lets an
intermediate activation leave the processing element; here the
activation of a tile of ``bm`` rows stays in shared memory across the
layers, and the layers' output words are split over a thread-block
cluster of ``cs`` blocks, which hand their words to each other through
distributed shared memory after each layer.  Each block streams only
its slice of each layer's weights (the weights are not resident: fc1 of
BinaryNet alone is 1 MiB, and a Hopper block has 227 KB).  Only the
first layer's input and the last layer's output cross device memory;
the dots run on the b1 tensor cores.

The words equal chaining ``binary_binary_dense(pack_out=True)``; the
plain version is exactly that chain of ``popcount_gemm_plain``.
``stack_plan`` is THE fused-vs-chained rule, shared with the graph
compiler's dense-run segmentation, and picks the launch's row tile and
cluster size.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import _build, autotune
from repro_torch.kernels.ops import binary_binary_dense, kernel_threshold
from repro_torch.kernels.packed import WORD, PackedArray, get_backend
from repro_torch.kernels.popcount_gemm import popcount_gemm_plain

__all__ = ["block_slices", "fused_binary_mlp", "fused_mlp_words",
           "fused_mlp_words_plain", "launch_config", "stack_plan"]

LayerThreshold = Union[int, torch.Tensor]

# the kernel's constants (csrc/fused_mlp.cu)
SMEM_BYTES = 232448          # shared memory one H100 block may use
SM_SMEM_BYTES = 233472       # shared memory of one H100 SM, its blocks' sum
MAX_LAYERS = 8               # layers one launch takes
ROW_TILES = (64, 32, 16)     # BM, rows per cluster, largest first
CLUSTERS = (16, 8)           # CS, blocks per cluster
RING = 4                     # stages of the weight ring
STAGE_BYTES = 4 * 9216       # one stage: 256 columns x (32 + 4) words
PAD_WORDS = 4                # words after each row of a buffer or stage
MMA_WORDS = 8                # K of one b1 m16n8k256 MMA, in words
# clusters of 16 and of 8 blocks an H100 SXM runs at once, one block an
# SM (cudaOccupancyMaxActiveClusters at any row tile: every block needs
# more than half an SM's shared memory)
H100_CLUSTERS = {16: 7, 8: 15}


def _round8(words: int) -> int:
    return -(-words // MMA_WORDS) * MMA_WORDS


def smem_bytes(bm: int, buf_words: int) -> int:
    """Dynamic shared memory of one block: the weight ring, two
    activation buffers of ``bm`` rows and the rows' popcounts."""
    return RING * STAGE_BYTES + 4 * (2 * bm * (buf_words + PAD_WORDS) + bm)


def block_slices(n: int, cs: int) -> List[Tuple[int, int]]:
    """The output words ``[lo, hi)`` of a layer of ``n`` columns that
    each block of a cluster of ``cs`` owns: whole 32-column words, as
    equal as they divide (a block may own none)."""
    nw = -(-n // 32)
    return [(nw * r // cs, nw * (r + 1) // cs) for r in range(cs)]


def stack_plan(m: int, k0: int, ns: Sequence[int],
               w0: Optional[int] = None,
               clusters: Optional[Dict[int, int]] = None) -> dict:
    """Geometry and fit of one fused-stack launch.

    ``m`` rows of a ``k0``-bit input (``w0`` words, if padded wider)
    through layers of widths ``ns``, on a card that runs ``clusters[cs]``
    clusters of ``cs`` blocks at once (``H100_CLUSTERS`` by default; the
    wrapper asks the card).  A cluster of ``cs`` blocks owns a row tile of
    ``bm`` rows and splits each layer's output words, so each block
    streams 1/cs of the weights; a block holds the tile's whole
    activation in two buffers of ``buf_words`` words a row (the widest
    layer input, rounded to whole MMA depths) beside a ring of weight
    stages.  Of the row tiles 16, 32, 64 that fit the 232,448 B a block
    may use, and the cluster sizes the card can run, the plan takes the
    fewest waves (ceil(row tiles / clusters at once)), then the larger
    cluster (half the weight bytes a block), then the smaller row tile.
    The stack fits one launch when ``bm`` = 16 fits and it has at most
    8 layers."""
    clusters = H100_CLUSTERS if clusters is None else clusters
    if w0 is None:
        w0 = (k0 + 31) // 32
    # the last layer writes device memory directly, not a buffer
    buf_words = max(_round8(w) for w in
                    [w0] + [(n + 31) // 32 for n in ns[:-1]])
    runnable = [cs for cs in CLUSTERS if clusters.get(cs, 0) > 0]
    if not runnable:
        raise ValueError(f"no cluster of {CLUSTERS} blocks can run: "
                         f"{clusters}")
    options = []            # (waves, -cs, bm): the first is the plan
    for bm in ROW_TILES:
        if smem_bytes(bm, buf_words) <= SMEM_BYTES:
            tiles = -(-m // bm)
            options += [(-(-tiles // clusters[cs]), -cs, bm)
                        for cs in runnable]
    waves, neg_cs, bm = min(options, default=(0, -runnable[0],
                                              ROW_TILES[-1]))
    cs = -neg_cs
    return {"bm": bm, "cs": cs, "blocks": -(-m // bm) * cs,
            "waves": waves, "w0": w0, "buf_words": buf_words,
            "smem_bytes": smem_bytes(bm, buf_words), "ring": RING,
            "fits": bool(options) and len(ns) <= MAX_LAYERS}


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


def _check_stack(x: torch.Tensor, ws: Sequence[torch.Tensor],
                 ks: Sequence[int],
                 thresholds: Sequence[LayerThreshold]) -> None:
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


def fused_mlp_words(x: torch.Tensor, ws: Sequence[torch.Tensor],
                    ks: Sequence[int],
                    thresholds: Sequence[LayerThreshold]) -> torch.Tensor:
    """x: int32 words [M, W0]; ws[l]: int32 words [N_l, KW_l] with
    KW_0 = W0 and KW_{l+1} = ceil(N_l/32); ks[l]: valid bits of layer
    l's input; thresholds[l]: int, or int32 [N_l] per channel.  Returns
    the last layer's words [M, ceil(N_L/32)].  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel with the row tile
    and cluster size of :func:`launch_config`.  A stack that does not
    fit one launch, or a card that can schedule neither cluster, raises."""
    _check_stack(x, ws, ks, thresholds)
    if x.device.type == "cpu":
        return fused_mlp_words_plain(x, ws, ks, thresholds)
    _build.require_cuda_tensor(x, "fused_mlp_words")
    config = launch_config(x.device, x.shape[0], ks[0],
                           [w.shape[0] for w in ws], x.shape[1])
    return _launch(x, ws, ks, thresholds, config)


def launch_config(device: torch.device, m: int, k0: int, ns: Sequence[int],
                  w0: Optional[int] = None,
                  tuned: bool = True) -> Tuple[int, int]:
    """The ``(BM, CS)`` a launch on ``device`` takes: the tuning table's
    entry for ``("fused_binary_mlp", "cuda", m, k0, tuple(ns))`` where it
    has one (``tuned``; ``kernels.autotune``), else ``stack_plan`` with
    the clusters of 16 and of 8 blocks the card runs at once
    (``cudaOccupancyMaxActiveClusters``).  Raises where the stack does
    not fit one launch or the card can schedule neither cluster (a
    tuned config the card cannot schedule raises at launch)."""
    hit = autotune.get_table().get(
        ("fused_binary_mlp", "cuda", m, k0, tuple(ns))) if tuned else None
    if hit:
        return hit["bm"], hit["cs"]
    buf_words = stack_plan(m, k0, ns, w0=w0)["buf_words"]
    clusters = {cs: _active_clusters(device, ROW_TILES[-1], cs, buf_words)
                for cs in CLUSTERS}
    if not any(clusters.values()):
        raise RuntimeError(f"fused_mlp: {device} can schedule no cluster "
                           f"of {' or '.join(map(str, CLUSTERS))} blocks "
                           f"with {smem_bytes(ROW_TILES[-1], buf_words)} B "
                           f"each")
    sp = stack_plan(m, k0, ns, w0=w0, clusters=clusters)
    if not sp["fits"]:
        raise ValueError(f"stack does not fit one launch "
                         f"({sp['smem_bytes']} B of shared memory, "
                         f"{len(ns)} layers)")
    return sp["bm"], sp["cs"]


_clusters: Dict[tuple, int] = {}


def _active_clusters(device: torch.device, bm: int, cs: int,
                     buf_words: int) -> int:
    """Clusters of ``cs`` blocks of row tile ``bm`` the card can run at
    once (``cudaOccupancyMaxActiveClusters``; 0: none can be
    scheduled)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (idx, bm, cs, buf_words)
    if key not in _clusters:
        lib = _build._load("fused_mlp")
        fn = lib.fused_mlp_active_clusters
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
        with torch.cuda.device(idx):
            n = fn(bm, cs, buf_words)
        if n < 0:
            raise RuntimeError(f"fused_mlp: occupancy query for BM={bm}, "
                               f"CS={cs} failed (CUDA error {-n})")
        _clusters[key] = n
    return _clusters[key]


def _launch(x: torch.Tensor, ws: Sequence[torch.Tensor], ks: Sequence[int],
            thresholds: Sequence[LayerThreshold],
            config: Tuple[int, int]) -> torch.Tensor:
    """The kernel on CUDA operands with the launch ``(BM, CS)`` given:
    :func:`fused_mlp_words` passes its plan, and the checks on the card
    pass every config in turn.  A config whose block does not fit the
    shared memory, or whose cluster the card cannot schedule, raises."""
    bm, cs = config
    if bm not in ROW_TILES or cs not in CLUSTERS:
        raise ValueError(f"config must be (BM, CS) with BM in {ROW_TILES} "
                         f"and CS in {CLUSTERS}, got {config}")
    _check_stack(x, ws, ks, thresholds)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp's kernel takes CUDA tensors, got "
                         f"device {x.device}")
    tvecs = [t for t in thresholds if isinstance(t, torch.Tensor)]
    for t in [x, *ws, *tvecs]:
        if t.dtype != WORD or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"fused_mlp_words: every operand must be "
                             f"contiguous int32 on {x.device}")
    ns = [w.shape[0] for w in ws]
    if len(ns) > MAX_LAYERS:
        raise ValueError(f"one launch takes at most {MAX_LAYERS} layers, "
                         f"got {len(ns)}")
    m = x.shape[0]
    buf_words = stack_plan(m, ks[0], ns, w0=x.shape[1])["buf_words"]
    smem = smem_bytes(bm, buf_words)
    if smem > SMEM_BYTES:
        raise ValueError(f"config {config} needs {smem} B of shared memory "
                         f"a block, more than {SMEM_BYTES}")
    if _active_clusters(x.device, bm, cs, buf_words) < 1:
        raise RuntimeError(f"config {config}: {x.device} cannot schedule a "
                           f"cluster of {cs} blocks with {smem} B each")
    nl = len(ws)
    out = torch.empty(m, (ns[-1] + 31) // 32, dtype=WORD, device=x.device)
    if m == 0:
        return out
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
        bm, cs, buf_words)
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
