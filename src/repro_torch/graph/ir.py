"""The BNN graph IR — a copy of ``repro.graph.ir`` (DESIGN.md §8).

A :class:`BNNSpec` is a declarative, purely-static description of a
binarized network as a chain of typed nodes — the paper's "arbitrary
nodes of a BNN" (§IV) as data.  The compiler (graph/compile.py) lowers
one spec into the packed executable on the Hopper kernels.

Node set:
  IntegerEntry   float-input conv, alpha*sign(w) weights (the XNOR-Net
                 boundary layer; "Integer" in the paper's Table III)
  Binarize       sign+pack — entry into the packed 1-bit domain
  BinaryConv     channel-packed conv (ops.binary_conv2d)
  MaxPool        max pool — bitwise OR in the packed domain
  BinaryDense    packed XNOR-popcount dense (ops.binary_binary_dense)
  BNThreshold    per-channel integer threshold (folded BN, §IV-D);
                 always FUSED into its producer's pack epilogue
  Logits         int32 dot (or a real dense's float) -> float32
                 logits (the classifier output)

and the residual family (ReActNet, Bi-Real Net), whose activations are
a float stream that each half-step leaves and re-enters the packed
domain from:
  RealConv             real-valued conv + eval batch norm (the stem),
                       optionally followed by a float max pool
  ResidualBinaryConv   one residual half-step: a sign (ReActNet's has a
                       learned threshold, RSign), binary conv (0
                       padding), batch norm, a shortcut (identity, 2x2
                       average, duplicated channels or a 2x2 average
                       through a float 1x1 conv and batch norm) and, in
                       ReActNet, the shifted PReLU (RPReLU)
  GlobalAvgPool        mean over the spatial axes
  RealDense            real-valued dense layer with a bias (the head)

Lowering entry points:
  from_workload     core/workloads.py dataclass -> BNNSpec (subsumes
                    the geometry inference: infer_conv_geometry,
                    infer_pool, fc_entry_size)
  from_dense_stack  a fully-binary MLP stack -> BNNSpec

and back: ``spec_to_workload`` (the spec's layers as the workloads.py
dataclasses the TULIP mapping and energy model take).

Specs are validated structurally (``BNNSpec.validate``): chain widths
must match, the packed domain can only be left through Logits, integer
layers cannot follow binary ones (a 1-bit activation cannot re-enter
the float domain — a "not representable" layer), and every
non-terminal BinaryConv/BinaryDense must be thresholded (an int32
activation cannot stay packed).  A ResidualBinaryConv follows the
RealConv or ResidualBinaryConv whose epilogue writes its sign bits,
keeps the float stream's geometry rules (see ``validate``) and takes a
float input; RealDense ends in Logits.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

from repro_torch.core.workloads import ConvLayer, FCLayer, Workload

__all__ = ["Binarize", "BinaryConv", "BinaryDense", "BNNSpec",
           "BNThreshold", "GlobalAvgPool", "IntegerEntry", "Logits",
           "MaxPool", "RealConv", "RealDense", "ResidualBinaryConv",
           "fc_entry_size", "from_dense_stack", "from_workload",
           "bireal_net18", "bireal_small", "bireal_spec",
           "infer_conv_geometry", "infer_pool", "reactnet_a",
           "reactnet_small", "spec_to_workload"]


# ------------------------------------------------------------------ #
# geometry inference                                                   #
# ------------------------------------------------------------------ #
def infer_conv_geometry(layer: ConvLayer) -> Tuple[int, int]:
    """Recover (stride, pad) from a workloads.ConvLayer's in/out dims —
    the paper's tables record only the feature-map sizes.  Searches
    small strides/pads for an exact match (BinaryNet: s=1 same-pad;
    AlexNet conv1: s=4 pad=0) and raises when the dims are not a
    realizable conv geometry."""
    for s in (1, 2, 4, 3):
        for p in range((layer.k + 1) // 2 + 1):
            ok_x = (layer.x1 + 2 * p - layer.k) % s == 0 and \
                (layer.x1 + 2 * p - layer.k) // s + 1 == layer.x2
            ok_y = (layer.y1 + 2 * p - layer.k) % s == 0 and \
                (layer.y1 + 2 * p - layer.k) // s + 1 == layer.y2
            if ok_x and ok_y:
                return s, p
    raise ValueError(f"no (stride, pad) realizes {layer.name}: "
                     f"{layer.x1}x{layer.y1} -> {layer.x2}x{layer.y2} "
                     f"with k={layer.k}")


def infer_pool(x_from: int, x_to: int) -> Optional[Tuple[int, int]]:
    """(window, stride) of the max-pool between two feature-map sizes,
    or None when none is needed.  Covers the workloads' 2x2/s2
    (BinaryNet) and 3x3/s2 (AlexNet) pools."""
    if x_from == x_to:
        return None
    for win, s in ((3, 2), (2, 2)):    # AlexNet's 3x3/s2 preferred;
        if (x_from - win) // s + 1 == x_to:   # BinaryNet only fits 2x2
            return win, s
    raise ValueError(f"no standard max-pool maps {x_from} -> {x_to}")


def fc_entry_size(last_conv: ConvLayer, fc0: FCLayer) -> int:
    """Spatial size the last conv's maps must pool down to so that
    z2 * s^2 == fc0.n_in (the flatten the paper's tables imply)."""
    s2 = fc0.n_in // last_conv.z2
    s = int(math.isqrt(s2))
    if last_conv.z2 * s * s != fc0.n_in:
        raise ValueError(f"{fc0.name}.n_in={fc0.n_in} is not "
                         f"z2 * s^2 for z2={last_conv.z2}")
    return s


# ------------------------------------------------------------------ #
# IR nodes                                                             #
# ------------------------------------------------------------------ #
@dataclass(frozen=True)
class IntegerEntry:
    """Float-input conv with alpha*sign(w) weights (paper "Integer")."""
    name: str
    kh: int
    kw: int
    c_in: int
    c_out: int
    h_in: int
    w_in: int
    h_out: int
    w_out: int
    stride: int = 1
    pad: int = 0
    parts: int = 1        # image buffer parts (paper Table III col 2)


@dataclass(frozen=True)
class Binarize:
    """sign+pack into the 1-bit domain; ``flatten`` collapses the
    spatial dims first (the all-integer-body -> FC boundary)."""
    name: str
    flatten: bool = False


@dataclass(frozen=True)
class BinaryConv:
    name: str
    kh: int
    kw: int
    c_in: int
    c_out: int
    h_in: int
    w_in: int
    h_out: int
    w_out: int
    stride: int = 1
    pad: int = 0
    parts: int = 1


@dataclass(frozen=True)
class MaxPool:
    name: str
    window: int
    stride: int


@dataclass(frozen=True)
class BinaryDense:
    name: str
    n_in: int
    n_out: int


@dataclass(frozen=True)
class BNThreshold:
    """Integer threshold (the folded-BN comparator, paper §IV-D).
    Structurally a node; in the compiled plan it is always FUSED into
    the producing conv/dense pack epilogue.  ``per_channel`` records
    whether the threshold is a [channels] vector (the folded-BN form;
    costs resident bytes in the megakernel) or a static scalar — the
    segmentation pass feeds it to the shared residency rule."""
    name: str
    channels: int
    per_channel: bool = True


@dataclass(frozen=True)
class Logits:
    """Terminal: the last dense's int32 dot as float32 logits."""
    name: str
    classes: int


# the max pool after a ResNet-style stem (Bi-Real Net's): window 3,
# stride 2, a pad of 1 that counts as -inf; the one conv it follows:
# kernel 7, stride 2, pad 3 (the stems the stem kernels take, see
# _check_stem)
STEM_POOL = (3, 2, 1)
POOLED_STEM = (7, 2, 3)


@dataclass(frozen=True)
class RealConv:
    """Real-valued square conv over 3 channels (float weights, zero
    padding; 3x3 in ReActNet, 7x7 in Bi-Real Net) and its eval batch
    norm: the stem of a residual network.  ``pool`` (the 7x7 stem's
    alone, :data:`POOLED_STEM`) follows the batch norm with the float
    max pool :data:`STEM_POOL`.  ``h_out`` x
    ``w_out`` is the node's output: the pooled map where a pool follows,
    else the conv's (:meth:`conv_hw`)."""
    name: str
    kh: int
    kw: int
    c_in: int
    c_out: int
    h_in: int
    w_in: int
    h_out: int
    w_out: int
    stride: int = 1
    pad: int = 0
    pool: bool = False

    def conv_hw(self) -> Tuple[int, int]:
        """The conv's output extent, before any pool."""
        return ((self.h_in + 2 * self.pad - self.kh) // self.stride + 1,
                (self.w_in + 2 * self.pad - self.kw) // self.stride + 1)


SHORTCUTS = ("identity", "avgpool", "duplicate", "projection")


@dataclass(frozen=True)
class ResidualBinaryConv:
    """One residual half-step.  ReActNet's (``rprelu``): ``a = sign(x +
    b_in)`` (RSign), ``u = bn(alpha * conv(a, sign(w)))`` with a k x k
    conv, a zero pad of (k-1)/2 and ``alpha`` the mean |w| of each output
    channel, then ``out = rprelu(u + shortcut(x))``.  Bi-Real Net's
    (``rprelu=False``): ``a = sign(x)`` and ``out = u + shortcut(x)``,
    which is ReActNet's with the neutral parameters b_in = 0, a PReLU
    slope of 1 and shifts of 0.  ``shortcut``: "identity" (same width,
    stride 1), "avgpool" (2x2 average, stride 2, same width),
    "duplicate" (channel f of the output takes channel f mod c_in; the
    conv is the two concatenated convs of a doubling, c_out = 2*c_in,
    stride 1) or "projection" (a doubling at stride 2: the 2x2 average
    through a float 1x1 conv c_in -> c_out and its batch norm)."""
    name: str
    k: int
    c_in: int
    c_out: int
    h_in: int
    w_in: int
    h_out: int
    w_out: int
    stride: int = 1
    pad: int = 0
    shortcut: str = "identity"
    rprelu: bool = True


@dataclass(frozen=True)
class GlobalAvgPool:
    """Mean of the float stream over its spatial axes."""
    name: str


@dataclass(frozen=True)
class RealDense:
    """Real-valued dense layer with a bias (the classifier head)."""
    name: str
    n_in: int
    n_out: int


Node = Union[IntegerEntry, Binarize, BinaryConv, MaxPool, BinaryDense,
             BNThreshold, Logits, RealConv, ResidualBinaryConv,
             GlobalAvgPool, RealDense]
ConvNode = (IntegerEntry, BinaryConv)
RESIDUAL_NODES = (RealConv, ResidualBinaryConv, GlobalAvgPool, RealDense)


# ------------------------------------------------------------------ #
# the spec                                                             #
# ------------------------------------------------------------------ #
@dataclass(frozen=True)
class BNNSpec:
    """A declarative BNN: input shape + an ordered chain of nodes.

    ``input_shape`` is the logical per-sample shape: ``(H, W, C)`` for
    a conv network fed float NHWC images, ``(K,)`` for a dense stack
    fed an already-packed activation row."""
    name: str
    input_shape: Tuple[int, ...]
    nodes: Tuple[Node, ...]
    dataset: str = ""

    @property
    def conv_nodes(self) -> Tuple[Node, ...]:
        return tuple(n for n in self.nodes if isinstance(n, ConvNode))

    @property
    def dense_nodes(self) -> Tuple[BinaryDense, ...]:
        return tuple(n for n in self.nodes
                     if isinstance(n, BinaryDense))

    @property
    def stem_nodes(self) -> Tuple[RealConv, ...]:
        return tuple(n for n in self.nodes if isinstance(n, RealConv))

    @property
    def residual_nodes(self) -> Tuple[ResidualBinaryConv, ...]:
        return tuple(n for n in self.nodes
                     if isinstance(n, ResidualBinaryConv))

    @property
    def head_nodes(self) -> Tuple[RealDense, ...]:
        return tuple(n for n in self.nodes if isinstance(n, RealDense))

    def thresholded(self, node: Union[BinaryConv, BinaryDense]) -> bool:
        """True when ``node`` is directly followed by a BNThreshold."""
        i = next((j for j, n in enumerate(self.nodes) if n is node),
                 None)
        if i is None:
            i = self.nodes.index(node)
        return i + 1 < len(self.nodes) and \
            isinstance(self.nodes[i + 1], BNThreshold)

    # -------------------------------------------------------------- #
    def validate(self) -> None:
        """Structural checks; raises ValueError with the offending
        node named.  See the module docstring for the rules."""
        if not self.nodes:
            raise ValueError(f"{self.name}: empty spec")
        first_dense = isinstance(self.nodes[0], BinaryDense)
        if first_dense and len(self.input_shape) != 1:
            raise ValueError(f"{self.name}: a dense-entry spec takes a "
                             f"packed (K,) input, got "
                             f"{self.input_shape}")
        domain = "packed_flat" if first_dense else "float"
        h, w, c = (0, 0, self.input_shape[0]) if first_dense else \
            self.input_shape
        width = self.input_shape[0] if first_dense else 0
        for i, nd in enumerate(self.nodes):
            prev = self.nodes[i - 1] if i else None
            if isinstance(nd, IntegerEntry):
                if domain != "float":
                    raise ValueError(
                        f"{nd.name}: integer layer after a binary layer "
                        f"is not representable")
                if (nd.c_in, nd.h_in, nd.w_in) != (c, h, w):
                    raise ValueError(
                        f"{nd.name}: expects {nd.h_in}x{nd.w_in}x"
                        f"{nd.c_in}, incoming is {h}x{w}x{c}")
                h, w, c = nd.h_out, nd.w_out, nd.c_out
            elif isinstance(nd, Binarize):
                if domain != "float":
                    raise ValueError(f"{nd.name}: already packed")
                if nd.flatten:
                    domain, width = "packed_flat", h * w * c
                else:
                    domain = "packed_conv"
            elif isinstance(nd, BinaryConv):
                if domain != "packed_conv":
                    raise ValueError(f"{nd.name}: binary conv needs the "
                                     f"packed conv domain (insert a "
                                     f"Binarize node)")
                if (nd.c_in, nd.h_in, nd.w_in) != (c, h, w):
                    raise ValueError(
                        f"{nd.name}: expects {nd.h_in}x{nd.w_in}x"
                        f"{nd.c_in}, incoming is {h}x{w}x{c}")
                if not self.thresholded(nd):
                    raise ValueError(
                        f"{nd.name}: a binary conv must be followed by "
                        f"a BNThreshold (an int32 activation cannot "
                        f"stay packed)")
                h, w, c = nd.h_out, nd.w_out, nd.c_out
            elif isinstance(nd, MaxPool):
                if domain not in ("float", "packed_conv"):
                    raise ValueError(f"{nd.name}: pooling needs spatial "
                                     f"activations")
                h = (h - nd.window) // nd.stride + 1
                w = (w - nd.window) // nd.stride + 1
                if h <= 0 or w <= 0:
                    raise ValueError(f"{nd.name}: pool empties the map")
            elif isinstance(nd, BinaryDense):
                if domain == "packed_conv":
                    domain, width = "packed_flat", h * w * c
                elif domain in ("float", "float_flat"):
                    raise ValueError(f"{nd.name}: dense input must be "
                                     f"packed (insert a Binarize node)")
                if nd.n_in != width:
                    raise ValueError(f"{nd.name}: n_in={nd.n_in} but the "
                                     f"incoming width is {width}")
                nxt = self.nodes[i + 1] if i + 1 < len(self.nodes) \
                    else None
                if nxt is not None and \
                        not isinstance(nxt, (BNThreshold, Logits)):
                    raise ValueError(
                        f"{nd.name}: a dense layer must be followed by "
                        f"a BNThreshold or Logits (or terminate the "
                        f"spec with a packed output)")
                width = nd.n_out
            elif isinstance(nd, BNThreshold):
                if not isinstance(prev, (BinaryConv, BinaryDense)):
                    raise ValueError(f"{nd.name}: BNThreshold must "
                                     f"directly follow a binary conv "
                                     f"or dense node")
                out = prev.c_out if isinstance(prev, BinaryConv) \
                    else prev.n_out
                if nd.channels != out:
                    raise ValueError(f"{nd.name}: {nd.channels} channels "
                                     f"for a {out}-wide producer")
            elif isinstance(nd, RealConv):
                if domain != "float":
                    raise ValueError(f"{nd.name}: a real conv takes a float "
                                     f"spatial input")
                _check_stem(nd, (c, h, w))
                h, w, c = nd.h_out, nd.w_out, nd.c_out
            elif isinstance(nd, ResidualBinaryConv):
                if not isinstance(prev, (RealConv, ResidualBinaryConv)):
                    raise ValueError(
                        f"{nd.name}: a residual half-step follows the real "
                        f"conv or half-step whose epilogue writes its sign "
                        f"bits")
                _check_residual(nd, (c, h, w))
                h, w, c = nd.h_out, nd.w_out, nd.c_out
            elif isinstance(nd, GlobalAvgPool):
                if domain != "float":
                    raise ValueError(f"{nd.name}: a global pool takes the "
                                     f"float spatial stream")
                domain, width = "float_flat", c
            elif isinstance(nd, RealDense):
                if domain != "float_flat":
                    raise ValueError(f"{nd.name}: a real dense layer takes a "
                                     f"flat float input (insert a "
                                     f"GlobalAvgPool)")
                if nd.n_in != width:
                    raise ValueError(f"{nd.name}: n_in={nd.n_in} but the "
                                     f"incoming width is {width}")
                nxt = self.nodes[i + 1] if i + 1 < len(self.nodes) \
                    else None
                if not isinstance(nxt, Logits):
                    raise ValueError(f"{nd.name}: a real dense layer must be "
                                     f"followed by Logits")
                width = nd.n_out
            elif isinstance(nd, Logits):
                if not isinstance(prev, (BinaryDense, RealDense)):
                    raise ValueError(f"{nd.name}: Logits must follow an "
                                     f"un-thresholded BinaryDense or a "
                                     f"RealDense")
                if nd.classes != prev.n_out:
                    raise ValueError(f"{nd.name}: {nd.classes} classes "
                                     f"vs {prev.n_out}-wide dense")
                if i != len(self.nodes) - 1:
                    raise ValueError(f"{nd.name}: Logits must be the "
                                     f"terminal node")
            else:
                raise ValueError(f"unknown node {nd!r}")


def _check_conv_geometry(nd, k: int, incoming: Tuple[int, int, int],
                         out: Optional[Tuple[int, int]] = None) -> None:
    """A conv node's input is the incoming (C, H, W) and its output
    (``out``, else the node's ``h_out`` x ``w_out``) the extent its
    stride and pad give."""
    c, h, w = incoming
    if (nd.c_in, nd.h_in, nd.w_in) != (c, h, w):
        raise ValueError(f"{nd.name}: expects {nd.h_in}x{nd.w_in}x"
                         f"{nd.c_in}, incoming is {h}x{w}x{c}")
    ho, wo = out if out is not None else (nd.h_out, nd.w_out)
    for n_in, n_out, axis in ((nd.h_in, ho, "H"), (nd.w_in, wo, "W")):
        if (n_in + 2 * nd.pad - k) // nd.stride + 1 != n_out:
            raise ValueError(f"{nd.name}: {axis} {n_in} -> {n_out} is not a "
                             f"{k}-wide stride-{nd.stride} pad-{nd.pad} "
                             f"conv")


def _check_stem(nd: "RealConv", incoming: Tuple[int, int, int]) -> None:
    """A stem's rules: the two stems the stem kernels take, a 3x3 over 3
    channels (any stride and pad) with no pool, or the 7x7 stride-2
    pad-3 conv over 3 channels of :data:`POOLED_STEM` with the max pool
    :data:`STEM_POOL` after it; the conv's extent, and the pool's."""
    if nd.kh != nd.kw or nd.kh not in (3, 7) or nd.c_in != 3:
        raise ValueError(f"{nd.name}: a real conv is the stem of an image "
                         f"network, a 7x7 or a 3x3 over 3 channels, got "
                         f"{nd.kh}x{nd.kw}x{nd.c_in}")
    _check_conv_geometry(nd, nd.kh, incoming,
                         nd.conv_hw() if nd.pool else None)
    if nd.pool != (nd.kh == 7) or (
            nd.pool and (nd.kh, nd.stride, nd.pad) != POOLED_STEM):
        raise ValueError(f"{nd.name}: a 3x3 stem takes no pool, a 7x7 stem "
                         f"is stride {POOLED_STEM[1]} pad {POOLED_STEM[2]} "
                         f"with the max pool {STEM_POOL} after it; got a "
                         f"{nd.kh}x{nd.kw} stride {nd.stride} pad {nd.pad}"
                         f"{' with' if nd.pool else ' without'} the pool")
    if not nd.pool:
        return
    window, stride, pad = STEM_POOL
    for n_in, n_out, axis in zip(nd.conv_hw(), (nd.h_out, nd.w_out), "HW"):
        want = (n_in + 2 * pad - window) // stride + 1
        if want != n_out:
            raise ValueError(f"{nd.name}: the max pool maps {axis} {n_in} to "
                             f"{want}, not {n_out}")


def _check_residual(nd: "ResidualBinaryConv",
                    incoming: Tuple[int, int, int]) -> None:
    """A half-step's rules: packed words of whole channels, a 1x1 or a
    3x3 "same" conv, and the shortcut its widths and stride call for."""
    if nd.k not in (1, 3) or nd.pad != (nd.k - 1) // 2:
        raise ValueError(f"{nd.name}: a half-step is a 1x1 (pad 0) or a 3x3 "
                         f"(pad 1) conv, got k={nd.k} pad={nd.pad}")
    if nd.stride not in (1, 2):
        raise ValueError(f"{nd.name}: stride must be 1 or 2, got "
                         f"{nd.stride}")
    if nd.c_in % 32:
        raise ValueError(f"{nd.name}: c_in={nd.c_in} is not whole packed "
                         f"words (c_in % 32 != 0)")
    if nd.stride == 2 and (nd.h_in % 2 or nd.w_in % 2):
        raise ValueError(f"{nd.name}: stride 2 on an odd map {nd.h_in}x"
                         f"{nd.w_in} (the 2x2 average shortcut needs even "
                         f"extents)")
    _check_conv_geometry(nd, nd.k, incoming)
    if nd.c_out not in (nd.c_in, 2 * nd.c_in):
        raise ValueError(f"{nd.name}: {nd.c_in} -> {nd.c_out} channels; a "
                         f"half-step keeps its width or doubles it to "
                         f"{2 * nd.c_in}")
    doubles = nd.c_out == 2 * nd.c_in
    want = {(True, 1): "duplicate", (True, 2): "projection",
            (False, 1): "identity", (False, 2): "avgpool"}[doubles, nd.stride]
    if nd.shortcut != want:
        raise ValueError(f"{nd.name}: {nd.c_in} -> {nd.c_out} at stride "
                         f"{nd.stride} takes the {want!r} shortcut, got "
                         f"{nd.shortcut!r}")


# ------------------------------------------------------------------ #
# lowering: workloads.py dataclasses -> IR                             #
# ------------------------------------------------------------------ #
def _conv_node(layer: ConvLayer, stride: int, pad: int) -> Node:
    cls = IntegerEntry if layer.integer else BinaryConv
    return cls(layer.name, layer.k, layer.k, layer.z1, layer.z2,
               layer.y1, layer.x1, layer.y2, layer.x2, stride, pad,
               layer.parts)


def from_workload(wl: Workload) -> BNNSpec:
    """Pass 1 of the compile pipeline: lower a paper Workload into the
    IR, inferring (stride, pad) and the inter-layer pools from the
    table dims exactly as the reference's from_workload does."""
    if not wl.fc:
        raise ValueError(f"{wl.name}: a workload needs an FC tail")
    nodes = []
    packed = False
    conv, fc = wl.conv, wl.fc
    for i, l in enumerate(conv):
        s, p = infer_conv_geometry(l)
        if l.integer:
            if packed:
                raise ValueError(f"{l.name}: integer layer after a "
                                 f"binary layer is not representable")
            nodes.append(_conv_node(l, s, p))
        else:
            if not packed:
                nodes.append(Binarize(f"binarize@{l.name}"))
                packed = True
            nodes.append(_conv_node(l, s, p))
            nodes.append(BNThreshold(f"{l.name}.bn", l.z2))
        nxt = conv[i + 1].x1 if i + 1 < len(conv) else \
            fc_entry_size(l, fc[0])
        pool = infer_pool(l.x2, nxt)
        if pool is not None:
            nodes.append(MaxPool(f"pool@{l.name}", *pool))
    if conv and not packed:            # all-integer conv body
        nodes.append(Binarize("binarize@flatten", flatten=True))
    for j, l in enumerate(fc):
        if l.integer:
            raise ValueError(f"{l.name}: integer FC layers are not "
                             f"representable on the packed datapath")
        nodes.append(BinaryDense(l.name, l.n_in, l.n_out))
        if j < len(fc) - 1:
            nodes.append(BNThreshold(f"{l.name}.bn", l.n_out))
        else:
            nodes.append(Logits("logits", l.n_out))
    shape = (conv[0].y1, conv[0].x1, conv[0].z1) if conv else \
        (fc[0].n_in,)
    spec = BNNSpec(wl.name, shape, tuple(nodes), dataset=wl.dataset)
    spec.validate()
    return spec


def from_dense_stack(k0: int, ns: Sequence[int],
                     thresholded: Optional[Sequence[bool]] = None,
                     name: str = "mlp", logits: bool = False,
                     per_channel: Optional[Sequence[bool]] = None
                     ) -> BNNSpec:
    """A fully-binary MLP stack as a spec: packed [.., k0] input
    through dense layers of widths ``ns``.  ``thresholded`` defaults
    to all-True (each layer's output stays packed); with ``logits``
    the last layer is un-thresholded and terminates in a Logits node.
    ``per_channel`` marks which thresholds are [N_l] vectors (default)
    vs static scalars — a residency-footprint input to the megakernel
    segmentation pass."""
    if not ns:
        raise ValueError("from_dense_stack needs at least one layer")
    if thresholded is None:
        thresholded = [True] * len(ns)
        if logits:
            thresholded[-1] = False
    if per_channel is None:
        per_channel = [True] * len(ns)
    nodes = []
    d = k0
    for idx, (n, thr, pc) in enumerate(zip(ns, thresholded,
                                           per_channel)):
        nodes.append(BinaryDense(f"dense{idx}", d, n))
        if thr:
            nodes.append(BNThreshold(f"dense{idx}.bn", n,
                                     per_channel=bool(pc)))
        d = n
    if logits:
        nodes.append(Logits("logits", ns[-1]))
    spec = BNNSpec(name, (k0,), tuple(nodes))
    spec.validate()
    return spec


def spec_to_workload(spec: BNNSpec) -> Workload:
    """The inverse bridge: IR conv/dense nodes back into the
    workloads.py dataclasses the TULIP mapping/energy model consumes.
    Guarantees ``compile(wl).tulip_mapping()`` sees exactly the layers
    ``core.mapping.table3_rows(wl)`` does.  The residual family's nodes
    are outside that model (a float stream between binary layers, which
    the paper's PE array has no datapath for): raises on them."""
    conv, fc = [], []
    for nd in spec.nodes:
        if isinstance(nd, RESIDUAL_NODES):
            raise ValueError(
                f"{spec.name}: {nd.name} ({type(nd).__name__}) is outside "
                f"the TULIP mapping model, which covers chains of "
                f"IntegerEntry, BinaryConv and BinaryDense layers")
        if isinstance(nd, ConvNode):
            if nd.kh != nd.kw:
                raise ValueError(f"{nd.name}: the mapping model takes "
                                 f"square kernels, got "
                                 f"{nd.kh}x{nd.kw}")
            conv.append(ConvLayer(
                nd.name, nd.c_in, nd.c_out, nd.w_in, nd.h_in,
                nd.w_out, nd.h_out, nd.kh,
                integer=isinstance(nd, IntegerEntry), parts=nd.parts))
        elif isinstance(nd, BinaryDense):
            fc.append(FCLayer(nd.name, nd.n_in, nd.n_out))
    return Workload(spec.name, spec.dataset, tuple(conv), tuple(fc))


# ------------------------------------------------------------------ #
# the residual family: ReActNet                                        #
# ------------------------------------------------------------------ #
# ReActNet-A (Liu et al., ECCV 2020, arXiv:2003.03488): the width of
# the stem and of each block's output; a block of width change that is
# not to 64 runs at stride 2
REACTNET_A_WIDTHS = (32, 64, 128, 128, 256, 256, 512, 512, 512, 512, 512,
                     512, 1024, 1024)


def reactnet_spec(name: str, input_hw: int, widths: Sequence[int],
                  classes: int, dataset: str = "") -> BNNSpec:
    """A ReActNet of ``widths`` (the stem's, then each block's output):
    the stem (3x3 stride-2 real conv + BN, no pool), one block per later
    width (a 3x3 half-step at the block's stride with the 2x2 average
    shortcut where that is 2, then a 1x1 half-step, two concatenated 1x1
    convs where the width doubles), every half-step with its RSign and
    RPReLU, a global average pool and a real dense head of ``classes``.
    A block runs at stride 2 where its width changes and is not 64 (the
    published table).  Bi-Real Net's 7x7 stem, max pool and projection
    shortcuts are :func:`bireal_spec`'s."""
    h = (input_hw + 2 - 3) // 2 + 1
    c = widths[0]
    nodes: list = [RealConv("stem", 3, 3, 3, c, input_hw, input_hw, h, h, 2,
                            1)]
    for i, p in enumerate(widths[1:]):
        s = 2 if p != c and p != 64 else 1
        ho = (h - 1) // s + 1
        nodes.append(ResidualBinaryConv(
            f"block{i}.conv3x3", 3, c, c, h, h, ho, ho, s, 1,
            "avgpool" if s == 2 else "identity"))
        nodes.append(ResidualBinaryConv(
            f"block{i}.conv1x1", 1, c, p, ho, ho, ho, ho, 1, 0,
            "duplicate" if p == 2 * c else "identity"))
        h, c = ho, p
    nodes += [GlobalAvgPool("avgpool"), RealDense("fc", c, classes),
              Logits("logits", classes)]
    spec = BNNSpec(name, (input_hw, input_hw, 3), tuple(nodes),
                   dataset=dataset)
    spec.validate()
    return spec


def reactnet_a() -> BNNSpec:
    """ReActNet-A at its published widths: 224x224x3 in, 13 blocks (26
    half-steps), 1000 classes."""
    return reactnet_spec("reactnet-a", 224, REACTNET_A_WIDTHS, 1000,
                         dataset="imagenet")


def reactnet_small(input_hw: int = 16, classes: int = 10) -> BNNSpec:
    """A small spec of the same structure for the CPU: the stem to 32
    channels, then 32 -> 64 (a doubling at stride 1), 64 -> 128 (stride
    2: the average shortcut, then a doubling) and 128 -> 128 (identity
    shortcuts)."""
    return reactnet_spec("reactnet-small", input_hw, (32, 64, 128, 128),
                         classes)


# ------------------------------------------------------------------ #
# the residual family: Bi-Real Net                                     #
# ------------------------------------------------------------------ #
# Bi-Real Net-18 (Liu et al., ECCV 2018, arXiv:1808.00278; the public
# birealnet.py, BiRealNet(BasicBlock, [4, 4, 4, 4])): the stem's width
# and each stage's, and the half-steps a stage
BIREAL_18_WIDTHS = (64, 64, 128, 256, 512)
BIREAL_18_BLOCKS = (4, 4, 4, 4)


def bireal_spec(name: str, input_hw: int, widths: Sequence[int],
                blocks: Sequence[int], classes: int, dataset: str = ""
                ) -> BNNSpec:
    """A Bi-Real Net of ``widths`` (the stem's, then each stage's) and
    ``blocks`` half-steps a stage: the stem (7x7 stride-2 pad-3 real conv
    + BN, then a 3x3 stride-2 pad-1 max pool), each stage's half-steps
    (a 3x3 binary conv, BN and the shortcut added, no learned sign
    threshold and no activation: ``rprelu=False``), the first of a stage
    whose width doubles at stride 2 with the projection shortcut (2x2
    average, float 1x1 conv, BN), a global average pool and a real dense
    head of ``classes``."""
    conv = (input_hw + 2 * 3 - 7) // 2 + 1
    h = (conv + 2 - 3) // 2 + 1
    c = widths[0]
    nodes: list = [RealConv("conv1", 7, 7, 3, c, input_hw, input_hw, h, h,
                            2, 3, pool=True)]
    for i, (p, n) in enumerate(zip(widths[1:], blocks)):
        for j in range(n):
            s = 2 if j == 0 and p != c else 1
            ho = (h - 1) // s + 1
            nodes.append(ResidualBinaryConv(
                f"layer{i + 1}.{j}", 3, c, p, h, h, ho, ho, s, 1,
                "projection" if s == 2 else "identity", rprelu=False))
            h, c = ho, p
    nodes += [GlobalAvgPool("avgpool"), RealDense("fc", c, classes),
              Logits("logits", classes)]
    spec = BNNSpec(name, (input_hw, input_hw, 3), tuple(nodes),
                   dataset=dataset)
    spec.validate()
    return spec


def bireal_net18() -> BNNSpec:
    """Bi-Real Net-18 at its published widths: 224x224x3 in, 16 binary
    3x3 half-steps (three with a projection shortcut), 1000 classes."""
    return bireal_spec("bireal-net-18", 224, BIREAL_18_WIDTHS,
                       BIREAL_18_BLOCKS, 1000, dataset="imagenet")


def bireal_small(input_hw: int = 32, classes: int = 10) -> BNNSpec:
    """A small spec of the same structure for the CPU: the 7x7 stem and
    its pool to 32 channels at input_hw / 4, one identity half-step,
    one projection half-step to 64 channels."""
    return bireal_spec("bireal-small", input_hw, (32, 32, 64), (1, 1),
                       classes)
