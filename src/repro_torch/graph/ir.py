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
  Logits         int32 dot -> float32 logits (the classifier output)

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
activation cannot stay packed).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

from repro_torch.core.workloads import ConvLayer, FCLayer, Workload

__all__ = ["Binarize", "BinaryConv", "BinaryDense", "BNNSpec",
           "BNThreshold", "IntegerEntry", "Logits", "MaxPool",
           "fc_entry_size", "from_dense_stack", "from_workload",
           "infer_conv_geometry", "infer_pool", "spec_to_workload"]


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


Node = Union[IntegerEntry, Binarize, BinaryConv, MaxPool, BinaryDense,
             BNThreshold, Logits]
ConvNode = (IntegerEntry, BinaryConv)


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
                elif domain == "float":
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
            elif isinstance(nd, Logits):
                if not isinstance(prev, BinaryDense):
                    raise ValueError(f"{nd.name}: Logits must follow an "
                                     f"un-thresholded BinaryDense")
                if nd.classes != prev.n_out:
                    raise ValueError(f"{nd.name}: {nd.classes} classes "
                                     f"vs {prev.n_out}-wide dense")
                if i != len(self.nodes) - 1:
                    raise ValueError(f"{nd.name}: Logits must be the "
                                     f"terminal node")
            else:
                raise ValueError(f"unknown node {nd!r}")


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
    ``core.mapping.table3_rows(wl)`` does."""
    conv, fc = [], []
    for nd in spec.nodes:
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
