"""Op cost counter with loop trip-count scaling — the port's
counterpart of ``repro.runtime.hlo_cost``.

The reference parses XLA's compiled HLO text, because XLA's own
``cost_analysis()`` counts a ``while`` body once.  The port has no HLO:
``count(fn, *args)`` runs ``fn`` under a ``TorchDispatchMode`` and
prices every aten op it dispatches (forward, backward, a remat's
recompute and the optimizer alike), with the reference's rules:

  * flops — a dot-like op (mm, bmm, addmm, baddbmm, convolution) costs
    2 * |result| * contraction (``hlo_cost._dot_flops``); an op of
    ``ELEMENTWISE`` costs its factor times |result| (the factor counts
    the XLA elementwise ops the aten op stands for: ``silu`` is
    logistic and multiply, 2); a reduction of ``REDUCE`` costs |result|,
    as hlo_cost counts ``reduce``;
  * bytes — operand bytes plus result bytes of every op that
    materialises; a view (``OpOverload.is_view``: view, reshape of a
    contiguous tensor, expand, slice, select, transpose, alias, detach,
    unbind, ...) and an op of ``FREE`` (empty, arange: XLA's
    ``parameter`` / ``iota``) cost nothing; an operand is charged its
    own bytes, so a slice that is read costs the slice, not its base
    (``Computation.slice_overrides``); an in-place update of a region
    (``index_put_``, ``copy_`` into a slice) costs twice the region, as
    hlo_cost charges ``dynamic-update-slice``;
  * collectives — operand bytes of every c10d op, by kind.  On one card
    there is none: ``compressed_psum`` only sums under a
    ``torch.distributed`` group.

Bytes are eager torch's: every op is its own materialisation boundary,
where XLA fuses elementwise chains, so they bound the reference's
fused bytes from above.  Flops follow the reference's rules op for op.

Trip-count scaling.  Eager torch walks every loop, so nothing is
undercounted, but a meta-device dry-run of a 32k-token prefill walks
tens of thousands of chunk tiles in Python.  Two ways count one trip of
a region whose trips have identical shapes and scale it by the trip
count:

  * ``scan(body, carry, xs)`` — ``jax.lax.scan``'s contract over a
    Python sequence, used by the models' chunk loops.  Under a
    ``Counter(scale_loops=True)`` with grad disabled it runs the first
    trip only, multiplies that trip's cost by ``len(xs)`` and returns
    the first trip's ``y`` in every slot (the values of the other trips
    are not computed: a scaled run is for counting).  Otherwise, and
    always with grad enabled (the backward pass would see one trip), it
    is the plain loop, so it changes no output bit.
  * ``extrapolate(base, [(bigger, trips)])`` — a region counted as
    the difference of two whole runs, ``bigger`` with one trip more
    than ``base``: the dry-run counts a model with k and k + 1 layer cycles
    and scales the difference to the config's cycle count, which
    prices a cycle's backward, recompute and optimizer work with it.

Memory: the counter also follows every storage an op creates until it
is freed (``weakref.finalize`` on the storage), so ``peak_bytes`` is
the peak of live bytes created inside the call — the counterpart of
XLA's ``temp_size_in_bytes`` plus the outputs live at that peak.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["Cost", "Counter", "ELEMENTWISE", "REDUCE", "FREE", "count",
           "extrapolate", "scan"]

# aten dot-like ops: (index of the lhs operand, contraction rule)
DOT = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1, "addbmm": 1,
       "mv": 0, "addmv": 1, "dot": 0, "vdot": 0, "convolution": 0,
       "_convolution": 0}
# the extra elementwise pass an add-fused dot carries (the bias add)
_DOT_ADD = {"addmm", "baddbmm", "addbmm", "addmv"}

# aten op -> XLA elementwise ops per result element (hlo_cost
# ``_ELEMENTWISE``: add, subtract, multiply, divide, power, exponential,
# log, tanh, rsqrt, sqrt, negate, maximum, minimum, and/or/xor/not,
# select, compare, convert, floor, ceil, abs, sign, cosine, sine,
# logistic, remainder, shifts, clamp, exponential-minus-one,
# log-plus-one, atan2).  A composite counts the ops jax writes it as.
ELEMENTWISE: Dict[str, float] = {
    "add": 1, "sub": 1, "rsub": 1, "mul": 1, "div": 1, "pow": 1,
    "exp": 1, "log": 1, "tanh": 1, "rsqrt": 1, "sqrt": 1, "neg": 1,
    "maximum": 1, "minimum": 1, "max": 1, "min": 1, "fmax": 1, "fmin": 1,
    "bitwise_and": 1, "bitwise_or": 1, "bitwise_xor": 1, "bitwise_not": 1,
    "logical_and": 1, "logical_or": 1, "logical_xor": 1, "logical_not": 1,
    "__and__": 1, "__or__": 1, "__xor__": 1,
    "where": 1, "masked_fill": 1,                       # select
    "eq": 1, "ne": 1, "lt": 1, "le": 1, "gt": 1, "ge": 1,   # compare
    "_to_copy": 1,                                      # convert
    "floor": 1, "ceil": 1, "round": 1, "trunc": 1, "abs": 1, "sign": 1,
    "sgn": 1, "cos": 1, "sin": 1, "sigmoid": 1, "remainder": 1,
    "fmod": 1, "bitwise_left_shift": 1, "bitwise_right_shift": 1,
    "__lshift__": 1, "__rshift__": 1, "clamp": 1, "clamp_min": 1,
    "clamp_max": 1, "expm1": 1, "log1p": 1, "atan2": 1, "erf": 1,
    "square": 1, "reciprocal": 1, "exp2": 1, "log2": 1,
    "silu": 2,                   # x * logistic(x)
    "softplus": 4,               # logaddexp(x, 0): max, |x|, exp, log1p
    "gelu": 8,                   # the tanh form: 8 ops
    "relu": 1,                   # maximum
    "lerp": 3,
    "addcmul": 2, "addcdiv": 2,
    "_softmax": 3,               # subtract, exponential, divide
    "_log_softmax": 3,           # subtract, exponential, log / subtract
    # backward ops, each priced by the ops jax's transpose writes
    "silu_backward": 5, "sigmoid_backward": 3, "tanh_backward": 3,
    "threshold_backward": 1, "gelu_backward": 12,
    "softplus_backward": 3, "_softmax_backward_data": 3,
    "_log_softmax_backward_data": 3,
}
# reductions: |result| (hlo_cost counts ``reduce`` by its output)
REDUCE = {"sum", "mean", "amax", "amin", "prod", "any", "all", "argmax",
          "argmin", "logsumexp", "norm", "linalg_vector_norm", "var",
          "std", "var_mean"}
# the divide that ``mean`` adds to its reduce
_REDUCE_EXTRA = {"mean": 1}
# allocations that move no bytes (XLA: parameter, constant, iota)
# (views are free through ``OpOverload.is_view``; ``_unsafe_view`` is
# a reshape that torch does not mark as one)
FREE = {"empty", "empty_like", "empty_strided", "new_empty",
        "new_empty_strided", "arange", "lift_fresh_copy", "scalar_tensor",
        "_local_scalar_dense", "set", "resize", "_unsafe_view",
        "record_stream"}
# c10d op name fragment -> collective kind
_COLLECTIVE = (("all_gather", "all-gather"), ("allgather", "all-gather"),
               ("reduce_scatter", "reduce-scatter"),
               ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
               ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
               ("broadcast", "collective-permute"),
               ("send", "collective-permute"),
               ("recv", "collective-permute"))


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collectives: Dict[str, float] = field(default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for k, v in other.collectives.items():
            self.collectives[k] = self.collectives.get(k, 0.0) + v * mult

    @property
    def collective_bytes(self) -> float:
        return sum(self.collectives.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _dot_flops(name: str, args, out: torch.Tensor) -> float:
    lhs = args[DOT[name]]
    if name in ("convolution", "_convolution"):
        w = args[1]
        contraction = w.numel() // max(w.shape[0], 1)
        if len(args) > 6 and args[6]:          # transposed
            contraction = w.numel() // max(w.shape[1], 1)
    else:
        contraction = lhs.shape[-1]
    flops = 2.0 * out.numel() * max(contraction, 1)
    if name in _DOT_ADD:
        flops += out.numel()
    return flops


def _collective_kind(name: str) -> Optional[str]:
    for frag, kind in _COLLECTIVE:
        if frag in name:
            return kind
    return None


def _base(name: str) -> str:
    """An aten op's name without its in-place underscore (``add_`` ->
    ``add``; ``__and__`` stays)."""
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


def _op_cost(func, args, kwargs, out) -> Tuple[float, float,
                                                Optional[str], float]:
    """(flops, bytes, collective kind or None, collective bytes) of one
    dispatched op."""
    name = func.overloadpacket.__name__
    base = _base(name)
    ins = _tensors((args, kwargs))
    outs = _tensors(out)
    if func.namespace in ("c10d", "_c10d_functional", "c10d_functional"):
        kind = _collective_kind(name)
        if kind is not None:
            nb = float(sum(_nbytes(t) for t in ins))
            return 0.0, nb + sum(_nbytes(t) for t in outs), kind, nb
    if func.is_view or base in FREE:
        return 0.0, 0.0, None, 0.0
    mutable = func._schema.is_mutable
    res = outs[0] if outs else None
    flops = 0.0
    if base in DOT and res is not None:
        flops = _dot_flops(base, args, res)
    elif base in ELEMENTWISE and res is not None:
        f = ELEMENTWISE[base]
        if base == "_to_copy" and ins and ins[0].dtype == res.dtype:
            f = 0                               # a copy, no convert
        flops = f * res.numel()
    elif base in REDUCE and res is not None:
        flops = (1 + _REDUCE_EXTRA.get(base, 0)) * res.numel()
    if base in ("index_put", "_index_put_impl") and mutable:
        # dynamic-update-slice: read + write the updated region only
        vals = args[2]
        idx = [i for i in args[1] if i is not None]
        region = vals.numel() * res.element_size()
        return flops, 2.0 * region + sum(_nbytes(i) for i in idx), \
            None, 0.0
    if mutable and ins and outs and outs[0] is ins[0]:
        # an in-place op on a (possibly sliced) tensor: its region
        # written, the other operands read
        nb = 2.0 * _nbytes(ins[0]) + sum(_nbytes(t) for t in ins[1:])
        if base in ("copy", "fill", "zero"):
            nb = _nbytes(ins[0]) + sum(_nbytes(t) for t in ins[1:])
        return flops, nb, None, 0.0
    nb = float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs))
    return flops, nb, None, 0.0


_ACTIVE = threading.local()


def _scaler() -> Optional["Counter"]:
    stack = getattr(_ACTIVE, "stack", None)
    if not stack:
        return None
    c = stack[-1]
    return c if c.scale_loops else None


class Counter(TorchDispatchMode):
    """Counts every aten op dispatched while it is entered.

    ``cost`` is the running ``Cost``; ``peak_bytes`` the peak of live
    bytes of the storages created inside (``live_bytes`` now);
    ``by_op`` maps every aten op dispatched to its call count, and
    ``unpriced`` those that materialise but have no flop rule (their
    bytes are counted).  ``scale_loops=True`` lets
    ``scan`` run one trip of a loop and scale it (grad disabled only).
    """

    def __init__(self, scale_loops: bool = False):
        super().__init__()
        self.scale_loops = scale_loops
        self.cost = Cost()
        self.unpriced: Dict[str, int] = {}
        self.by_op: Dict[str, int] = {}
        self.ops = 0
        self.live_bytes = 0.0
        self.peak_bytes = 0.0
        self._mult = 1.0
        self._lock = threading.Lock()
        self._trip_new: Optional[List[Tuple[Any, int]]] = None
        self._weights: Dict[int, float] = {}

    def __enter__(self):
        _ACTIVE.stack = getattr(_ACTIVE, "stack", []) + [self]
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.stack = _ACTIVE.stack[:-1]
        return super().__exit__(*exc)

    # -- memory ----------------------------------------------------- #
    def _free(self, key: int, nbytes: int) -> None:
        with self._lock:
            w = self._weights.pop(key, 1.0)
            self.live_bytes -= nbytes * w

    def _track(self, func, args, kwargs, out) -> None:
        if func.is_view:
            return
        seen = {t.untyped_storage()._cdata
                for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._weights:
                continue
            seen.add(key)
            nb = st.nbytes()
            with self._lock:
                self._weights[key] = 1.0
                self.live_bytes += nb
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key, nb)
            if self._trip_new is not None:
                self._trip_new.append((key, nb))

    # -- dispatch --------------------------------------------------- #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flops, nb, kind, cb = _op_cost(func, args, kwargs, out)
        m = self._mult
        self.ops += 1
        key = str(func)
        self.by_op[key] = self.by_op.get(key, 0) + 1
        self.cost.flops += flops * m
        self.cost.bytes += nb * m
        if kind is not None:
            self.cost.collectives[kind] = \
                self.cost.collectives.get(kind, 0.0) + cb * m
        elif flops == 0 and nb:
            name = _base(func.overloadpacket.__name__)
            if name not in DOT and name not in ELEMENTWISE \
                    and name not in REDUCE:
                self.unpriced[name] = self.unpriced.get(name, 0) + 1
        self._track(func, args, kwargs, out)
        return out

    @contextlib.contextmanager
    def trips(self, n: int):
        """Count the block as ``n`` trips of itself: its ops' cost times
        ``n``; storages it creates that the yielded dict's ``"keep"``
        (the trip's outputs) holds count ``n`` times while they live,
        and the peak grows by the ``n - 1`` trips' outputs held before
        the last."""
        outer_mult, outer_new = self._mult, self._trip_new
        self._mult = outer_mult * n
        self._trip_new = []
        start_peak = self.peak_bytes
        self.peak_bytes = self.live_bytes
        box: Dict[str, Any] = {}
        try:
            yield box
        finally:
            created = self._trip_new
            self._mult, self._trip_new = outer_mult, outer_new
            kept = {t.untyped_storage()._cdata
                    for t in _tensors(box.get("keep"))}
            extra = 0.0
            with self._lock:
                for key, nb in created:
                    if key in kept and key in self._weights:
                        self._weights[key] = float(n)
                        extra += (n - 1) * nb
                self.live_bytes += extra
                self.peak_bytes = max(start_peak, self.peak_bytes + extra)
            if outer_new is not None:
                outer_new.extend(created)


def scan(body: Callable[[Any, Any], Tuple[Any, Any]], carry: Any,
         xs: Iterable[Any]) -> Tuple[Any, List[Any]]:
    """``jax.lax.scan`` over a Python sequence: ``body(carry, x) ->
    (carry, y)``; returns ``(carry, [y, ...])``.  Under a
    ``Counter(scale_loops=True)`` with grad disabled, the first trip
    runs once, counted ``len(xs)`` times (every trip must have the same
    shapes), and its ``y`` fills every slot."""
    xs = list(xs)
    c = _scaler()
    if c is None or len(xs) < 2 or torch.is_grad_enabled():
        ys = []
        for x in xs:
            carry, y = body(carry, x)
            ys.append(y)
        return carry, ys
    with c.trips(len(xs)) as box:
        carry, y = body(carry, xs[0])
        box["keep"] = y
    return carry, [y] * len(xs)


def count(fn: Callable[..., Any], *args, scale_loops: bool = False,
          **kwargs) -> Cost:
    """The cost of one call ``fn(*args, **kwargs)``."""
    with Counter(scale_loops=scale_loops) as c:
        fn(*args, **kwargs)
    return c.cost


def extrapolate(base: Cost, regions: Iterable[Tuple[Cost, float]]) -> Cost:
    """``base`` plus, for each ``(bigger, trips)``, ``trips`` more
    copies of the region that ``bigger`` (the same run with one trip of
    the region more) adds to ``base``."""
    out = Cost()
    out.add(base)
    for bigger, trips in regions:
        out.add(bigger, trips)
        out.add(base, -trips)
    return out
