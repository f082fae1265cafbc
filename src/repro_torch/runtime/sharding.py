"""Sharding rules: logical-axis -> mesh-axis mapping with divisibility
fallbacks, parameter PartitionSpec trees, and activation constraints.

The port of ``repro.runtime.sharding``, over the port's own
:class:`~repro_torch.launch.mesh.Mesh` (any object whose ``.shape`` is
a name -> size map will do for the rules).

Mesh axes (launch/mesh.py):
  single-pod: ("data", "model")       = (16, 16)
  multi-pod:  ("pod", "data", "model") = (2, 16, 16)

Policy (DESIGN.md §4):
  * FSDP/ZeRO-3 over "data": every parameter is additionally sharded on
    its largest remaining dim over "data".
  * TP over "model": attention heads / d_ff / vocab.
  * "pod" is pure DP (gradient all-reduce crosses pods only).
  * any dim not divisible by its mesh axis falls back to replication —
    never a crash (e.g. 10-head recurrentgemma attention).

:class:`P` is the port's ``PartitionSpec``: a tuple of per-dim entries
(None, an axis name, or a tuple of names) equal to the reference's.
:class:`NamedSharding` places a tensor by its spec: ``shard`` cuts it
into one piece per mesh slot (on the slot's device), ``gather`` puts
the pieces back together; on a ``torch.distributed`` ``DeviceMesh``,
:class:`MeshSharding` places it as a DTensor (``distribute``; a
PackedArray by its words).
``shard_act`` is the reference's activation
constraint: it never changes a value; inside a mesh context it computes
the spec and keeps it on the mesh (``mesh.constraints``).

Tensor parallelism (an SPMD step, Megatron-style on plain local
tensors): ``tp_blocks`` turns the DTensor params into :class:`Block`
leaves (the local block, its "model" and "data" dims, and whether the
layer computes on it whole over "model": ``computes_on_block``, which
keeps heads whole where ``fit_spec`` would only ask a width to divide);
inside ``tensor_parallel(tp_groups(mesh))`` the models ``materialize``
a cycle's Blocks (all-gather over "data", and over "model" for a whole
leaf; the backward reduce-scatters the float32 grad to the block, over
"model" too where each rank reads its own part of a whole leaf, sums
it over "pod", divides by the batch group's size), pass a
column-parallel layer's input through ``copy_to_model`` (its gradient
summed over "model") and sum a row-parallel layer's partial output with
``reduce_from_model``.  With one rank on an axis each helper is the
identity and runs no op.
"""
from __future__ import annotations

import contextlib
import math
import re
from typing import (Any, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.kernels.packed import PackedArray
from repro_torch.launch.mesh import Mesh, current_mesh
from repro_torch.runtime.op_cost import backend_work

__all__ = ["BATCH_AXES", "Block", "MeshSharding", "NamedSharding", "P",
           "TPGroups", "axis_size", "batch_group", "batch_mean",
           "batch_shard", "batch_specs", "computes_on_block",
           "copy_to_model", "distribute", "fit_spec",
           "gather_from_model", "global_batch", "heads_split",
           "holds_first_copy", "materialize",
           "max_over_model", "model_group", "named", "param_specs",
           "placements", "reduce_from_model", "shard_act",
           "spec_for_param", "tensor_parallel", "tp_blocks",
           "tp_groups", "tp_rank", "tp_size"]


class P(tuple):
    """A PartitionSpec: one entry per dim, None (replicated), a mesh axis
    name, or a tuple of names (the dim split over all of them, the first
    major)."""

    def __new__(cls, *entries: Any) -> "P":
        return super().__new__(cls, entries)

    def __getnewargs__(self) -> Tuple[Any, ...]:
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _is_spec(x: Any) -> bool:
    return isinstance(x, P)


def axis_size(mesh: Optional[Any], name: str) -> int:
    if mesh is None or name not in mesh.shape:
        return 1
    return mesh.shape[name]


def fit_spec(shape: Sequence[int], want: Sequence[Any],
             mesh: Optional[Any]) -> P:
    """Drop mesh axes that don't divide their dim (replicate instead)."""
    out = []
    for dim, ax in zip(shape, want):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        keep = []
        rem = dim
        for a in axes:
            s = axis_size(mesh, a)
            if s > 1 and rem % s == 0:
                keep.append(a)
                rem //= s
        out.append(tuple(keep) if len(keep) > 1 else
                   (keep[0] if keep else None))
    return P(*out)


def shard_act(x: Any, want: Sequence[Any]) -> Any:
    """The reference's ``with_sharding_constraint`` site: returns ``x``
    unchanged.  Inside a mesh context the spec ``fit_spec`` gives for
    ``x`` (non-divisible dims replicated) is kept in the mesh's
    ``constraints`` as ``(shape, spec)``."""
    mesh = current_mesh()
    if mesh is None or mesh.empty:
        return x
    mesh.constraints.append((tuple(x.shape), fit_spec(x.shape, want, mesh)))
    return x


# ------------------------------------------------------------------ #
# parameter sharding rules                                             #
# ------------------------------------------------------------------ #
# rules matched against the '/'-joined param path; first match wins.
# specs are *logical*: "model" = TP axis, "fsdp" = the data axis reused
# for ZeRO-3 parameter sharding.  Packed projections are PackedArray
# leaves whose path ends in ".../{name}_p/words" — the optional
# (/words)? suffix lets the same rule shard the words (same rank as the
# latent weight, K replaced by K/32).
_RULES: Tuple[Tuple[str, Tuple[Any, ...]], ...] = (
    # embeddings / logits: vocab on model, d_model on fsdp
    (r"embed|lm_head",                 ("model", "fsdp")),
    (r"pos_emb",                       (None, "fsdp")),
    # attention projections (leading layer-stack dim handled separately)
    (r"attn/(wq|wk|wv)(_p)?(/words)?$", ("fsdp", "model")),
    (r"attn/(bq|bk|bv)$",              ("model",)),
    (r"attn/wo(_p)?(/words)?$",        ("model", "fsdp")),
    (r"_alpha$",                       (None,)),
    (r"attn/bo$",                      (None,)),
    # MoE: experts on fsdp when divisible, d_ff on model
    (r"moe/router$",                   ("fsdp", None)),
    (r"moe/(w_gate|w_up)(_p)?(/words)?$", ("fsdp", None, "model")),
    (r"moe/w_down(_p)?(/words)?$",     ("fsdp", "model", None)),
    # dense FFN
    (r"mlp/(w_gate|w_up)(_p)?(/words)?$", ("fsdp", "model")),
    (r"mlp/w_down(_p)?(/words)?$",     ("model", "fsdp")),
    (r"mlp/(b_gate|b_up)$",            ("model",)),
    (r"mlp/b_down$",                   (None,)),
    # mamba
    (r"ssm/in_proj(_p)?(/words)?$",    ("fsdp", "model")),
    (r"ssm/conv_w$",                   ("model", None)),
    (r"ssm/conv_b$",                   ("model",)),
    (r"ssm/x_proj$",                   ("model", None)),
    (r"ssm/dt_proj$",                  (None, "model")),
    (r"ssm/dt_bias$",                  ("model",)),
    (r"ssm/(A_log|D)$",                ("model", None)),
    (r"ssm/out_proj(_p)?(/words)?$",   ("model", "fsdp")),
    # rg-lru
    (r"lru/(in_proj|gate_proj)(_p)?(/words)?$", ("fsdp", "model")),
    (r"lru/conv_w$",                   ("model", None)),
    (r"lru/(a_param|conv_b|in_bias|gate_bias)$", ("model",)),
    (r"lru/out_proj(_p)?(/words)?$",   ("model", "fsdp")),
    # norms, scales, biases: replicate (small)
    (r"norm|scale|bias",               (None,)),
)


def spec_for_param(path: str, shape: Sequence[int],
                   mesh: Optional[Any], stacked: bool,
                   fsdp_axis: str = "data") -> P:
    """PartitionSpec for one parameter.

    stacked: params inside a stack of layer cycles carry a leading
    [n_cycles] dim that stays unsharded."""
    want: Optional[Tuple[Any, ...]] = None
    core_shape = shape[1:] if stacked else shape
    for pat, spec in _RULES:
        if re.search(pat, path):
            want = spec
            break
    if want is None or len(want) != len(core_shape):
        want = (None,) * len(core_shape)
    want = tuple(fsdp_axis if a == "fsdp" else a for a in want)
    spec = fit_spec(core_shape, want, mesh)
    if stacked:
        spec = P(None, *spec)
    # ZeRO-3 fallback: if nothing got the fsdp axis, put it on the
    # largest remaining divisible dim
    if mesh is not None and fsdp_axis in mesh.shape:
        flat = list(spec)
        used = {a for s in flat if s for a in
                ((s,) if isinstance(s, str) else s)}
        if fsdp_axis not in used:
            size = axis_size(mesh, fsdp_axis)
            dims = sorted(range(len(core_shape)),
                          key=lambda i: -core_shape[i])
            off = 1 if stacked else 0
            for i in dims:
                cur = flat[i + off]
                if cur is None and core_shape[i] % size == 0 \
                        and core_shape[i] >= 4 * size:
                    flat[i + off] = fsdp_axis
                    break
            spec = P(*flat)
    return spec


def _shape(leaf: Any) -> Tuple[int, ...]:
    """A leaf's shape; a PackedArray's is that of its words (the leaf
    the reference shards)."""
    if isinstance(leaf, PackedArray):
        leaf = leaf.words
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def param_specs(params: Any, mesh: Optional[Any],
                stacked_prefixes: Tuple[str, ...] = ("layers",),
                fsdp_axis: str = "data") -> Any:
    """PartitionSpec tree for a parameter tree (dict-of-dicts): a
    :class:`P` in place of every leaf (of a PackedArray too, for its
    words)."""
    flat, treedef = _tree.flatten_with_path(params)
    specs = []
    for pstr, leaf in flat:
        stacked = any(pstr.startswith(p) for p in stacked_prefixes)
        specs.append(spec_for_param(pstr, _shape(leaf), mesh, stacked,
                                    fsdp_axis))
    return _tree.unflatten(treedef, specs)


# ------------------------------------------------------------------ #
# placing tensors by spec                                              #
# ------------------------------------------------------------------ #
class NamedSharding:
    """A :class:`P` on a mesh with devices: which block of a tensor each
    slot holds.  A dim whose entry names axes is cut into as many equal
    blocks as those axes have slots together (the first axis major); a
    slot holds the block its coordinates on those axes select, and the
    slots that differ only on other axes hold copies."""

    def __init__(self, mesh: Mesh, spec: P):
        if not isinstance(mesh, Mesh) or mesh.devices is None:
            raise TypeError("a NamedSharding needs a Mesh with devices")
        self.mesh = mesh
        self.spec = P(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def _axes(self, entry: Any) -> Tuple[str, ...]:
        if entry is None:
            return ()
        return entry if isinstance(entry, tuple) else (entry,)

    def blocks(self, shape: Sequence[int]
               ) -> List[Tuple[Tuple[int, int], ...]]:
        """For every slot in mesh order, its ``(start, stop)`` along each
        dim of a tensor of ``shape``."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more dims than {shape}")
        names = self.mesh.axis_names
        out = []
        for coord in np.ndindex(*self.mesh.devices.shape):
            at = dict(zip(names, coord))
            dims = []
            for d, size in enumerate(shape):
                axes = self._axes(self.spec[d]) if d < len(self.spec) else ()
                count, index = 1, 0
                for a in axes:
                    count *= self.mesh.shape[a]
                    index = index * self.mesh.shape[a] + at[a]
                if size % count:
                    raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                     f"split {count} ways ({self.spec})")
                step = size // count
                dims.append((index * step, (index + 1) * step))
            out.append(tuple(dims))
        return out

    def shard(self, t: Any) -> List[Any]:
        """One piece of ``t`` per slot, in mesh order, each on its
        slot's device (a PackedArray keeps its layout, its words cut)."""
        words = t.words if isinstance(t, PackedArray) else t
        pieces = []
        for dev, block in zip(self.mesh.slots(), self.blocks(words.shape)):
            piece = words[tuple(slice(a, b) for a, b in block)].to(dev)
            pieces.append(t.with_words(piece)
                          if isinstance(t, PackedArray) else piece)
        return pieces

    def gather(self, pieces: Sequence[Any]) -> Any:
        """The tensor ``shard`` cut into ``pieces``, on the first slot's
        device."""
        first = pieces[0]
        words = [p.words if isinstance(p, PackedArray) else p
                 for p in pieces]
        counts = [math.prod(self.mesh.shape[a] for a in self._axes(e))
                  for e in self.spec]
        shape = [s * (counts[d] if d < len(counts) else 1)
                 for d, s in enumerate(words[0].shape)]
        dev = self.mesh.slots()[0]
        out = torch.empty(shape, dtype=words[0].dtype, device=dev)
        done = set()
        for w, block in zip(words, self.blocks(shape)):
            if block not in done:
                done.add(block)
                out[tuple(slice(a, b) for a, b in block)] = w.to(dev)
        return first.with_words(out) if isinstance(first, PackedArray) \
            else out


def named(tree_specs: Any, mesh: Any) -> Any:
    """A sharding in place of every spec: a :class:`NamedSharding` on a
    :class:`Mesh`, a :class:`MeshSharding` on a ``DeviceMesh``."""
    kind = NamedSharding if isinstance(mesh, Mesh) else MeshSharding
    return _tree.map(lambda s: kind(mesh, s), tree_specs, is_leaf=_is_spec)


# ------------------------------------------------------------------ #
# DTensor placements on a torch.distributed DeviceMesh                 #
# ------------------------------------------------------------------ #
def _axes_of(entry: Any) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: Sequence[Any], mesh: Any) -> Tuple[Any, ...]:
    """``spec`` on a ``DeviceMesh`` as DTensor placements, one per mesh
    dim: ``Shard(d)`` where tensor dim ``d``'s entry names the dim's
    axis, else ``Replicate()``.  A tensor dim split over several axes
    must name them in mesh-dim order: DTensor cuts it by the first
    mesh dim, then each piece by the next, which is the first-axis-major
    order of :meth:`NamedSharding.blocks`."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {P(*spec)} names {a!r}, not an axis "
                                 f"of the mesh {names}")
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {P(*spec)} splits dim {d} over {axes}, "
                             f"not in the mesh's order {names}")
        for i in dims:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {P(*spec)} names {names[i]!r} twice")
            out[i] = Shard(d)
    return tuple(out)


class MeshSharding:
    """A :class:`P` on a ``torch.distributed`` ``DeviceMesh``: the
    DTensor ``placements`` it stands for, and ``distribute``."""

    def __init__(self, mesh: Any, spec: Sequence[Any]):
        self.mesh = mesh
        self.spec = P(*spec)
        self.placements = placements(self.spec, mesh)

    def __repr__(self) -> str:
        return f"MeshSharding({self.mesh!r}, {self.spec!r})"

    def distribute(self, t: Any) -> Any:
        """``t``, which every rank holds whole and equal, as a DTensor on
        the mesh's device: each rank keeps its own block, and nothing
        is sent.  A PackedArray keeps its length, axis and values, its
        words a DTensor placed by the spec (the words' spec: they are
        split as words, never as bits)."""
        from torch.distributed.tensor import distribute_tensor
        if isinstance(t, PackedArray):
            return t.with_words(self.distribute(t.words))
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"cannot distribute a {type(t).__name__}")
        return distribute_tensor(t, self.mesh, self.placements,
                                 src_data_rank=None)


def distribute(tree: Any, shardings: Any) -> Any:
    """Every leaf of ``tree`` placed by the :class:`MeshSharding` at the
    same place in ``shardings`` (``named``'s output)."""
    return _tree.map(lambda t, s: s.distribute(t), tree, shardings)


def holds_first_copy(d: Any) -> bool:
    """Whether this rank's block of the DTensor ``d`` is the first of its
    copies: coordinate 0 on every mesh dim that ``d`` replicates on (a
    sum over the mesh of the blocks such ranks hold counts each element
    once)."""
    from torch.distributed.tensor import Replicate
    coord = d.device_mesh.get_coordinate()
    return all(c == 0 for c, pl in zip(coord, d.placements)
               if isinstance(pl, Replicate))


# ------------------------------------------------------------------ #
# the batch group of an SPMD step                                      #
# ------------------------------------------------------------------ #
def batch_shard(mesh: Any) -> Tuple[int, int]:
    """(this rank's shard, the number of shards) of the global batch on
    a ``DeviceMesh``: its coordinate over the mesh's ``BATCH_AXES``,
    the first major, as ``batch_specs`` splits the batch dim; ranks
    that differ only on "model" read the same rows."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for a in BATCH_AXES:
        if a in names:
            i = names.index(a)
            index = index * mesh.shape[i] + coord[i]
            count *= mesh.shape[i]
    return index, count


def batch_group(mesh: Any) -> Tuple[Any, int]:
    """(process group, size) of the ranks whose rows together are the
    global batch and that share this rank's other coordinates; the
    group is None where it is this rank alone.  Every rank of the mesh
    must call it (it makes the groups)."""
    import torch.distributed as dist
    names = tuple(mesh.mesh_dim_names)
    batch = [names.index(a) for a in BATCH_AXES if a in names]
    rest = [i for i in range(len(names)) if i not in batch]
    ranks = mesh.mesh.permute(*rest, *batch)
    size = math.prod(mesh.shape[i] for i in batch)
    if size == 1:
        return None, 1
    if size == dist.get_world_size():
        return dist.group.WORLD, size
    group, _ = dist.new_subgroups_by_enumeration(
        ranks.reshape(-1, size).tolist())
    return group, size


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) over a process group, and the same of the
    gradient: every rank's loss reads the sum, so each member's input
    gets the sum of every rank's gradient."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any) -> torch.Tensor:
        import torch.distributed as dist
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[torch.Tensor, None]:
        import torch.distributed as dist
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


# (group, size) of the SPMD step running in this process, or None.  A
# process-wide setting, not a context variable: on the card the backward
# recomputes a checkpointed layer on the autograd engine's own thread.
_BATCH_GROUP: List[Optional[Tuple[Any, int]]] = [None]


@contextlib.contextmanager
def global_batch(group: Any, size: int) -> Iterator[None]:
    """Inside the block, ``batch_mean`` averages over the rows of all
    ``size`` ranks of ``group`` (each holding as many rows)."""
    was = _BATCH_GROUP[0]
    _BATCH_GROUP[0] = (group, size)
    try:
        yield
    finally:
        _BATCH_GROUP[0] = was


def batch_mean(x: torch.Tensor, dim: Tuple[int, ...]) -> torch.Tensor:
    """``torch.mean(x, dim)`` over the batch dims ``dim``: over the
    global batch inside ``global_batch`` (the mean of the ranks' equal
    shares, differentiable), else over ``x``'s own rows."""
    m = torch.mean(x, dim=dim)
    at = _BATCH_GROUP[0]
    if at is None or at[1] == 1:
        return m
    group, size = at
    return _SumOverGroup.apply(m, group) / size


# ------------------------------------------------------------------ #
# tensor-parallel compute over "model", FSDP gathers over "data"       #
# ------------------------------------------------------------------ #
class TPGroups(NamedTuple):
    """The process groups of one rank of an SPMD step: "model" (the
    ranks that hold the other blocks of a tensor-parallel layer),
    "data" (the FSDP gather of a leaf's blocks), "pod" and the batch
    group (pod x data: the ranks whose rows are the global batch).  A
    group is None where it is this rank alone."""
    model: Any
    model_size: int
    model_rank: int
    data: Any
    data_size: int
    pod: Any
    pod_size: int
    batch: Any
    batch_size: int


def _dim_group(mesh: Any, name: str) -> Tuple[Any, int, int]:
    """(group, size, this rank's coordinate) of a ``DeviceMesh`` dim;
    (None, 1, 0) where the mesh has no such dim or it has one rank."""
    names = tuple(mesh.mesh_dim_names)
    if name not in names or mesh.size(names.index(name)) == 1:
        return None, 1, 0
    return (mesh.get_group(name), mesh.size(names.index(name)),
            mesh.get_local_rank(name))


def model_group(mesh: Any) -> Tuple[Any, int, int]:
    """(group, size, rank in it) of the ranks that differ from this one
    only on "model"; (None, 1, 0) on a mesh with one rank there."""
    return _dim_group(mesh, "model")


def tp_groups(mesh: Any) -> TPGroups:
    """This rank's :class:`TPGroups` on ``mesh``.  Every rank of the mesh
    must call it (it makes the batch group)."""
    batch, batch_size = batch_group(mesh)
    m, ms, mr = model_group(mesh)
    d, ds, _ = _dim_group(mesh, "data")
    p, ps, _ = _dim_group(mesh, "pod")
    return TPGroups(m, ms, mr, d, ds, p, ps, batch, batch_size)


# the TP groups of the SPMD step running in this process, or None.  A
# process-wide setting, like _BATCH_GROUP: on the card the backward
# recomputes a checkpointed layer on the autograd engine's own thread.
_TP: List[Optional[TPGroups]] = [None]


@contextlib.contextmanager
def tensor_parallel(groups: Optional[TPGroups]) -> Iterator[None]:
    """Inside the block the model computes its tensor-parallel layers
    on this rank's "model" blocks and :class:`Block` leaves gather over
    ``groups`` (None: one process, nothing changes)."""
    was = _TP[0]
    _TP[0] = groups
    try:
        yield
    finally:
        _TP[0] = was


def tp_size() -> int:
    """The number of "model" ranks of the step running here (1 outside
    one)."""
    at = _TP[0]
    return 1 if at is None else at.model_size


def tp_rank() -> int:
    """This rank's coordinate on "model" (0 outside a step)."""
    at = _TP[0]
    return 0 if at is None else at.model_rank


def _wait(work: Any) -> None:
    """Wait for a collective; what its backend dispatches meanwhile is
    not the program's (``op_cost.backend_work``)."""
    with backend_work():
        work.wait()


def _all_reduce(x: torch.Tensor, group: Any, op: str = "sum"
                ) -> torch.Tensor:
    """A new tensor: ``x`` reduced over ``group`` (sum or max)."""
    import torch.distributed as dist
    out = x.clone(memory_format=torch.contiguous_format)
    _wait(dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                          else dist.ReduceOp.SUM, group=group,
                          async_op=True))
    return out


def _all_gather(x: torch.Tensor, dim: int, group: Any, size: int
                ) -> torch.Tensor:
    """``x``'s blocks of ``size`` ranks of ``group`` concatenated along
    ``dim`` in rank order."""
    import torch.distributed as dist
    dim %= x.ndim
    x = x.contiguous()
    out = x.new_empty((size * x.shape[0], *x.shape[1:]))
    _wait(dist.all_gather_into_tensor(out, x, group=group, async_op=True))
    if dim == 0:
        return out
    shape = list(x.shape)
    shape[dim] *= size
    return out.view(size, *x.shape).movedim(0, dim).reshape(shape)


def _reduce_scatter(g: torch.Tensor, dim: int, group: Any, size: int
                    ) -> torch.Tensor:
    """The sum of ``g`` over ``group``, this rank's block along ``dim``
    (the transpose of ``_all_gather``)."""
    import torch.distributed as dist
    dim %= g.ndim
    x = g.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // size, *x.shape[1:]))
    _wait(dist.reduce_scatter_tensor(out, x, group=group, async_op=True))
    return out.movedim(0, dim).contiguous() if dim else out


def _own_block(g: torch.Tensor, dim: int, size: int, rank: int
               ) -> torch.Tensor:
    step = g.shape[dim] // size
    return g.narrow(dim, rank * step, step)


class _CopyToModel(torch.autograd.Function):
    """Identity, its gradient summed over "model": the input of a
    column-parallel layer (every model rank reads the same ``x`` and
    gives back the gradient of its own block's product)."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[torch.Tensor, None]:
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over "model" of each rank's partial product (the output
    of a row-parallel layer); every rank reads the sum, so the gradient
    passes back unchanged."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any) -> torch.Tensor:
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[torch.Tensor, None]:
        return g, None


def copy_to_model(x: Any) -> Any:
    """``x`` as the input of a column-parallel layer (the identity with
    one "model" rank or no grad)."""
    at = _TP[0]
    if at is None or at.model_size == 1 or not torch.is_grad_enabled() \
            or not x.requires_grad:
        return x
    return _CopyToModel.apply(x, at.model)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over "model" of ``x`` (the identity with one rank)."""
    at = _TP[0]
    if at is None or at.model_size == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x, at.model)
    return _all_reduce(x, at.model)


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The element-wise max over "model" of ``x``, no gradient (a
    softmax's stabiliser)."""
    at = _TP[0]
    if at is None or at.model_size == 1:
        return x
    return _all_reduce(x.detach(), at.model, "max")


class _GatherFromModel(torch.autograd.Function):
    """The "model" ranks' blocks concatenated; each rank reads its own
    part of the whole, so the gradient is summed over "model" and cut
    to the rank's block (a reduce-scatter)."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, dim: int,
                at: TPGroups) -> torch.Tensor:
        ctx.dim, ctx.at = dim, at
        return _all_gather(x, dim, at.model, at.model_size)

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor):
        at = ctx.at
        return _reduce_scatter(g, ctx.dim, at.model, at.model_size), \
            None, None


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The "model" ranks' blocks of ``x`` concatenated along ``dim``
    (the identity with one rank); with grad, the gradient is
    reduce-scattered back to the blocks."""
    at = _TP[0]
    if at is None or at.model_size == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherFromModel.apply(x, dim, at)
    return _all_gather(x, dim, at.model, at.model_size)


class Block:
    """A param leaf of an SPMD step as this rank holds it: ``local``
    (a plain tensor, or a PackedArray of local words), the dims its
    spec splits over "model" and "data", and ``whole``: the model
    computes on the leaf whole over "model" (it is gathered there)
    rather than on its "model" block; ``part``: of a whole leaf, each
    "model" rank reads its own part (its channels of two concatenated
    halves), so its gradient is the rank's share of the whole one.
    ``materialize`` makes what the model computes on; a stacked leaf's
    ``unbind(0)`` gives one Block a cycle."""
    __slots__ = ("local", "model_dim", "data_dim", "whole", "part")

    def __init__(self, local: Any, model_dim: Optional[int],
                 data_dim: Optional[int], whole: bool, part: bool = False):
        self.local = local
        self.model_dim = model_dim
        self.data_dim = data_dim
        self.whole = whole
        self.part = part

    def __repr__(self) -> str:
        return (f"Block({tuple(_shape(self.local))}, model_dim="
                f"{self.model_dim}, data_dim={self.data_dim}, "
                f"whole={self.whole}, part={self.part})")

    def _with(self, local: Any, shift: int = 0) -> "Block":
        def dim(d):
            return None if d is None else d - shift
        return Block(local, dim(self.model_dim), dim(self.data_dim),
                     self.whole, self.part)

    def unbind(self, dim: int = 0) -> Tuple["Block", ...]:
        if dim != 0 or 0 in (self.model_dim, self.data_dim):
            raise ValueError(f"{self!r}: only an unsplit leading dim "
                             f"unbinds")
        if isinstance(self.local, PackedArray):
            return tuple(self._with(self.local.with_words(w), 1)
                         for w in self.local.words.unbind(0))
        return tuple(self._with(t, 1) for t in self.local.unbind(0))

    def detach(self) -> "Block":
        return self._with(self.local.detach())

    def requires_grad_(self, flag: bool = True) -> "Block":
        self.local.requires_grad_(flag)
        return self


class _GatherLeaf(torch.autograd.Function):
    """A float leaf's block gathered over "data" (and over "model"
    where the model computes on it whole); the gradient taken back to
    the block: the model slice of the (equal) whole gradient, or, where
    each rank reads a part of it (``Block.part``), the ranks' shares
    summed over "model" to the block (a reduce-scatter in the
    gradient's dtype); then, in float32, summed over "data" to this
    rank's block (a reduce-scatter) or, for a leaf the rules do not
    split there, over the batch group, then over "pod", and divided by
    the batch group's size."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, blk: Block,
                at: TPGroups) -> torch.Tensor:
        ctx.blk, ctx.at, ctx.dtype = blk, at, x.dtype
        return _gather_tensor(x, blk, at)

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor):
        blk, at = ctx.blk, ctx.at
        if blk.whole and blk.model_dim is not None and at.model_size > 1:
            # the ranks' shares summed in the gradient's dtype, as a
            # column-parallel input's gradient is (``copy_to_model``)
            g = _reduce_scatter(g, blk.model_dim, at.model, at.model_size) \
                if blk.part else _own_block(g, blk.model_dim, at.model_size,
                                            at.model_rank)
        g = g.to(torch.float32)
        if blk.data_dim is not None and at.data_size > 1:
            g = _reduce_scatter(g, blk.data_dim, at.data, at.data_size)
            if at.pod_size > 1:
                g = _all_reduce(g, at.pod)
        elif at.batch_size > 1:
            g = _all_reduce(g, at.batch)
        if at.batch_size > 1:
            g = g / at.batch_size
        return g.to(ctx.dtype), None, None


def _gather_tensor(x: torch.Tensor, blk: Block, at: TPGroups
                   ) -> torch.Tensor:
    if blk.data_dim is not None and at.data_size > 1:
        x = _all_gather(x, blk.data_dim, at.data, at.data_size)
    if blk.whole and blk.model_dim is not None and at.model_size > 1:
        x = _all_gather(x, blk.model_dim, at.model, at.model_size)
    return x


def _gathers(blk: Block, at: TPGroups) -> bool:
    """Whether materialising ``blk`` runs a collective (forward or
    backward)."""
    return at.batch_size > 1 or (at.data_size > 1
                                 and blk.data_dim is not None) \
        or (blk.whole and blk.model_dim is not None and at.model_size > 1)


def materialize(tree: Any) -> Any:
    """Every :class:`Block` leaf of ``tree`` as the tensor the model
    computes on (other leaves as they are): gathered over "data", and
    over "model" where it is ``whole``; a PackedArray's words likewise,
    its length that of its "model" block where the block splits the
    pack axis (the last block's pad bits stay outside it).  Outside an
    SPMD step a tree has no Block."""
    at = _TP[0]

    def one(leaf: Any) -> Any:
        if not isinstance(leaf, Block):
            return leaf
        x = leaf.local
        if at is None or not _gathers(leaf, at):
            return _packed_block(x, leaf, at)
        if isinstance(x, PackedArray):
            return _packed_block(
                x.with_words(_gather_tensor(x.words, leaf, at)), leaf, at)
        if x.is_floating_point() and x.requires_grad \
                and torch.is_grad_enabled():
            return _GatherLeaf.apply(x, leaf, at)
        return _gather_tensor(x, leaf, at)
    return _tree.map(one, tree)


def _packed_block(x: Any, blk: Block, at: Optional[TPGroups]) -> Any:
    """A PackedArray whose words keep their "model" block along the pack
    axis: the block's bits as its length (the last block ends at the
    array's length, its pad bits past it)."""
    if not isinstance(x, PackedArray) or at is None or blk.whole \
            or blk.model_dim is None or at.model_size == 1 \
            or blk.model_dim - x.words.ndim != x.axis:
        return x
    n = x.words.shape[x.axis] * 32
    start = at.model_rank * n
    return PackedArray(x.words, length=max(0, min(x.length, start + n)
                                           - start),
                       axis=x.axis, values=x.values)


# leaf path -> the layer rule deciding whether the model computes on its
# "model" block (the rest is computed whole over "model"): embeddings
# vocab-parallel, attention heads when they split (a rank's q heads must
# read whole kv heads), the FFN / experts on d_ff, the Mamba and RG-LRU
# channels.  Their in_proj / gate_proj write two concatenated halves
# (x | z, r | i), whose column blocks are not a rank's channels: they
# are gathered whole and each rank reads its channels of both halves.
_TP_RULES: Tuple[Tuple[str, str], ...] = (
    (r"(^|/)(embed|lm_head)$", "vocab"),
    (r"attn/(wq|bq|wo)(_p)?(/words)?$", "q"),
    (r"attn/(wk|wv|bk|bv)(_p)?(/words)?$", "kv"),
    (r"(mlp|moe)/(w_gate|w_up|w_down|b_gate|b_up)(_p)?(/words)?$", "ffn"),
    (r"(ssm|lru)/(in_proj|gate_proj)(_p)?(/words)?$", "whole"),
    (r"(ssm|lru)/", "channels"),
)


def heads_split(cfg: Any, m: int) -> Tuple[bool, bool]:
    """(q heads, kv heads) computed on "model" blocks at ``m`` model
    ranks: q heads when they divide and a rank's q heads read whole kv
    heads (the kv heads divide too, or one kv head serves a rank's
    whole block); kv heads when they divide as well.  ``fit_spec`` only
    asks that the projections' widths divide, which they do at
    recurrentgemma's 10 heads (MQA) or whisper's 20 on 16 ranks."""
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    if m == 1 or not hq or hq % m:
        return False, False
    if hkv % m == 0:
        return True, True
    return (hq // hkv) % (hq // m) == 0, False


def _tp_rule(path: str) -> Optional[str]:
    for pat, rule in _TP_RULES:
        if re.search(pat, path):
            return rule
    return None


def computes_on_block(path: str, cfg: Any, m: int) -> bool:
    """Whether the model computes on the "model" block of the leaf at
    ``path`` (``flatten_with_path``'s) at ``m`` model ranks, or on the
    whole leaf (:class:`Block`'s ``whole``)."""
    rule = _tp_rule(path)
    if rule == "q":
        return heads_split(cfg, m)[0]
    if rule == "kv":
        return heads_split(cfg, m)[1]
    return rule not in (None, "whole")


def _reads_part(path: str, shape: Sequence[int], m: int) -> bool:
    """Whether each of ``m`` model ranks reads its own part of the
    whole leaf at ``path`` of global ``shape`` (:class:`Block`'s
    ``part``): a Mamba / RG-LRU in_proj or gate_proj whose halves' ``n``
    channels split into the ranks' blocks (``param_specs`` then splits
    the layer's channels over "model", ``layers.own_halves``)."""
    return m > 1 and _tp_rule(path) == "whole" and (shape[-1] // 2) % m == 0


def _mesh_dims(d: Any) -> Tuple[Optional[int], Optional[int]]:
    """(the tensor dim the DTensor ``d`` is split on over "model", over
    "data"), each None where it is not split there."""
    from torch.distributed.tensor import Shard
    dims = {}
    for name, pl in zip(d.device_mesh.mesh_dim_names, d.placements):
        if isinstance(pl, Shard):
            dims[name] = pl.dim
    return dims.get("model"), dims.get("data")


def tp_blocks(params: Any, cfg: Any) -> Any:
    """The DTensor ``params`` (placed by ``param_specs``) as a tree of
    :class:`Block` leaves: each rank's local block (a PackedArray of
    local words), the dims its placements split over "model" and
    "data", and whether the model computes on it whole over "model"
    (``computes_on_block``)."""
    flat, treedef = _tree.flatten_with_path(params)
    out = []
    for path, leaf in flat:
        packed = isinstance(leaf, PackedArray)
        d = leaf.words if packed else leaf
        names = tuple(d.device_mesh.mesh_dim_names)
        m = d.device_mesh.size(names.index("model")) \
            if "model" in names else 1
        local = leaf.with_words(d.to_local()) if packed else d.to_local()
        model_dim, data_dim = _mesh_dims(d)
        out.append(Block(local, model_dim, data_dim,
                         not computes_on_block(path, cfg, m),
                         model_dim is not None
                         and _reads_part(path, d.shape, m)))
    return _tree.unflatten(treedef, out)


# ------------------------------------------------------------------ #
# batch / cache shardings                                              #
# ------------------------------------------------------------------ #
BATCH_AXES = ("pod", "data")


def batch_specs(batch: Any, mesh: Optional[Any]) -> Any:
    """Input-batch PartitionSpecs: batch dim over (pod, data); d_model-
    like trailing dims of frontend embeddings over model; KV caches get
    split-KV sharding (seq over model when heads don't divide)."""
    flat, treedef = _tree.flatten_with_path(batch)
    return _tree.unflatten(treedef, [_batch_leaf_spec(p, _shape(leaf), mesh)
                                     for p, leaf in flat])


def _batch_leaf_spec(path: str, shape: Sequence[int], mesh: Any) -> P:
    nd = len(shape)
    last = path.rsplit("/", 1)[-1]
    if "caches" in path:
        # stacked cache leaves carry a leading [n_cycles] dim
        lead = (None,) if nd >= 3 and "layers" in path else ()
        core = shape[len(lead):]
        if last in ("k", "v"):
            # [B, W(seq), H, D]: heads over model if divisible, else
            # split-KV (seq over model)
            hdim = core[2] if len(core) >= 4 else 1
            if mesh is not None and axis_size(mesh, "model") > 1 \
                    and hdim % axis_size(mesh, "model") == 0:
                want = lead + (BATCH_AXES, None, "model", None)
            else:
                want = lead + (BATCH_AXES, "model", None, None)
        elif last in ("pos", "k_scale", "v_scale"):
            want = lead + (BATCH_AXES,) + (None,) * (len(core) - 1)
        elif last == "conv":
            want = lead + (BATCH_AXES, None, "model")
        elif last == "h":
            want = lead + (BATCH_AXES, "model") + (None,) * (len(core) - 2)
        else:
            want = lead + (BATCH_AXES,) + (None,) * (len(core) - 1)
        want = want[:nd]
    elif last in ("frames", "image_embeds"):
        want = (BATCH_AXES, None, "model")
    else:  # tokens / targets / step
        want = (BATCH_AXES,) + (None,) * (nd - 1)
    return fit_spec(shape, want, mesh)

