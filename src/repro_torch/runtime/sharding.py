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
:class:`MeshSharding` places it as a DTensor (``distribute``,
``local_block``, ``full_tensor``; a PackedArray by its words).
``shard_act`` is the reference's activation
constraint: it never changes a value; inside a mesh context it computes
the spec and keeps it on the mesh (``mesh.constraints``).
"""
from __future__ import annotations

import contextlib
import math
import re
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.kernels.packed import PackedArray
from repro_torch.launch.mesh import Mesh, current_mesh

__all__ = ["BATCH_AXES", "MeshSharding", "NamedSharding", "P", "axis_size",
           "batch_group", "batch_mean", "batch_shard", "batch_specs",
           "distribute", "fit_spec", "full_tensor", "global_batch",
           "holds_first_copy", "local_block", "named", "param_specs",
           "placements", "shard_act", "spec_for_param"]


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


def local_block(t: Any, like: Any) -> Any:
    """The block of ``t`` (whole, equal on every rank) that the DTensor
    ``like`` holds on this rank, as a plain tensor (a PackedArray and a
    PackedArray of DTensor words: the block of the words)."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(t, PackedArray):
        return t.with_words(local_block(t.words, like.words))
    return distribute_tensor(t, like.device_mesh, like.placements,
                             src_data_rank=None).to_local()


def full_tensor(d: Any) -> Any:
    """The DTensor ``d`` gathered whole on every rank (every rank of its
    mesh calls this); a PackedArray of DTensor words as the PackedArray
    of the gathered words."""
    if isinstance(d, PackedArray):
        return d.with_words(d.words.full_tensor())
    return d.full_tensor()


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

