"""Device placement for the serving engine (DESIGN.md §9).

The port of ``repro.serving.placement``.  Data-parallel serving: the
request batch axis is split over the mesh's data axes, parameters are
replicated.  The rules come from ``runtime/sharding.py``: ``fit_spec``
with the shared ``BATCH_AXES`` degrades to replication whenever the
rows do not divide the mesh (a 1- or 2-row bucket on a 4-slot mesh),
so every bucket runs on every mesh.

A mesh is a :class:`~repro_torch.launch.mesh.Mesh` whose slots may
repeat a device.  With ``mesh=None`` placement is one device:
``replicate`` moves the parameters there once and ``shard_batch`` moves
a request payload.  With a mesh, ``shard_batch`` returns one piece of
the payload per slot (each on its slot's device; a PackedArray's
leading word rows, whole packed rows, are what is split) and
``replicate`` one copy of the tree per distinct device.  Anything else
given as a mesh raises ``TypeError``.  ``ensure_owned`` clones every
leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.kernels.packed import PackedArray, resolve_device
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.runtime.sharding import BATCH_AXES, NamedSharding, fit_spec

__all__ = ["data_mesh", "ensure_owned", "replicate", "shard_batch"]


def _map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    """Apply ``fn`` to every tensor leaf of dicts, lists, tuples,
    NamedTuples and PackedArrays (numpy leaves become tensors first)."""
    if isinstance(tree, PackedArray):
        return tree.with_words(fn(tree.words))
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(tree)
    return fn(tree)


def check_mesh(mesh: Any) -> Mesh:
    """``mesh``, if it is a Mesh with devices to place on; raises
    otherwise."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch Mesh or None, got "
                        f"{type(mesh).__name__}")
    if mesh.devices is None:
        raise ValueError("a shape-only mesh has no devices to place on")
    return mesh


def data_mesh(model: int = 1, devices: Optional[List[Any]] = None) -> Mesh:
    """A whole-host ("data", "model") mesh for data-parallel serving —
    the launch/mesh.py local-mesh shape, every slot on "data" by
    default; ``devices`` (default every visible card) may repeat a
    device."""
    return make_local_mesh(model=model, devices=devices)


def shard_batch(tree: Any, device: Any = None,
                mesh: Optional[Mesh] = None) -> Any:
    """Without a mesh: the payload moved to ``device`` (None: the card).
    With one: a list of per-slot payloads in mesh order, every leaf's
    leading (batch) axis split over the mesh's data axes where they
    divide it (each slot then holds its block of rows) and whole on
    every slot where they do not."""
    if mesh is None:
        dev = resolve_device(device)
        return _map(lambda t: t.to(dev, non_blocking=True), tree)
    mesh = check_mesh(mesh)
    # numpy leaves become tensors
    flat, treedef = _tree.flatten(_map(lambda t: t, tree))
    pieces = []
    for leaf in flat:
        shape = tuple((leaf.words if isinstance(leaf, PackedArray)
                       else leaf).shape)
        want = (BATCH_AXES,) + (None,) * (len(shape) - 1)
        pieces.append(NamedSharding(mesh, fit_spec(shape, want, mesh))
                      .shard(leaf))
    return [_tree.unflatten(treedef, [p[i] for p in pieces])
            for i in range(mesh.size)]


def replicate(tree: Any, device: Any = None,
              mesh: Optional[Mesh] = None) -> Any:
    """Without a mesh: the parameters moved to ``device`` (None: the
    card), once.  With one: ``{device: copy}`` for each distinct device
    of the mesh (the parameters are read-only, so slots that share a
    device share its copy)."""
    if mesh is None:
        dev = resolve_device(device)
        return _map(lambda t: t.to(dev), tree)
    mesh = check_mesh(mesh)
    copies: Dict[torch.device, Any] = {}
    for dev in mesh.distinct_devices():
        copies[dev] = _map(lambda t, d=dev: t.to(d), tree)
    return copies


def ensure_owned(tree: Any) -> Any:
    """Clone every leaf: the result shares no memory with ``tree``."""
    return _map(lambda t: t.clone(), tree)
