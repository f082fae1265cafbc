"""Device meshes: a grid of torch devices with named axes.

The port of ``repro.launch.mesh``.  A :class:`Mesh` is to the port what
a ``jax.sharding.Mesh`` is to the reference: an n-d array of devices
that one process drives, one name per axis.  Its entries are *slots*,
and a device may fill more than one slot: four slots on one card (or
on the CPU) run the same data-parallel split as four cards, each slot
with its own streams and graphs (``serving.BNNServer``).

    mesh = make_local_mesh()                        # every visible card
    mesh = make_local_mesh(devices=[torch.device("cpu")] * 4)
    with mesh:                                      # shard_act's mesh
        logits = forward(params, cfg, tokens)

``make_production_mesh`` gives the reference's (16, 16) and (2, 16, 16)
meshes by shape alone, with no devices: the sharding rules
(``runtime.sharding.param_specs``) read only ``mesh.shape``.

``make_process_mesh`` is the other kind of mesh, the one SPMD training
runs on: a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
default process group, one rank (one process, one card) a point.
``rules_mesh`` reads it as the shape-only :class:`Mesh` the rules take.

    dist.init_process_group("gloo", ...)            # or "nccl"
    dm = make_process_mesh(device="cpu")            # ("data", "model")
    specs = param_specs(params, rules_mesh(dm), ("decoder", "encoder"))

``fake_world`` is torch's fake default process group: ``n`` ranks in
one process, collectives that move nothing.  Over it
``make_process_mesh`` builds the production meshes as real
``DeviceMesh`` objects, and the dry-run runs rank 0's view of an SPMD
step on meta tensors (``launch.dryrun``):

    with fake_world(512):
        dm = make_process_mesh(16, pods=2, device="cpu")  # (2, 16, 16)

Functions, not module-level constants: importing this module touches
no device.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "current_mesh", "fake_world", "make_local_mesh",
           "make_process_mesh", "make_production_mesh", "rules_mesh"]

# the meshes entered in this context, innermost last
_ENTERED: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=())


class Mesh:
    """A grid of ``torch.device`` slots with named axes.

    devices: an array (or nested lists) of devices, one axis per name;
    None for a shape-only mesh, which then needs ``shape``.  ``.shape``
    is an ordered name -> size map like jax's, ``.size`` the number of
    slots, ``.devices`` an object array of ``torch.device`` (None for a
    shape-only mesh).  ``with mesh:`` makes it the current mesh of
    ``shard_act`` in this context; the specs ``shard_act`` computes
    under it are kept in ``.constraints`` (the latest 4096)."""

    def __init__(self, devices: Any, axis_names: Sequence[str], *,
                 shape: Optional[Sequence[int]] = None):
        names = tuple(axis_names)
        if devices is None:
            if shape is None or len(shape) != len(names):
                raise ValueError("a mesh without devices needs one size "
                                 "per axis name")
            dims = tuple(int(s) for s in shape)
            self.devices = None
        else:
            arr = np.array(devices, dtype=object)
            if arr.ndim != len(names):
                raise ValueError(f"{arr.ndim}-d devices for axes {names}")
            self.devices = np.vectorize(torch.device, otypes=[object])(arr)
            dims = tuple(arr.shape)
        if len(set(names)) != len(names):
            raise ValueError(f"axis names repeat: {names}")
        self.axis_names: Tuple[str, ...] = names
        self.shape: Dict[str, int] = dict(zip(names, dims))
        self.size = math.prod(dims)
        self.constraints: deque = deque(maxlen=4096)

    @property
    def empty(self) -> bool:
        return self.size == 0

    def slots(self) -> List[torch.device]:
        """The device of every slot, in mesh (row-major) order."""
        if self.devices is None:
            raise ValueError("a shape-only mesh has no devices")
        return list(self.devices.flat)

    def distinct_devices(self) -> List[torch.device]:
        """Each device of the mesh once, in the order of first slot."""
        return list(dict.fromkeys(self.slots()))

    def __enter__(self) -> "Mesh":
        _ENTERED.set(_ENTERED.get() + (self,))
        return self

    def __exit__(self, *exc: Any) -> None:
        _ENTERED.set(_ENTERED.get()[:-1])

    def __repr__(self) -> str:
        where = "no devices" if self.devices is None else \
            f"{len(self.distinct_devices())} distinct devices"
        return f"Mesh({self.shape}, {where})"


def current_mesh() -> Optional[Mesh]:
    """The innermost mesh entered in this context, or None."""
    entered = _ENTERED.get()
    return entered[-1] if entered else None


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh by shape: ("data", "model") =
    (16, 16), or ("pod", "data", "model") = (2, 16, 16)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(None, axes, shape=shape)


def make_local_mesh(model: int = 1,
                    devices: Optional[Sequence[Any]] = None) -> Mesh:
    """A ("data", "model") mesh of ``devices`` (default: every visible
    card), ``model`` slots on the model axis.  A device may repeat."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device: pass devices= (e.g. "
                               "[torch.device('cpu')] * 4) for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    if n == 0 or n % model:
        raise ValueError(f"{n} devices do not split into model={model}")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(n // model, model), ("data", "model"))


def make_process_mesh(model: int = 1, *, pods: int = 1, device=None):
    """A ``torch.distributed`` ``DeviceMesh`` over the ranks of the
    initialised default process group: ("data", "model") with ``model``
    ranks on the model axis and the rest on "data" (the reference's
    ``make_local_mesh``), or ("pod", "data", "model") where ``pods`` >
    1.  Its device type is "cuda" (an NCCL group) unless ``device``
    asks for the CPU (a gloo group); None means the card and raises
    without one."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card "
                           "unless the caller passes device='cpu'")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_process_mesh needs an initialised default "
                           "process group (torch.distributed."
                           "init_process_group)")
    n = dist.get_world_size()
    if model < 1 or pods < 1 or n % (model * pods):
        raise ValueError(f"{n} ranks do not split into pods={pods} x "
                         f"model={model}")
    if pods > 1:
        shape: Tuple[int, ...] = (pods, n // (pods * model), model)
        names: Tuple[str, ...] = ("pod", "data", "model")
    else:
        shape, names = (n // model, model), ("data", "model")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0) -> Iterator[None]:
    """torch's fake default process group of ``n`` ranks for the block,
    this process rank ``rank``; destroyed on exit.  Its collectives move
    nothing and leave their outputs' values as they were: a run over it
    is good for shapes and counts (meta tensors), not for values.
    Raises where a default process group is already initialised: it
    never joins or replaces one."""
    import torch.distributed as dist
    if not dist.is_available():
        raise RuntimeError("this torch has no torch.distributed")
    if dist.is_initialized():
        raise RuntimeError(
            f"a default process group ({dist.get_backend()}, world "
            f"{dist.get_world_size()}) is already initialised: fake_world "
            f"never joins or replaces one")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("this torch has no fake process group "
                           "(torch.testing._internal.distributed.fake_pg)"
                           ) from e
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def rules_mesh(mesh: Any) -> Mesh:
    """A ``DeviceMesh`` as the shape-only :class:`Mesh` of its axis
    names and sizes, which ``param_specs``, ``batch_specs``,
    ``fit_spec`` and ``axis_size`` read (a :class:`Mesh` is returned
    as it is)."""
    if isinstance(mesh, Mesh):
        return mesh
    return Mesh(None, mesh.mesh_dim_names, shape=tuple(mesh.shape))
