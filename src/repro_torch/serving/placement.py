"""Device placement for the serving engine, on one card.

The reference (``repro.serving.placement``) shards the request batch
over a jax mesh and replicates the parameters.  The port serves one
card, so placement reduces to moving trees to the server's device:
``replicate`` moves the parameters there once, ``shard_batch`` moves a
request payload, and ``ensure_owned`` clones every leaf.  A ``mesh``
other than None raises ``ValueError``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.kernels.packed import PackedArray

__all__ = ["data_mesh", "ensure_owned", "replicate", "shard_batch"]


def _one_card(mesh: Optional[Any]) -> None:
    if mesh is not None:
        raise ValueError("the port serves one card: pass mesh=None")


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


def data_mesh(model: int = 1) -> None:
    """The serving mesh: on one card, none (``BNNServer(mesh=None)``)."""
    if model != 1:
        raise ValueError("the port serves one card: no model axis")
    return None


def shard_batch(tree: Any, device: torch.device,
                mesh: Optional[Any] = None) -> Any:
    """Move a request payload to the server's device."""
    _one_card(mesh)
    return _map(lambda t: t.to(device, non_blocking=True), tree)


def replicate(tree: Any, device: torch.device,
              mesh: Optional[Any] = None) -> Any:
    """Move the parameters to the server's device, once."""
    _one_card(mesh)
    return _map(lambda t: t.to(device), tree)


def ensure_owned(tree: Any) -> Any:
    """Clone every leaf: the result shares no memory with ``tree``."""
    return _map(lambda t: t.clone(), tree)
