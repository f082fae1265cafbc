"""Gradient compression with error feedback — the port of
``repro.runtime.compression``.

Where the gradient all-reduce crosses slow links, the traffic is int8:
per-chunk max-abs scaling, quantize, all-reduce the int8 payload
(summed in int32), and dequantize — with the quantization error fed
back into the next step's gradient (error feedback keeps SGD
convergence; Karimireddy et al.).

The reference's collective is a ``psum`` over a ``shard_map`` axis.
Here ``group`` names the ``torch.distributed`` process group to sum
over: None means the default group when one is initialised, and a
group of one (this process alone, no collective) when none is — the
port's single-card trainer.  ``torch.round`` rounds half to even, as
``jnp.round``, so ``q``, ``scale`` and ``err`` equal the reference's
bit for bit.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import tree as _tree

__all__ = ["compress_tree_psum", "compressed_psum", "compression_ratio",
           "dequantize_int8", "init_error_state", "quantize_int8"]


def quantize_int8(x: torch.Tensor, chunk: int = 1024
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q int8 [n_chunks, chunk], scale float32 [n_chunks, 1],
    error in x's shape and dtype)."""
    flat = x.to(torch.float32).reshape(-1)
    n = flat.shape[0]
    blocks = F.pad(flat, (0, (-n) % chunk)).reshape(-1, chunk)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = (q.to(torch.float32) * scale).reshape(-1)[:n]
    err = flat - deq
    return q, scale, err.reshape(x.shape).to(x.dtype)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def _distributed(group) -> bool:
    """Whether the sums run over a ``torch.distributed`` group (None:
    the default group, when one is initialised)."""
    return group is not None or (dist.is_available()
                                 and dist.is_initialized())


def _psum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group's members (a group of one: t itself)."""
    if not _distributed(group):
        return t
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def compressed_psum(x: torch.Tensor, error: torch.Tensor, group=None,
                    chunk: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce over ``group``.

    The int8 payloads are summed in int32 (the sum can reach 127 x n).
    Returns (the mean-reduced gradient, the new error)."""
    q, scale, err = quantize_int8(x + error.to(x.dtype), chunk)
    q32 = _psum(q.to(torch.int32), group)
    s = _psum(scale, group)           # conservative shared scale sum
    n = float(dist.get_world_size(group) if _distributed(group) else 1)
    # each member used its own scale; summing q * own scale != the sum
    # exactly, so the scales are all-reduced too and their mean used
    mean_scale = s / n
    deq = q32.to(torch.float32) * mean_scale
    out = dequantize_int8(deq, torch.ones_like(mean_scale), x.shape,
                          x.dtype)
    # the reference divides by a float32 array: a bf16 x gives float32
    return out.to(torch.promote_types(x.dtype, torch.float32)) / n, err


def compress_tree_psum(grads: Any, errors: Any, group=None,
                       chunk: int = 1024) -> Tuple[Any, Any]:
    flat_g, tdef = _tree.flatten(grads)
    outs = [compressed_psum(g, e, group, chunk)
            for g, e in zip(flat_g, _tree.leaves(errors))]
    return (_tree.unflatten(tdef, [o[0] for o in outs]),
            _tree.unflatten(tdef, [o[1] for o in outs]))


def init_error_state(grads: Any) -> Any:
    return _tree.map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                     grads)


def compression_ratio(dtype_in: torch.dtype = torch.bfloat16) -> float:
    return dtype_in.itemsize / torch.int8.itemsize
