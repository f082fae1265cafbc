"""Atomic, async, integrity-checked checkpoints — the port of
``repro.checkpoint.checkpointer``, on the same on-disk layout.

Layout: ``<dir>/step_<k:08d>/`` holding ``arrays.npz`` (the tree's
leaves as ``leaf_i``, in jax's leaf order: ``repro_torch.tree``) and
``meta.json`` (step, leaf count, structure, prefix fingerprint, full
sha256 digest, time, the caller's ``extra``).  The reference's
``restore`` reads a checkpoint this module wrote and this module's
``restore`` reads one the reference wrote.  Writes go to a tmp dir and
``os.replace`` (atomic on POSIX): a save is visible only once complete,
so a crash mid-save never corrupts the latest restorable state.
``AsyncCheckpointer`` copies the tree to the host before it returns and
writes on a background thread.

bfloat16 leaves, which ``.npz`` cannot hold, have a rule of their own:
the leaf's bits are stored as uint16 and ``meta.json`` records
``"leaf_dtypes": {"<i>": "bfloat16"}``; the fingerprint and the digest
cover the stored bits, and ``restore`` views them back as bfloat16.
A tree without bfloat16 leaves is written exactly as the reference
writes it (no ``leaf_dtypes`` key).  A ``PackedArray`` leaf is stored
as its words in the reference's uint32 (the reference's PackedArray
flattens to that one leaf) and restored into the template's
PackedArray.  The reference cannot read a port
checkpoint with bfloat16 leaves (it would cast the uint16 values), nor
restore its own (ROADMAP hazard 11).

SPMD state (DTensor leaves on a ``torch.distributed`` ``DeviceMesh``
that spans the default process group) is saved whole: every rank takes
part in each leaf's ``full_tensor()`` gather, rank 0 alone writes the
same mesh-agnostic files, and rank 0's outcome is then sent to every
rank (a barrier that also raises a failed write everywhere).
``restore(..., shardings=)`` is the elastic path, as the reference's:
a ``runtime.sharding.MeshSharding`` leaf places its leaf as a DTensor
on its mesh, each rank keeping its own block of what it read, so a
checkpoint of any world size (or of one process) reads back onto any
mesh; without ``shardings`` every leaf comes back whole.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.kernels.packed import PackedArray, as_uint32, from_uint32

__all__ = ["AsyncCheckpointer", "ChecksumError", "latest_step", "restore",
           "save"]


class ChecksumError(IOError):
    """A checkpoint's on-disk bytes do not match the digest recorded at
    save time — bit rot, a torn write, or tampering."""


_BF16 = "bfloat16"


def _is_dtensor(x: Any) -> bool:
    if not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _spmd(tree: Any) -> bool:
    """Whether ``tree`` is SPMD state: it holds a DTensor leaf."""
    return any(_is_dtensor(x) for x in _tree.leaves(tree))


def _to_host(x: Any) -> Any:
    """A leaf as a host copy of its bytes: a CPU tensor (its dtype
    kept; a DTensor whole, gathered from every rank) or a numpy
    array."""
    if isinstance(x, PackedArray):
        return x.with_words(_to_host(x.words))
    if _is_dtensor(x):
        return x.detach().full_tensor().to("cpu", copy=True)
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)


def _writer() -> bool:
    """Whether this process writes SPMD state: rank 0."""
    import torch.distributed as dist
    return dist.get_rank() == 0


def _agree(error: Optional[BaseException]) -> None:
    """Send rank 0's outcome of a write to every rank, and raise it
    everywhere if it failed (every rank calls this once a save)."""
    import torch.distributed as dist
    msg = [None if error is None else f"{type(error).__name__}: {error}"]
    dist.broadcast_object_list(msg, src=0)
    if error is not None:
        raise error
    if msg[0] is not None:
        raise IOError(f"rank 0 failed to write the checkpoint: {msg[0]}")


def _stored(x: Any) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf as the array ``arrays.npz`` holds, and the dtype its bits
    stand for where that is not the array's own (bfloat16 as uint16)."""
    if isinstance(x, PackedArray):
        return as_uint32(x.words), None
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        return t.numpy(), None
    return np.asarray(x), None


def _flatten(tree: Any) -> Tuple[List[np.ndarray], Dict[str, str], Any]:
    flat, treedef = _tree.flatten(tree)
    stored = [_stored(x) for x in flat]
    dtypes = {str(i): d for i, (_, d) in enumerate(stored) if d}
    return [a for a, _ in stored], dtypes, treedef


def _fingerprint(arrs: List[np.ndarray]) -> str:
    h = hashlib.sha256()
    for a in arrs:
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes()[:4096])   # prefix hash: cheap integrity check
    return h.hexdigest()


def _digest(arrs: List[np.ndarray]) -> str:
    """sha256 over every leaf's shape, dtype and all of its bytes."""
    h = hashlib.sha256()
    for a in arrs:
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def save(directory: str, step: int, tree: Any,
         extra: Optional[Dict[str, Any]] = None,
         keep: int = 3) -> str:
    """Write ``tree`` as ``step``'s checkpoint; keep the newest ``keep``.
    SPMD state: every rank calls this, rank 0 writes."""
    if not _spmd(tree):
        return _write(directory, step, tree, extra, keep)
    host = _tree.map(_to_host, tree)
    final, error = os.path.join(directory, f"step_{step:08d}"), None
    if _writer():
        try:
            final = _write(directory, step, host, extra, keep)
        except Exception as e:   # raised on every rank by _agree
            error = e
    _agree(error)
    return final


def _write(directory: str, step: int, tree: Any,
           extra: Optional[Dict[str, Any]], keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrs, dtypes, treedef = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": a for i, a in enumerate(arrs)})
    meta = {
        "step": step,
        "n_leaves": len(arrs),
        "treedef": repr(treedef),
        "fingerprint": _fingerprint(arrs),
        "sha256": _digest(arrs),
        "time": time.time(),
        "extra": extra or {},
    }
    if dtypes:
        meta["leaf_dtypes"] = dtypes
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _retention(directory, keep)
    return final


def _retention(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _like(a: np.ndarray, stored_as: Optional[str], t: Any) -> Any:
    """A restored leaf in the template leaf's form: a tensor of its
    dtype on its device, or a numpy array of its dtype."""
    if stored_as not in (None, _BF16):
        raise ValueError(f"unknown stored dtype {stored_as!r}")
    if isinstance(t, PackedArray):
        return t.with_words(from_uint32(a, t.words.device))
    if isinstance(t, torch.Tensor):
        # a copy: np.load's arrays may be read-only, and
        # ascontiguousarray would make a 0-d leaf 1-d
        x = torch.from_numpy(a.copy())
        if stored_as == _BF16:
            x = x.view(torch.bfloat16)
        return x.to(device=t.device, dtype=t.dtype)
    if stored_as == _BF16:
        a = torch.from_numpy(a.copy()).view(torch.bfloat16).float().numpy()
    return a.astype(np.asarray(t).dtype)


def restore(directory: str, template: Any, step: Optional[int] = None,
            shardings: Any = None) -> Tuple[Any, Dict[str, Any]]:
    """Load ``step`` (default: the latest) into ``template``'s tree
    structure, each leaf in its template leaf's dtype and on its
    device; raises :class:`ChecksumError` when the bytes do not match
    the recorded fingerprint or digest.  ``shardings``: a tree of
    ``MeshSharding`` leaves of the template's structure (the elastic
    path, ``sharding.named(specs, device_mesh)``): each leaf comes back
    a DTensor placed by it, every rank reading the file and keeping its
    own block."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrs = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    if _fingerprint(arrs) != meta["fingerprint"]:
        raise ChecksumError(
            f"checkpoint {path} failed the prefix fingerprint check")
    want = meta.get("sha256")  # absent on pre-digest checkpoints
    if want is not None and _digest(arrs) != want:
        raise ChecksumError(
            f"checkpoint {path} failed the full sha256 content digest "
            f"— corrupted on disk")
    flat_t, treedef = _tree.flatten(template)
    if len(flat_t) != len(arrs):
        raise ValueError(f"leaf count mismatch: the template has "
                         f"{len(flat_t)}, the checkpoint {len(arrs)}")
    if shardings is None:
        flat_s: List[Any] = [None] * len(flat_t)
    else:
        flat_s, sdef = _tree.flatten(shardings)
        if sdef != treedef:
            raise ValueError("shardings and template differ in structure")
    dtypes = meta.get("leaf_dtypes", {})
    out = []
    for i, (t, a, sh) in enumerate(zip(flat_t, arrs, flat_s)):
        shape = tuple(np.shape(t.words if isinstance(t, PackedArray) else t))
        if shape != a.shape:
            raise ValueError(f"shape mismatch {shape} vs {a.shape}")
        x = _like(a, dtypes.get(str(i)), t)
        out.append(x if sh is None else sh.distribute(x))
    return _tree.unflatten(treedef, out), meta


class AsyncCheckpointer:
    """Write on a background thread, at most one save in flight
    (training never blocks on I/O unless saves outpace the interval).
    SPMD state: every rank calls ``save`` and ``wait`` alike; the
    gathers run before ``save`` returns, the write on rank 0's thread,
    and ``wait`` sends its outcome to every rank."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[int] = None
        self._spmd = False
        self.saved_steps: List[int] = []

    def wait(self) -> None:
        if self._pending is None:
            return
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        step, self._pending = self._pending, None
        if self._spmd:
            _agree(err)
        elif err is not None:
            raise err
        self.saved_steps.append(step)

    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        # on the host before control returns: the trainer may overwrite
        # the device tensors as soon as this returns
        self._spmd = _spmd(tree)
        host = _tree.map(_to_host, tree)
        self._pending = step
        if self._spmd and not _writer():
            return

        def run():
            try:
                _write(self.directory, step, host, extra, self.keep)
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
