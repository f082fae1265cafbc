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


def _to_host(x: Any) -> Any:
    """A leaf as a host copy of its bytes: a CPU tensor (its dtype
    kept) or a numpy array."""
    if isinstance(x, PackedArray):
        return x.with_words(_to_host(x.words))
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)


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
    """Write ``tree`` as ``step``'s checkpoint; keep the newest ``keep``."""
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


def restore(directory: str, template: Any, step: Optional[int] = None
            ) -> Tuple[Any, Dict[str, Any]]:
    """Load ``step`` (default: the latest) into ``template``'s tree
    structure, each leaf in its template leaf's dtype and on its
    device; raises :class:`ChecksumError` when the bytes do not match
    the recorded fingerprint or digest."""
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
    dtypes = meta.get("leaf_dtypes", {})
    out = []
    for i, (t, a) in enumerate(zip(flat_t, arrs)):
        shape = tuple(np.shape(t.words if isinstance(t, PackedArray) else t))
        if shape != a.shape:
            raise ValueError(f"shape mismatch {shape} vs {a.shape}")
        out.append(_like(a, dtypes.get(str(i)), t))
    return _tree.unflatten(treedef, out), meta


class AsyncCheckpointer:
    """Write on a background thread, at most one save in flight
    (training never blocks on I/O unless saves outpace the interval)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saved_steps: List[int] = []

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        # on the host before control returns: the trainer may overwrite
        # the device tensors as soon as this returns
        host = _tree.map(_to_host, tree)

        def run():
            try:
                save(self.directory, step, host, extra, keep=self.keep)
                self.saved_steps.append(step)
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
