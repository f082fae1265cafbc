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

__all__ = ["AsyncCheckpointer", "ChecksumError", "latest_step", "restore",
           "save"]


class ChecksumError(IOError):
    """A checkpoint's on-disk bytes do not match the digest recorded at
    save time — bit rot, a torn write, or tampering."""


def _to_host(x: Any) -> np.ndarray:
    """A leaf as a host array with a copy of its bytes."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


def _flatten(tree: Any) -> Tuple[List[np.ndarray], Any]:
    flat, treedef = _tree.flatten(tree)
    return [_to_host(x) for x in flat], treedef


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
    arrs, treedef = _flatten(tree)
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


def _like(a: np.ndarray, t: Any) -> Any:
    """A restored leaf in the template leaf's form: a tensor of its
    dtype on its device, or a numpy array of its dtype."""
    if isinstance(t, torch.Tensor):
        # a copy: np.load's arrays may be read-only, and
        # ascontiguousarray would make a 0-d leaf 1-d
        return torch.from_numpy(a.copy()).to(device=t.device, dtype=t.dtype)
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
    out = []
    for t, a in zip(flat_t, arrs):
        if tuple(np.shape(t)) != a.shape:
            raise ValueError(f"shape mismatch {tuple(np.shape(t))} vs "
                             f"{a.shape}")
        out.append(_like(a, t))
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
