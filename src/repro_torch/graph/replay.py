"""GraphedApply: ``CompiledBNN.apply`` replayed as one CUDA graph.

The port's twin of ``jax.jit(apply, **serving_jit_kwargs)``: the
reference runs a forward as one XLA executable, one per (bucket,
valid_rows) level; the port captures the forward's launches (cuDNN's
entry conv, torch's pools and copies, the Hopper kernels through
ctypes) into one ``torch.cuda.CUDAGraph`` per level and replays it, so
the host pays one graph launch instead of a Python dispatch per step.

    g = GraphedApply(compiled, params, batch=256, valid_rows=200)
    logits = g(x)          # x: up to 256 rows; returns ``valid_rows``

A ``GraphedApply`` owns a static input buffer of ``batch`` rows and the
graph, captured once after an eager warm-up on a side stream (which
builds the kernel libraries, sets their function attributes and fills
the plans' caches, so the capture records launches only).  A call
copies ``x`` into the buffer, zeroes the pad rows (the reference pads
with zeros), replays on the current stream and returns a clone of the
graph's output, which no later replay can overwrite.  The params are
read by address: the graph holds the tensors it was captured with.

Graphs may share one memory pool (``torch.cuda.graph_pool_handle()``):
then their calls must run in turn on one stream, each clone before the
next replay, as ``BNNServer`` does under its dispatch lock.

On the CPU a call pads and runs ``apply`` eagerly: the CPU entry point,
which the tests drive.  A capture that fails raises; nothing falls back
to eager on the card.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.packed import PM1, PackedArray

__all__ = ["CaptureError", "GraphedApply", "kind_of", "rows_of", "spec_kind",
           "tensor_of"]

Kind = Tuple


class CaptureError(RuntimeError):
    """Capturing a forward into a CUDA graph failed."""


def kind_of(x: Any) -> Kind:
    """The shape-minus-batch signature a graph is keyed on: a float
    batch ``("dense", trailing shape, dtype)`` or a packed one
    ``("packed", trailing word shape, length, axis, values)``."""
    if isinstance(x, PackedArray):
        return ("packed", tuple(x.words.shape[1:]), x.length, x.axis,
                x.values)
    return ("dense", tuple(x.shape[1:]), x.dtype)


def spec_kind(spec: Any) -> Kind:
    """The input kind a spec takes: float32 NHWC images, or packed rows
    of ``input_shape[0]`` bits for a dense-entry spec."""
    if len(spec.input_shape) == 1:
        k = spec.input_shape[0]
        return ("packed", ((k + 31) // 32,), k, -1, PM1)
    return ("dense", tuple(spec.input_shape), torch.float32)


def rows_of(x: Any) -> int:
    return int(tensor_of(x).shape[0])


def _zeros(kind: Kind, rows: int, device: torch.device) -> Any:
    if kind[0] == "packed":
        _, tail, length, axis, values = kind
        return PackedArray(torch.zeros((rows, *tail), dtype=torch.int32,
                                       device=device), length, axis, values)
    _, tail, dtype = kind
    return torch.zeros((rows, *tail), dtype=dtype, device=device)


def tensor_of(x: Any) -> torch.Tensor:
    """A payload's tensor: a PackedArray's words, or the tensor itself."""
    return x.words if isinstance(x, PackedArray) else x


def _clone(y: Any) -> Any:
    if isinstance(y, PackedArray):
        return y.with_words(y.words.clone())
    return y.clone()


class GraphedApply:
    """``compiled.apply(params, x, valid_rows=valid_rows)`` on batches of
    up to ``batch`` rows of the spec's input kind, replayed as one CUDA
    graph (see the module docstring).  ``pool`` is a graph memory pool
    to share; ``stream`` the capture's side stream (a new one by
    default)."""

    def __init__(self, compiled: Any, params: Dict[str, Any], batch: int,
                 valid_rows: Optional[int] = None, pool: Any = None,
                 stream: Optional[torch.cuda.Stream] = None):
        self.compiled = compiled
        self.params = params
        self.batch = int(batch)
        self.valid_rows = self.batch if valid_rows is None else int(valid_rows)
        if not 1 <= self.valid_rows <= self.batch:
            raise ValueError(f"valid_rows must be in [1, {self.batch}], got "
                             f"{self.valid_rows}")
        self.kind = spec_kind(compiled.spec)
        self.device = compiled.device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        self.capture_s = 0.0
        self._in = _zeros(self.kind, self.batch, self.device)
        if self.device.type == "cuda":
            self._capture(pool, stream)

    def _forward(self) -> Any:
        return self.compiled.apply(self.params, self._in,
                                   valid_rows=self.valid_rows)

    def _capture(self, pool: Any, stream: Optional[torch.cuda.Stream]
                 ) -> None:
        t0 = time.perf_counter()
        side = stream if stream is not None else torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._forward()
        side.synchronize()
        graph = torch.cuda.CUDAGraph()
        # the cyclic collector is held off while capturing: another
        # graph it freed here (CUDAGraph.reset) would be a call the
        # capture refuses, which invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            # the capture runs nothing: its launches count at each replay
            with _build.recording() as self.launches, \
                    torch.cuda.graph(graph, pool=pool, stream=side,
                                     capture_error_mode="thread_local"):
                out = self._forward()
        except Exception as e:
            raise CaptureError(f"capturing {self.compiled.spec.name} at "
                               f"batch {self.batch}, valid_rows "
                               f"{self.valid_rows} failed: {e!r}") from e
        finally:
            if collecting:
                gc.enable()
        side.synchronize()
        self.graph, self._out = graph, out
        self.capture_s = time.perf_counter() - t0

    def __call__(self, x: Any) -> Any:
        """The forward of ``x`` (at most ``batch`` rows, this kind), with
        ``valid_rows`` rows.  On the card the copy, the replay and the
        clone run on the current stream; the caller synchronises."""
        n = rows_of(x)
        if not 1 <= n <= self.valid_rows:
            raise ValueError(f"{n} rows for a graph of {self.valid_rows} "
                             f"valid rows")
        if kind_of(x) != self.kind:
            raise ValueError(f"input kind {kind_of(x)} is not the graph's "
                             f"{self.kind}")
        buf = tensor_of(self._in)
        buf[:n].copy_(tensor_of(x), non_blocking=True)
        if n < self.batch:
            buf[n:].zero_()
        if self.graph is None:
            return self._forward()
        self.graph.replay()
        _build.add_launches(self.launches)
        return _clone(self._out)
