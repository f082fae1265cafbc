"""Where the time of a BNN forward goes on the card.

    PYTHONPATH=src python -m repro_torch.trace [--model binarynet alexnet]
        [--batches 1 32 256] [--graphed]

Runs full-width BinaryNet CIFAR-10, XNOR-AlexNet, ReActNet-A or Bi-Real
Net-18 (random
weights from
a seeded generator, integer images) through ``graph.compile(...).apply``
— or, with ``--graphed``, through its CUDA graph
(``graph.replay.GraphedApply``, captured before the trace), replayed —
under ``torch.profiler`` and prints, per batch, the device time of each
kernel group per forward (and, in the JSON, every kernel's launches per
forward), the wall time per forward under the profiler,
and the device's busy share (device kernel time over wall time; the
profiler's own overhead inflates the wall time, so the share is a lower
bound).  Needs a CUDA device; each line names the card and its power
limit (``nvidia-smi``), and the results also go to
``trace_<model>.json`` (``trace_<model>_graphed.json``) in the output
directory (see ``main``).

For a running ``BNNServer`` traced from outside: ``clock_anchor`` maps
its spans (``serving/spans.py``, on ``perf_counter_ns``) onto the
profiler's clock, ``idle_gaps`` finds a session's device idle gaps, and
``label_gaps`` labels each idle ns by the dispatcher's or the
completer's span.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Sequence, Tuple, Union

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import graph
from repro_torch.core.workloads import WORKLOADS, Workload
from repro_torch.graph.ir import BNNSpec, bireal_net18, reactnet_a
from repro_torch.graph.replay import GraphedApply
from repro_torch.serving.spans import (ADMIT, AHEAD_WAIT, COMPLETER, CONCAT,
                                       DISPATCHER, LAUNCH, RECOVER, RESOLVE,
                                       SYNC, Span)

# kernel-name fragment -> group: the port's nine kernels by symbol (the
# fused residual half-step before the conv whose name its own holds), then
# the float entry convs left to cuDNN (the kernels cuDNN chose, with its
# layout transposes and FFT stages) and torch's own kernels (elementwise,
# pools, copies); the first fragment a name holds decides
CUDNN = "cuDNN float convs"
TORCH = "torch elementwise, pools, copies"
GROUPS = (("pack_kernel", "pack"),
          ("packed_conv_kernel_residual_epilogue", "residual_conv"),
          ("packed_conv_kernel", "packed_conv2d"),
          ("fused_mlp_kernel", "fused_binary_mlp"),
          ("popcount_gemm_kernel", "popcount_gemm"),
          ("xnor_gemm_kernel", "xnor_gemm"),
          ("entry_convolve_bits_kernel", "entry_conv"),
          ("stem_conv_", "stem_conv"),
          ("shortcut_conv_kernel", "shortcut_conv"),
          ("convolve_", CUDNN), ("cudnn", CUDNN), ("fft2d_", CUDNN),
          ("xmma_", CUDNN), ("flip_filter", CUDNN),
          ("at::native::", TORCH))
PORT_GROUPS = GROUPS[:9]          # the port's own kernels


def _device_us(e) -> float:
    """A profiler event's own device time, µs (the attribute's name
    changed between torch versions)."""
    t = getattr(e, "self_device_time_total", None)
    return e.self_cuda_time_total if t is None else t


def _group(name: str) -> str:
    for frag, group in GROUPS:
        if frag in name:
            return group
    return "other: " + name[:60]


# torch.profiler on the H100 returns, now and then, a session with no
# device event at all, at times a few sessions in a row: such a session
# is asked again, up to TRIES sessions; SESSIONS counts the sessions
# opened and the empty ones among them
TRIES = 10
SESSIONS = {"opened": 0, "empty": 0}


def device_events(fn: Callable[[], object], iters: int = 1
                  ) -> Tuple[List, float]:
    """The device events (``key_averages()``, CUDA only) of ``iters``
    calls of ``fn`` under torch.profiler, and the wall seconds of those
    calls.  ``fn`` must launch device work: a session that saw no device
    event at all is the profiler's loss, and is asked again, up to
    ``TRIES`` sessions with a growing pause between them, then this
    raises.  No time is ever taken another way."""
    for attempt in range(TRIES):
        SESSIONS["opened"] += 1
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events, wall_s
        SESSIONS["empty"] += 1
        time.sleep(0.05 * (attempt + 1))
    raise AssertionError(f"the profiler saw no device event in {TRIES} "
                         f"sessions")


def kernel_ms(fn: Callable[[], object], symbol: str, iters: int = 20
              ) -> float:
    """Device time of one call's launches of the kernels whose symbol
    contains ``symbol``, from torch.profiler over ``iters`` calls of
    ``fn`` (``device_events``).  (A back-to-back CUDA-event timing of a
    kernel shorter than the host's launch path through the wrapper
    measures the host.)  Raises where the profiler saw device kernels
    but none named like ``symbol``: that kernel did not run."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    events, _ = device_events(fn, iters)
    us = sum(_device_us(e) for e in events if symbol in e.key)
    if us <= 0:
        raise AssertionError(
            f"the profiler saw no device time of a kernel named like "
            f"{symbol}; it saw {sorted(e.key[:60] for e in events)[:8]}")
    return us / iters / 1e3


def device_kernels(fn: Callable[[], object]) -> Dict[str, int]:
    """The device kernels one call of ``fn`` launches (after a warm-up
    call), by name, with how many times each ran (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    return {e.key: e.count for e in device_events(fn)[0]}


def device_times(fn: Callable[[], object], iters: int = 2
                 ) -> Dict[str, float]:
    """Device µs per call of ``fn`` by kernel name (and by the
    profiler's memcpy names), from torch.profiler over ``iters`` calls
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out: Dict[str, float] = {}
    for e in device_events(fn, iters)[0]:
        out[e.key] = out.get(e.key, 0.0) + _device_us(e) / iters
    return out


def clock_anchor() -> Tuple[int, int]:
    """A ``(time.perf_counter_ns(), time.time_ns())`` pair read at one
    instant, the tightest of 16 reads: the profiler's events
    are on the Unix-epoch clock, a server's spans on ``perf_counter_ns``,
    and ``time_ns - perf_counter_ns`` maps the second onto the first."""
    best = None
    for _ in range(16):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, wall)
    return best[1], best[2]


def idle_gaps(events: Iterable) -> List[Tuple[int, int]]:
    """The ``(start, end)`` ns, on the profiler's clock, of every gap
    between the busy intervals of a session's device events (kernels,
    copies, sets: ``prof.profiler.kineto_results.events()``)."""
    cuda = torch.autograd.DeviceType.CUDA
    iv = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                for e in events
                if e.device_type() == cuda and e.duration_ns() > 0)
    gaps: List[Tuple[int, int]] = []
    if not iv:
        return gaps
    end = iv[0][1]
    for s, e in iv[1:]:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    return gaps


# a thread's outermost spans, which label an idle ns (the rest is "none")
LABELS = {DISPATCHER: (LAUNCH, AHEAD_WAIT, CONCAT, ADMIT, RECOVER),
          COMPLETER: (SYNC, RESOLVE, RECOVER)}


def label_gaps(gaps: Iterable[Tuple[int, int]], spans: Sequence[Span],
               offset_ns: int, role: str = DISPATCHER) -> Dict[str, int]:
    """Every ns of the ``gaps`` (``(start, end)`` on another clock, such
    as the device trace's) labelled by the span of ``LABELS[role]`` that
    thread was in at that instant, or ``"none"``; a span's times map
    onto the gaps' clock by ``+ offset_ns``.  The labels sum to the
    gaps' length (these spans of one thread do not overlap, but for a
    ``recover`` inside a completer's ``resolve``, whose ns the
    ``resolve`` keeps)."""
    names = LABELS[role]
    iv = sorted((s.t0_ns + offset_ns, s.t1_ns + offset_ns, s.name)
                for s in spans if s.role == role and s.name in names)
    out = dict.fromkeys(names + ("none",), 0)
    i = 0
    for g0, g1 in sorted(gaps):
        while i < len(iv) and iv[i][1] <= g0:
            i += 1
        cur, j = g0, i
        while j < len(iv) and iv[j][0] < g1 and cur < g1:
            s0, s1, name = iv[j]
            lo, hi = max(cur, s0), min(g1, s1)
            if hi > lo:
                out["none"] += lo - cur
                out[name] += hi - lo
                cur = hi
            j += 1
        out["none"] += g1 - cur
    return out


# the models ``--model`` takes: the paper's workloads, ReActNet-A and
# Bi-Real Net-18
MODELS = {**WORKLOADS, "reactnet": reactnet_a(), "bireal": bireal_net18()}


def trace_forward(workload: Union[Workload, BNNSpec], batch: int,
                  iters: int = 20, graphed: bool = False) -> Dict:
    cb = graph.compile(workload, batch=batch)
    params = cb.init(torch.Generator().manual_seed(0))
    x = torch.randint(-3, 4, (batch, *cb.spec.input_shape),
                      generator=torch.Generator().manual_seed(batch)
                      ).to(torch.float32).to("cuda")
    if graphed:
        forward = GraphedApply(cb, params, batch)
    else:
        def forward(x):
            return cb.apply(params, x)
    for _ in range(2):
        forward(x)
    torch.cuda.synchronize()
    events, wall_s = device_events(lambda: forward(x), iters)
    wall_us = wall_s * 1e6
    groups: Dict[str, float] = {}
    kernels: Dict[str, float] = {}
    for e in events:
        us = _device_us(e)
        groups[_group(e.key)] = groups.get(_group(e.key), 0.0) + us / iters
        kernels[e.key[:160]] = kernels.get(e.key[:160], 0) + e.count / iters
    device_us = sum(groups.values())
    return {"batch": batch, "graphed": graphed,
            "wall_us_per_forward": wall_us / iters,
            "device_us_per_forward": device_us,
            "busy_share": device_us / (wall_us / iters),
            "device_us_by_group": dict(sorted(groups.items(),
                                              key=lambda kv: -kv[1])),
            "kernels_per_forward": kernels}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=sorted(MODELS), nargs="+",
                    default=["binarynet"])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 256])
    ap.add_argument("--graphed", action="store_true",
                    help="trace the forward replayed from its CUDA graph")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    path = Path("chiprun_out")
    path.mkdir(exist_ok=True)
    for model in args.model:
        out = []
        for b in args.batches:
            r = trace_forward(MODELS[model], b, graphed=args.graphed)
            out.append(r)
            how = "replayed" if args.graphed else "eager"
            print(f"{smi}: {model} {how} B={b}: wall "
                  f"{r['wall_us_per_forward']:.1f} us/forward under the "
                  f"profiler, device {r['device_us_per_forward']:.1f}"
                  f" us, busy share {r['busy_share']:.3f}")
            for g, us in r["device_us_by_group"].items():
                print(f"  {us:10.1f} us  {g}")
        name = f"trace_{model}{'_graphed' if args.graphed else ''}.json"
        (path / name).write_text(json.dumps(
            {"card": smi, "batches": out}, indent=1))


if __name__ == "__main__":
    main()
