"""Device time over a slice of a run's traffic, from torch.profiler.

The grouping of kernel names and the rule that an empty session is
asked again are copied from the program's ``repro_torch/trace.py``
(``GROUPS``, ``_group``, ``device_events``), the one profiler path that
has held on the H100, so that a change to the program cannot move the
yardstick.  torch.profiler now and then returns a session with no
device event at all; such a slice is profiled again, up to ``TRIES``
sessions, while the traffic lasts.  A run profiles the slice right after
its measured window, with the same traffic still on, so that the
profiler's own start and reading fall outside the window.

A slice's numbers:

* ``busy_s``: the union of the intervals in which a kernel, copy or set
  ran on the card; ``window_s``: from the first such start to the last
  end (the profiler can lose a session's first records, and the span of
  what it kept is the window those records cover);
* device seconds by kernel group and by kernel name (summed, not
  unioned: groups can overlap on two streams);
* the idle gaps between busy intervals, summed by what the host did to
  end each: the CUDA runtime call that launched the operation after the
  gap (``cudaGraphLaunch``: a flight's replay; ``cudaMemcpyAsync``: the
  copy of its rows into the graph's input buffer; ``cudaLaunchKernel``:
  an eager op around the replay).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

CUDNN = "cuDNN float convs"
TORCH = "torch elementwise, pools, copies"
# kernel-name fragment -> group; the first fragment a name holds decides
GROUPS = (("pack_kernel", "pack"), ("packed_conv_kernel", "packed_conv2d"),
          ("fused_mlp_kernel", "fused_binary_mlp"),
          ("popcount_gemm_kernel", "popcount_gemm"),
          ("xnor_gemm_kernel", "xnor_gemm"),
          ("convolve_", CUDNN), ("cudnn", CUDNN), ("fft2d_", CUDNN),
          ("xmma_", CUDNN), ("flip_filter", CUDNN),
          ("at::native::", TORCH))
TRIES = 10


def group(name: str) -> str:
    for frag, g in GROUPS:
        if frag in name:
            return g
    return "other: " + name[:60]


@dataclass
class SliceTrace:
    window_s: float
    busy_s: float
    rows: int                      # real rows the server launched in it
    group_s: Dict[str, float] = field(default_factory=dict)
    kernel_s: Dict[str, float] = field(default_factory=dict)
    idle_by_host: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_time(self, fragment: str) -> float:
        """Device seconds of the kernels whose name holds ``fragment``."""
        return sum(s for k, s in self.kernel_s.items() if fragment in k)


def _union(intervals: List[Tuple[int, int, object]]
           ) -> Tuple[int, List[Tuple[int, int, object]]]:
    """Busy ns of sorted ``(start, end, event)`` intervals, and the gaps
    between them as ``(start, end, event after the gap)``."""
    busy, gaps = 0, []
    cur_s, cur_e = intervals[0][0], intervals[0][1]
    for s, e, ev in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s, ev))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, gaps


def _runtime_calls(host_events: List) -> Dict[int, str]:
    """The CUDA runtime calls of a session by correlation id."""
    out: Dict[int, str] = {}
    for e in host_events:
        if e.name().startswith("cuda"):
            out.setdefault(e.correlation_id(), e.name())
    return out


def _launcher(calls: Dict[int, str], dev_event) -> str:
    """The runtime call that launched a device op, or "unattributed"."""
    for corr in (dev_event.correlation_id(),
                 dev_event.linked_correlation_id()):
        if corr in calls:
            return calls[corr]
    return "unattributed"


def analyse(events: List, rows: int) -> Optional[SliceTrace]:
    """A slice's numbers from a session's raw events (``None`` where it
    holds no device event)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in events:
        (dev if e.device_type() == cuda else host).append(e)
    if not dev:
        return None
    iv = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e)
                for e in dev if e.duration_ns() > 0)
    if not iv:
        return None
    busy_ns, gaps = _union(iv)
    window_ns = max(e for _, e, _ in iv) - iv[0][0]
    out = SliceTrace(window_s=window_ns / 1e9, busy_s=busy_ns / 1e9,
                     rows=rows)
    for s, e, ev in iv:
        name = ev.name()
        out.kernel_s[name] = out.kernel_s.get(name, 0.0) + (e - s) / 1e9
        g = group(name)
        out.group_s[g] = out.group_s.get(g, 0.0) + (e - s) / 1e9
    calls = _runtime_calls(host)
    idle: Dict[str, float] = {}
    for s, e, ev in gaps:
        label = _launcher(calls, ev)
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e9
    out.idle_by_host = sorted(idle.items(), key=lambda kv: -kv[1])
    return out


def warm() -> None:
    """Open and close one session on a small op, so that the profiler's
    first start (CUPTI's set-up) falls into set-up, not the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def profile_slice(seconds: float, rows_now: Callable[[], int],
                  deadline: float) -> Tuple[Optional[SliceTrace], int, int]:
    """Profile ``seconds`` of the running traffic, again after an empty
    session, while a whole slice still ends before ``deadline``
    (``time.perf_counter``).  Returns (the slice or None, sessions
    opened, empty sessions)."""
    from torch.profiler import ProfilerActivity, profile

    opened = empty = 0
    for attempt in range(TRIES):
        if time.perf_counter() + seconds > deadline:
            break
        opened += 1
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            r0 = rows_now()
            time.sleep(seconds)
            r1 = rows_now()
        got = analyse(list(prof.profiler.kineto_results.events()), r1 - r0)
        if got is not None:
            return got, opened, empty
        empty += 1
        time.sleep(0.05 * (attempt + 1))
    return None, opened, empty
