"""ChaosMonkey: seeded system-fault injection for BNNServer.

A copy of ``repro.robustness.chaos`` for the port's server
(``repro_torch.serving.BNNServer``); the port imports nothing of the
reference, so it keeps its own.

The server takes a ``chaos`` object duck-typed to two hooks it calls
at well-defined points (serving/server.py never imports this module,
so robustness stays a cycle-free layer over serving):

* ``on_flight(payloads, fallback=)`` — invoked before every flight
  execution (primary and fallback re-executions alike).  May sleep (a
  latency spike) or raise (an injected fault); the payload list lets
  targeted poison faults follow a specific request through
  coalescing, retries, and bisection.
* ``maybe_kill(role)`` — polled by the dispatcher and completer
  loops; raises :class:`ThreadKill` to simulate a dying worker
  thread.  ``ThreadKill`` is a BaseException so the server's
  ``except Exception`` recovery paths cannot swallow it — only the
  supervisor sees the dead thread and restarts the loop.

Faults come in three deterministic flavors:

* scripted — ``fail_next(exc)`` / ``spike_next(s)`` / ``kill(role)``
  queue exactly-once events (tests assert precise recovery paths);
* targeted — ``poison(payload)`` makes every flight containing that
  exact payload raise :class:`PoisonError` (a ValueError: the
  deterministic, non-retryable class), on the primary *and* fallback
  paths — exactly what a payload-bound fault looks like, and what the
  bisection ladder must isolate;
* rate-based — ``ChaosConfig.fault_rate`` / ``latency_spike_rate``
  draw from a seeded RNG per flight (storm tests).  Rate faults raise
  :class:`~repro_torch.serving.errors.BackendFault` and by default spare
  the fallback path (``fail_fallback=False``), so a storm exercises
  graceful degradation without losing futures.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np

from repro_torch.serving.errors import BackendFault

__all__ = [
    "ChaosConfig",
    "ChaosMonkey",
    "PoisonError",
    "ThreadKill",
    "TransientFault",
]


class ThreadKill(BaseException):
    """Simulated worker-thread death.  A BaseException on purpose:
    the server's ``except Exception`` fault recovery must not be able
    to catch it — only the supervisor's liveness check may react."""


class PoisonError(ValueError):
    """A payload-bound deterministic fault: re-executing the same
    request raises it again (ValueError => the server skips retries
    and goes straight to bisection)."""


class TransientFault(RuntimeError):
    """A fault that is neither a backend fault nor payload-bound —
    the class the bounded-retry ladder exists for."""


@dataclass
class ChaosConfig:
    """Rate-based chaos knobs; all off by default (scripted/targeted
    faults still work on a default config)."""

    seed: int = 0
    fault_rate: float = 0.0  # P(BackendFault) per on_flight call
    fail_fallback: bool = False  # rate faults also hit fallback re-execs
    latency_spike_rate: float = 0.0  # P(sleep) per on_flight call
    latency_spike_s: float = 0.05


class ChaosMonkey:
    """Deterministic fault injector (see module docstring); thread-safe
    — the server calls its hooks from the dispatcher, completer, and
    caller (flush) threads.  ``events`` counts what actually fired."""

    def __init__(self, cfg: Optional[ChaosConfig] = None):
        self.cfg = cfg or ChaosConfig()
        self._rng = np.random.default_rng(self.cfg.seed)
        self._lock = threading.Lock()
        self._poison: set = set()
        self._scripted_faults: deque = deque()
        self._scripted_spikes: deque = deque()
        self._kills: deque = deque()
        self.events: Dict[str, int] = {
            "faults": 0,
            "spikes": 0,
            "poison_hits": 0,
            "kills": 0,
        }

    # -- arming ------------------------------------------------------ #
    def poison(self, payload: Any) -> None:
        """Mark this exact payload object: every flight containing it
        raises PoisonError (primary and fallback), forever."""
        with self._lock:
            self._poison.add(id(payload))

    def fail_next(self, exc: Optional[BaseException] = None, times: int = 1) -> None:
        """Queue ``times`` one-shot flight faults (default:
        TransientFault); consumed by primary executions only, so a
        scripted BackendFault tests the fallback path cleanly."""
        with self._lock:
            for _ in range(times):
                self._scripted_faults.append(exc or TransientFault("chaos"))

    def spike_next(self, seconds: float, times: int = 1) -> None:
        """Queue ``times`` one-shot latency spikes."""
        with self._lock:
            for _ in range(times):
                self._scripted_spikes.append(float(seconds))

    def kill(self, role: str) -> None:
        """Queue one thread kill; fires the next time that role's loop
        polls ``maybe_kill`` (kills fire in FIFO order across roles)."""
        with self._lock:
            self._kills.append(role)

    # -- the server-facing hooks ------------------------------------- #
    def on_flight(self, payloads: Sequence[Any], fallback: bool = False) -> None:
        """Called by the server before every flight execution."""
        spike = 0.0
        exc: Optional[BaseException] = None
        with self._lock:
            if any(id(p) in self._poison for p in payloads):
                self.events["poison_hits"] += 1
                raise PoisonError("chaos: poisoned payload in flight")
            if not fallback and self._scripted_faults:
                exc = self._scripted_faults.popleft()
            elif self.cfg.fault_rate and (self.cfg.fail_fallback or not fallback):
                if self._rng.random() < self.cfg.fault_rate:
                    exc = BackendFault("chaos: injected kernel-launch failure")
            if self._scripted_spikes:
                spike = self._scripted_spikes.popleft()
            elif self.cfg.latency_spike_rate:
                if self._rng.random() < self.cfg.latency_spike_rate:
                    spike = self.cfg.latency_spike_s
            if spike:
                self.events["spikes"] += 1
            if exc is not None:
                self.events["faults"] += 1
        if spike:
            time.sleep(spike)
        if exc is not None:
            raise exc

    def maybe_kill(self, role: str) -> None:
        """Called by the worker loops; raises ThreadKill when a kill
        for ``role`` is at the head of the kill queue."""
        with self._lock:
            if not (self._kills and self._kills[0] == role):
                return
            self._kills.popleft()
            self.events["kills"] += 1
        raise ThreadKill(role)
