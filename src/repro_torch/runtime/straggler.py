"""Straggler detection and mitigation.

A copy of ``repro.runtime.straggler`` (the port imports nothing of the
reference); the port's server feeds ``StepWatchdog`` per-flight wall
times.

On real pods, stragglers show up as step-time outliers on one host.
This module provides (a) a step-time watchdog that flags slow steps /
slow hosts from timing telemetry, and (b) a simulation harness that
evaluates mitigation policies (sync-wait vs backup-workers vs
drop-slowest-with-grad-rescale) on configurable latency distributions —
the policy layer a 1000-node deployment tunes before enabling.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional

import numpy as np


@dataclass
class WatchdogConfig:
    window: int = 50             # trailing steps for the baseline
    slow_factor: float = 2.0     # step > factor * median => straggler
    min_samples: int = 10


class StepWatchdog:
    """Feed per-step durations; it flags outliers and slow hosts."""

    def __init__(self, cfg: WatchdogConfig = WatchdogConfig()):
        self.cfg = cfg
        self.history: Deque[float] = deque(maxlen=cfg.window)
        self.flags: List[int] = []
        self._step = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        assert self._t0 is not None
        return self.observe(time.perf_counter() - self._t0)

    def observe(self, duration: float) -> bool:
        """Returns True if this step is a straggler event."""
        slow = False
        if len(self.history) >= self.cfg.min_samples:
            med = float(np.median(self.history))
            slow = duration > self.cfg.slow_factor * med
        self.history.append(duration)
        if slow:
            self.flags.append(self._step)
        self._step += 1
        return slow

    @property
    def median(self) -> float:
        return float(np.median(self.history)) if self.history else 0.0


# ------------------------------------------------------------------ #
# policy simulation                                                    #
# ------------------------------------------------------------------ #
@dataclass
class StragglerSim:
    """Step time = max over workers (sync) under a heavy-tail latency
    model; evaluates mitigation policies."""
    n_workers: int = 256
    base_ms: float = 100.0
    jitter_frac: float = 0.05
    tail_prob: float = 0.01      # per-worker chance of a straggle event
    tail_factor: float = 8.0     # straggle multiplies step time
    seed: int = 0

    def _draw(self, rng, steps: int) -> np.ndarray:
        t = self.base_ms * (1 + self.jitter_frac
                            * rng.standard_normal((steps, self.n_workers)))
        tail = rng.random((steps, self.n_workers)) < self.tail_prob
        return np.where(tail, t * self.tail_factor, t)

    def run(self, steps: int = 1000,
            policy: str = "sync",
            drop_frac: float = 0.02,
            backup_frac: float = 0.05) -> Dict[str, float]:
        rng = np.random.default_rng(self.seed)
        t = self._draw(rng, steps)
        if policy == "sync":
            per_step = t.max(axis=1)
            eff_batch = 1.0
        elif policy == "drop":
            # wait for the fastest (1-drop_frac) workers; rescale grads
            k = max(1, int(self.n_workers * (1 - drop_frac)))
            per_step = np.sort(t, axis=1)[:, k - 1]
            eff_batch = k / self.n_workers
        elif policy == "backup":
            # backup workers duplicate the slowest shards (speculative)
            nb = max(1, int(self.n_workers * backup_frac))
            t2 = self._draw(rng, steps)[:, :nb]
            worst = np.sort(t, axis=1)[:, -nb:]
            covered = np.minimum(worst, t2)
            rest = np.sort(t, axis=1)[:, :-nb]
            per_step = np.maximum(rest.max(axis=1), covered.max(axis=1))
            eff_batch = 1.0
        else:
            raise ValueError(policy)
        return {
            "mean_ms": float(per_step.mean()),
            "p50_ms": float(np.percentile(per_step, 50)),
            "p99_ms": float(np.percentile(per_step, 99)),
            "throughput_rel": float(
                eff_batch * (self.base_ms / per_step.mean())),
        }
