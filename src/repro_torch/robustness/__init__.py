"""Chaos for the port's serving engine (DESIGN.md §11).

:mod:`repro_torch.robustness.chaos` is a copy of the reference's seeded
``ChaosMonkey`` (injected flight exceptions, latency spikes, thread
kills), the fault hook of ``repro_torch.serving.BNNServer``.  The data
faults of ``repro.robustness.inject`` are not ported yet.

This package imports from ``serving`` (never the reverse): the server
takes its chaos hook duck-typed.
"""

from repro_torch.robustness.chaos import (
    ChaosConfig,
    ChaosMonkey,
    PoisonError,
    ThreadKill,
    TransientFault,
)

__all__ = [
    "ChaosConfig",
    "ChaosMonkey",
    "PoisonError",
    "ThreadKill",
    "TransientFault",
]
