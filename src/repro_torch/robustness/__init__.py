"""Chaos and data faults for the port (DESIGN.md §11).

:mod:`repro_torch.robustness.chaos` is a copy of the reference's seeded
``ChaosMonkey`` (injected flight exceptions, latency spikes, thread
kills), the fault hook of ``repro_torch.serving.BNNServer``.
:mod:`repro_torch.robustness.inject` holds the data faults of
``repro.robustness.inject``: SEU bit flips in the packed weights,
integer noise on the thresholds, and the sweeps of both over a compiled
network, drawn from the same numpy streams as the reference's.

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
from repro_torch.robustness.inject import (
    flip_bits,
    flip_params,
    perturb_thresholds,
    seu_curve,
    threshold_curve,
)

__all__ = [
    "ChaosConfig",
    "ChaosMonkey",
    "PoisonError",
    "ThreadKill",
    "TransientFault",
    "flip_bits",
    "flip_params",
    "perturb_thresholds",
    "seu_curve",
    "threshold_curve",
]
