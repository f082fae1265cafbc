"""The counter hash of the reference's data pipeline
(``repro.data.pipeline``), copied: every synthetic sample is a pure
function of (seed, counter) through splitmix64, so the port's batches
equal the reference's bit for bit."""
from __future__ import annotations

import numpy as np

__all__ = ["_splitmix64"]


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))
