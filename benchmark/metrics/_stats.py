"""Percentiles and means of a run's samples.

A percentile is by nearest rank over every sample: the smallest value with
at least ``q`` percent of the samples at or below it. It is one of the
samples, and never an interpolation between two.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    if not values:
        return None
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def mean(values: Sequence[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None
