"""Statistics of a window: a tail over every request, a share of a peak."""
from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile (linear between order statistics) of every
    value, or None for none."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def share_pct(part: float, whole: float) -> float | None:
    """100 * part / whole, or None where there is no whole to share."""
    if not whole or whole <= 0:
        return None
    return 100.0 * part / whole
