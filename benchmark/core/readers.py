"""What several metric readers share: the device's idle share of a traced
stretch, and device time by kernel family per operation."""

from __future__ import annotations

import re

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def idle_pct(run):
    """Percent of the traced stretch with no operation on the device."""
    p = run.profile
    if p is None or p.busy_s <= 0 or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)


def device_s_per_call(run, pattern: str):
    """Device seconds per traced operation in kernels whose names match
    `pattern`; None where no such kernel ran."""
    p = run.profile
    if p is None:
        return None
    rx = re.compile(pattern)
    hits = [(e - s) / 1e6 for name, s, e in p.ops if rx.search(name)]
    if not hits:
        return None
    return sum(hits) / p.calls


def roofline_pct(nbytes: float, seconds):
    """Percent of the least time the bytes take at the memory rate."""
    if not seconds:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
