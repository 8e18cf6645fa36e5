"""What the metric readers under ``metrics/`` share.

A reader takes the run's record (see ``harness.Runner``) and returns a
number, or None where the run has nothing for it to read.
"""
from __future__ import annotations

from cpdbench import generate, plugins


def per_fit_ms(rec: dict, *keys: str):
    """Milliseconds a fit in the methods' routine timers ``keys`` (summed),
    over the traced run's timed fits; None unless every key was timed."""
    timers = rec.get("timers")
    if not timers or any(k not in timers for k in keys):
        return None
    return 1e3 * sum(timers[k] for k in keys) / rec["timed_fits"]


def least_s(peak: dict, nbytes: float, ops: float) -> float:
    """Least time for the work on the card: bytes at the memory's peak or
    operations at float32's peak, the larger."""
    return max(nbytes / peak["hbm_bytes_per_s"],
               ops / peak["fp32_flop_per_s"])


def kernel_roofline(rec: dict, kernel: str):
    """Percent of the kernel's roofline over a fit: the least time of the
    fit's calls (``counts/<kernel>.py``, one call a mode an iteration) over
    the time the methods' timers gave the kernel."""
    ms = per_fit_ms(rec, kernel)
    if ms is None or rec.get("peak") is None:
        return None
    counts = plugins.module("counts", kernel)
    dims, mix = rec["dims"], rec["mix"]
    ranks = generate.ranks_of(mix, len(dims))
    least = sum(least_s(rec["peak"], *counts.call(dims, rec["nnz"], ranks, n))
                for n in range(len(dims))) * int(mix["niters"])
    return 100.0 * least / (ms * 1e-3)
