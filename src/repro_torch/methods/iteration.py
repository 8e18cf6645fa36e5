"""The driver's per-iteration bookkeeping (counterpart of
``repro.methods.iteration``).

:class:`IterationRecorder` times each iteration, feeds the time to a
straggler monitor when one is given, and prints the one verbose line every
method prints::

      its = 3  fit = 0.812345  delta = +1.234e-02

Tracing spans and the metrics registry are not ported yet, so nothing else
is recorded.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Iterator


def record_iteration(monitor, dt: float) -> None:
    """Feed one iteration's wall time to a straggler monitor (any object
    with ``record(host, seconds)``); this process is host 0."""
    if monitor is not None:
        monitor.record(0, float(dt))


class IterationRecorder:
    """Per-driver-call recorder for the iteration loop.

    ``iteration(it)`` wraps one iteration's work; ``progress(it, fit,
    fit_prev)`` computes the delta, prints the verbose line, and returns
    the delta for the driver's tol check.
    """

    __slots__ = ("method", "monitor", "verbose")

    def __init__(self, method: str, *, monitor=None,
                 verbose: bool = False) -> None:
        self.method = method
        self.monitor = monitor
        self.verbose = verbose

    @contextmanager
    def iteration(self, it: int) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        record_iteration(self.monitor, time.perf_counter() - t0)
        if self.monitor is not None:
            self.monitor.check()

    def progress(self, it: int, fit, fit_prev) -> float:
        """Cast both fits to python float first, then subtract, so the
        printed delta is the one the tol check compares."""
        delta = float(fit) - float(fit_prev)
        if self.verbose:
            print(f"  its = {it + 1}  fit = {float(fit):.6f}  "
                  f"delta = {delta:+.3e}")
        return delta
