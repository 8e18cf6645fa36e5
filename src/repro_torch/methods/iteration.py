"""The driver's per-iteration bookkeeping (counterpart of
``repro.methods.iteration``).

:class:`IterationRecorder` is the block every method driver shares: an
``"iteration"`` span (when tracing), the straggler monitor's feed plus its
escalation check, the fit-trajectory metrics (``fit.iterations``,
``fit.iteration_ms``, ``fit.fit``) and ``iteration`` events, and the one
verbose line every method prints::

      its = 3  fit = 0.812345  delta = +1.234e-02

With observability disabled (no active tracer) an iteration costs one
perf_counter pair and an ``is None`` check: no tracer or registry traffic.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Iterator

from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.recorder import record_event


def record_iteration(monitor, dt: float) -> None:
    """Feed one iteration's wall time to a StragglerMonitor (if any)."""
    if monitor is not None:
        from repro_torch.dist.straggler import record_step_times

        record_step_times(monitor, dt)


class IterationRecorder:
    """Per-driver-call recorder for the iteration loop.

    ``iteration(it)`` wraps one iteration's work; ``progress(it, fit,
    fit_prev)`` computes the delta, prints the verbose line, and returns
    the delta for the driver's tol check.
    """

    __slots__ = ("method", "monitor", "verbose", "_observed")

    def __init__(self, method: str, *, monitor=None,
                 verbose: bool = False) -> None:
        self.method = method
        self.monitor = monitor
        self.verbose = verbose
        self._observed = obs_trace.tracing()

    @contextmanager
    def iteration(self, it: int) -> Iterator[None]:
        t0 = time.perf_counter()
        with obs_trace.span("iteration", method=self.method, i=int(it)):
            yield
        dt = time.perf_counter() - t0
        record_iteration(self.monitor, dt)
        if self.monitor is not None:
            # escalations land in the metrics registry inside check()
            self.monitor.check()
        if self._observed:
            registry = get_registry()
            registry.counter("fit.iterations").inc()
            registry.histogram("fit.iteration_ms").observe(dt * 1e3)
            record_event("iteration", method=self.method, i=int(it),
                         ms=dt * 1e3)

    def progress(self, it: int, fit, fit_prev) -> float:
        """Cast both fits to python float first, then subtract, so the
        printed delta is the one the tol check compares."""
        delta = float(fit) - float(fit_prev)
        if self.verbose:
            print(f"  its = {it + 1}  fit = {float(fit):.6f}  "
                  f"delta = {delta:+.3e}")
        if self._observed:
            get_registry().gauge("fit.fit").set(float(fit))
        return delta
