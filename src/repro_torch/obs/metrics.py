"""Process-local metrics registry: counters, gauges, histograms.

Counterpart of ``repro.obs.metrics``, the same instruments and names.  One
registry per process (module default, swappable for tests via
:func:`scoped_registry`) unifies the perf signals the repo already
measures but keeps scattered and internal:

* ``autotune.hit`` / ``autotune.miss``       — AutotuneStore lookups
* ``ingest.cache.hit`` / ``ingest.cache.miss`` — IngestCache loads
* ``straggler.slow`` / ``straggler.persistent`` — monitor escalations
* ``fit.iterations`` (counter), ``fit.fit`` (gauge),
  ``fit.iteration_ms`` (histogram)            — fit trajectory
* ``serve.query_ms`` (histogram)              — serve-query latency,
  summarized with p50/p90/p99
* ``tucker.truncation.gram`` / ``tucker.truncation.svd`` — HOOI
  truncations by the float64 Gram or by the thin SVD (port only)

Deliberately dependency-free (no torch) so any module, the straggler
monitor (``repro_torch.dist.straggler``) among them, can feed it without
import cycles, and so the disabled-observability path costs a dict lookup
plus a lock, nothing more.
"""
from __future__ import annotations

import json
import math
import threading
from collections import deque
from contextlib import contextmanager
from typing import Iterator, Optional, Sequence

# per-histogram retention for percentile estimates; count/total/min/max
# are exact over ALL observations regardless
HISTOGRAM_WINDOW = 4096


class Counter:
    """Monotonically increasing float counter."""

    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> float:
        if amount < 0:
            raise ValueError(f"counters only go up, got inc({amount})")
        with self._lock:
            self.value += amount
            return self.value


class Gauge:
    """Last-write-wins scalar (fit value, active plan rank, ...)."""

    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = None

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)


class Histogram:
    """Windowed histogram: exact count/total/min/max over every
    observation, percentiles over the last :data:`HISTOGRAM_WINDOW`."""

    __slots__ = ("_lock", "_window", "count", "total", "min", "max")

    def __init__(self, window: int = HISTOGRAM_WINDOW) -> None:
        self._lock = threading.Lock()
        self._window: deque = deque(maxlen=window)
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._window.append(value)
            self.count += 1
            self.total += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)

    @property
    def window_size(self) -> int:
        """The retention bound (deque maxlen) percentiles are computed
        over — what a cross-host merge must preserve."""
        return self._window.maxlen

    def percentile(self, p: float) -> Optional[float]:
        """p-th percentile (nearest-rank) of the retained window."""
        with self._lock:
            window = sorted(self._window)
        return window_percentile(window, p)

    def summary(self) -> dict:
        with self._lock:
            window = sorted(self._window)
            count, total = self.count, self.total
            lo, hi = self.min, self.max

        return {
            "count": count,
            "total": total,
            "mean": (total / count) if count else None,
            "min": lo,
            "max": hi,
            "p50": window_percentile(window, 50),
            "p90": window_percentile(window, 90),
            "p99": window_percentile(window, 99),
        }

    def state(self) -> dict:
        """:meth:`summary` plus the raw retained window and its bound —
        the mergeable per-host form (``repro_torch.obs.aggregate`` recomputes
        percentiles from the concatenated windows)."""
        with self._lock:
            window = list(self._window)
        return {**self.summary(), "window": window,
                "window_size": self.window_size}


def window_percentile(window: Sequence[float], p: float) -> Optional[float]:
    """Nearest-rank percentile of an already-sorted window (None when
    empty) — shared by :class:`Histogram` and the cross-host merge."""
    if not window:
        return None
    rank = max(1, math.ceil(p / 100.0 * len(window)))
    return window[rank - 1]


class MetricsRegistry:
    """Named instruments, created on first use.  A name is one kind of
    instrument forever — asking for ``counter("x")`` after ``gauge("x")``
    raises rather than silently splitting the signal."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: dict[str, object] = {}

    def _get(self, name: str, cls):
        with self._lock:
            instrument = self._instruments.get(name)
            if instrument is None:
                instrument = cls()
                self._instruments[name] = instrument
        if not isinstance(instrument, cls):
            raise TypeError(
                f"metric {name!r} is a {type(instrument).__name__}, "
                f"asked for {cls.__name__}")
        return instrument

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self, *, with_window: bool = False) -> dict:
        """JSON-ready dump: ``{name: {"type": ..., ...values...}}``.

        ``with_window=True`` includes each histogram's raw retained
        window (and its bound) — the per-host form
        ``repro_torch.obs.aggregate`` merges across processes."""
        with self._lock:
            items = sorted(self._instruments.items())
        out = {}
        for name, instrument in items:
            if isinstance(instrument, Counter):
                out[name] = {"type": "counter", "value": instrument.value}
            elif isinstance(instrument, Gauge):
                out[name] = {"type": "gauge", "value": instrument.value}
            else:
                assert isinstance(instrument, Histogram)
                dump = (instrument.state() if with_window
                        else instrument.summary())
                out[name] = {"type": "histogram", **dump}
        return out

    def to_json(self, **dump_kwargs) -> str:
        dump_kwargs.setdefault("indent", 1)
        dump_kwargs.setdefault("sort_keys", True)
        return json.dumps(self.snapshot(), **dump_kwargs)

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


_DEFAULT = MetricsRegistry()
_DEFAULT_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry every instrumented module
    feeds."""
    return _DEFAULT


@contextmanager
def scoped_registry(
        registry: Optional[MetricsRegistry] = None
) -> Iterator[MetricsRegistry]:
    """Swap in a fresh (or given) default registry for the block —
    isolation for tests and benchmarks."""
    global _DEFAULT
    fresh = registry if registry is not None else MetricsRegistry()
    with _DEFAULT_LOCK:
        previous, _DEFAULT = _DEFAULT, fresh
    try:
        yield fresh
    finally:
        with _DEFAULT_LOCK:
            _DEFAULT = previous
