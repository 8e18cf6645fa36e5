"""Hierarchical spans with Chrome-trace JSONL export.

Counterpart of ``repro.obs.trace``: the same span names (and the few of
``PORT_ONLY_SPANS``), event schema and switches.  Design constraints, in
order:

1. **Near-zero cost when disabled.**  The module-level :func:`span` is
   what hot code calls (``with obs_trace.span("mttkrp", mode=n): ...``).
   When no tracer is active it returns one shared no-op context manager
   without touching the :class:`Tracer` class at all: a contextvar get,
   an ``is None`` check, done.  ``tests/test_torch_obs.py`` pins this with
   a counting monkeypatch: a fit with obs disabled makes **zero**
   ``Tracer.span`` / ``Tracer._record`` calls.
2. **Thread-safe nesting via contextvars.**  The active tracer and the
   current parent span id both live in contextvars, so spans opened on
   worker threads nest under the right parent and two threads never
   corrupt each other's stacks.
3. **Chrome-trace/Perfetto-compatible output.**  :meth:`Tracer.export_jsonl`
   writes one JSON object per line using the trace-event schema's
   complete events (``"ph": "X"``, ``ts``/``dur`` in microseconds,
   ``pid``/``tid``); ``chrome://tracing`` and https://ui.perfetto.dev
   load the file directly (both accept newline-delimited events).  The
   span hierarchy rides in ``args`` (``id``/``parent``) so
   :mod:`repro_torch.obs.report` can rebuild the tree without relying on
   timestamp containment.
4. **Profiler bridge.**  Each recorded span also opens a
   ``torch.profiler.record_function`` range, so the same names show up in
   a ``torch.profiler`` trace, beside the CUDA kernels they launched.  The
   switch keeps the JAX package's name, ``xla_annotations``, because the
   run configuration's schema is shared; ``xla_annotations=False`` turns
   the bridge off, and it is skipped when torch is not importable.

5. **Device time without synchronisation.**  A span opened while CUDA is
   initialised also records a pair of timing events on the current stream
   (the stream the port's kernels launch on), taken from a pool.  Nothing
   waits for them during the run: when the pool is empty, the pairs the
   card has already passed are read (a non-blocking query) and go back
   to it; :meth:`Tracer.events` (and so :meth:`Tracer.export_jsonl`)
   waits once for the rest.  Each span gets ``args.device_ms``, the
   card's time from the span's first enqueued work to its last (idle time
   inside, waiting on the host, included).  Without CUDA a span has no
   ``device_ms``.
6. **One clock with the device trace.**  Spans are stamped with
   ``time.perf_counter_ns`` from the tracer's epoch; the export's
   ``process_name`` metadata carries ``epoch_unix_ns``, the Unix time of
   ``ts = 0``, read once beside the epoch.  ``torch.profiler`` places its
   events in microseconds from its trace start on the Unix clock, so
   ``ts + profiler_offset_us(epoch_unix_ns, prof)`` puts a span on that
   timeline (:func:`profiler_offset_us`).

A span's ``ts``/``dur`` is host time, on every path: the drivers'
plain path adds no synchronisation when traced.  Only the per-routine
timed path (``timers=``, or ``routines="split"``) synchronises the card
around each routine.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from contextvars import ContextVar
from pathlib import Path
from typing import Any, Callable, Iterator, Optional

TRACE_FILENAME = "trace.jsonl"
METRICS_FILENAME = "metrics.json"
# the spans only the port emits (the JAX package has no counterpart): the
# truncation under Tucker's ``ttmc`` span (named ``svd``, with the ``path``
# it took), and the Sort's workspace builds and off-sort streams
PORT_ONLY_SPANS = ("svd", "sort.build", "sort.streams")

# the active tracer (None → module-level span() is a no-op) and the id of
# the innermost open span in THIS thread/context (None → next span is a
# root; _DROPPED → inside an unsampled root, record nothing)
_ACTIVE: ContextVar[Optional["Tracer"]] = ContextVar(
    "repro_torch_obs_active_tracer", default=None)
_PARENT: ContextVar[Any] = ContextVar("repro_torch_obs_parent_span", default=None)
_DROPPED = object()


class _NullSpan:
    """Shared do-nothing span: the entire disabled-path cost."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def annotate(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _DroppedSpan:
    """An unsampled root span: marks the context so every descendant
    span is dropped with it (a half-recorded subtree would render as
    orphans in the trace viewer)."""

    __slots__ = ("_token",)

    def __enter__(self) -> "_DroppedSpan":
        self._token = _PARENT.set(_DROPPED)
        return self

    def __exit__(self, *exc) -> bool:
        _PARENT.reset(self._token)
        return False

    def annotate(self, **attrs) -> None:
        pass


class Span:
    """One open span; records a complete ("X") trace event on exit."""

    __slots__ = ("_tracer", "name", "cat", "attrs", "id", "parent",
                 "_token", "_start_ns", "_annotation", "_device")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 attrs: dict) -> None:
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs

    def __enter__(self) -> "Span":
        tracer = self._tracer
        self.id = tracer._next_id()
        self.parent = _PARENT.get()
        self._token = _PARENT.set(self.id)
        self._annotation = None
        if tracer._annotation_cls is not None:
            self._annotation = tracer._annotation_cls(self.name)
            self._annotation.__enter__()
        self._start_ns = time.perf_counter_ns()
        self._device = tracer._device_mark()
        return self

    def annotate(self, **attrs) -> None:
        """Add attributes known only inside the span (they land in
        ``args`` beside those it was opened with)."""
        self.attrs.update(attrs)

    def __exit__(self, *exc) -> bool:
        device = self._device
        if device is not None:
            device = (device, self._tracer._device_mark())
        end_ns = time.perf_counter_ns()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        _PARENT.reset(self._token)
        tracer = self._tracer
        args: dict = {"id": self.id}
        if self.parent is not None:
            args["parent"] = self.parent
        args.update(self.attrs)
        tracer._record({
            "name": self.name,
            "cat": self.cat,
            "ph": "X",
            "ts": (self._start_ns - tracer._epoch_ns) / 1e3,
            "dur": (end_ns - self._start_ns) / 1e3,
            "pid": tracer._pid,
            "tid": threading.get_ident(),
            "args": args,
        }, device)
        return False


class Tracer:
    """Collects spans for one run; export with :meth:`export_jsonl`.

    ``sample_rate`` keeps 1-in-``round(1/rate)`` **root** spans
    (deterministic stride, not random — reruns produce identical traces);
    descendants always follow their root's fate.  ``routines`` is advice
    to the fit drivers: ``"fused"`` (default) leaves them on their plain
    path, whose sort / mttkrp / epilogue (Tucker: ttmc / svd / fit) spans
    add no synchronisation, while ``"split"`` opts into the paper's full
    Table-III routine set (ata / inverse / norm / fit) at the cost of a
    synchronisation around every routine.  ``xla_annotations`` mirrors
    each span into ``torch.profiler.record_function`` (the name is the
    JAX package's, kept for the shared configuration schema).
    """

    def __init__(self, *, enabled: bool = True, sample_rate: float = 1.0,
                 routines: str = "fused",
                 xla_annotations: bool = True) -> None:
        if not 0.0 < sample_rate <= 1.0:
            raise ValueError(f"sample_rate must be in (0, 1], "
                             f"got {sample_rate}")
        if routines not in ("fused", "split"):
            raise ValueError(f"routines must be 'fused' or 'split', "
                             f"got {routines!r}")
        self.enabled = bool(enabled)
        self.sample_rate = float(sample_rate)
        self.routines = routines
        self._stride = max(1, round(1.0 / self.sample_rate))
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._id_counter = 0
        self._root_counter = 0
        self._epoch_ns, self.epoch_unix_ns = _epoch()
        self._pid = os.getpid()
        self._annotation_cls = None
        # torch.cuda when enabled (the device clock), the timing events free
        # for reuse, and the recorded spans whose events are not yet read
        self._cuda = None
        self._free_events: list = []
        self._pending: deque = deque()
        if self.enabled:
            try:
                import torch
                from torch.profiler import record_function
            except Exception:  # torch absent: spans still work
                pass
            else:
                self._cuda = torch.cuda
                if xla_annotations:
                    self._annotation_cls = record_function

    # -- span construction -------------------------------------------------

    def span(self, name: str, *, cat: str = "repro", **attrs):
        """A context manager timing one span.  Keyword attrs land in the
        event's ``args`` (mode=, impl=, ...)."""
        if not self.enabled:
            return _NULL_SPAN
        parent = _PARENT.get()
        if parent is _DROPPED:
            return _NULL_SPAN
        if parent is None and self._stride > 1:
            with self._lock:
                root_index = self._root_counter
                self._root_counter += 1
            if root_index % self._stride:
                return _DroppedSpan()
        return Span(self, name, cat, attrs)

    @contextmanager
    def activate(self) -> Iterator["Tracer"]:
        """Make this tracer the target of the module-level :func:`span`
        within the block (contextvar-scoped: per thread/task)."""
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    # -- recording ---------------------------------------------------------

    def _next_id(self) -> int:
        with self._lock:
            self._id_counter += 1
            return self._id_counter

    def _device_mark(self):
        """A timing event recorded on the current CUDA stream, or None
        where CUDA is not initialised."""
        cuda = self._cuda
        if cuda is None or not cuda.is_initialized():
            return None
        if not self._free_events:
            with self._lock:
                self._resolve(wait=False)
        try:
            event = self._free_events.pop()
        except IndexError:
            event = cuda.Event(enable_timing=True)
        event.record()
        return event

    def _record(self, event: dict, device=None) -> None:
        with self._lock:
            self._events.append(event)
            if device is not None:
                self._pending.append((event, *device))

    def _resolve(self, wait: bool = True) -> None:
        """Write ``device_ms`` into the recorded spans whose events are
        pending, oldest first, and free their events (lock held).  With
        ``wait`` each end event is waited for; without, it stops at the
        first the card has not reached."""
        pending = self._pending
        while pending:
            event, start, end = pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            event["args"]["device_ms"] = start.elapsed_time(end)
            self._free_events += (start, end)
            pending.popleft()

    def events(self) -> list[dict]:
        """The recorded spans, each with its ``device_ms`` where it has
        device events (waiting for the card here, once)."""
        with self._lock:
            self._resolve()
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            for _, start, end in self._pending:
                self._free_events += (start, end)
            self._pending.clear()
        self._epoch_ns, self.epoch_unix_ns = _epoch()

    # -- export ------------------------------------------------------------

    def export_jsonl(self, path) -> Path:
        """Write the trace as Chrome-trace JSONL (one event per line; a
        leading ``"M"`` metadata event names the process and carries
        ``epoch_unix_ns``, the clock step of :func:`profiler_offset_us`).
        Returns the path written."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        lines = [json.dumps({
            "name": "process_name", "ph": "M", "pid": self._pid,
            "tid": 0, "args": {"name": "repro_torch",
                               "epoch_unix_ns": self.epoch_unix_ns}})]
        lines.extend(json.dumps(e, sort_keys=True) for e in self.events())
        path.write_text("\n".join(lines) + "\n")
        return path


def _epoch() -> tuple[int, int]:
    """A ``perf_counter_ns`` reading and the Unix time (ns) at it: the
    midpoint of two readings around one ``time_ns``."""
    before = time.perf_counter_ns()
    unix = time.time_ns()
    after = time.perf_counter_ns()
    return (before + after) // 2, unix


def profiler_offset_us(epoch_unix_ns: int, prof) -> float:
    """Microseconds to add to a span's ``ts`` to place it on the timeline
    of ``prof``, a finished ``torch.profiler.profile``, whose events'
    ``time_range`` counts microseconds from its trace start on the Unix
    clock.  ``epoch_unix_ns`` is :attr:`Tracer.epoch_unix_ns`, or the
    ``process_name`` event's ``args`` in an exported trace."""
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    return (epoch_unix_ns - start_ns) / 1e3


# ---------------------------------------------------------------------------
# module-level API — what instrumented code imports
# ---------------------------------------------------------------------------


def current_tracer() -> Optional[Tracer]:
    """The tracer activated in this context, or None."""
    return _ACTIVE.get()


def tracing() -> bool:
    """True when an *enabled* tracer is active."""
    tracer = _ACTIVE.get()
    return tracer is not None and tracer.enabled


def split_routines() -> bool:
    """True when an enabled active tracer asks for the paper's full
    Table-III routine set (``routines="split"``): the fit drivers then
    take their synchronised per-routine path."""
    tracer = _ACTIVE.get()
    return (tracer is not None and tracer.enabled
            and tracer.routines == "split")


def span(name: str, *, cat: str = "repro", **attrs):
    """Open a span on the active tracer, or do nothing.

    The disabled path (no active tracer) is one contextvar read and
    returns a shared singleton — it never touches :class:`Tracer`.
    """
    tracer = _ACTIVE.get()
    if tracer is None:
        return _NULL_SPAN
    return tracer.span(name, cat=cat, **attrs)


def traced(name: Optional[str] = None, *, cat: str = "repro",
           **attrs) -> Callable:
    """Decorator form: ``@traced("ingest.parse")`` wraps the call in a
    span (named after the function when ``name`` is omitted)."""

    def decorate(fn: Callable) -> Callable:
        label = name if name is not None else fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(label, cat=cat, **attrs):
                return fn(*args, **kwargs)

        return wrapper

    return decorate


def read_trace(path) -> list[dict]:
    """Parse a trace JSONL file back into its event dicts (metadata
    ``"M"`` events included; corrupt lines are skipped, never fatal)."""
    events = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            event = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(event, dict) and "ph" in event:
            events.append(event)
    return events
