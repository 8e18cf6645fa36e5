"""Flight recorder: a bounded ring buffer of structured events, plus the
postmortem machinery built on it (heartbeat snapshots, crash dumps).

Counterpart of ``repro.obs.recorder``, with the same formats.

Spans (``obs.trace``) answer *where the time went*; the flight recorder
answers *what just happened* when a long run dies or drifts.  Instrumented
code calls the module-level :func:`record_event` — one global read and an
``is None`` check when no recorder is active, mirroring ``trace.span()``'s
disabled-path contract — and the active :class:`FlightRecorder` keeps the
last ``capacity`` events in a deque:

* ``iteration``    — per-iteration fit/time records (``methods.iteration``)
* ``straggler``    — monitor escalations (``dist.straggler``)
* ``cache``        — ingest-cache / autotune hits and misses
* ``plan``         — planner decisions (per-mode impls, policy, source)
* ``stream.drift`` — streaming fit drops on new chunks (drift signal)
* ``dist.iteration`` — shard_map driver iterations

Three consumers:

* :class:`Heartbeat` — a daemon thread that atomically rewrites
  ``heartbeat.json`` under ``obs.trace_dir`` every ``interval`` seconds
  (metrics snapshot + recorder tail + stage), so a *live* long run can be
  inspected from the filesystem even with the HTTP exposition off, and a
  killed one leaves its last known state behind.
* :func:`write_crash_dump` — called by ``Session.fit`` on an unhandled
  exception: traceback + config + metrics + the event tail into
  ``crash.json``.  The postmortem for OOM-killed / preempted fits.
* ``Session.export_obs`` — dumps the ring as ``events.jsonl`` next to the
  trace.

Deliberately dependency-free (like ``obs.metrics``) so any module feeds
it without import cycles.
"""
from __future__ import annotations

import json
import os
import threading
import time
import traceback as traceback_mod
from collections import deque
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Iterator, Optional

HEARTBEAT_FILENAME = "heartbeat.json"
CRASH_FILENAME = "crash.json"
EVENTS_FILENAME = "events.jsonl"

DEFAULT_CAPACITY = 1024

# events kept inline in heartbeat/crash payloads — the full ring lives in
# events.jsonl; dumps want the recent tail, not megabytes of history
_TAIL_EVENTS = 64


class FlightRecorder:
    """Bounded ring buffer of structured events.

    ``record(kind, **fields)`` appends ``{"kind", "t", "seq", **fields}``;
    once ``capacity`` events are resident the oldest drop (``recorded``
    counts everything ever seen, so ``recorded - len(events())`` is the
    drop count).  Field values must be JSON-expressible — the ring is
    written verbatim into heartbeats, crash dumps and ``events.jsonl``.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=self.capacity)
        self.recorded = 0

    def record(self, kind: str, **fields) -> dict:
        event = {"kind": kind, "t": time.time(), **fields}
        with self._lock:
            event["seq"] = self.recorded
            self.recorded += 1
            self._events.append(event)
        return event

    def events(self, *, kind: Optional[str] = None) -> list[dict]:
        with self._lock:
            events = list(self._events)
        if kind is not None:
            events = [e for e in events if e.get("kind") == kind]
        return events

    def snapshot(self, *, tail: Optional[int] = None) -> dict:
        """JSON-ready state: capacity / total recorded / drop count and
        the (optionally tail-truncated) resident events."""
        with self._lock:
            events = list(self._events)
            recorded = self.recorded
        if tail is not None:
            events = events[-tail:]
        return {"capacity": self.capacity, "recorded": recorded,
                "dropped": recorded - len(self._events), "events": events}

    def export_jsonl(self, path) -> Path:
        """One event per line, oldest first (the resident ring only)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        lines = [json.dumps(e, sort_keys=True) for e in self.events()]
        path.write_text("\n".join(lines) + ("\n" if lines else ""))
        return path

    @contextmanager
    def activate(self) -> Iterator["FlightRecorder"]:
        """Make this recorder the target of :func:`record_event` for the
        block (process-global, like the default metrics registry)."""
        global _ACTIVE
        with _ACTIVE_LOCK:
            previous, _ACTIVE = _ACTIVE, self
        try:
            yield self
        finally:
            with _ACTIVE_LOCK:
                _ACTIVE = previous


_ACTIVE: Optional[FlightRecorder] = None
_ACTIVE_LOCK = threading.Lock()


def current_recorder() -> Optional[FlightRecorder]:
    """The active recorder, or None (events are then dropped for free)."""
    return _ACTIVE


def record_event(kind: str, **fields) -> None:
    """Record one structured event on the active recorder, or do nothing.

    The disabled path is one global read and an ``is None`` check —
    instrumented modules (straggler monitor, ingest cache) call this
    unconditionally."""
    recorder = _ACTIVE
    if recorder is not None:
        recorder.record(kind, **fields)


# ---------------------------------------------------------------------------
# heartbeat snapshots
# ---------------------------------------------------------------------------


def _atomic_write_json(path: Path, payload: dict) -> None:
    tmp = path.with_suffix(path.suffix + f".tmp{os.getpid()}")
    tmp.write_text(json.dumps(payload, indent=1, sort_keys=True))
    os.replace(tmp, path)


class Heartbeat:
    """Daemon thread that periodically snapshots live state to disk.

    Every ``interval`` seconds (plus once at start and once at stop, so
    even a sub-interval run leaves a heartbeat behind) it atomically
    rewrites ``<dir>/heartbeat.json``::

        {"seq": 3, "t": ..., "interval_s": 5.0, "stage": "fit",
         "metrics": {...registry snapshot...},
         "events": {...recorder tail...}}

    ``info_fn`` contributes extra context (the Session passes its current
    stage and config summary).  Writes are atomic (tmp + rename): a
    reader never sees a torn heartbeat.
    """

    def __init__(self, directory, interval: float, *,
                 registry_fn: Optional[Callable[[], dict]] = None,
                 recorder: Optional[FlightRecorder] = None,
                 info_fn: Optional[Callable[[], dict]] = None) -> None:
        if interval <= 0:
            raise ValueError(f"interval must be > 0, got {interval}")
        self.path = Path(directory) / HEARTBEAT_FILENAME
        self.interval = float(interval)
        self._registry_fn = registry_fn
        self._recorder = recorder
        self._info_fn = info_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.beats = 0

    def beat(self) -> None:
        """Write one heartbeat now (also called from the timer thread)."""
        payload: dict = {"seq": self.beats, "t": time.time(),
                         "interval_s": self.interval}
        if self._info_fn is not None:
            try:
                payload.update(self._info_fn())
            except Exception:  # info is advisory; the beat must land
                pass
        if self._registry_fn is not None:
            payload["metrics"] = self._registry_fn()
        if self._recorder is not None:
            payload["events"] = self._recorder.snapshot(tail=_TAIL_EVENTS)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        _atomic_write_json(self.path, payload)
        self.beats += 1

    def start(self) -> "Heartbeat":
        if self._thread is not None:
            return self
        self.beat()  # one beat immediately: short runs still leave state

        def loop() -> None:
            while not self._stop.wait(self.interval):
                self.beat()

        self._thread = threading.Thread(target=loop, name="repro_torch-heartbeat",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
        self.beat()  # final flush: the last known state survives the stop


# ---------------------------------------------------------------------------
# crash dumps
# ---------------------------------------------------------------------------


def write_crash_dump(directory, exc: BaseException, *,
                     recorder: Optional[FlightRecorder] = None,
                     metrics: Optional[dict] = None,
                     config: Optional[dict] = None,
                     stage: Optional[str] = None) -> Path:
    """Write ``<dir>/crash.json`` — the postmortem for a killed long run.

    Payload: the exception (type / message / formatted traceback), the
    stage it died in, the run config, the final metrics snapshot, and the
    flight recorder's event tail.  Never raises on its own account beyond
    filesystem errors — it is called from an exception handler."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    payload: dict = {
        "t": time.time(),
        "error": {
            "type": type(exc).__name__,
            "message": str(exc),
            "traceback": traceback_mod.format_exception(
                type(exc), exc, exc.__traceback__),
        },
    }
    if stage is not None:
        payload["stage"] = stage
    if config is not None:
        payload["config"] = config
    if metrics is not None:
        payload["metrics"] = metrics
    if recorder is not None:
        payload["events"] = recorder.snapshot(tail=_TAIL_EVENTS)
    path = directory / CRASH_FILENAME
    _atomic_write_json(path, payload)
    return path
