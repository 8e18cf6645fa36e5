"""Live metrics exposition: Prometheus text format over stdlib HTTP.

Counterpart of ``repro.obs.exposition``, with the same formats.

:func:`render_prometheus` turns a ``MetricsRegistry`` snapshot into
Prometheus text exposition format 0.0.4 — counters and gauges as plain
samples, histograms as summaries (quantile-labelled samples plus
``_sum``/``_count``).  Metric names are sanitized to the Prometheus
charset (``fit.iteration_ms`` → ``fit_iteration_ms``) with the original
name kept in a ``# HELP`` line.

:class:`ExpositionServer` wraps ``http.server.ThreadingHTTPServer`` in a
daemon thread and serves:

* ``GET /metrics`` — the live registry, text/plain version=0.0.4
* ``GET /healthz`` — JSON liveness: ``{"status": "ok", "stage": ...}``
* ``GET /trace``   — JSON summary of the current tracer's events
  (per-routine breakdown via ``obs.report.routine_breakdown``)

The server holds *callables*, not objects: the registry function is
resolved per request, so ``scoped_registry`` swaps (tests, benchmarks)
are visible live, and the Session can feed its stage/tracer without the
server importing any module of the decomposition stack.  Opt-in via
``ObsConfig.http_port`` (0 binds an ephemeral port — the bound port is
on ``server.port``); started by ``Session.fit`` / ``serve_handle`` and
stopped by ``Session.close()``.
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from . import metrics as obs_metrics

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_QUANTILES = (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99"))


def sanitize_metric_name(name: str) -> str:
    """Map a registry name onto the Prometheus metric-name charset
    (``[a-zA-Z_:][a-zA-Z0-9_:]*``)."""
    sanitized = _NAME_RE.sub("_", name)
    if not sanitized or sanitized[0].isdigit():
        sanitized = "_" + sanitized
    return sanitized


def _format_value(value) -> str:
    if value is None:
        return "NaN"
    return repr(float(value))


def render_prometheus(snapshot: Optional[dict] = None, *,
                      registry: Optional[obs_metrics.MetricsRegistry] = None
                      ) -> str:
    """Render a registry (or a ``snapshot()`` dict) as Prometheus text.

    Histograms render as summaries: one quantile-labelled sample per
    retained percentile plus exact ``_sum`` and ``_count`` — matching
    what ``Histogram`` actually keeps (windowed percentiles, exact
    totals)."""
    if snapshot is None:
        reg = registry if registry is not None else obs_metrics.get_registry()
        snapshot = reg.snapshot()
    lines: list[str] = []
    for name in sorted(snapshot):
        entry = snapshot[name]
        kind = entry.get("type")
        metric = sanitize_metric_name(name)
        lines.append(f"# HELP {metric} repro metric {name!r}")
        if kind == "counter":
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric} {_format_value(entry.get('value', 0.0))}")
        elif kind == "gauge":
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {_format_value(entry.get('value'))}")
        elif kind == "histogram":
            lines.append(f"# TYPE {metric} summary")
            for quantile, key in _QUANTILES:
                lines.append(
                    f'{metric}{{quantile="{quantile}"}} '
                    f"{_format_value(entry.get(key))}")
            lines.append(
                f"{metric}_sum {_format_value(entry.get('total', 0.0))}")
            count = entry.get("count", 0)
            lines.append(f"{metric}_count {int(count)}")
        else:  # unknown instrument type: expose nothing but keep HELP
            lines.append(f"# TYPE {metric} untyped")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    server: "ExpositionServer"

    # silence the default stderr access log — this runs inside fits
    def log_message(self, fmt, *args) -> None:  # noqa: A002
        pass

    def _send(self, status: int, content_type: str, body: str) -> None:
        payload = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/metrics":
                snapshot = self.server.exposition.registry_fn().snapshot()
                self._send(200, CONTENT_TYPE, render_prometheus(snapshot))
            elif path == "/healthz":
                self._send(200, "application/json",
                           json.dumps(self.server.exposition.health()))
            elif path == "/trace":
                self._send(200, "application/json",
                           json.dumps(self.server.exposition.trace_summary()))
            else:
                self._send(404, "application/json",
                           json.dumps({"error": "not found", "path": path,
                                       "routes": ["/metrics", "/healthz",
                                                  "/trace"]}))
        except BrokenPipeError:  # client went away mid-response
            pass
        except Exception as exc:  # never take the fit down from a scrape
            try:
                self._send(500, "application/json",
                           json.dumps({"error": str(exc)}))
            except Exception:
                pass


class ExpositionServer:
    """Background ``/metrics`` + ``/healthz`` + ``/trace`` endpoint.

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    ``registry_fn`` defaults to the live process registry, so scoped
    swaps are reflected per request.  ``events_fn`` supplies the tracer
    events behind ``/trace``; ``info_fn`` extends the ``/healthz``
    payload (the Session passes its current stage)."""

    def __init__(self, port: int, *, host: str = "127.0.0.1",
                 registry_fn: Optional[
                     Callable[[], obs_metrics.MetricsRegistry]] = None,
                 events_fn: Optional[Callable[[], list]] = None,
                 info_fn: Optional[Callable[[], dict]] = None) -> None:
        self.registry_fn = registry_fn or obs_metrics.get_registry
        self._events_fn = events_fn
        self._info_fn = info_fn
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.exposition = self  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None
        self.host = host
        self.port = self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def health(self) -> dict:
        payload = {"status": "ok", "port": self.port}
        if self._info_fn is not None:
            try:
                payload.update(self._info_fn())
            except Exception as exc:
                payload["status"] = "degraded"
                payload["error"] = str(exc)
        return payload

    def trace_summary(self) -> dict:
        events = []
        if self._events_fn is not None:
            events = list(self._events_fn())
        # deferred import: report pulls trace
        from .report import routine_breakdown
        return {"events": len(events),
                "routines": routine_breakdown(events)}

    def start(self) -> "ExpositionServer":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name=f"repro_torch-exposition:{self.port}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._httpd.shutdown()
        self._thread.join(timeout=5.0)
        self._thread = None
        self._httpd.server_close()

    def __enter__(self) -> "ExpositionServer":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.stop()
