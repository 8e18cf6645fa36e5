"""`DecompServer`: the serving front door, plus the HTTP daemon
(counterpart of ``repro.serve.server``).

``DecompServer`` composes a :class:`ModelRegistry` (resident models,
hot-swap, eviction) with a :class:`BatchQueue` (coalescing workers) and
speaks the query vocabulary:

    server = DecompServer.from_config(cfg.serve)
    server.publish("default", session.fit())
    vals = server.values_at("default", coords)            # blocking
    fut = server.submit_top_k("default", users, k=10)     # async
    scores, items = server.top_k_for_user("default", user=3, k=10)

``ServeDaemon`` puts that behind HTTP for the CLI (`python -m repro_torch
serve-daemon`) with the reference's routes, status codes and JSON bodies: ``/healthz``, ``/metrics`` (Prometheus,
same renderer the live-fit exposition uses), ``/v1/tenants``,
``/v1/top_k?tenant=&user=&k=``, ``/v1/values_at`` (POST), and
``/v1/shutdown`` (POST) for clean scripted teardown.

Throughput is tracked as a trailing-window ``serve.qps`` gauge updated
on every completed call, so a scrape mid-load sees the live rate.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence
from urllib.parse import parse_qs, urlparse

import numpy as np

from repro_torch.obs.exposition import render_prometheus
from repro_torch.obs.metrics import get_registry

from .queue import BatchQueue
from .registry import DEFAULT_BUCKETS, ModelRegistry

_QPS_WINDOW_S = 5.0


class _QpsMeter:
    """Trailing-window completions-per-second, published as a gauge."""

    def __init__(self, window_s: float = _QPS_WINDOW_S):
        self.window_s = window_s
        self._lock = threading.Lock()
        self._ticks: deque[float] = deque()

    def tick(self, n: int = 1) -> None:
        now = time.monotonic()
        with self._lock:
            self._ticks.extend([now] * n)
            cut = now - self.window_s
            while self._ticks and self._ticks[0] < cut:
                self._ticks.popleft()
            span = max(now - self._ticks[0], 1e-9) if self._ticks else 1.0
            get_registry().gauge("serve.qps").set(len(self._ticks) / span)


class DecompServer:
    """Multi-tenant continuous-batching server over fitted decompositions."""

    def __init__(self, *, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_ms: float = 2.0, workers: int = 1,
                 budget_bytes: Optional[int] = None):
        self.registry = ModelRegistry(budget_bytes=budget_bytes,
                                      buckets=buckets)
        self.queue = BatchQueue(self.registry, buckets=buckets,
                                max_wait_ms=max_wait_ms, workers=workers)
        self._qps = _QpsMeter()
        self._closed = False

    @classmethod
    def from_config(cls, serve_cfg) -> "DecompServer":
        return cls(buckets=serve_cfg.buckets,
                   max_wait_ms=serve_cfg.max_wait_ms,
                   workers=serve_cfg.workers,
                   budget_bytes=int(serve_cfg.max_resident_mb * 2**20))

    # -- tenancy -----------------------------------------------------------
    def publish(self, tenant: str, decomp,
                dims: Optional[Sequence[int]] = None, *,
                warmup: bool = True):
        """(Re)publish a tenant's model; in-flight queries on the old model
        finish on the old handle."""
        entry = self.registry.publish(tenant, decomp, dims)
        if warmup:
            entry.model.warmup()
        return entry

    def tenants(self) -> dict[str, dict]:
        return self.registry.tenants()

    # -- queries -----------------------------------------------------------
    def submit_values_at(self, tenant: str, coords) -> Future:
        return self.queue.submit(tenant, "values_at", coords)

    def values_at(self, tenant: str, coords):
        out = self.submit_values_at(tenant, coords).result()
        self._qps.tick()
        return out

    def submit_top_k(self, tenant: str, users, *, k: int) -> Future:
        return self.queue.submit(tenant, "top_k", users, k=k)

    def top_k(self, tenant: str, users, *, k: int):
        out = self.submit_top_k(tenant, users, k=k).result()
        self._qps.tick()
        return out

    def top_k_for_user(self, tenant: str, user: int, *, k: int):
        """The flagship recommendation query: ``(scores (k,), items (k,))``
        for one user, item ids in ORIGINAL labels."""
        scores, items = self.top_k(tenant, np.asarray([int(user)]), k=k)
        return scores[0], items[0]

    # -- introspection / lifecycle ----------------------------------------
    def stats(self) -> dict:
        return {"tenants": self.tenants(),
                "queue_depth": self.queue.depth(),
                "batches_executed": self.queue.batches_executed,
                "resident_bytes": self.registry.resident_bytes()}

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.queue.stop(drain=True)

    def __enter__(self) -> "DecompServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ServeDaemon:
    """HTTP frontend around a :class:`DecompServer` (stdlib-only, the
    ThreadingHTTPServer pattern of ``repro_torch.obs.exposition``)."""

    def __init__(self, server: DecompServer, *, port: int = 0,
                 host: str = "127.0.0.1"):
        self.decomp = server
        self.shutdown_requested = threading.Event()
        daemon = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, status: int, content_type: str,
                      body: bytes) -> None:
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, status: int, obj) -> None:
                self._send(status, "application/json",
                           (json.dumps(obj) + "\n").encode())

            def do_GET(self):
                url = urlparse(self.path)
                try:
                    if url.path == "/healthz":
                        self._json(200, {"status": "serving",
                                         **daemon.decomp.stats()})
                    elif url.path == "/metrics":
                        body = render_prometheus(get_registry().snapshot())
                        self._send(200, "text/plain; version=0.0.4",
                                   body.encode())
                    elif url.path == "/v1/tenants":
                        self._json(200, daemon.decomp.tenants())
                    elif url.path == "/v1/top_k":
                        q = parse_qs(url.query)
                        tenant = q.get("tenant", ["default"])[0]
                        user = int(q["user"][0])
                        k = int(q.get("k", ["10"])[0])
                        scores, items = daemon.decomp.top_k_for_user(
                            tenant, user, k=k)
                        self._json(200, {
                            "tenant": tenant, "user": user, "k": k,
                            "items": [int(i) for i in items],
                            "scores": [float(s) for s in scores]})
                    else:
                        self._json(404, {"error": f"no route {url.path}"})
                except KeyError as exc:
                    self._json(404, {"error": str(exc)})
                except (ValueError, TypeError) as exc:
                    self._json(400, {"error": str(exc)})

            def do_POST(self):
                url = urlparse(self.path)
                try:
                    if url.path == "/v1/shutdown":
                        daemon.shutdown_requested.set()
                        self._json(200, {"status": "shutting down"})
                    elif url.path == "/v1/values_at":
                        n = int(self.headers.get("Content-Length", 0))
                        req = json.loads(self.rfile.read(n) or b"{}")
                        tenant = req.get("tenant", "default")
                        coords = req["coords"]
                        vals = daemon.decomp.values_at(tenant, coords)
                        self._json(200, {
                            "tenant": tenant,
                            "values": [float(v) for v in vals]})
                    else:
                        self._json(404, {"error": f"no route {url.path}"})
                except KeyError as exc:
                    self._json(404, {"error": str(exc)})
                except (ValueError, TypeError,
                        json.JSONDecodeError) as exc:
                    self._json(400, {"error": str(exc)})

        self._http = ThreadingHTTPServer((host, port), _Handler)
        self._http.daemon_threads = True
        self.host, self.port = self._http.server_address[:2]
        self._thread = threading.Thread(target=self._http.serve_forever,
                                        name="repro-torch-serve-daemon",
                                        daemon=True)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ServeDaemon":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._http.shutdown()
        self._http.server_close()
        self._thread.join(timeout=10.0)

    def serve_until_shutdown(self, *, duration_s: Optional[float] = None,
                             poll_s: float = 0.2) -> None:
        """Block until ``POST /v1/shutdown`` (or the optional duration)."""
        deadline = (time.monotonic() + duration_s
                    if duration_s is not None else None)
        while not self.shutdown_requested.is_set():
            if deadline is not None and time.monotonic() >= deadline:
                return
            self.shutdown_requested.wait(timeout=poll_s)

    def __enter__(self) -> "ServeDaemon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
