"""Continuous-batching request queue: coalesce, pad, execute, resolve
(counterpart of ``repro.serve.queue``, which imports no JAX: this is its
copy, with the port's metrics registry).

The contract with callers: ``submit`` returns a ``concurrent.futures.
Future`` immediately; worker threads drain the queue, coalesce requests
into batches, and resolve the futures.  Coalescing is what buys the
throughput (one replay over a padded bucket instead of N tiny calls), so
the batching rules matter:

* Requests coalesce only within a **(tenant, kind, k)** group: mixing
  tenants would mix models, mixing kinds would mix output shapes, and k
  is part of the captured variant.

* A batch closes when it **fills the largest bucket** or the **coalescing
  window expires** — ``max_wait_ms`` measured from the FIRST request in
  the batch, so the first caller's latency bounds everyone's wait and a
  trickle of singleton queries never stalls longer than the window.

* The registry entry is resolved **at execution time**, not submit time.
  That is the hot-swap guarantee: a ``publish`` between submit and
  execute means the batch runs on the NEW model; a publish DURING
  execution doesn't touch the already-resolved handle.  Either way no
  in-flight future is dropped.

Results are materialized host-side (numpy) before futures resolve, so
the ``serve.<tenant>.query_ms`` histogram records honest device-complete
latency (enqueue -> result materialized), not launch time.  Payloads
and result slicing stay in numpy for the same reason padding does (see
``queries.pad_rows``): only the fixed bucket shapes reach the device.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from repro_torch.obs.metrics import get_registry

from .queries import QUERY_KINDS
from .registry import DEFAULT_BUCKETS, ModelRegistry


@dataclass
class _Request:
    """One submitted query awaiting a batch slot."""

    tenant: str
    kind: str  # one of QUERY_KINDS
    payload: np.ndarray  # (n, order) coords or (n,) user ids
    n: int
    future: Future = field(default_factory=Future)
    k: int = 0  # static top_k width; 0 for values_at
    t_enqueue: float = field(default_factory=time.monotonic)

    @property
    def key(self) -> tuple:
        return (self.tenant, self.kind, self.k)


class BatchQueue:
    """Request queue + coalescing worker threads over a ModelRegistry."""

    def __init__(self, registry: ModelRegistry, *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_ms: float = 2.0, workers: int = 1):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.registry = registry
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._pending: deque[_Request] = deque()
        self._cond = threading.Condition()
        self._stopping = False
        self.batches_executed = 0
        self._threads = [
            threading.Thread(target=self._worker_loop,
                             name=f"repro-torch-serve-worker-{i}", daemon=True)
            for i in range(workers)]
        for t in self._threads:
            t.start()

    # -- submit ------------------------------------------------------------
    def submit(self, tenant: str, kind: str, payload, *,
               k: int = 0) -> Future:
        if kind not in QUERY_KINDS:
            raise ValueError(f"unknown query kind {kind!r}; "
                             f"expected one of {QUERY_KINDS}")
        payload = np.asarray(payload, dtype=np.int32)
        if kind == "values_at" and payload.ndim != 2:
            raise ValueError(
                f"values_at expects (n, order) coords, got {payload.shape}")
        if kind == "top_k":
            if payload.ndim != 1:
                raise ValueError(
                    f"top_k expects a 1-d user batch, got {payload.shape}")
            if k < 1:
                raise ValueError(f"top_k needs k >= 1, got {k}")
        req = _Request(tenant=tenant, kind=kind, payload=payload,
                       n=int(payload.shape[0]), k=int(k))
        with self._cond:
            if self._stopping:
                raise RuntimeError("BatchQueue is stopped")
            self._pending.append(req)
            get_registry().gauge("serve.queue.depth").set(len(self._pending))
            self._cond.notify()
        return req.future

    # -- worker ------------------------------------------------------------
    def _worker_loop(self) -> None:
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            self._execute(batch)

    def _next_batch(self) -> Optional[list[_Request]]:
        """Block for a first request, then coalesce same-key requests until
        the largest bucket fills or the first request's window expires."""
        with self._cond:
            while not self._pending:
                if self._stopping:
                    return None
                self._cond.wait()
            first = self._pending.popleft()
            batch = [first]
            budget = self.buckets[-1] - first.n
            deadline = first.t_enqueue + self.max_wait_s
            while budget > 0:
                self._collect(batch, first.key, budget)
                budget = self.buckets[-1] - sum(r.n for r in batch)
                if budget <= 0 or self._stopping:
                    break
                if self._pending:
                    # only OTHER-key work is queued (matching requests were
                    # just collected) — idling the device through the
                    # window would starve it, so execute what we have
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            get_registry().gauge("serve.queue.depth").set(len(self._pending))
            return batch

    def _collect(self, batch: list[_Request], key: tuple,
                 budget: int) -> None:
        """Pull every pending same-key request that still fits (called with
        the lock held)."""
        kept: deque[_Request] = deque()
        while self._pending:
            req = self._pending.popleft()
            if req.key == key and req.n <= budget:
                batch.append(req)
                budget -= req.n
            else:
                kept.append(req)
        self._pending.extend(kept)

    def _execute(self, batch: list[_Request]) -> None:
        first = batch[0]
        reg = get_registry()
        try:
            # resolve the tenant NOW: a hot-swap before this point serves
            # the new model, one after it finishes on this handle
            model = self.registry.get(first.tenant).model
            merged = batch[0].payload if len(batch) == 1 else \
                np.concatenate([r.payload for r in batch], axis=0)
            # TenantModel returns synced numpy (it materializes results
            # host-side), so resolved futures hold device-complete values
            if first.kind == "values_at":
                out = model.values_at(merged)
            else:
                out = model.top_k(merged, first.k)
        except BaseException as exc:  # noqa: BLE001 — delivered via futures
            for req in batch:
                if not req.future.set_running_or_notify_cancel():
                    continue
                req.future.set_exception(exc)
            return
        done = time.monotonic()
        self.batches_executed += 1
        lat = reg.histogram(f"serve.{first.tenant}.query_ms")
        queries = reg.counter(f"serve.{first.tenant}.queries")
        off = 0
        for req in batch:
            if len(batch) == 1:
                res = out
            elif first.kind == "values_at":
                res = out[off:off + req.n]
            else:
                res = (out[0][off:off + req.n], out[1][off:off + req.n])
            off += req.n
            lat.observe((done - req.t_enqueue) * 1e3)
            queries.inc()
            if req.future.set_running_or_notify_cancel():
                req.future.set_result(res)

    # -- lifecycle ---------------------------------------------------------
    def stop(self, *, drain: bool = True) -> None:
        """Stop the workers.  With ``drain`` (default) every already-
        submitted future still resolves before the threads exit; without
        it, pending requests get a RuntimeError."""
        with self._cond:
            self._stopping = True
            if not drain:
                while self._pending:
                    req = self._pending.popleft()
                    if req.future.set_running_or_notify_cancel():
                        req.future.set_exception(
                            RuntimeError("BatchQueue stopped before "
                                         "this request was served"))
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=30.0)

    def depth(self) -> int:
        with self._cond:
            return len(self._pending)
