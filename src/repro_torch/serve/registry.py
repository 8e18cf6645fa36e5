"""Multi-tenant model registry: resident decompositions, hot-swap, LRU
(counterpart of ``repro.serve.registry``).

A serving process holds MANY fitted decompositions, one per tenant, and
re-fits replace them while queries are in flight.  The registry makes the
three hard parts explicit:

* **Hot swap is atomic handle replacement.**  ``publish(tenant, decomp)``
  builds the new :class:`TenantModel` OUTSIDE the registry lock, then swaps
  the entry in one dict assignment.  A worker that already resolved the old
  entry keeps its reference and finishes on the old handle; the next batch
  resolves the new one.  Nothing is mutated in place.

* **One compiled variant per bucket lives with the model.**  On the card a
  ``TenantModel`` captures one ``torch.cuda.CUDAGraph`` per ``values_at``
  bucket and one per ``(bucket, k)`` for ``top_k``, each with static input
  and output buffers, at first use (``warmup()`` captures the smallest
  ``values_at`` bucket up front).  On the CPU, which has no graphs, the
  same calls run eagerly.  ``compile_count`` counts captures on the card
  and first builds of a bucket variant on the CPU, which is how the tests
  pin "never more than one variant per bucket".  A capture that fails
  raises: the card never serves eagerly.

* **Eviction is an explicit byte budget.**  Every model's resident bytes
  (factors + lambda/core) are accounted; when a publish pushes the total
  over ``budget_bytes`` the least-recently-USED tenants are evicted until
  it fits (the tenant just published is never the victim: publishing is a
  use).  A single model larger than the whole budget stays resident.  A
  swapped-out or evicted model's graphs, and their private memory pools,
  go when the last reference to the model goes.

Captures are one at a time in the process (:class:`_CaptureGuard`): a
capture starts with a device synchronisation, a collection and an
``empty_cache`` (``torch.cuda.graph``), which fail, and invalidate the
other capture, while another thread captures; this happens when a
republish under load makes the new model and the old one capture at
once.  For the same reason a graph's teardown (its executable, its private
memory pool) must not overlap a capture: the old model's graphs die in
whichever worker drops the last reference, so a graph that dies during a
capture waits in a graveyard and is released when the capture ends.

A graph's static buffers (and their pinned host copies) are shared state,
so each graph has its own lock around copy-in, replay and copy-out, which
ends in a stream synchronisation: two workers never race on one graph's
buffers, workers on different buckets replay concurrently, and the count
stays one capture per bucket (a graph per worker would multiply captures
and pools by the worker count for replays that take microseconds).

Metrics (``repro_torch.obs``): ``serve.registry.models`` /
``serve.registry.resident_bytes`` gauges, ``serve.registry.swaps`` /
``serve.registry.evictions`` counters, the ``serve.batch_fill`` histogram.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs.metrics import get_registry

from .queries import bucket_for, make_top_k_fn, pad_rows, resident_bytes

DEFAULT_BUCKETS = (16, 64, 256)

# eager calls on a side stream before a capture, as the CUDA-graph
# documentation asks (library handles and workspaces get made here)
_CAPTURE_WARMUP = 3


class _Eager:
    """A bucket variant on the CPU: the function itself, run eagerly."""

    def __init__(self, fn: Callable, dtype: torch.dtype):
        self._fn = fn
        self._dtype = dtype

    def __call__(self, x: np.ndarray) -> tuple[np.ndarray, ...]:
        out = self._fn(torch.from_numpy(x).to(self._dtype))
        outs = out if isinstance(out, tuple) else (out,)
        return tuple(o.numpy() for o in outs)


class _CaptureGuard:
    """One capture at a time in the process, and the graphs that died
    during one: a release waits until no capture runs, and a capture waits
    for a release in progress."""

    def __init__(self):
        self._capture = threading.Lock()  # one capture at a time
        # re-entrant: a release may drop the last reference to another
        # graph in the same thread
        self._lock = threading.RLock()
        self._active = False
        self._graveyard: list = []

    @contextlib.contextmanager
    def capturing(self):
        with self._capture:
            with self._lock:
                self._active = True
            try:
                yield
            finally:
                with self._lock:
                    self._active = False
                    dead, self._graveyard = self._graveyard, []
                    for graph in dead:
                        graph.release()

    def bury(self, graph) -> None:
        """Release ``graph`` now, or keep it until the capture ends."""
        with self._lock:
            if self._active:
                self._graveyard.append(graph)
            else:
                graph.release()


_CAPTURES = _CaptureGuard()


class _Graph:
    """A bucket variant on the card: one captured CUDA graph with static
    input and output buffers and pinned host copies of them, replayed
    under its own lock: the batch goes into the pinned input, both copies
    and the replay are queued asynchronously, and one stream
    synchronisation ends the call before the lock goes."""

    def __init__(self, fn: Callable, shape: tuple[int, ...],
                 dtype: torch.dtype, device: torch.device):
        self._lock = threading.Lock()
        with torch.cuda.device(device):
            self._in = torch.zeros(shape, dtype=dtype, device=device)
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with _CAPTURES.capturing():
                with torch.cuda.stream(side):
                    for _ in range(_CAPTURE_WARMUP):
                        fn(self._in)
                self._graph = torch.cuda.CUDAGraph()
                # thread_local: other workers keep launching while this
                # thread captures; the side stream is this capture's own
                with torch.cuda.graph(self._graph, stream=side,
                                      capture_error_mode="thread_local"):
                    out = fn(self._in)
            torch.cuda.current_stream(device).wait_stream(side)
        self._device = device
        self._out = out if isinstance(out, tuple) else (out,)
        # pinned staging: a pageable copy each way costs more than the
        # replay itself (PERF.md, PR 19)
        self._in_host = torch.empty(shape, dtype=dtype, pin_memory=True)
        self._out_host = tuple(torch.empty(o.shape, dtype=o.dtype,
                                           pin_memory=True)
                               for o in self._out)

    def release(self) -> None:
        """Free the graph, its pool and its buffers (no capture runs)."""
        self._in = self._out = self._in_host = self._out_host = None
        self._graph.reset()

    def __del__(self):
        if getattr(self, "_graph", None) is not None and _CAPTURES is not None:
            _CAPTURES.bury(self)

    def __call__(self, x: np.ndarray) -> tuple[np.ndarray, ...]:
        with self._lock:
            self._in_host.numpy()[...] = x
            self._in.copy_(self._in_host, non_blocking=True)
            self._graph.replay()
            for host, o in zip(self._out_host, self._out):
                host.copy_(o, non_blocking=True)
            # the results are on the host before the lock goes to the next
            # batch, which reuses every buffer
            torch.cuda.current_stream(self._device).synchronize()
            return tuple(h.numpy().copy() for h in self._out_host)


class TenantModel:
    """One resident decomposition with one compiled variant per bucket.

    ``values_at(coords)`` and ``top_k(users, k)`` accept ANY batch size:
    the batch is chunked at the largest bucket, each chunk zero-padded up
    to its bucket on the host, and results are sliced back, so the device
    only ever sees bucket shapes and each shape is captured exactly once
    (``compile_count`` proves it).  Immutable once built: a re-fit builds
    a new model and the registry swaps handles."""

    def __init__(self, decomp, dims: tuple[int, ...], *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 user_mode: int = 0, item_mode: int = 1):
        self.decomp = decomp
        self.dims = tuple(int(d) for d in dims)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.user_mode = user_mode
        self.item_mode = item_mode
        self.device = decomp.factors[0].device
        self.nbytes = resident_bytes(decomp)
        self.compile_count = {"values_at": 0, "top_k": 0}
        # the scoring closure (weight vector / contracted core) is built
        # once, outside every capture
        self._top_k_raw = make_top_k_fn(decomp, user_mode=user_mode,
                                        item_mode=item_mode)
        self._variants: dict[tuple, object] = {}
        self._build_lock = threading.Lock()

    @property
    def variant_keys(self) -> tuple[tuple, ...]:
        """The built variants: ``("values_at", bucket)`` and
        ``("top_k", bucket, k)``, in build order."""
        with self._build_lock:
            return tuple(self._variants)

    def _variant(self, kind: str, bucket: int, k: int):
        key = (kind, bucket) if kind == "values_at" else (kind, bucket, k)
        variant = self._variants.get(key)
        if variant is not None:
            return variant
        with self._build_lock:  # one capture per bucket
            variant = self._variants.get(key)
            if variant is None:
                if kind == "values_at":
                    fn = self.decomp.values_at
                    shape, dtype = (bucket, len(self.dims)), torch.int32
                else:
                    fn = functools.partial(self._top_k_raw, k=k)
                    shape, dtype = (bucket,), torch.int64
                if self.device.type == "cuda":
                    variant = _Graph(fn, shape, dtype, self.device)
                else:
                    variant = _Eager(fn, dtype)
                self._variants[key] = variant
                self.compile_count[kind] += 1
        return variant

    def _bucketed(self, x: np.ndarray, kind: str, k: int = 0):
        """Chunk at the largest bucket -> pad to the bucket -> run -> slice;
        records the real/padded fill ratio per call.  Chunking, padding,
        slicing and re-assembly stay on the host in numpy; results come
        back as numpy arrays."""
        n = int(x.shape[0])
        fill = get_registry().histogram("serve.batch_fill")
        if n in self.buckets:
            # exact-bucket fast path (the common case under continuous
            # batching): no pad, no slice
            fill.observe(1.0)
            return self._unpack(self._variant(kind, n, k)(x))
        outs = []
        off = 0
        while off < n:
            take = min(n - off, self.buckets[-1])
            b = bucket_for(take, self.buckets)
            out = self._variant(kind, b, k)(pad_rows(x[off:off + take], b))
            fill.observe(take / b)
            outs.append(tuple(o[:take] for o in out))
            off += take
        if len(outs) == 1:
            return self._unpack(outs[0])
        return self._unpack(tuple(np.concatenate(xs, axis=0)
                                  for xs in zip(*outs)))

    @staticmethod
    def _unpack(out: tuple):
        return out[0] if len(out) == 1 else out

    @staticmethod
    def _check_range(x: np.ndarray, dims: tuple[int, ...], what: str) -> None:
        """Refuse ids outside the dims on the host: on the card an
        out-of-range gather is a device-side assert that ends the process's
        CUDA context (the reference's gathers clamp instead)."""
        if x.size and ((x < 0).any() or (x >= np.asarray(dims)).any()):
            raise ValueError(f"{what} outside the dims {dims}")

    def values_at(self, coords) -> np.ndarray:
        """Reconstructed values (n,) as a numpy array."""
        coords = np.ascontiguousarray(coords, dtype=np.int32)
        if coords.ndim != 2 or coords.shape[1] != len(self.dims):
            raise ValueError(f"values_at expects (n, {len(self.dims)}) "
                             f"coords, got {coords.shape}")
        self._check_range(coords, self.dims, "coordinates")
        return self._bucketed(coords, "values_at")

    def top_k(self, users, k: int):
        """(scores (n, k), items (n, k)): item ids in ORIGINAL labels."""
        users = np.ascontiguousarray(np.asarray(users), dtype=np.int64)
        self._check_range(users, (self.dims[self.user_mode],), "user ids")
        if int(k) < 1:
            raise ValueError(f"top_k needs k >= 1, got {k}")
        return self._bucketed(users, "top_k", int(k))

    def warmup(self) -> None:
        """Build the smallest ``values_at`` bucket up front, so the first
        real query pays a replay, not a capture."""
        self._variant("values_at", self.buckets[0], 0)


@dataclasses.dataclass
class TenantEntry:
    """Registry slot: the immutable model plus the mutable bookkeeping the
    registry updates under its own lock."""

    tenant: str
    model: TenantModel
    generation: int
    last_used: int = 0


class ModelRegistry:
    """Named resident :class:`TenantModel` handles with atomic hot-swap
    and LRU byte-budget eviction."""

    def __init__(self, *, budget_bytes: Optional[int] = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS):
        self.budget_bytes = budget_bytes
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self._lock = threading.Lock()
        self._entries: dict[str, TenantEntry] = {}
        self._clock = itertools.count(1)
        self.evicted: list[str] = []  # names only, for error messages

    # -- publish / resolve -------------------------------------------------
    def publish(self, tenant: str, decomp, dims: Optional[Sequence[int]] = None,
                *, user_mode: int = 0, item_mode: int = 1) -> TenantEntry:
        """Make ``decomp`` the tenant's serving model.  The model is built
        before the lock is taken; the swap itself is one assignment, so
        readers see either the old complete entry or the new one."""
        if dims is None:
            dims = tuple(int(f.shape[0]) for f in decomp.factors)
        model = TenantModel(decomp, tuple(dims), buckets=self.buckets,
                            user_mode=user_mode, item_mode=item_mode)
        with self._lock:
            old = self._entries.get(tenant)
            entry = TenantEntry(tenant=tenant, model=model,
                                generation=(old.generation + 1) if old else 1,
                                last_used=next(self._clock))
            self._entries[tenant] = entry
            if tenant in self.evicted:
                self.evicted.remove(tenant)
            if old is not None:
                get_registry().counter("serve.registry.swaps").inc()
            self._evict_over_budget(keep=tenant)
            self._record_gauges()
        return entry

    def get(self, tenant: str) -> TenantEntry:
        """Resolve a tenant (bumps its LRU clock).  Raises ``KeyError``
        naming the resident set, and whether the tenant was evicted, when
        absent."""
        with self._lock:
            entry = self._entries.get(tenant)
            if entry is None:
                state = ("evicted (over the resident-bytes budget)"
                         if tenant in self.evicted else "not published")
                raise KeyError(
                    f"tenant {tenant!r} is {state}; resident: "
                    f"{sorted(self._entries)}")
            entry.last_used = next(self._clock)
            return entry

    def drop(self, tenant: str) -> bool:
        with self._lock:
            removed = self._entries.pop(tenant, None) is not None
            self._record_gauges()
        return removed

    # -- accounting --------------------------------------------------------
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident_bytes_locked()

    def _resident_bytes_locked(self) -> int:
        return sum(e.model.nbytes for e in self._entries.values())

    def _evict_over_budget(self, *, keep: str) -> None:
        if self.budget_bytes is None:
            return
        evictions = get_registry().counter("serve.registry.evictions")
        while self._resident_bytes_locked() > self.budget_bytes:
            victims = [e for t, e in self._entries.items() if t != keep]
            if not victims:
                # the kept model alone exceeds the budget: stay resident
                # (serving nothing is worse); the gauge shows the overrun
                return
            victim = min(victims, key=lambda e: e.last_used)
            del self._entries[victim.tenant]
            self.evicted.append(victim.tenant)
            evictions.inc()

    def _record_gauges(self) -> None:
        reg = get_registry()
        reg.gauge("serve.registry.models").set(len(self._entries))
        reg.gauge("serve.registry.resident_bytes").set(
            self._resident_bytes_locked())

    def tenants(self) -> dict[str, dict]:
        """JSON-ready summary per resident tenant (the daemon's
        ``/v1/tenants`` payload)."""
        with self._lock:
            return {t: {"generation": e.generation,
                        "resident_bytes": e.model.nbytes,
                        "dims": list(e.model.dims),
                        "fit": float(getattr(e.model.decomp, "fit",
                                             float("nan"))),
                        "buckets": list(e.model.buckets)}
                    for t, e in sorted(self._entries.items())}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, tenant: str) -> bool:
        with self._lock:
            return tenant in self._entries
