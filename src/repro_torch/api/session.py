"""``Session``: the one front door, ingest -> plan -> fit -> serve
(counterpart of ``repro.api.session``).

    from repro_torch.api import RunConfig, DataConfig, MethodConfig, Session

    cfg = RunConfig(data=DataConfig(source="data.tnsb"),
                    method=MethodConfig(name="cp_als", rank=35))
    sess = Session(cfg)           # on the CUDA card; device="cpu" asks
    ing    = sess.ingest()        # Ingested handle (stats, cache, relabel)
    plan   = sess.plan()          # per-mode DecompPlan (None for streaming)
    dec    = sess.fit()           # decomposition via the configured executor
    handle = sess.serve_handle()  # batched values_at / top-k queries
    server = sess.decomp_server() # batching multi-tenant server

Stages are lazy and cached: each runs at most once per session, later
stages trigger earlier ones, and ``repro_torch.api.run(cfg)`` is the
one-shot ``Session(cfg).fit()``.  With ``exec.checkpoint_dir`` set the fit
checkpoints every ``exec.checkpoint_every`` iterations through
``repro_torch.checkpoint.CheckpointManager`` as the shared
:class:`~repro_torch.methods.DecompState`, and a NEW session over the same
config resumes from the latest complete step.

The device is the session's, not the config's (the configuration schema
is shared with the JAX package): ``device=None`` means the CUDA card, and
raises without one, unless an in-memory tensor is handed in, which keeps
its own device.  The ``dist`` executor runs on ``Session.mesh()``, a rank
grid over a ``torch.distributed`` process group: NCCL for a CUDA session,
gloo for a CPU one.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np
import torch

from repro_torch.core.coo import DeviceLike, SparseTensor, resolve_device
from repro_torch.obs.metrics import Histogram, get_registry

from .config import RunConfig
from .executor import get_executor, require_capability

# per-batch latency sampling in ServeHandle.benchmark: enough batches for
# stable p50/p99, few enough that the sync-per-batch probe stays cheap next
# to the asynchronous throughput loop it must not perturb
_LATENCY_SAMPLE_BATCHES = 64


def _sync(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeHandle:
    """Batched reconstruction queries against a fitted decomposition.

    ``query(coords)`` takes an (n, order) coordinate batch in the tensor's
    ORIGINAL label space (the session's ingest restored the factor labels)
    and returns the reconstructed values, computed on the device of the
    factors by ``decomp.values_at``.

    ``tracer``: an optional :class:`repro_torch.obs.Tracer`; queries then
    record ``serve.query`` spans (the Session passes its own when obs is
    on)."""

    def __init__(self, decomp, dims: tuple[int, ...], tracer=None):
        self.decomp = decomp
        self.dims = dims
        self.device = decomp.factors[0].device
        self._topk_fns = {}  # (user_mode, item_mode) -> top-k fn
        self._tracer = tracer

    def query(self, coords) -> torch.Tensor:
        coords = torch.as_tensor(coords, dtype=torch.int32,
                                 device=self.device)
        if self._tracer is not None:
            with self._tracer.span("serve.query",
                                   batch=int(coords.shape[0])):
                return self.decomp.values_at(coords)
        return self.decomp.values_at(coords)

    def top_k_for_user(self, user: int, k: int, *, user_mode: int = 0,
                       item_mode: int = 1):
        """``(scores (k,), items (k,))``: the k best items for one user,
        scored against ALL items via the factor matrices (item ids in the
        tensor's ORIGINAL label space)."""
        fn = self._topk_fns.get((user_mode, item_mode))
        if fn is None:
            from repro_torch.serve.queries import make_top_k_fn

            fn = make_top_k_fn(self.decomp, user_mode=user_mode,
                               item_mode=item_mode)
            self._topk_fns[(user_mode, item_mode)] = fn
        users = torch.tensor([int(user)], dtype=torch.int64,
                             device=self.device)
        if self._tracer is not None:
            with self._tracer.span("serve.top_k", k=int(k)):
                scores, items = fn(users, int(k))
        else:
            scores, items = fn(users, int(k))
        return scores[0], items[0]

    def benchmark(self, *, queries: int, batch: int, seed: int = 0) -> dict:
        """Timed random-coordinate query loop: uniform coordinates over the
        handle's dims (drawn with numpy from ``seed`` and moved to the
        device before timing), one warm-up batch, then ``queries``
        reconstructions in ``batch``-sized calls.

        Throughput (``serve_s``/``qps``) comes from the asynchronous loop:
        one device synchronisation at its end, so queries overlap.  Latency
        is a separate, smaller probe with a synchronisation after every
        batch (up to 64 batches), summarized as a histogram: ``latency_ms``
        carries mean/p50/p90/p99, and the observations feed the
        ``serve.query_ms`` histogram of the metrics registry."""
        rng = np.random.default_rng(seed)
        n_batches = max(1, queries // batch)
        # batch 0 is a dedicated warm-up batch, never timed
        coords = torch.as_tensor(np.stack(
            [rng.integers(0, d, (n_batches + 1, batch)) for d in self.dims],
            axis=-1).astype(np.int32), device=self.device)
        self.query(coords[0])
        _sync(self.device)
        t0 = time.perf_counter()
        for b in range(1, n_batches + 1):
            self.query(coords[b])
        _sync(self.device)
        serve_s = time.perf_counter() - t0

        hist = Histogram()
        registry_hist = get_registry().histogram("serve.query_ms")
        for b in range(1, min(n_batches, _LATENCY_SAMPLE_BATCHES) + 1):
            t1 = time.perf_counter()
            self.query(coords[b])
            _sync(self.device)
            dt_ms = (time.perf_counter() - t1) * 1e3
            hist.observe(dt_ms)
            registry_hist.observe(dt_ms)
        qps = n_batches * batch / max(serve_s, 1e-9)
        get_registry().gauge("serve.qps").set(qps)
        return {"serve_s": serve_s, "queries": n_batches * batch,
                "qps": qps, "latency_ms": hist.summary()}

    @property
    def fit(self) -> float:
        return float(self.decomp.fit)


class Session:
    """Lazy, cached, resumable pipeline over one :class:`RunConfig`.

    ``tensor`` optionally hands in-memory data to a config whose ``data``
    section names no source: a :class:`~repro_torch.core.coo.SparseTensor`,
    or an already-built :class:`~repro_torch.ingest.Ingested` handle, which
    becomes the ingest stage as-is (its reorder/cache/tile choices win over
    ``data``'s), so several sessions share one ingest.

    ``device``: where the tensor, workspaces and factors live.  None means
    the in-memory tensor's device, else the CUDA card (raising without
    one); ``"cpu"`` asks for the CPU."""

    def __init__(self, cfg: RunConfig, tensor=None, *,
                 device: DeviceLike = None):
        if not isinstance(cfg, RunConfig):
            raise TypeError(
                f"Session wants a RunConfig, got {type(cfg).__name__}")
        if tensor is not None and (cfg.data.source or cfg.data.dataset):
            raise ValueError(
                "data.source: config already names a data source; drop it "
                "to pass an in-memory tensor")
        self.cfg = cfg
        self.device = self._resolve_device(tensor, device)
        self._tensor = tensor
        self._tracer = None
        self._recorder = None
        self._exposition = None
        self._heartbeat = None
        self._stage_name = None
        self._ing = None
        self._plan = None
        self._plan_done = False
        self._result = None
        self._handle = None
        self._server = None
        self._mesh = None
        self._own_group = False
        self._monitor = None
        self._ckpt_mgr = None
        self._resume_state = None
        self._resume_checked = False

    @staticmethod
    def _resolve_device(tensor, device: DeviceLike) -> torch.device:
        if tensor is None:
            return resolve_device(device)
        from repro_torch.ingest import Ingested

        own = (tensor.tensor if isinstance(tensor, Ingested)
               else tensor).device
        if device is None:
            return own
        dev = torch.device(device)
        if isinstance(tensor, Ingested) and own.type != dev.type:
            raise ValueError(
                f"the Ingested handle lives on {own}, the session was asked "
                f"for {dev}; ingest onto {dev} instead")
        return dev

    @classmethod
    def from_config(cls, cfg: RunConfig, tensor=None, *,
                    device: DeviceLike = None) -> "Session":
        return cls(cfg, tensor=tensor, device=device)

    def synchronize(self) -> None:
        """Wait for the work queued on the session's device (the card runs
        asynchronously; a no-op on the CPU)."""
        _sync(self.device)

    # -- observability -----------------------------------------------------
    def tracer(self):
        """The session's one :class:`repro_torch.obs.Tracer` (lazy; None
        with ``obs.enabled=false``): every stage runs with it active, so
        spans from ingest/plan/fit/serve all land in one trace."""
        if self._tracer is None and self.cfg.obs.enabled:
            from repro_torch.obs import Tracer

            o = self.cfg.obs
            self._tracer = Tracer(sample_rate=o.sample_rate,
                                  routines=o.routines,
                                  xla_annotations=o.xla_annotations)
        return self._tracer

    def recorder(self):
        """The session's flight recorder (lazy; None with obs off), active
        during every stage, so instrumented modules' ``record_event`` calls
        land in its ring."""
        if self._recorder is None and self.cfg.obs.enabled:
            from repro_torch.obs.recorder import FlightRecorder

            self._recorder = FlightRecorder(
                capacity=self.cfg.obs.events_buffer)
        return self._recorder

    def exposition(self):
        """The live ``/metrics`` + ``/healthz`` + ``/trace`` endpoint on
        127.0.0.1 (started on first access when ``obs.http_port`` is set;
        None otherwise).  ``http_port=0`` binds an ephemeral port: read it
        back from ``session.exposition().port``."""
        if self._exposition is None and self.cfg.obs.http_port is not None:
            from repro_torch.obs.exposition import ExpositionServer

            tracer = self.tracer()
            self._exposition = ExpositionServer(
                self.cfg.obs.http_port,
                events_fn=tracer.events if tracer is not None else None,
                info_fn=lambda: {"stage": self._stage_name,
                                 "run": self.cfg.summary()},
            ).start()
        return self._exposition

    def _start_live(self):
        """Bring up the live surfaces configured in ``obs``: the HTTP
        exposition endpoint and the heartbeat writer (both no-ops when
        their fields are unset)."""
        self.exposition()
        if self._heartbeat is None and self.cfg.obs.heartbeat_s > 0:
            from repro_torch.obs.recorder import Heartbeat

            self._heartbeat = Heartbeat(
                self.cfg.obs.trace_dir, self.cfg.obs.heartbeat_s,
                registry_fn=lambda: get_registry().snapshot(),
                recorder=self.recorder(),
                info_fn=lambda: {"stage": self._stage_name}).start()

    def close(self):
        """Drain and stop the decomposition server, stop the live surfaces
        (the heartbeat flushes a final snapshot; the exposition socket
        closes), and end the process group if this session started it.
        Idempotent; the threads are daemons, so an unclosed session still
        exits cleanly."""
        if self._server is not None:
            self._server.close()
            self._server = None
        if self._own_group:
            import torch.distributed as dist

            dist.destroy_process_group()
            self._own_group = False
            self._mesh = None
        if self._heartbeat is not None:
            self._heartbeat.stop()
            self._heartbeat = None
        if self._exposition is not None:
            self._exposition.stop()
            self._exposition = None

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    @contextmanager
    def _stage(self, name: str):
        """Activate the session tracer + flight recorder and open a
        ``stage.<name>`` span around one pipeline stage (a no-op when obs
        is disabled: zero tracer traffic)."""
        tracer = self.tracer()
        if tracer is None:
            yield
            return
        recorder = self.recorder()
        prev, self._stage_name = self._stage_name, name
        try:
            with tracer.activate(), recorder.activate(), \
                    tracer.span(f"stage.{name}"):
                yield
        finally:
            self._stage_name = prev

    def export_obs(self):
        """Write ``trace.jsonl`` + ``metrics.json`` (+ ``events.jsonl``
        when the flight recorder saw traffic, + ``metrics-aggregated.json``
        when per-host snapshots exist) under ``obs.trace_dir``; called
        after fit and after serve benchmarks.  Returns the trace path, or
        None when no trace dir is configured."""
        tracer = self.tracer()
        if tracer is None or not self.cfg.obs.trace_dir:
            return None
        from pathlib import Path

        from repro_torch.obs.aggregate import aggregate_dir
        from repro_torch.obs.recorder import EVENTS_FILENAME
        from repro_torch.obs.trace import METRICS_FILENAME, TRACE_FILENAME

        d = Path(self.cfg.obs.trace_dir)
        path = tracer.export_jsonl(d / TRACE_FILENAME)
        (d / METRICS_FILENAME).write_text(get_registry().to_json())
        recorder = self.recorder()
        if recorder is not None and recorder.recorded:
            recorder.export_jsonl(d / EVENTS_FILENAME)
        aggregate_dir(d, write=True)
        return path

    # -- stage 1: ingest ---------------------------------------------------
    def load_tensor(self):
        """The raw tensor (before ingest options): the in-memory one, the
        synthetic paper replica drawn on the session's device from
        ``data.seed``, or the file source read by the ingest reader."""
        from repro_torch.core import paper_dataset
        from repro_torch.ingest import reader

        d = self.cfg.data
        if self._tensor is not None:
            return self._tensor
        if d.dataset is not None:
            self._tensor = paper_dataset(d.dataset, d.seed, scale=d.scale,
                                         device=self.device)
            return self._tensor
        if d.source is None:
            raise ValueError(
                "data.source: config names no data (no source, no dataset) "
                "and no in-memory tensor was passed to Session")
        self._tensor = reader.read_any(d.source, dims=d.dims,
                                       duplicates=d.duplicates,
                                       device=self.device)
        return self._tensor

    def ingest(self):
        """The :class:`~repro_torch.ingest.Ingested` handle (cached):
        relabeled tensor + per-mode stats + (possibly cache-warm)
        workspaces.  A pre-built handle passed in is adopted as-is."""
        if self._ing is None:
            from repro_torch.ingest import Ingested, ingest

            if isinstance(self._tensor, Ingested):
                self._ing = self._tensor
                return self._ing
            d = self.cfg.data
            x = d.source if (d.source and self._tensor is None) \
                else self.load_tensor()
            with self._stage("ingest"):
                self._ing = ingest(x, reorder=d.reorder, compact=d.compact,
                                   cache=d.cache, tile=d.tile, dims=d.dims,
                                   duplicates=d.duplicates, seed=d.seed,
                                   device=self.device)
        return self._ing

    def chunk_source(self):
        """What the streaming executor folds: the file path itself when the
        data is on disk with no ingest transforms (never one COO in
        memory), else the tensor or the ingested handle.  A non-default
        duplicates policy also forces the ingest path: chunk folds sum
        scatter contributions, which IS "sum" but cannot "keep" or
        "error"."""
        d = self.cfg.data
        if d.reorder == "identity" and not d.compact:
            if (d.source is not None and self._tensor is None
                    and d.duplicates == "sum"):
                return d.source
            if isinstance(self._tensor, SparseTensor):
                return self._tensor
        return self.ingest()

    # -- stage 2: plan -----------------------------------------------------
    def plan(self):
        """The per-mode :class:`~repro_torch.plan.DecompPlan` (cached),
        scored against the method's kernel registry at the method's rank
        (Kronecker widths for the ttmc kernel).  Streaming methods fold
        unsorted chunks and never execute a per-mode plan: None."""
        if self._plan_done:
            return self._plan
        from repro_torch.methods import get_method

        cfg = self.cfg
        spec = get_method(cfg.method.name)
        if spec.supports_streaming:
            # streaming folds unsorted chunks through gather_scatter only:
            # a pinned policy, a calibration pass, or an allow set that
            # excludes gather_scatter cannot be honored, so reject it
            if (cfg.plan.policy not in ("auto", "gather_scatter")
                    or cfg.plan.calibrate
                    or (cfg.plan.allow is not None
                        and "gather_scatter" not in cfg.plan.allow)):
                from .config import ConfigError

                raise ConfigError(
                    f"plan.policy: streaming method {cfg.method.name!r} "
                    f"executes gather_scatter chunk folds only (no sorted "
                    f"workspace is ever built) — drop the pinned policy/"
                    f"calibration or pick a batch method")
            self._plan, self._plan_done = None, True
            return None
        ing = self.ingest()
        allow = cfg.plan.allow
        if cfg.exec.executor == "dist":
            # restrict candidates to what the iteration body expresses: the
            # ONE set core.distributed declares, not a private copy; an
            # allow entry the body cannot express is rejected, never
            # silently filtered (the user believed it was a candidate)
            from repro_torch.core.distributed import DIST_IMPLS

            inexpressible = tuple(a for a in (allow or ())
                                  if a not in DIST_IMPLS)
            if inexpressible:
                from .config import ConfigError

                raise ConfigError(
                    f"plan.allow: {inexpressible} cannot execute under the "
                    f"dist executor; the iteration body expresses only "
                    f"{DIST_IMPLS}")
            allow = allow or DIST_IMPLS
        factor_ranks = None
        if spec.kernel == "ttmc":
            from repro_torch.methods.tucker_hooi import (_kron_widths,
                                                         _resolve_ranks)

            factor_ranks = _resolve_ranks(cfg.method.rank, ing.dims)
            rank = _kron_widths(factor_ranks)
        else:
            rank = cfg.method.rank
        with self._stage("plan"):
            self._plan = ing.plan(cfg.plan.policy, rank=rank,
                                  kernel=spec.kernel,
                                  backend=cfg.plan.backend,
                                  allow=allow,
                                  calibrate=cfg.plan.calibrate,
                                  factor_ranks=factor_ranks,
                                  recalibrate=cfg.plan.recalibrate)
        rec = self.recorder()
        if rec is not None:
            rec.record("plan", policy=cfg.plan.policy,
                       impls=list(self._plan.impls),
                       calibrated=cfg.plan.calibrate)
        self._plan_done = True
        return self._plan

    def plan_report(self) -> str:
        """The human-readable per-mode planner table, with a provenance
        footer surfacing the ingest-cache and autotune hit/miss counters
        behind this session's plan."""
        from repro_torch.utils.report import plan_report

        plan = self.plan()
        if plan is None:
            return (f"# method={self.cfg.method.name}: chunked "
                    "gather_scatter fold, no per-mode plan")
        return plan_report(plan, reorder_deltas=self.ingest().reorder_deltas(),
                           method=self.cfg.method.name,
                           provenance=self._plan_provenance())

    def _plan_provenance(self) -> dict:
        """Cache provenance for the plan_report footer: whether this
        ingest was warm, and the per-store hit/miss counters."""
        ing = self.ingest()
        prov = {"cache_hit": ing.cache_hit}
        if ing.cache is not None:
            prov["ingest"] = {"hits": ing.cache.hits,
                              "misses": ing.cache.misses}
            store = ing.cache.autotune
            prov["autotune"] = {"hits": store.hits, "misses": store.misses}
        return prov

    # -- stage 3: fit ------------------------------------------------------
    def fit(self, *, force: bool = False):
        """The decomposition, computed by the configured executor (cached;
        ``force=True`` re-runs).

        With ``obs.trace_dir`` set, an unhandled executor exception leaves a
        ``crash.json`` postmortem (traceback + config + metrics + flight
        recorder tail) before re-raising."""
        if self._result is None or force:
            ex = get_executor(self.cfg.exec.executor)
            require_capability(self.cfg.method.name, ex.name)
            self._start_live()
            try:
                with self._stage("fit"):
                    self._result = ex.fn(self)
            except Exception as exc:
                self._write_crash_dump(exc)
                raise
            self.export_obs()
        return self._result

    def _write_crash_dump(self, exc: BaseException):
        if not self.cfg.obs.trace_dir:
            return None
        from repro_torch.obs.recorder import write_crash_dump

        return write_crash_dump(self.cfg.obs.trace_dir, exc,
                                recorder=self.recorder(),
                                metrics=get_registry().snapshot(),
                                config=self.cfg.to_dict(),
                                stage="fit")

    # -- stage 4: serve ----------------------------------------------------
    def serve_handle(self) -> ServeHandle:
        """Batched-query handle over the fitted decomposition (runs the fit
        if it has not happened yet; cached like every other stage)."""
        if self._handle is None or self._handle.decomp is not self._result:
            dec = self.fit()
            if self._ing is not None:
                dims = self._ing.original_dims
            else:  # streaming straight off a path: dims from factor rows
                dims = tuple(int(f.shape[0]) for f in dec.factors)
            self._handle = ServeHandle(dec, tuple(dims),
                                       tracer=self.tracer())
        return self._handle

    def decomp_server(self):
        """The continuous-batching multi-tenant server
        (:class:`repro_torch.serve.DecompServer`, cached), configured from
        the ``serve`` section with this session's fit published under every
        ``serve.tenants`` id.  Runs fit if needed; ``close()`` drains and
        stops it."""
        if self._server is None:
            from repro_torch.serve import DecompServer

            handle = self.serve_handle()  # fit + original-label dims
            self._server = DecompServer.from_config(self.cfg.serve)
            self._stage_name = "serve"
            for tenant in self.cfg.serve.tenants:
                self._server.publish(tenant, handle.decomp, handle.dims)
            self._start_live()
        return self._server

    # -- executor plumbing (consumed by repro_torch.api.executor) ----------
    def method_generator(self) -> torch.Generator:
        """The factor-init generator: a fresh ``torch.Generator`` on the
        session's device seeded with ``method.seed``.  Fresh on every call,
        because a generator's state advances as it draws: a re-fit of the
        same session must draw the same initial factors (the JAX package's
        cached key is immutable; a cached generator would not be)."""
        return torch.Generator(device=self.device).manual_seed(
            int(self.cfg.method.seed))

    def mesh(self):
        """The dist executor's rank grid (cached): ``exec.mesh_shape``
        verbatim, else every rank of the world on the 'data' axis.  It
        lives on the process group that exists; else, under ``torchrun``,
        one set up from the environment; else a one-rank group this session
        starts (and ``close()`` ends): NCCL for a CUDA session, gloo for a
        CPU one.  ``exec.multi_pod`` without ``mesh_shape`` asks for the
        reference's production pod mesh, which belongs to the LM substrate
        (ROADMAP.md queue 1, item 10), and raises."""
        if self._mesh is None:
            import torch.distributed as dist

            from repro_torch.dist.collectives import (init_process_group_for,
                                                      make_mesh)

            shape = self.cfg.exec.mesh_shape
            if shape is None and self.cfg.exec.multi_pod:
                from .config import ConfigError

                raise ConfigError(
                    "exec.multi_pod: the production pod mesh is part of the "
                    "LM substrate, not ported (ROADMAP.md queue 1, item "
                    "10); give exec.mesh_shape, e.g. {'pod': 2, 'data': 2, "
                    "'model': 1}")
            self._own_group = init_process_group_for(self.device)
            if shape is None:
                shape = {"data": dist.get_world_size(), "model": 1}
            self._mesh = make_mesh(tuple(shape.values()), tuple(shape))
        return self._mesh

    def monitor(self):
        """The per-iteration StragglerMonitor, when configured."""
        if self._monitor is None and self.cfg.exec.monitor:
            from repro_torch.dist import StragglerMonitor

            e = self.cfg.exec
            self._monitor = StragglerMonitor(window=e.monitor_window,
                                             threshold=e.monitor_threshold,
                                             patience=e.monitor_patience)
        return self._monitor

    def checkpoint_manager(self):
        if self._ckpt_mgr is None and self.cfg.exec.checkpoint_dir:
            from repro_torch.checkpoint import CheckpointManager

            self._ckpt_mgr = CheckpointManager(self.cfg.exec.checkpoint_dir,
                                               async_save=False)
        return self._ckpt_mgr

    def checkpoint_cb(self):
        """The fit's checkpoint callback: every ``checkpoint_every``-th
        :class:`DecompState` goes through the manager's atomic save."""
        mgr = self.checkpoint_manager()
        if mgr is None:
            return None
        every = self.cfg.exec.checkpoint_every
        extra = {"method": self.cfg.method.name,
                 "rank": self._rank_record(), "seed": self.cfg.method.seed}

        def cb(state):
            it = int(state.iteration)
            if it % every == 0:
                mgr.save(it, state, extra=dict(extra))
        return cb

    def _rank_record(self):
        """JSON-safe rank for checkpoint provenance (tuples become lists)."""
        r = self.cfg.method.rank
        return list(r) if isinstance(r, tuple) else r

    def resume_state(self):
        """The latest complete checkpointed :class:`DecompState` under
        ``exec.checkpoint_dir`` (None when absent), restored onto the
        session's device: what makes a re-created Session continue a
        killed fit."""
        if self._resume_checked:
            return self._resume_state
        self._resume_checked = True
        mgr = self.checkpoint_manager()
        if mgr is None or mgr.latest_step() is None:
            return None
        step = mgr.latest_step()
        # validate provenance BEFORE the structural restore: a foreign
        # method's state has a different structure and would fail with an
        # opaque leaf-count error instead of this one
        extra = mgr.read_extra(step)
        if extra.get("method") not in (None, self.cfg.method.name):
            raise ValueError(
                f"exec.checkpoint_dir: checkpoint at step {extra['step']} "
                f"was written by method {extra['method']!r}, config says "
                f"{self.cfg.method.name!r}")
        # rank/seed mismatches would resume into a silently wrong result
        for field, want in (("rank", self._rank_record()),
                            ("seed", self.cfg.method.seed)):
            have = extra.get(field)
            if have is not None and have != want:
                raise ValueError(
                    f"exec.checkpoint_dir: checkpoint at step "
                    f"{extra['step']} was written with method.{field}="
                    f"{have!r}, config says {want!r}")
        state, _ = mgr.restore(self._blank_state(), step=step)
        self._resume_state = state
        return state

    def _blank_state(self):
        """A structure-only DecompState template for checkpoint restore:
        leaf shapes come from the checkpoint; each leaf's device (the
        session's) is where the restore puts it.  The aux key set is
        method knowledge, declared by ``MethodSpec.state_aux``."""
        from repro_torch.methods import DecompState, get_method

        d = self.cfg.data
        if self._ing is not None:
            order = len(self._ing.dims)
        elif hasattr(self._tensor, "order"):
            order = self._tensor.order
        elif d.dims is not None:
            order = len(d.dims)
        elif d.source is not None and self._tensor is None:
            from repro_torch.ingest.reader import open_chunk_source

            order = len(open_chunk_source(d.source, device=self.device).dims)
        else:
            order = len(self.ingest().dims)

        def z(dtype=torch.float32):
            return torch.zeros((), dtype=dtype, device=self.device)

        aux = {k: z() for k in get_method(self.cfg.method.name).state_aux}
        return DecompState(tuple(z() for _ in range(order)), aux, z(), z(),
                           z(torch.int32))


def run(cfg: RunConfig, tensor=None, *, device: DeviceLike = None):
    """One-shot: ``Session(cfg, tensor, device=device).fit()``."""
    return Session(cfg, tensor=tensor, device=device).fit()
