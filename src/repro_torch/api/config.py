"""Declarative run configuration: the one parameter surface for the stack.

Counterpart of ``repro.api.config``, field for field: the JSON schema is
the JAX package's (``tests/data/runconfig_golden.json``), so a config file
means the same run to either package.  What it validates against are the
port's registries (impls, methods, executors).  The device is not part of
the configuration: :class:`~repro_torch.api.Session` takes it.

A decomposition run is six frozen dataclasses composed into a
:class:`RunConfig`:

    RunConfig(
        data=DataConfig(source="data.tns", reorder="degree_sort",
                        cache=".cache/ingest"),
        plan=PlanConfig(policy="auto"),
        method=MethodConfig(name="cp_als", rank=35, niters=20),
        exec=ExecConfig(executor="local"),
        obs=ObsConfig(enabled=True, trace_dir="artifacts/trace"),
    )

Every field is validated at construction; a bad value raises
:class:`ConfigError` naming the offending field (``method.rank: ...``), and
an unknown key in :meth:`RunConfig.from_dict` is rejected with its full path
plus the nearest valid name.  ``to_dict``/``from_dict`` (and the JSON
convenience wrappers) round-trip bit-exactly:

    RunConfig.from_json(cfg.to_json()) == cfg

which is what makes a config file, a CLI invocation and a programmatic
``repro_torch.api.run(cfg)`` interchangeable descriptions of the same run.
"""
from __future__ import annotations

import dataclasses
import difflib
import json
from typing import Any, Optional, Sequence, Union


class ConfigError(ValueError):
    """A RunConfig field failed validation; the message names the field."""


def _suggest(name: str, candidates: Sequence[str]) -> str:
    """'; did you mean X?' when a close match exists, else ''."""
    close = difflib.get_close_matches(name, list(candidates), n=1, cutoff=0.5)
    return f"; did you mean {close[0]!r}?" if close else ""


def _err(section: str, field: str, msg: str) -> ConfigError:
    return ConfigError(f"{section}.{field}: {msg}")


def _require(cond: bool, section: str, field: str, msg: str) -> None:
    if not cond:
        raise _err(section, field, msg)


# ---------------------------------------------------------------------------
# the sections
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Where the tensor comes from and how it is ingested.

    Exactly one of ``source`` (a ``.tns``/``.tnsb`` path), ``dataset`` (a
    synthetic paper replica from ``repro_torch.core.PAPER_DATASETS``, scaled by
    ``scale``), or an in-memory tensor handed to
    :meth:`~repro_torch.api.Session.from_config` describes the bytes; the rest of
    the fields are the ``repro_torch.ingest`` options (reorder / compact / cache /
    tile geometry / reader hints)."""

    _section = "data"

    source: Optional[str] = None
    dataset: Optional[str] = None
    scale: float = 1.0
    seed: int = 0
    dims: Optional[tuple[int, ...]] = None
    duplicates: str = "sum"
    reorder: str = "identity"
    compact: bool = False
    cache: Optional[str] = None
    tile: tuple[int, int] = (512, 128)

    def __post_init__(self):
        from repro_torch.ingest import DUPLICATE_POLICIES, REORDERINGS

        _canon_field(self, "dims")
        _canon_field(self, "tile")
        s = self._section
        _require(not (self.source and self.dataset), s, "source",
                 "give either a file source or a synthetic dataset, not both")
        if self.dataset is not None:
            from repro_torch.core import PAPER_DATASETS

            _require(self.dataset in PAPER_DATASETS, s, "dataset",
                     f"unknown dataset {self.dataset!r}; one of "
                     f"{tuple(PAPER_DATASETS)}"
                     + _suggest(self.dataset, PAPER_DATASETS))
        _require(self.scale > 0.0, s, "scale",
                 f"must be > 0, got {self.scale}")
        _require(self.duplicates in DUPLICATE_POLICIES, s, "duplicates",
                 f"unknown policy {self.duplicates!r}; one of "
                 f"{tuple(DUPLICATE_POLICIES)}"
                 + _suggest(self.duplicates, DUPLICATE_POLICIES))
        _require(self.reorder in REORDERINGS, s, "reorder",
                 f"unknown reordering {self.reorder!r}; one of "
                 f"{tuple(REORDERINGS)}"
                 + _suggest(self.reorder, REORDERINGS))
        _require(len(self.tile) == 2
                 and all(int(v) > 0 for v in self.tile), s, "tile",
                 f"must be a positive (block, row_tile) pair, got {self.tile}")


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """Per-mode planner policy (``repro_torch.plan``).

    ``policy``: ``"auto"`` (cost-model argmin per mode) or a registered
    kernel-impl name that pins every mode.  ``calibrate`` replaces the cost
    models with measured timings on the actual tensor — persisted in the
    ingest cache's autotune store when ``data.cache`` is set, so only the
    first run times anything.  ``recalibrate`` is the escape hatch: force a
    fresh measured pass and overwrite the stored entry (requires
    ``calibrate``; the CLI's ``--recalibrate`` sets both).  ``allow``
    restricts the candidate set; ``backend`` overrides backend detection."""

    _section = "plan"

    policy: str = "auto"
    calibrate: bool = False
    recalibrate: bool = False
    backend: Optional[str] = None
    allow: Optional[tuple[str, ...]] = None

    def __post_init__(self):
        _canon_field(self, "allow")
        names = _known_impl_names()
        _require(self.policy == "auto" or self.policy in names,
                 self._section, "policy",
                 f"unknown impl {self.policy!r}; 'auto' or one of {names}"
                 + _impl_hint(self.policy, names))
        _require(not self.recalibrate or self.calibrate,
                 self._section, "recalibrate",
                 "requires plan.calibrate=true (a recalibration IS a "
                 "calibration run; the CLI's --recalibrate sets both)")
        if self.allow is not None:
            for a in self.allow:
                _require(a in names, self._section, "allow",
                         f"unknown impl {a!r}; one of {names}"
                         + _impl_hint(a, names))


def _known_impl_names() -> tuple[str, ...]:
    """Union of the port's kernel-impl registries (MTTKRP + TTMc)."""
    from repro_torch.core import REGISTRY, TTMC_REGISTRY

    return tuple(dict.fromkeys(list(REGISTRY) + list(TTMC_REGISTRY)))


# the JAX package's TPU kernel impls and the port's hand-written kernels
# that take their place
_TPU_IMPLS = {"pallas": "cuda", "linearized_pallas": "linearized_cuda"}


def _impl_hint(name: str, names: Sequence[str]) -> str:
    """The nearest-name hint, or for a TPU impl name the port's kernel."""
    if name in _TPU_IMPLS:
        return (f"; {name!r} is the JAX package's TPU kernel, the port's "
                f"hand-written one is {_TPU_IMPLS[name]!r}")
    return _suggest(name, names)


@dataclasses.dataclass(frozen=True)
class MethodConfig:
    """Which decomposition to compute (``repro_torch.methods`` registry).

    ``rank`` is an int for the CP family, an int or per-mode tuple for
    Tucker.  ``seed`` seeds the factor-init ``torch.Generator``.  ``options`` carries
    method-specific keywords (``decay=``, ``first_norm=``, ``timers=``, ...)
    forwarded verbatim to the registered implementation."""

    _section = "method"

    name: str = "cp_als"
    rank: Union[int, tuple[int, ...]] = 16
    niters: int = 20
    tol: float = 0.0
    seed: int = 0
    options: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        from repro_torch.methods import METHODS

        # canonicalize sequence-valued options to tuples so the JSON
        # round-trip (which can only carry lists) reproduces an EQUAL
        # config — the bit-exact contract covers option payloads too
        object.__setattr__(self, "options", _canon_options(self.options))
        _canon_field(self, "rank")
        s = self._section
        # options that shadow section-backed kwargs would be silently
        # overwritten at dispatch (the executor composes niters/tol/key/...
        # from the sections); reject the collision at construction
        reserved = _RESERVED_OPTIONS & set(self.options)
        _require(not reserved, s, "options",
                 f"{sorted(reserved)} collide with section-backed settings; "
                 "configure them via method.niters/method.tol/method.seed/"
                 "plan.policy/exec.* instead")
        _require(self.name in METHODS, s, "name",
                 f"unknown method {self.name!r}; one of {tuple(METHODS)}"
                 + _suggest(self.name, METHODS))
        ranks = self.rank if isinstance(self.rank, tuple) else (self.rank,)
        _require(len(ranks) > 0 and all(
            isinstance(r, int) and r > 0 for r in ranks), s, "rank",
            f"must be a positive int or tuple of positive ints, "
            f"got {self.rank!r}")
        _require(self.niters >= 1, s, "niters",
                 f"must be >= 1, got {self.niters}")
        _require(self.tol >= 0.0, s, "tol",
                 f"must be >= 0, got {self.tol}")


# method.options keys the executors compose from the config sections; a
# user option with one of these names would either be dropped or shadow
# the section value (n_chunks/chunk_nnz/dims are exec/data-section-owned).
# The JAX package's set, plus the port's "generator" (its "key")
_RESERVED_OPTIONS = {"rank", "method", "niters", "tol", "key", "generator",
                     "seed", "state", "checkpoint_cb", "monitor", "plan",
                     "impl", "n_chunks", "chunk_nnz", "dims"}


def _canon_field(cfg, name: str) -> None:
    """Frozen-dataclass field canonicalization: a list-valued sequence field
    (Python callers can pass lists; JSON always does) becomes the tuple the
    bit-exact round-trip contract compares against."""
    v = getattr(cfg, name)
    if isinstance(v, list):
        object.__setattr__(cfg, name,
                           tuple(tuple(e) if isinstance(e, list) else e
                                 for e in v))


def _canon_options(v):
    """Lists/tuples -> tuples, recursively through dicts (JSON-expressible
    payloads only; other values pass through untouched).  Dicts keep their
    object identity when nothing inside changed: options like
    ``{"timers": {}}`` are out-params whose reference the caller reads
    back after the fit."""
    if isinstance(v, (list, tuple)):
        return tuple(_canon_options(e) for e in v)
    if isinstance(v, dict):
        new = {k: _canon_options(e) for k, e in v.items()}
        return v if all(new[k] is v[k] for k in v) else new
    return v


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """How and where the method executes (``repro_torch.api.executor``
    registry).

    ``executor``: ``"local"`` (single-process ``methods.fit``), ``"dist"``
    (``core.distributed.dist_cp_als`` over a ``torch.distributed`` rank
    grid), or ``"streaming"`` (chunked folds from an ``ingest.reader``
    chunk source).
    ``mesh_shape``/``multi_pod``/``shard_c``/``mode_order`` belong to the
    dist executor.  ``monitor*`` configure the per-iteration
    :class:`repro_torch.dist.StragglerMonitor`; ``checkpoint_dir``/``_every``
    attach a :class:`repro_torch.checkpoint.CheckpointManager` so a killed
    fit resumes from its last complete
    :class:`repro_torch.methods.DecompState`."""

    _section = "exec"

    executor: str = "local"
    mesh_shape: Optional[dict] = None
    multi_pod: bool = False
    shard_c: bool = False
    mode_order: str = "natural"
    monitor: bool = False
    monitor_window: int = 8
    monitor_threshold: float = 1.5
    monitor_patience: int = 3
    chunk_nnz: int = 1 << 20
    n_chunks: Optional[int] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1

    def __post_init__(self):
        from .executor import EXECUTORS

        s = self._section
        _require(self.executor in EXECUTORS, s, "executor",
                 f"unknown executor {self.executor!r}; one of "
                 f"{tuple(EXECUTORS)}"
                 + _suggest(self.executor, EXECUTORS))
        _require(self.mode_order in ("natural", "auto"), s, "mode_order",
                 f"must be 'natural' or 'auto', got {self.mode_order!r}")
        if self.mesh_shape is not None:
            _require(all(isinstance(v, int) and v > 0
                         for v in self.mesh_shape.values()), s, "mesh_shape",
                     f"axis extents must be positive ints, "
                     f"got {self.mesh_shape}")
        _require(self.chunk_nnz > 0, s, "chunk_nnz",
                 f"must be > 0, got {self.chunk_nnz}")
        _require(self.n_chunks is None or self.n_chunks > 0, s, "n_chunks",
                 f"must be > 0, got {self.n_chunks}")
        _require(self.checkpoint_every >= 1, s, "checkpoint_every",
                 f"must be >= 1, got {self.checkpoint_every}")


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability (``repro_torch.obs``): structured tracing + metrics.

    ``enabled`` turns span recording on; the fit drivers stay on their
    plain path, and on the card each span carries its device time
    (``device_ms``, from CUDA events, with no synchronisation).  ``trace_dir``
    makes the Session export ``trace.jsonl`` (Chrome-trace/Perfetto JSONL;
    read it back with ``python -m repro_torch trace <dir>``) and
    ``metrics.json``
    there after fit/serve.  ``sample_rate`` keeps that fraction of root
    spans (deterministic stride).  ``routines`` picks the traced routine
    set: ``"fused"`` (sort/mttkrp/epilogue on the plain path, no sync,
    the default) or ``"split"`` (the paper's full Table III:
    ata/inverse/norm/fit on the timed path, one sync around each
    routine).  ``xla_annotations``
    (the JAX package's name, kept for the shared schema) mirrors spans into
    ``torch.profiler.record_function``, so they show up in a
    ``torch.profiler`` trace.

    The live half (phase 2): ``http_port`` starts the Prometheus
    exposition endpoint (``/metrics`` + ``/healthz`` + ``/trace``) on
    127.0.0.1 for the duration of fit/serve — 0 binds an ephemeral port,
    read back from ``Session.exposition.port``.  ``heartbeat_s`` > 0
    atomically rewrites ``<trace_dir>/heartbeat.json`` (metrics + recent
    events + stage) at that interval so a live or killed run can be
    inspected from the filesystem.  ``events_buffer`` bounds the flight
    recorder's event ring (the crash-dump / events.jsonl tail)."""

    _section = "obs"

    enabled: bool = False
    trace_dir: Optional[str] = None
    sample_rate: float = 1.0
    routines: str = "fused"
    xla_annotations: bool = True
    http_port: Optional[int] = None
    heartbeat_s: float = 0.0
    events_buffer: int = 1024

    def __post_init__(self):
        s = self._section
        _require(0.0 < self.sample_rate <= 1.0, s, "sample_rate",
                 f"must be in (0, 1], got {self.sample_rate}")
        _require(self.routines in ("fused", "split"), s, "routines",
                 f"must be 'fused' or 'split', got {self.routines!r}"
                 + _suggest(self.routines, ("fused", "split")))
        _require(self.trace_dir is None or self.enabled, s, "trace_dir",
                 "set obs.enabled=true to record a trace "
                 "(a trace_dir with tracing off would silently write "
                 "nothing)")
        if self.http_port is not None:
            _require(isinstance(self.http_port, int)
                     and 0 <= self.http_port <= 65535, s, "http_port",
                     f"must be a port in [0, 65535] (0 = ephemeral), "
                     f"got {self.http_port!r}")
            _require(self.enabled, s, "http_port",
                     "set obs.enabled=true to expose live metrics "
                     "(an endpoint over a disabled registry would serve "
                     "nothing)")
        _require(self.heartbeat_s >= 0.0, s, "heartbeat_s",
                 f"must be >= 0 (0 = off), got {self.heartbeat_s}")
        _require(self.heartbeat_s == 0.0 or self.trace_dir is not None,
                 s, "heartbeat_s",
                 "requires obs.trace_dir (heartbeat snapshots are "
                 "written under the trace directory)")
        _require(isinstance(self.events_buffer, int)
                 and self.events_buffer >= 1, s, "events_buffer",
                 f"must be >= 1, got {self.events_buffer!r}")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The serving layer: continuous batching + tenancy
    (``repro_torch.serve``, ``Session.decomp_server``, ``serve-daemon``).

    ``buckets`` are the padded batch sizes the worker coalesces into
    (strictly increasing; each bucket shape is captured exactly once, as
    a CUDA graph on the card, and anything larger than the last bucket is
    chunked).  ``max_wait_ms`` is the coalescing window measured from the
    first request in a batch: the latency a caller trades for batch fill.  ``workers`` is the
    number of batch-executing threads.  ``tenants`` names the models
    ``serve-daemon`` publishes from the session's fit; ``max_resident_mb``
    is the registry's LRU eviction budget over all resident models.
    ``port`` binds the daemon's HTTP frontend (0 = ephemeral, read back
    from ``ServeDaemon.port``; None = library use, no HTTP)."""

    _section = "serve"

    buckets: tuple[int, ...] = (16, 64, 256)
    max_wait_ms: float = 2.0
    workers: int = 1
    tenants: tuple[str, ...] = ("default",)
    max_resident_mb: float = 256.0
    port: Optional[int] = None

    def __post_init__(self):
        _canon_field(self, "buckets")
        _canon_field(self, "tenants")
        s = self._section
        _require(len(self.buckets) > 0, s, "buckets",
                 "need at least one batch bucket")
        _require(all(isinstance(b, int) and b > 0 for b in self.buckets),
                 s, "buckets",
                 f"bucket sizes must be positive ints, got {self.buckets}")
        _require(all(a < b for a, b in zip(self.buckets, self.buckets[1:])),
                 s, "buckets",
                 f"bucket sizes must be strictly increasing, "
                 f"got {self.buckets}")
        _require(self.max_wait_ms >= 0.0, s, "max_wait_ms",
                 f"must be >= 0 (0 = no coalescing wait), "
                 f"got {self.max_wait_ms}")
        _require(isinstance(self.workers, int) and self.workers >= 1,
                 s, "workers", f"must be >= 1, got {self.workers!r}")
        _require(len(self.tenants) > 0, s, "tenants",
                 "need at least one tenant id")
        _require(all(isinstance(t, str) and t for t in self.tenants),
                 s, "tenants",
                 f"tenant ids must be non-empty strings, got {self.tenants}")
        _require(len(set(self.tenants)) == len(self.tenants), s, "tenants",
                 f"tenant ids must be unique, got {self.tenants}")
        _require(self.max_resident_mb > 0, s, "max_resident_mb",
                 f"eviction budget must be > 0, got {self.max_resident_mb}")
        if self.port is not None:
            _require(isinstance(self.port, int) and 0 <= self.port <= 65535,
                     s, "port",
                     f"must be a port in [0, 65535] (0 = ephemeral), "
                     f"got {self.port!r}")


# ---------------------------------------------------------------------------
# composition + (de)serialization
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """The complete declarative description of one decomposition run."""

    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    plan: PlanConfig = dataclasses.field(default_factory=PlanConfig)
    method: MethodConfig = dataclasses.field(default_factory=MethodConfig)
    exec: ExecConfig = dataclasses.field(default_factory=ExecConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)

    def __post_init__(self):
        # the (method, executor) capability gate lives in exactly one place
        # (executor.require_capability); running it here means a bad combo
        # fails at RunConfig construction, not deep inside a fit
        from .executor import require_capability

        require_capability(self.method.name, self.exec.executor)

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        """Nested plain-python dict (tuples preserved; JSON-safe)."""
        return {name: dataclasses.asdict(getattr(self, name))
                for name in _SECTIONS}

    @classmethod
    def from_dict(cls, d: dict) -> "RunConfig":
        """Build + validate from a nested dict; unknown keys are rejected
        with their full path and a nearest-name suggestion."""
        if not isinstance(d, dict):
            raise ConfigError(f"RunConfig wants a dict, got {type(d).__name__}")
        kwargs = {}
        for k, v in d.items():
            if k not in _SECTIONS:
                raise ConfigError(
                    f"unknown section {k!r}; one of {tuple(_SECTIONS)}"
                    + _suggest(k, _SECTIONS))
            kwargs[k] = _build_section(_SECTIONS[k], v, path=k)
        return cls(**kwargs)

    def to_json(self, *, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "RunConfig":
        return cls.from_dict(json.loads(s))

    # -- convenience -------------------------------------------------------
    def replace(self, **kwargs) -> "RunConfig":
        """``dataclasses.replace`` over sections: ``cfg.replace(method=...)``."""
        return dataclasses.replace(self, **kwargs)

    def summary(self) -> str:
        src = (self.data.source or
               (f"{self.data.dataset}@{self.data.scale:g}"
                if self.data.dataset else "memory"))
        return (f"{self.method.name} rank={self.method.rank} "
                f"niters={self.method.niters} on {src} "
                f"[plan={self.plan.policy} exec={self.exec.executor}]")


_SECTIONS = {"data": DataConfig, "plan": PlanConfig,
             "method": MethodConfig, "exec": ExecConfig,
             "obs": ObsConfig, "serve": ServeConfig}


def _build_section(cls, d: Any, *, path: str):
    if not isinstance(d, dict):
        raise ConfigError(f"{path}: wants a mapping, got {type(d).__name__}")
    names = tuple(f.name for f in dataclasses.fields(cls))
    kwargs = {}
    for k, v in d.items():
        if k not in names:
            raise ConfigError(
                f"{path}.{k}: unknown key; {path} accepts {names}"
                + _suggest(k, names))
        # JSON lists become tuples in each section's __post_init__
        # (_canon_field / _canon_options) — no special casing here
        kwargs[k] = v
    try:
        return cls(**kwargs)
    except ConfigError:
        raise
    except TypeError as e:
        raise ConfigError(f"{path}: {e}") from None
