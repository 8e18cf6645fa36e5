"""The executor registry: local / distributed / streaming execution of a
registered decomposition method, selected by name and gated by the
capability flags the method's :class:`~repro_torch.methods.MethodSpec`
declares (counterpart of ``repro.api.executor``).

An :class:`ExecutorSpec` pairs an execution strategy with the ``MethodSpec``
flag it requires, and :func:`require_capability` is the ONE capability
gate: ``RunConfig`` construction and ``Session.fit`` raise the same error
with the same capability listing.

Each executor's ``fn`` consumes a :class:`~repro_torch.api.session.Session`
(the stage cache: ingested tensor, plan, checkpoint state) and returns a
decomposition with ``factors`` / ``fit`` / ``values_at``, the surface
``Session.serve_handle`` builds on.  ``dist`` runs
``repro_torch.core.distributed.dist_cp_als`` over the session's rank grid
(``Session.mesh``, a ``torch.distributed`` process group).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

# executor name -> the available_methods() filter keyword proving capability
_CAPABILITY_FILTER = {"supports_dist": "dist", "supports_streaming": "streaming"}


@dataclasses.dataclass(frozen=True)
class ExecutorSpec:
    """One execution strategy and the method capability it requires.

    requires: the :class:`~repro_torch.methods.MethodSpec` boolean attribute
              that must be True for a method to run under this executor
              (None = any method).
    """

    name: str
    fn: Callable[..., object]
    requires: Optional[str] = None
    description: str = ""


EXECUTORS: dict[str, ExecutorSpec] = {}


def register_executor(spec: ExecutorSpec) -> ExecutorSpec:
    """Add (or replace) an executor in the registry."""
    if spec.requires is not None and spec.requires not in _CAPABILITY_FILTER:
        raise ValueError(
            f"executor {spec.name!r} requires unknown capability flag "
            f"{spec.requires!r}; one of {tuple(_CAPABILITY_FILTER)}")
    EXECUTORS[spec.name] = spec
    return spec


def get_executor(name: str) -> ExecutorSpec:
    try:
        return EXECUTORS[name]
    except KeyError:
        from .config import _suggest

        raise ValueError(
            f"unknown executor {name!r}; one of {tuple(EXECUTORS)}"
            + _suggest(name, EXECUTORS)) from None


def require_capability(method: str, executor: str):
    """THE capability gate: validate that ``method`` can run under
    ``executor``; returns the :class:`~repro_torch.methods.MethodSpec` on
    success, raises ValueError with the capability listing otherwise."""
    from repro_torch.methods import available_methods, get_method

    spec = get_method(method)
    ex = get_executor(executor)
    if ex.requires is not None and not getattr(spec, ex.requires):
        kw = _CAPABILITY_FILTER[ex.requires]
        capable = available_methods(**{kw: True})
        raise ValueError(
            f"method {method!r} cannot run under the {executor!r} executor "
            f"(MethodSpec.{ex.requires}=False); {executor}-capable methods: "
            f"{capable}.  Run it with executor='local' via repro_torch.api, "
            f"or repro_torch.methods.fit(..., method={method!r})")
    return spec


def executor_matrix() -> list[dict]:
    """Rows of (executor, requires, supported methods): what the CLI's
    ``--list-methods`` renders, sourced from the registries."""
    from repro_torch.methods import METHODS

    out = []
    for name, ex in EXECUTORS.items():
        methods = tuple(m for m in METHODS
                        if ex.requires is None
                        or getattr(METHODS[m], ex.requires))
        out.append({"executor": name, "requires": ex.requires or "-",
                    "methods": methods, "description": ex.description})
    return out


# ---------------------------------------------------------------------------
# the execution strategies
# ---------------------------------------------------------------------------


def _method_kwargs(session) -> dict:
    """Keywords shared by every strategy, from the session's RunConfig."""
    cfg = session.cfg
    kw = dict(cfg.method.options)
    kw.update(niters=cfg.method.niters, tol=cfg.method.tol,
              generator=session.method_generator(),
              state=session.resume_state(),
              checkpoint_cb=session.checkpoint_cb(),
              monitor=session.monitor())
    return kw


def _check_options(spec, options: dict) -> None:
    """Reject method options the registered implementation does not accept,
    with the field path and a nearest-name hint: a typo'd option must not
    surface as a raw TypeError from deep inside a fit.  The names listed
    are the port's (``generator``, not the JAX package's ``key``)."""
    import inspect

    params = inspect.signature(spec.fn).parameters
    if any(p.kind == p.VAR_KEYWORD for p in params.values()):
        return
    bad = sorted(set(options) - set(params))
    if bad:
        from .config import _suggest

        names = tuple(p for p in params
                      if p not in ("t", "source", "rank", "self"))
        raise ValueError(
            f"method.options: {bad} not accepted by method "
            f"{spec.name!r} (accepts {names})"
            + _suggest(bad[0], names))


def _run_local(session):
    """Single-process ``methods.fit`` over the planner/ingest stack."""
    from repro_torch.methods import fit

    cfg = session.cfg
    spec = require_capability(cfg.method.name, "local")
    if spec.supports_streaming:
        # a streaming-only method executes as chunk folds either way; going
        # through the streaming strategy (chunk_source) avoids building
        # per-mode CSF workspaces the fold would never touch
        return _run_streaming(session)
    if cfg.exec.n_chunks is not None:
        raise ValueError(
            f"exec.n_chunks: method {cfg.method.name!r} is a batch method "
            "and does not fold chunks; chunk geometry applies only to "
            "streaming-capable methods")
    _check_options(spec, cfg.method.options)
    return fit(session.ingest(), cfg.method.rank, method=cfg.method.name,
               plan=session.plan(), **_method_kwargs(session))


def _run_dist(session):
    """The medium-grained distributed driver (``core.distributed``) over
    the session's rank grid."""
    from repro_torch.core.cpals import CPDecomp
    from repro_torch.core.distributed import dist_cp_als

    cfg = session.cfg
    require_capability(cfg.method.name, "dist")
    if cfg.exec.checkpoint_dir is not None:
        raise ValueError(
            "exec.checkpoint_dir: the dist executor's iteration body has no "
            "mid-fit checkpoint hook; checkpoint/resume needs executor="
            "'local' or 'streaming'")
    if cfg.method.tol > 0.0:
        raise ValueError(
            "method.tol: the dist executor's iteration body runs a fixed "
            "iteration count (no early-stop hook); drop tol or use "
            "executor='local'")
    # dist_cp_als has no **kwargs sink: reject foreign method options with
    # the field path instead of letting a raw TypeError escape.  The
    # options are all the config adds to the keywords composed below.
    supported = {"niters", "generator", "monitor", "verbose", "init"}
    bad = sorted(set(cfg.method.options) - supported)
    if bad:
        raise ValueError(
            f"method.options: {bad} not supported by the dist executor "
            f"(dist_cp_als accepts only {sorted(supported)} from the "
            "method section)")
    # the grid first: under torchrun it puts this rank on its own card
    # before the tensor and the generator are made there
    mesh = session.mesh()
    kw = _method_kwargs(session)
    # the iteration body owns its loop: no mid-fit state/tol hooks
    # (state/checkpoint_cb are None here: checkpoint_dir was rejected
    # above, and tol > 0 too; tol = 0.0 is the default)
    for unsupported in ("state", "checkpoint_cb", "tol"):
        kw.pop(unsupported, None)
    factors, lam, fit = dist_cp_als(
        session.ingest(), cfg.method.rank, mesh,
        shard_c=cfg.exec.shard_c, mode_order=cfg.exec.mode_order,
        plan=session.plan(), method=cfg.method.name, **kw)
    _emit_host_metrics(session)
    return CPDecomp(factors=tuple(factors), lmbda=lam, fit=fit)


def _emit_host_metrics(session) -> None:
    """Drop this process's registry snapshot (histogram windows included)
    as ``metrics-<host>.json`` under ``obs.trace_dir``: the per-host half
    of cross-host aggregation; ``Session.export_obs`` folds every such
    file into ``metrics-aggregated.json``.  The host is keyed on the
    ``torch.distributed`` rank."""
    cfg = session.cfg
    if not (cfg.obs.enabled and cfg.obs.trace_dir):
        return
    import socket

    import torch.distributed as dist

    from repro_torch.obs.aggregate import write_host_metrics
    from repro_torch.obs.metrics import get_registry

    rank = dist.get_rank() if dist.is_initialized() else 0
    host = f"{socket.gethostname()}-p{rank}"
    write_host_metrics(cfg.obs.trace_dir, host, registry=get_registry())


def _run_streaming(session):
    """Chunked-fold execution straight off the chunk source: a ``.tnsb``
    memory map or a re-streamed ``.tns`` is never materialized as one COO;
    its chunks go to the session's device."""
    from repro_torch.methods import fit

    cfg = session.cfg
    spec = require_capability(cfg.method.name, "streaming")
    _check_options(spec, cfg.method.options)
    # for its validation side effect: a pinned plan policy / calibration
    # that chunk folds cannot honor raises here (returns None otherwise)
    session.plan()
    kw = _method_kwargs(session)
    kw.setdefault("chunk_nnz", cfg.exec.chunk_nnz)
    if cfg.exec.n_chunks is not None:
        kw.setdefault("n_chunks", cfg.exec.n_chunks)
    source = session.chunk_source()
    if not hasattr(source, "order"):  # a path: chunks land on the device
        kw.setdefault("device", session.device)
        if cfg.data.dims is not None:
            kw.setdefault("dims", cfg.data.dims)
    return fit(source, cfg.method.rank, method=cfg.method.name, **kw)


register_executor(ExecutorSpec(
    name="local", fn=_run_local, requires=None,
    description="single-process methods.fit over the planned workspaces"))
register_executor(ExecutorSpec(
    name="dist", fn=_run_dist, requires="supports_dist",
    description="medium-grained CP-ALS over a torch.distributed rank grid"))
register_executor(ExecutorSpec(
    name="streaming", fn=_run_streaming, requires="supports_streaming",
    description="chunked MTTKRP folds from an ingest.reader chunk source"))
