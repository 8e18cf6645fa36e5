"""Persistent autotune store: measured calibration outcomes that outlive
the process.

Counterpart of ``repro.plan.autotune``.  ``plan_decomposition(calibrate=
True)`` replaces the registry's declared cost models with per-impl kernel
(MTTKRP or TTMc) timings on the actual tensor.  The outcome is a pure
function of the tensor's bytes, the candidate set, the backend, the scored
rank and the workspace geometry, so this module keeps it on disk and a
warm plan makes **zero** timing runs:

* :func:`calibration_key`: sha256 over (tensor content key, mode, candidate
  names, backend, rank, kernel family, block/row_tile, a stats digest) plus
  :func:`registry_fingerprint`, a digest of every registered impl's
  declared capabilities.  Changing the registry changes the fingerprint,
  so measurements made against an older registry are never addressed
  again.  The port's registry differs from the JAX package's (``cuda`` in
  place of ``pallas``), so the two packages never share entries.
* :class:`AutotuneStore`: one small JSON per key under
  ``<root>/<key[:2]>/<key>.json``, written atomically (tmp + rename);
  ``hits``/``misses`` count lookups.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from pathlib import Path
from typing import Optional, Sequence, Union

from repro_torch.obs.metrics import get_registry
from repro_torch.obs.recorder import record_event

CALIBRATION_FORMAT_VERSION = 1


def canonical_candidates(names: Sequence[str]) -> tuple[str, ...]:
    """The one ordering of a candidate impl set, sorted by name: the
    calibration key and the planner's cost table both use it, and registry
    insertion order is never part of a cache identity."""
    return tuple(sorted(names))


def registry_fingerprint(kernel: str) -> str:
    """Digest of the kernel family's registry as declared: impl names plus
    every capability field of each impl."""
    from .planner import _kernel_registry

    registry = _kernel_registry(kernel)
    h = hashlib.sha256()
    h.update(f"calib-v{CALIBRATION_FORMAT_VERSION}|kernel={kernel}|".encode())
    for name in sorted(registry):
        s = registry[name]
        h.update(f"{name}|{s.layout}|{int(s.needs_sorted)}|"
                 f"{int(s.supports_order_gt3)}|{s.backend}|"
                 f"{int(s.benchmark_only)}|{int(s.oracle)}|".encode())
    return h.hexdigest()[:16]


def calibration_key(
    tensor_key: str,
    *,
    mode: int,
    names: Sequence[str],
    backend: str,
    rank: int,
    kernel: str = "mttkrp",
    block: int,
    row_tile: int,
    stats_digest: str = "",
) -> str:
    """sha256 key for one mode's measured cost table.  ``names`` is the
    candidate set that was measured (order-insensitive)."""
    h = hashlib.sha256()
    h.update(f"reg={registry_fingerprint(kernel)}|tensor={tensor_key}|"
             f"mode={mode}|names={','.join(canonical_candidates(names))}|"
             f"backend={backend}|rank={rank}|kernel={kernel}|"
             f"block={block}|row_tile={row_tile}|"
             f"stats={stats_digest}|".encode())
    return h.hexdigest()


@dataclasses.dataclass
class AutotuneStore:
    """Content-addressed store of measured calibration tables under ``root``.

    Each entry is one JSON file ``{"version", "costs": {impl: ms}, "meta",
    "measured_at"}``; writes are atomic (tmp file + ``os.replace``), so
    concurrent planners at worst re-measure, never read a torn entry."""

    root: Path
    hits: int = 0
    misses: int = 0

    def __init__(self, root: Union[str, os.PathLike]):
        self.root = Path(root)
        self.hits = 0
        self.misses = 0

    def _path(self, key: str) -> Path:
        return self.root / key[:2] / f"{key}.json"

    def has(self, key: str) -> bool:
        return self._path(key).exists()

    def load(self, key: str) -> Optional[dict]:
        """The stored ``{"costs": {impl: ms}, "meta": {...}}`` payload, or
        None on a miss or a version mismatch (whose file is removed).
        Counts hits and misses on the instance and in the obs metrics
        registry (``autotune.hit`` / ``autotune.miss``), with a ``cache``
        event each."""
        p = self._path(key)
        try:
            payload = json.loads(p.read_text())
        except (OSError, json.JSONDecodeError):
            self.misses += 1
            get_registry().counter("autotune.miss").inc()
            record_event("cache", store="autotune", key=key, hit=False)
            return None
        if payload.get("version") != CALIBRATION_FORMAT_VERSION:
            p.unlink(missing_ok=True)  # the next store() republishes it
            self.misses += 1
            get_registry().counter("autotune.miss").inc()
            record_event("cache", store="autotune", key=key, hit=False)
            return None
        self.hits += 1
        get_registry().counter("autotune.hit").inc()
        record_event("cache", store="autotune", key=key, hit=True)
        return payload

    def store(self, key: str, costs: dict, *,
              meta: Optional[dict] = None) -> None:
        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            "version": CALIBRATION_FORMAT_VERSION,
            "costs": {name: float(ms) for name, ms in costs.items()},
            "meta": dict(meta or {}),
            "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        }
        tmp = p.with_name(p.name + f".tmp{os.getpid()}")
        tmp.write_text(json.dumps(payload, indent=1))
        os.replace(tmp, p)


def as_store(x: Union[AutotuneStore, str, os.PathLike, None]
             ) -> Optional[AutotuneStore]:
    """An AutotuneStore passes through, a path roots a new one, None stays
    None."""
    if x is None or isinstance(x, AutotuneStore):
        return x
    return AutotuneStore(x)
