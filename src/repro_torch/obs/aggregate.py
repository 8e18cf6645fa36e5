"""Cross-host metrics aggregation.

Counterpart of ``repro.obs.aggregate``, with the same formats.

Each participating process dumps its registry with histogram windows
included (:func:`write_host_metrics` → ``metrics-<host>.json`` under the
trace dir); :func:`aggregate_dir` / :func:`merge_snapshots` fold those
per-host snapshots into one cluster view with fixed, documented
semantics:

* **counters sum** across hosts; the merged entry keeps a per-host
  ``hosts`` breakdown so a skewed host is visible in the merged view.
* **gauges keep per-host labels** — a last-write-wins scalar has no
  meaningful cross-host sum, so the merged entry's ``value`` is the
  last host's (sorted order) and ``hosts`` carries every host's value.
* **histogram windows merge**: exact ``count``/``total``/``min``/``max``
  combine exactly; the retained windows concatenate, truncate to the
  largest per-host ``window_size`` (keeping the most recent samples),
  and percentiles are recomputed over the merged window with the same
  nearest-rank rule as :class:`~repro_torch.obs.metrics.Histogram`.

A name carrying different instrument types on different hosts is a
schema bug, not something to paper over — it raises ``ValueError``
naming the metric and both types.
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Iterable, Optional

from .metrics import MetricsRegistry, window_percentile

HOST_METRICS_PATTERN = "metrics-*.json"
AGGREGATED_FILENAME = "metrics-aggregated.json"

_HOST_RE = re.compile(r"^metrics-(?P<host>.+)\.json$")


def host_metrics_filename(host: str) -> str:
    return f"metrics-{host}.json"


def write_host_metrics(directory, host: str, *,
                       registry: Optional[MetricsRegistry] = None,
                       snapshot: Optional[dict] = None) -> Path:
    """Dump one host's registry (windows included) as
    ``<dir>/metrics-<host>.json`` for later aggregation."""
    if snapshot is None:
        if registry is None:
            raise ValueError("need a registry or a snapshot to write")
        snapshot = registry.snapshot(with_window=True)
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / host_metrics_filename(host)
    path.write_text(json.dumps({"host": host, "metrics": snapshot},
                               indent=1, sort_keys=True))
    return path


def _merge_histograms(name: str, entries: dict[str, dict]) -> dict:
    merged_window: list[tuple[float, float]] = []
    count = 0
    total = 0.0
    lo: Optional[float] = None
    hi: Optional[float] = None
    window_size = 0
    hosts = {}
    for host in sorted(entries):
        entry = entries[host]
        count += int(entry.get("count", 0))
        total += float(entry.get("total", 0.0))
        e_min, e_max = entry.get("min"), entry.get("max")
        if e_min is not None:
            lo = e_min if lo is None else min(lo, e_min)
        if e_max is not None:
            hi = e_max if hi is None else max(hi, e_max)
        window = entry.get("window", [])
        window_size = max(window_size, int(entry.get("window_size",
                                                     len(window))))
        merged_window.extend(float(v) for v in window)
        hosts[host] = {"count": entry.get("count", 0),
                       "total": entry.get("total", 0.0)}
    # keep the most recent samples up to the largest per-host bound, so
    # the merged histogram honors the same retention contract
    if window_size and len(merged_window) > window_size:
        merged_window = merged_window[-window_size:]
    ordered = sorted(merged_window)
    return {
        "type": "histogram",
        "count": count,
        "total": total,
        "mean": (total / count) if count else None,
        "min": lo,
        "max": hi,
        "p50": window_percentile(ordered, 50),
        "p90": window_percentile(ordered, 90),
        "p99": window_percentile(ordered, 99),
        "window_size": window_size,
        "hosts": hosts,
    }


def merge_snapshots(snapshots: dict[str, dict]) -> dict:
    """Merge ``{host: registry_snapshot}`` into one cluster snapshot.

    See the module docstring for the per-instrument semantics.  Raises
    ``ValueError`` if a metric name maps to different instrument types
    on different hosts."""
    by_name: dict[str, dict[str, dict]] = {}
    types: dict[str, str] = {}
    for host in sorted(snapshots):
        for name, entry in snapshots[host].items():
            kind = entry.get("type")
            seen = types.setdefault(name, kind)
            if seen != kind:
                raise ValueError(
                    f"metric {name!r} is a {seen} on one host and a "
                    f"{kind} on {host!r}; refusing to merge")
            by_name.setdefault(name, {})[host] = entry

    merged: dict[str, dict] = {}
    for name in sorted(by_name):
        entries = by_name[name]
        kind = types[name]
        if kind == "counter":
            hosts = {h: entries[h].get("value", 0.0)
                     for h in sorted(entries)}
            merged[name] = {"type": "counter",
                            "value": sum(hosts.values()),
                            "hosts": hosts}
        elif kind == "gauge":
            hosts = {h: entries[h].get("value") for h in sorted(entries)}
            last = hosts[sorted(hosts)[-1]]
            merged[name] = {"type": "gauge", "value": last, "hosts": hosts}
        elif kind == "histogram":
            merged[name] = _merge_histograms(name, entries)
        else:
            merged[name] = {"type": kind,
                            "hosts": {h: entries[h]
                                      for h in sorted(entries)}}
    return merged


def load_host_metrics(path) -> tuple[str, dict]:
    """Read one ``metrics-<host>.json``; host comes from the payload,
    falling back to the filename."""
    path = Path(path)
    payload = json.loads(path.read_text())
    host = payload.get("host")
    if not host:
        match = _HOST_RE.match(path.name)
        host = match.group("host") if match else path.stem
    return host, payload.get("metrics", {})


def aggregate_dir(directory, *,
                  write: bool = False) -> Optional[dict]:
    """Merge every ``metrics-<host>.json`` under ``directory``.

    Returns the merged snapshot wrapped with the host list, or None when
    no per-host files exist (single-process runs: ``metrics.json`` is
    already the whole story).  ``write=True`` also persists the result
    as ``metrics-aggregated.json``."""
    directory = Path(directory)
    paths = sorted(directory.glob(HOST_METRICS_PATTERN))
    paths = [p for p in paths if p.name != AGGREGATED_FILENAME]
    if not paths:
        return None
    snapshots: dict[str, dict] = {}
    for path in paths:
        host, snapshot = load_host_metrics(path)
        snapshots[host] = snapshot
    merged = {"hosts": sorted(snapshots), "metrics": merge_snapshots(snapshots)}
    if write:
        out = directory / AGGREGATED_FILENAME
        out.write_text(json.dumps(merged, indent=1, sort_keys=True))
    return merged


def read_aggregated(directory) -> Optional[dict]:
    path = Path(directory) / AGGREGATED_FILENAME
    if not path.exists():
        return None
    return json.loads(path.read_text())


def merge_files(paths: Iterable) -> dict:
    """Merge an explicit list of per-host metric files (CLI helper)."""
    snapshots: dict[str, dict] = {}
    for path in paths:
        host, snapshot = load_host_metrics(path)
        snapshots[host] = snapshot
    return {"hosts": sorted(snapshots),
            "metrics": merge_snapshots(snapshots)}
