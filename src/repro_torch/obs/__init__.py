"""repro_torch.obs: structured observability, hierarchical spans and
metrics (counterpart of ``repro.obs``, the same names and file formats).

The paper's central artifact is a per-routine timing table (Table III:
sort / MTTKRP / inverse / normalization / fit).  This package is that
table as infrastructure: :mod:`repro_torch.obs.trace` records hierarchical
spans across ingest -> plan -> fit -> serve and exports Chrome-trace /
Perfetto-compatible JSONL; :mod:`repro_torch.obs.metrics` is a
process-local registry of counters, gauges and histograms (autotune
hits/misses, ingest cache warm/cold, straggler escalations, fit
trajectory, serve latency percentiles); :mod:`repro_torch.obs.report`
renders a recorded trace as the paper's Table-III-style per-routine
breakdown (``python -m repro_torch trace <dir>``).

The live half: :mod:`repro_torch.obs.exposition` renders the registry in
Prometheus text format and serves ``/metrics`` + ``/healthz`` + ``/trace``
from a stdlib-HTTP daemon thread on localhost (``ObsConfig.http_port``);
:mod:`repro_torch.obs.recorder` is a bounded ring-buffer flight recorder
of structured events with periodic heartbeat snapshots and crash dumps;
:mod:`repro_torch.obs.aggregate` merges per-host metrics snapshots
(counters sum, gauges keep host labels, histogram windows merge).

Only the tracer touches torch (its ``torch.profiler.record_function``
bridge, imported when an enabled tracer is made); the rest is plain
Python, so any module can feed it without import cycles.
"""
from .aggregate import aggregate_dir, merge_snapshots, write_host_metrics
from .exposition import ExpositionServer, render_prometheus
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry, scoped_registry)
from .recorder import (FlightRecorder, Heartbeat, current_recorder,
                       record_event, write_crash_dump)
from .trace import (Span, Tracer, current_tracer, read_trace, span, traced,
                    tracing)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "scoped_registry",
    "Span", "Tracer", "current_tracer", "read_trace", "span", "traced",
    "tracing",
    "ExpositionServer", "render_prometheus",
    "FlightRecorder", "Heartbeat", "current_recorder", "record_event",
    "write_crash_dump",
    "aggregate_dir", "merge_snapshots", "write_host_metrics",
]
