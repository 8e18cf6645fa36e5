"""The port's observability, ``repro_torch.obs``, alone and against the JAX
package's ``repro.obs``.

On its own terms (mirroring ``tests/test_obs.py`` and
``tests/test_live_obs.py``): span nesting, sampling, the Chrome-trace
schema, the profiler bridge, the metrics registry, the zero-traffic
disabled path (a fit with obs off makes no ``Tracer.span`` /
``Tracer._record`` call), the Session's trace and metrics export, the
Prometheus exposition on an ephemeral localhost port, the flight recorder,
heartbeats, crash dumps and cross-host aggregation.  Thread isolation is
checked with both threads alive at once, so their ids cannot be reused.

Against the reference: the same config gives the same span names and tree
(names, parents, attributes) in both packages, less the spans only the
port emits (``PORT_ONLY_SPANS``), and ``trace_report`` the
same routine rows (calls and per-mode impls; the times are each run's
own); the same registry renders the same Prometheus text.
"""
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from repro import api as japi
from repro.obs import report as jreport
from repro.obs import scoped_registry as jax_scoped_registry
from repro.obs.exposition import render_prometheus as jax_render
from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro_torch.api import (ConfigError, ExecConfig, MethodConfig,
                             ObsConfig, RunConfig, Session, cli)
from repro_torch.api.executor import EXECUTORS
from repro_torch.obs import (Counter, Gauge, Histogram, MetricsRegistry,
                             Tracer, current_tracer, get_registry,
                             read_trace, scoped_registry, span, traced,
                             tracing)
from repro_torch.obs.aggregate import (AGGREGATED_FILENAME, aggregate_dir,
                                       merge_files, merge_snapshots,
                                       write_host_metrics)
from repro_torch.obs.exposition import (ExpositionServer, render_prometheus,
                                        sanitize_metric_name)
from repro_torch.obs.metrics import window_percentile
from repro_torch.obs.recorder import (CRASH_FILENAME, EVENTS_FILENAME,
                                      HEARTBEAT_FILENAME, FlightRecorder,
                                      Heartbeat, current_recorder,
                                      record_event, write_crash_dump)
from repro_torch.obs.report import (format_breakdown, routine_breakdown,
                                    trace_report)
from repro_torch.obs.trace import (METRICS_FILENAME, PORT_ONLY_SPANS,
                                   TRACE_FILENAME)

from test_torch_helpers import both_tensors, np_coo, planted

DIMS = (10, 9, 8)


def lowrank():
    inds, vals = planted(DIMS, 3, 0)
    return both_tensors(inds, vals, DIMS)[1]


def traced_session(tmp_path, **obs_kw):
    obs_kw.setdefault("enabled", True)
    obs_kw.setdefault("trace_dir", str(tmp_path / "trace"))
    cfg = RunConfig(method=MethodConfig(rank=4, niters=3, seed=0),
                    obs=ObsConfig(**obs_kw))
    return Session(cfg, tensor=lowrank())


def http_json(url):
    return json.loads(urllib.request.urlopen(url, timeout=10).read())


# ---------------------------------------------------------------------------
# Tracer core
# ---------------------------------------------------------------------------

def test_span_nesting_parent_links():
    tracer = Tracer(xla_annotations=False)
    with tracer.activate():
        with span("outer"):
            with span("inner", mode=1):
                pass
        with span("sibling"):
            pass
    events = {e["name"]: e for e in tracer.events()}
    assert set(events) == {"outer", "inner", "sibling"}
    assert events["inner"]["args"]["parent"] == events["outer"]["args"]["id"]
    assert "parent" not in events["outer"]["args"]
    assert "parent" not in events["sibling"]["args"]
    assert events["inner"]["args"]["mode"] == 1
    assert events["inner"]["ts"] >= events["outer"]["ts"]
    assert events["inner"]["dur"] <= events["outer"]["dur"]


def test_no_active_tracer_is_inert():
    assert current_tracer() is None
    assert not tracing()
    with span("anything"):
        pass


def test_disabled_tracer_records_nothing():
    tracer = Tracer(enabled=False)
    with tracer.activate():
        assert not tracing()
        with tracer.span("x"):
            with span("y"):
                pass
    assert tracer.events() == []


def test_sample_rate_drops_whole_subtrees():
    tracer = Tracer(sample_rate=0.5, xla_annotations=False)
    with tracer.activate():
        for i in range(4):
            with span(f"root{i}"):
                with span("child"):
                    pass
    names = [e["name"] for e in tracer.events()]
    assert sorted(names) == ["child", "child", "root0", "root2"]


def test_tracer_validation():
    with pytest.raises(ValueError, match="sample_rate"):
        Tracer(sample_rate=0.0)
    with pytest.raises(ValueError, match="sample_rate"):
        Tracer(sample_rate=1.5)
    with pytest.raises(ValueError, match="routines"):
        Tracer(routines="both")


def test_traced_decorator():
    tracer = Tracer(xla_annotations=False)

    @traced("work.step", kind="unit-test")
    def step(x):
        return x + 1

    with tracer.activate():
        assert step(1) == 2
    (e,) = tracer.events()
    assert e["name"] == "work.step" and e["args"]["kind"] == "unit-test"
    assert step(1) == 2


def test_thread_isolation():
    """Two threads, both inside their root span at once (a barrier holds
    them), so their thread ids are distinct and each child links to its
    own thread's root."""
    tracer = Tracer(xla_annotations=False)
    barrier = threading.Barrier(2, timeout=30)

    def worker(i):
        with tracer.activate():  # threads start with a fresh context
            with tracer.span(f"root-t{i}"):
                barrier.wait()
                with tracer.span("child"):
                    pass
                barrier.wait()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    events = tracer.events()
    assert len(events) == 4
    roots = {e["name"]: e for e in events if e["name"].startswith("root")}
    children = [e for e in events if e["name"] == "child"]
    assert len(roots) == 2 and len(children) == 2
    for child in children:
        root = next(r for r in roots.values()
                    if r["args"]["id"] == child["args"]["parent"])
        assert child["tid"] == root["tid"]
    assert len({r["tid"] for r in roots.values()}) == 2


def test_export_jsonl_chrome_schema_roundtrip(tmp_path):
    tracer = Tracer(xla_annotations=False)
    with tracer.activate():
        with span("mttkrp", mode=0, impl="segment"):
            pass
    path = tracer.export_jsonl(tmp_path / "t" / TRACE_FILENAME)
    first = json.loads(path.read_text().splitlines()[0])
    assert first["ph"] == "M" and first["name"] == "process_name"
    events = read_trace(path)
    assert [e["ph"] for e in events] == ["M", "X"]
    x = events[1]
    for field in ("name", "cat", "ts", "dur", "pid", "tid", "args"):
        assert field in x
    assert x["name"] == "mttkrp" and x["args"]["impl"] == "segment"
    assert x["dur"] >= 0 and x["ts"] >= 0


def test_read_trace_skips_corrupt_lines(tmp_path):
    p = tmp_path / TRACE_FILENAME
    p.write_text('{"ph": "X", "name": "ok", "ts": 0, "dur": 1}\n'
                 "{not json}\n"
                 '["not", "a", "dict"]\n'
                 '{"no_ph": true}\n')
    assert [e["name"] for e in read_trace(p)] == ["ok"]


def test_clear_resets_events_and_epoch():
    tracer = Tracer(xla_annotations=False)
    with tracer.activate(), span("a"):
        pass
    tracer.clear()
    assert tracer.events() == []
    with tracer.activate(), span("b"):
        pass
    (e,) = tracer.events()
    assert e["ts"] < 1e6


def test_profiler_bridge_mirrors_spans_into_torch_profiler():
    """``xla_annotations`` (the shared schema's name) mirrors each span
    into ``torch.profiler.record_function``: the span's name shows up in a
    torch.profiler trace; with the switch off it does not."""
    for bridge in (True, False):
        tracer = Tracer(xla_annotations=bridge)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tracer.activate(), span("bridge.probe"):
                torch.ones(8) + 1
        names = {e.key for e in prof.key_averages()}
        assert ("bridge.probe" in names) == bridge
        assert [e["name"] for e in tracer.events()] == ["bridge.probe"]


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_counter_gauge_basics():
    c = Counter()
    assert c.inc() == 1.0 and c.inc(2.5) == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = Gauge()
    g.set(7)
    assert g.value == 7.0


def test_histogram_percentiles_and_window():
    h = Histogram()
    for v in range(1, 101):
        h.observe(v)
    s = h.summary()
    assert s["count"] == 100 and s["min"] == 1 and s["max"] == 100
    assert s["mean"] == pytest.approx(50.5)
    assert s["p50"] == 50 and s["p90"] == 90 and s["p99"] == 99
    assert Histogram().summary()["p50"] is None
    h = Histogram(window=4)
    for v in (1, 2, 3, 4, 100, 100, 100, 100):
        h.observe(v)
    assert h.percentile(50) == 100
    assert h.summary()["count"] == 8 and h.summary()["min"] == 1
    assert window_percentile([], 50) is None
    state = h.state()
    assert state["window"] == [100.0] * 4 and state["window_size"] == 4


def test_registry_type_conflict_and_scoping():
    r = MetricsRegistry()
    r.counter("x").inc()
    with pytest.raises(TypeError, match="asked for Gauge"):
        r.gauge("x")
    with scoped_registry() as r:
        assert get_registry() is r
        r.counter("a").inc(2)
        r.gauge("b").set(1.5)
        r.histogram("c").observe(10)
        snap = json.loads(r.to_json())
        assert snap["a"] == {"type": "counter", "value": 2.0}
        assert snap["b"] == {"type": "gauge", "value": 1.5}
        assert snap["c"]["type"] == "histogram" and snap["c"]["count"] == 1
    assert get_registry() is not r


# ---------------------------------------------------------------------------
# the disabled-path contract: a fit makes ZERO tracer calls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,rank", [("cp_als", 4), ("cp_nn_hals", 4),
                                         ("tucker_hooi", (3, 3, 3)),
                                         ("cp_als_streaming", 4)])
def test_fit_with_obs_disabled_makes_zero_tracer_calls(monkeypatch, tmp_path,
                                                       method, rank):
    from repro_torch.ingest import ingest
    from repro_torch.methods import fit as methods_fit

    calls = {"span": 0, "_record": 0}
    orig_span, orig_record = Tracer.span, Tracer._record

    def counting_span(self, *a, **k):
        calls["span"] += 1
        return orig_span(self, *a, **k)

    def counting_record(self, *a, **k):
        calls["_record"] += 1
        return orig_record(self, *a, **k)

    monkeypatch.setattr(Tracer, "span", counting_span)
    monkeypatch.setattr(Tracer, "_record", counting_record)
    t = lowrank()
    x = t if method == "cp_als_streaming" else ingest(
        t, reorder="degree_sort", cache=tmp_path / "c")
    result = methods_fit(x, rank, method=method, niters=2)
    assert float(result.fit) > 0
    sess = Session(RunConfig(method=MethodConfig(name=method, rank=rank,
                                                 niters=2)), tensor=t)
    sess.fit()
    assert sess.tracer() is None and sess.export_obs() is None
    assert calls == {"span": 0, "_record": 0}


# ---------------------------------------------------------------------------
# Session wiring: one trace across the pipeline
# ---------------------------------------------------------------------------

def test_session_fit_writes_trace_and_metrics(tmp_path):
    with scoped_registry():
        sess = traced_session(tmp_path)
        sess.fit()
        assert "# provenance:" in sess.plan_report()
    d = tmp_path / "trace"
    events = read_trace(d / TRACE_FILENAME)
    names = {e["name"] for e in events}
    assert {"stage.ingest", "stage.plan", "stage.fit", "fit.dispatch",
            "iteration", "mttkrp", "epilogue", "sort"} <= names
    iters = [e for e in events if e.get("name") == "iteration"]
    assert len(iters) == 3
    assert all(e["args"]["method"] == "cp_als" for e in iters)
    m = next(e for e in events if e.get("name") == "mttkrp")
    assert "impl" in m["args"] and "mode" in m["args"]
    metrics = json.loads((d / METRICS_FILENAME).read_text())
    assert metrics["fit.iterations"]["value"] == 3.0
    assert metrics["fit.iteration_ms"]["count"] == 3
    assert metrics["fit.fit"]["value"] == pytest.approx(
        float(sess.fit().fit))


def test_session_split_routines_trace(tmp_path):
    with scoped_registry():
        traced_session(tmp_path, routines="split").fit()
    names = {e["name"] for e in read_trace(tmp_path / "trace"
                                           / TRACE_FILENAME)}
    assert {"ata", "mttkrp", "inverse", "norm", "fit"} <= names
    assert "epilogue" not in names


def test_traced_fit_equals_untraced_fit(tmp_path):
    """Tracing leaves the fit on its plain path; its numbers are the
    untraced fit's, bit for bit."""
    with scoped_registry():
        traced = traced_session(tmp_path).fit()
    plain = Session(RunConfig(method=MethodConfig(rank=4, niters=3)),
                    tensor=lowrank()).fit()
    assert torch.equal(traced.fit, plain.fit)
    for a, b in zip(traced.factors, plain.factors):
        assert torch.equal(a, b)


PLAIN_PATH_CASES = [
    ("cp_als", 4, ("sort", "sort.build", "sort.streams", "mttkrp",
                   "epilogue")),
    ("cp_nn_hals", 4, ("sort", "sort.build", "sort.streams", "mttkrp",
                       "epilogue")),
    ("tucker_hooi", (3, 3, 3), ("sort.build", "sort.streams", "ttmc", "svd",
                                "fit")),
]


@pytest.mark.parametrize("method,rank,names", PLAIN_PATH_CASES)
def test_traced_fit_adds_no_synchronisation(monkeypatch, method, rank,
                                            names):
    """Under the default routines a traced fit stays on the plain path:
    ``core.cpals._sync`` is never called, the routine spans are there (one
    ``mttkrp`` or ``ttmc`` a mode an iteration) and the result is the
    untraced fit's, bit for bit.  ``routines="split"`` and an explicit
    ``timers=`` still take the synchronised path."""
    from repro_torch.core import cpals
    from repro_torch.methods import fit as methods_fit

    syncs = []
    real_sync = cpals._sync

    def counting_sync():
        syncs.append(None)
        real_sync()

    monkeypatch.setattr(cpals, "_sync", counting_sync)
    t = lowrank()
    plain = methods_fit(t, rank, method=method, niters=2)
    tracer = Tracer(xla_annotations=False)
    with tracer.activate():
        traced = methods_fit(t, rank, method=method, niters=2)
    assert syncs == []
    seen = [e["name"] for e in tracer.events()]
    assert set(names) <= set(seen)
    kernel = "ttmc" if method == "tucker_hooi" else "mttkrp"
    assert seen.count(kernel) == len(DIMS) * 2
    assert torch.equal(traced.fit, plain.fit)
    for a, b in zip(traced.factors, plain.factors):
        assert torch.equal(a, b)
    for routines, timers in (("split", None), ("fused", {})):
        syncs.clear()
        tracer = Tracer(xla_annotations=False, routines=routines)
        with tracer.activate():
            methods_fit(t, rank, method=method, niters=2, timers=timers)
        assert syncs
        assert {e["name"] for e in tracer.events()} >= set(names) - {
            "epilogue"}


class _StubEvent:
    """Stands in for ``torch.cuda.Event``: each ``record`` takes the next
    tick of a shared clock, ``elapsed_time`` counts the ticks between two
    records, ``query`` says whether the card has passed the event (as
    ``ready`` is set), and every construction and wait is logged."""

    log: list = []
    ticks = [0]
    ready = True

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None
        self.log.append("new")

    def record(self, stream=None):
        self.ticks[0] += 1
        self.at = self.ticks[0]

    def query(self):
        return self.ready

    def synchronize(self):
        self.log.append("synchronize")

    def elapsed_time(self, end):
        return float(end.at - self.at)


@pytest.mark.parametrize("ready", [True, False])
def test_span_device_ms_resolved_without_waiting_mid_fit(monkeypatch,
                                                         ready):
    """With CUDA in use (stubbed), every span records a pair of events and
    nothing waits for them during the fit.  Pairs the card has passed
    (``ready``) are read and reused mid-fit, so a fit makes a few events
    and not two a span; the rest are waited for once, by ``events()``.
    Every span gets ``device_ms``, an outer span's above its children's,
    and a second fit makes no new event."""
    from repro_torch.methods import fit as methods_fit

    _StubEvent.log.clear()
    waits = []
    monkeypatch.setattr(_StubEvent, "ready", ready)
    monkeypatch.setattr(torch.cuda, "Event", _StubEvent)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: waits.append(None))
    t = lowrank()
    tracer = Tracer(xla_annotations=False)
    with tracer.activate():
        methods_fit(t, 4, method="cp_als", niters=2)
    made = _StubEvent.log.count("new")
    assert "synchronize" not in _StubEvent.log and waits == []
    events = tracer.events()
    assert len(events) > 10
    if ready:
        assert made <= 10
        assert _StubEvent.log.count("synchronize") < len(events)
    else:
        assert made == 2 * len(events)
        assert _StubEvent.log.count("synchronize") == len(events)
    by_id = {e["args"]["id"]: e for e in events}
    for e in events:
        assert e["args"]["device_ms"] > 0
        parent = by_id.get(e["args"].get("parent"))
        if parent is not None:
            assert parent["args"]["device_ms"] > e["args"]["device_ms"]
    assert tracer.events() == events  # read once
    tracer.clear()
    with tracer.activate():
        methods_fit(t, 4, method="cp_als", niters=2)
    assert _StubEvent.log.count("new") == made
    assert all("device_ms" in e["args"] for e in tracer.events())


def test_span_without_cuda_has_no_device_ms():
    tracer = Tracer(xla_annotations=False)
    with tracer.activate(), span("host.only"):
        pass
    (e,) = tracer.events()
    assert "device_ms" not in e["args"]


def test_exported_spans_lie_on_the_profilers_clock(tmp_path):
    """The export's clock step (``epoch_unix_ns`` in its metadata, then
    ``profiler_offset_us``) puts every span inside the
    ``record_function`` range the bridge opened for it, to 50 us, and the
    spans' starts a median of less than 50 us after their ranges' (the
    bridge's own entry).  A wrong step would move them all.  The first
    fit under the profiler warms the bridge (its first range opens about
    a millisecond before the span's stamp) and is cleared."""
    from collections import defaultdict

    from repro_torch.methods import fit as methods_fit
    from repro_torch.obs.trace import profiler_offset_us

    tracer = Tracer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracer.activate():
            methods_fit(lowrank(), 4, method="cp_als", niters=2)
            tracer.clear()
            methods_fit(lowrank(), 4, method="cp_als", niters=2)
    events = read_trace(tracer.export_jsonl(tmp_path / TRACE_FILENAME))
    shift = profiler_offset_us(events[0]["args"]["epoch_unix_ns"], prof)
    ranges = defaultdict(list)
    for ev in prof.events():
        ranges[ev.name].append((ev.time_range.start, ev.time_range.end))
    spans = [e for e in events if e["ph"] == "X"]
    assert len(spans) >= 20
    lags = []
    for e in spans:
        start = e["ts"] + shift
        near = min(ranges[e["name"]], key=lambda r: abs(r[0] - start))
        assert near[0] - 50 <= start
        assert start + e["dur"] <= near[1] + 50
        lags.append(start - near[0])
    assert 0 <= sorted(lags)[len(lags) // 2] < 50


def test_serve_latency_histogram_and_qps_gauge(tmp_path):
    with scoped_registry() as registry:
        sess = traced_session(tmp_path)
        sess.fit()
        bench = sess.serve_handle().benchmark(queries=64, batch=16)
        lat = bench["latency_ms"]
        assert lat["count"] > 0 and lat["p50"] <= lat["p99"]
        assert registry.histogram("serve.query_ms").count > 0
        assert registry.gauge("serve.qps").value == pytest.approx(
            bench["qps"])
    sess.export_obs()
    events = read_trace(tmp_path / "trace" / TRACE_FILENAME)
    assert any(e.get("name") == "serve.query" for e in events)


def test_straggler_escalations_feed_registry_and_recorder():
    from repro_torch.dist import StragglerMonitor

    rec = FlightRecorder(capacity=8)
    with scoped_registry() as registry, rec.activate():
        monitor = StragglerMonitor(window=4, threshold=1.5, patience=2)
        for _ in range(3):
            monitor.record(0, 1.0)
            monitor.record(1, 1.0)
            monitor.record(2, 10.0)
        assert monitor.check() == {2: "slow"}
        assert monitor.check() == {2: "persistent"}
        snap = registry.snapshot()
    assert snap["straggler.slow"]["value"] == 1.0
    assert snap["straggler.persistent"]["value"] == 1.0
    flags = [e["flag"] for e in rec.events(kind="straggler")]
    assert flags == ["slow", "persistent"]


def test_monitor_config_feeds_the_fit():
    cfg = RunConfig(method=MethodConfig(rank=4, niters=3),
                    exec=ExecConfig(monitor=True, monitor_window=4))
    sess = Session(cfg, tensor=lowrank())
    sess.fit()
    monitor = sess.monitor()
    assert monitor is sess.monitor() and list(monitor.means()) == [0]
    assert len(monitor._times[0]) == 3  # one wall time an iteration


def test_provenance_footer_variants():
    from repro_torch.utils.report import _provenance_footer

    warm = _provenance_footer({"cache_hit": True,
                               "ingest": {"hits": 1, "misses": 0},
                               "autotune": {"hits": 3, "misses": 1}})
    assert "ingest-cache warm (hits=1 misses=0)" in warm
    assert "autotune hits=3 misses=1" in warm
    cold = _provenance_footer({"cache_hit": False,
                               "ingest": {"hits": 0, "misses": 1}})
    assert "ingest-cache cold" in cold
    assert "no ingest cache" in _provenance_footer({"cache_hit": False})


def test_ingest_cache_and_autotune_feed_registry_and_events(tmp_path):
    from repro_torch.ingest import ingest

    rec = FlightRecorder(capacity=64)
    with scoped_registry() as registry, rec.activate():
        ingest(lowrank(), cache=tmp_path / "cache")  # cold: miss + store
        ing = ingest(lowrank(), cache=tmp_path / "cache")  # warm: hit
        ing.plan("auto", rank=4, calibrate=True)  # 3 misses, timed
        ing.plan("auto", rank=4, calibrate=True)  # 3 hits
        snap = registry.snapshot()
    assert snap["ingest.cache.miss"]["value"] == 1.0
    assert snap["ingest.cache.hit"]["value"] == 1.0
    assert snap["autotune.miss"]["value"] == 3.0
    assert snap["autotune.hit"]["value"] == 3.0
    events = rec.events(kind="cache")
    assert [(e["store"], e["hit"]) for e in events] == (
        [("ingest", False), ("ingest", True)] + [("autotune", False)] * 3
        + [("autotune", True)] * 3)


def test_streaming_drift_gauge_on_a_fit_drop(monkeypatch):
    """A fit that falls between streaming iterations (forced here: every
    other iteration's fit is lowered by 0.05) sets the drift gauge, counts
    the drop and records a ``stream.drift`` event."""
    from repro_torch.methods import fit as methods_fit
    from repro_torch.methods import streaming

    calls = []
    real_fit = streaming.kruskal_fit

    def drifting_fit(*a, **k):
        calls.append(None)
        return real_fit(*a, **k) - (0.05 if len(calls) % 2 == 0 else 0.0)

    monkeypatch.setattr(streaming, "kruskal_fit", drifting_fit)
    inds, vals = np_coo((12, 10, 9), 400, 3)
    t = both_tensors(inds, vals, (12, 10, 9))[1]
    tracer, rec = Tracer(xla_annotations=False), FlightRecorder()
    with scoped_registry() as registry, tracer.activate(), rec.activate():
        fits = []
        methods_fit(t, 6, method="cp_als_streaming", niters=8, n_chunks=3,
                    checkpoint_cb=lambda s: fits.append(float(s.fit)))
        drops = sum(b < a for a, b in zip(fits[:-1], fits[1:]))
        snap = registry.snapshot()
    assert drops > 0
    assert snap["stream.fit_drops"]["value"] == drops
    assert snap["stream.fit_drop"]["value"] > 0
    assert len(rec.events(kind="stream.drift")) == drops
    names = {e["name"] for e in tracer.events()}
    assert {"iteration", "mttkrp", "epilogue", "fit"} <= names


# ---------------------------------------------------------------------------
# the span tree and trace_report against the reference
# ---------------------------------------------------------------------------

def _reference_spans(events):
    """The complete events less the spans only the port emits
    (``PORT_ONLY_SPANS``), whose children none are."""
    return [e for e in events
            if e.get("ph") == "X" and e["name"] not in PORT_ONLY_SPANS]


def _tree(events):
    """(name, parent name, attributes) of every complete event, in record
    order: the span tree without ids and times."""
    xs = [e for e in events if e.get("ph") == "X"]
    by_id = {e["args"]["id"]: e["name"] for e in xs}
    return [(e["name"], by_id.get(e["args"].get("parent")),
             {k: v for k, v in e["args"].items() if k not in ("id", "parent")})
            for e in xs]


def _rows(summary):
    return {name: (row["calls"],
                   {m: c["impl"] for m, c in row["modes"].items()})
            for name, row in summary["routines"].items()}


TREE_CASES = [
    ("cp_als", 4, {}, {}, {}),
    ("cp_als", 4, {"routines": "split"}, {}, {}),
    ("cp_als", 4, {}, {"reorder": "degree_sort", "cache": "CACHE"},
     {"policy": "segment"}),
    ("cp_nn_hals", 4, {}, {}, {"policy": "gather_scatter"}),
    ("tucker_hooi", (3, 3, 3), {}, {}, {}),
    ("cp_als_streaming", 4, {}, {}, {}),
]


@pytest.mark.parametrize("method,rank,obs_kw,data_kw,plan_kw", TREE_CASES)
def test_span_tree_and_routine_rows_match_reference(tmp_path, method, rank,
                                                    obs_kw, data_kw,
                                                    plan_kw):
    inds, vals = np_coo((20, 15, 12), 600, 2, skew=1.0)
    jt, pt = both_tensors(inds, vals, (20, 15, 12))
    trees, rows = [], []
    for side, mod, t in (("jax", japi, jt), ("port", None, pt)):
        d = tmp_path / side
        dk = {k: (str(d / "cache") if v == "CACHE" else v)
              for k, v in data_kw.items()}
        ex = {"executor": "streaming", "n_chunks": 2} \
            if method == "cp_als_streaming" else {}
        spec = dict(data=dk, plan=plan_kw, exec=ex,
                    method=dict(name=method, rank=rank, niters=2),
                    obs=dict(enabled=True, trace_dir=str(d / "trace"),
                             **obs_kw))
        if mod is japi:
            with jax_scoped_registry():
                sess = japi.Session.from_config(
                    japi.RunConfig.from_dict(spec), tensor=t)
                sess.fit()
                sess.serve_handle().query(inds[:8])
                sess.export_obs()
            report = jreport
        else:
            with scoped_registry():
                sess = Session(RunConfig.from_dict(spec), tensor=t)
                sess.fit()
                sess.serve_handle().query(inds[:8])
                sess.export_obs()
            from repro_torch.obs import report
        events = read_trace(d / "trace" / TRACE_FILENAME)
        if mod is not japi:
            events = _reference_spans(events)
        trees.append(_tree(events))
        rows.append(_rows(report.routine_breakdown(events)))
        text = report.trace_report(d / "trace", with_metrics=False)
        assert "| routine |" in text
    assert trees[1] == trees[0]
    assert rows[1] == rows[0]


def test_prometheus_text_matches_reference():
    reg, jreg = MetricsRegistry(), JaxRegistry()
    for r in (reg, jreg):
        r.counter("fit.iterations").inc(3)
        r.gauge("serve.qps").set(1500.5)
        r.gauge("fit.fit")
        h = r.histogram("fit.iteration_ms")
        for v in (1.0, 2.0, 3.0, 4.0):
            h.observe(v)
    assert render_prometheus(registry=reg) == jax_render(registry=jreg)


# ---------------------------------------------------------------------------
# the trace report + CLI
# ---------------------------------------------------------------------------

def test_routine_breakdown_aggregation():
    us = 1e6
    events = [
        {"name": "stage.fit", "ph": "X", "ts": 0, "dur": 10 * us, "args": {}},
        {"name": "iteration", "ph": "X", "ts": 0, "dur": 5 * us,
         "args": {"method": "cp_als"}},
        {"name": "mttkrp", "ph": "X", "ts": 0, "dur": 2 * us,
         "args": {"mode": 0, "impl": "segment"}},
        {"name": "mttkrp", "ph": "X", "ts": 2 * us, "dur": 1 * us,
         "args": {"mode": 1, "impl": "cuda"}},
        {"name": "epilogue", "ph": "X", "ts": 3 * us, "dur": 2 * us,
         "args": {"mode": 0}},
        {"name": "ignored", "ph": "M", "args": {}},
    ]
    s = routine_breakdown(events)
    assert s["fit_s"] == pytest.approx(10.0)
    assert s["iterations"] == 1 and s["methods"] == ["cp_als"]
    mt = s["routines"]["mttkrp"]
    assert mt["calls"] == 2 and mt["total_s"] == pytest.approx(3.0)
    assert mt["modes"][1]["impl"] == "cuda"
    assert s["unaccounted_s"] == pytest.approx(5.0)
    assert s == jreport.routine_breakdown(events)


def test_routine_breakdown_self_time_and_device_seconds():
    """A routine span nested in another (Tucker's ``svd`` in ``ttmc``)
    counts in its own row only, on the host and the card; the table gives
    the card's seconds where the spans carry ``device_ms``."""
    us = 1e6
    events = [
        {"name": "svd", "ph": "X", "ts": 1 * us, "dur": 3 * us,
         "args": {"id": 2, "parent": 1, "mode": 0, "device_ms": 2500.0}},
        {"name": "ttmc", "ph": "X", "ts": 0, "dur": 5 * us,
         "args": {"id": 1, "mode": 0, "impl": "cuda", "device_ms": 4000.0}},
        {"name": "fit", "ph": "X", "ts": 5 * us, "dur": 1 * us,
         "args": {"id": 3}},
    ]
    s = routine_breakdown(events)
    assert s["routines"]["ttmc"]["total_s"] == pytest.approx(2.0)
    assert s["routines"]["ttmc"]["device_s"] == pytest.approx(1.5)
    assert s["routines"]["ttmc"]["modes"][0]["total_s"] == pytest.approx(2.0)
    assert s["routines"]["svd"]["total_s"] == pytest.approx(3.0)
    assert s["routines"]["svd"]["device_s"] == pytest.approx(2.5)
    assert "device_s" not in s["routines"]["fit"]
    table = format_breakdown(s)
    assert "| routine | calls | total_s | device_s | % fit |" in table
    assert "| ttmc | 1 | 2.000 | 1.500 |" in table
    assert "| fit calc | 1 | 1.000 | - |" in table


def test_trace_and_metrics_subcommands(tmp_path, capsys):
    with scoped_registry():
        traced_session(tmp_path).fit()
    report = trace_report(tmp_path / "trace")
    assert "| routine |" in report and "# metrics" in report
    assert "sort" in report
    assert cli.main(["trace", str(tmp_path / "trace")]) == 0
    out = capsys.readouterr().out
    assert "| routine |" in out and "% fit" in out
    assert cli.main(["trace", str(tmp_path / "nope")]) == 2
    assert "no trace.jsonl" in capsys.readouterr().err
    assert cli.main(["metrics", str(tmp_path / "trace")]) == 0
    assert "fit.iterations" in capsys.readouterr().out
    assert cli.main(["metrics", str(tmp_path / "nope")]) == 2
    assert "no metrics.json" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError, match="--trace-dir"):
        trace_report(tmp_path / "missing")


def test_cli_traced_fit_on_cpu(tmp_path, capsys):
    with scoped_registry():
        rc = cli.main(["fit", "--dataset", "yelp", "--scale", "0.0005",
                       "--rank", "4", "--iters", "2", "--impl", "segment",
                       "--trace-dir", str(tmp_path / "t"), "--device",
                       "cpu"])
    assert rc == 0
    assert "python -m repro_torch trace" in capsys.readouterr().out
    names = {e["name"] for e in read_trace(tmp_path / "t" / TRACE_FILENAME)}
    assert {"stage.ingest", "stage.plan", "stage.fit", "sort", "iteration",
            "mttkrp", "epilogue"} <= names


def test_obs_config_validation_and_cli_flags(tmp_path):
    with pytest.raises(ConfigError, match="obs.sample_rate"):
        ObsConfig(sample_rate=0.0)
    with pytest.raises(ConfigError, match="obs.routines"):
        ObsConfig(routines="both")
    with pytest.raises(ConfigError, match="obs.enabled"):
        ObsConfig(trace_dir="/tmp/x")
    with pytest.raises(ConfigError, match="obs.http_port"):
        ObsConfig(enabled=True, http_port=70000)
    with pytest.raises(ConfigError, match="obs.heartbeat_s"):
        ObsConfig(enabled=True, heartbeat_s=1.0)
    with pytest.raises(ConfigError, match="obs.events_buffer"):
        ObsConfig(events_buffer=0)
    cfg = RunConfig(obs=ObsConfig(enabled=True, trace_dir="t",
                                  sample_rate=0.5, routines="split",
                                  xla_annotations=False, http_port=0,
                                  heartbeat_s=2.0, events_buffer=16))
    assert RunConfig.from_json(cfg.to_json()) == cfg


# ---------------------------------------------------------------------------
# exposition, recorder, heartbeat, crash dumps, aggregation
# ---------------------------------------------------------------------------

def test_render_prometheus_kinds_and_names():
    reg = MetricsRegistry()
    reg.counter("fit.iterations").inc(3)
    reg.gauge("fit.fit")
    h = reg.histogram("fit.iteration_ms")
    for v in (1.0, 2.0, 3.0, 4.0):
        h.observe(v)
    text = render_prometheus(registry=reg)
    assert "fit_iterations 3.0" in text and "fit_fit NaN" in text
    assert 'fit_iteration_ms{quantile="0.5"} 2.0' in text
    assert "fit_iteration_ms_sum 10.0" in text
    assert "fit_iteration_ms_count 4" in text
    assert sanitize_metric_name("a-b c/d") == "a_b_c_d"
    assert sanitize_metric_name("9lives")[0] == "_"


def test_exposition_endpoints_on_an_ephemeral_port():
    reg = MetricsRegistry()
    reg.counter("c").inc(2)
    with ExpositionServer(0, registry_fn=lambda: reg,
                          info_fn=lambda: {"stage": "fit"}) as srv:
        assert srv.port != 0 and srv.host == "127.0.0.1"
        body = urllib.request.urlopen(f"{srv.url}/metrics",
                                      timeout=10).read().decode()
        assert "c 2.0" in body
        hz = http_json(f"{srv.url}/healthz")
        assert hz["status"] == "ok" and hz["stage"] == "fit"
        assert http_json(f"{srv.url}/trace")["events"] == 0
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{srv.url}/nope", timeout=10)
        assert ei.value.code == 404
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"{srv.url}/healthz", timeout=1)


def test_exposition_tracks_scoped_registry_swaps():
    with ExpositionServer(0) as srv:
        with scoped_registry() as reg:
            reg.counter("scoped.only").inc()
            body = urllib.request.urlopen(f"{srv.url}/metrics",
                                          timeout=10).read().decode()
        assert "scoped_only 1.0" in body


def test_recorder_ring_activation_and_export(tmp_path):
    rec = FlightRecorder(capacity=3)
    for i in range(5):
        rec.record("iteration", i=i)
    snap = rec.snapshot()
    assert snap["recorded"] == 5 and snap["dropped"] == 2
    assert [e["i"] for e in snap["events"]] == [2, 3, 4]
    assert current_recorder() is None
    record_event("iteration", i=0)  # no recorder: dropped for free
    with rec.activate():
        assert current_recorder() is rec
        record_event("cache", store="ingest", hit=True)
    assert current_recorder() is None
    path = rec.export_jsonl(tmp_path / EVENTS_FILENAME)
    kinds = [json.loads(l)["kind"] for l in path.read_text().splitlines()]
    assert kinds == ["iteration", "iteration", "cache"]
    with pytest.raises(ValueError, match="capacity"):
        FlightRecorder(capacity=0)


def test_recorder_thread_safety():
    rec = FlightRecorder(capacity=64)

    def spam(k):
        for i in range(100):
            rec.record("t", worker=k, i=i)

    threads = [threading.Thread(target=spam, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = rec.snapshot()
    assert snap["recorded"] == 400 and len(snap["events"]) == 64
    seqs = [e["seq"] for e in snap["events"]]
    assert seqs == sorted(seqs)


def test_heartbeat_start_stop_and_failures(tmp_path):
    reg = MetricsRegistry()
    reg.counter("beats.seen").inc(7)
    rec = FlightRecorder(capacity=4)
    rec.record("iteration", i=0)
    hb = Heartbeat(tmp_path, 30.0, registry_fn=reg.snapshot, recorder=rec,
                   info_fn=lambda: {"stage": "fit"})
    hb.start()
    first = json.loads((tmp_path / HEARTBEAT_FILENAME).read_text())
    assert first["seq"] == 0 and first["stage"] == "fit"
    assert first["metrics"]["beats.seen"]["value"] == 7.0
    assert first["events"]["events"][0]["kind"] == "iteration"
    hb.stop()
    final = json.loads((tmp_path / HEARTBEAT_FILENAME).read_text())
    assert final["seq"] >= 1 and hb.beats == final["seq"] + 1
    with pytest.raises(ValueError, match="interval"):
        Heartbeat(tmp_path, 0.0)

    def broken():
        raise RuntimeError("advisory info must not kill the beat")

    Heartbeat(tmp_path / "b", 30.0, info_fn=broken).beat()
    assert json.loads((tmp_path / "b" / HEARTBEAT_FILENAME).read_text())[
        "seq"] == 0


def test_write_crash_dump_payload(tmp_path):
    rec = FlightRecorder(capacity=4)
    rec.record("iteration", i=2)
    try:
        raise RuntimeError("boom")
    except RuntimeError as exc:
        path = write_crash_dump(tmp_path, exc, recorder=rec,
                                metrics={"m": {"type": "counter",
                                               "value": 1.0}},
                                config={"method": {"name": "cp_als"}},
                                stage="fit")
    dump = json.loads(path.read_text())
    assert dump["error"]["type"] == "RuntimeError"
    assert any("boom" in line for line in dump["error"]["traceback"])
    assert dump["stage"] == "fit" and dump["events"]["events"][0]["i"] == 2


def test_session_fit_writes_crash_dump(tmp_path, monkeypatch):
    def boom(session):
        raise RuntimeError("synthetic executor failure")

    monkeypatch.setitem(EXECUTORS, "local",
                        dataclasses.replace(EXECUTORS["local"], fn=boom))
    with scoped_registry():
        sess = traced_session(tmp_path)
        with pytest.raises(RuntimeError, match="synthetic"):
            sess.fit()
    dump = json.loads((tmp_path / "trace" / CRASH_FILENAME).read_text())
    assert dump["error"]["type"] == "RuntimeError" and dump["stage"] == "fit"
    assert dump["config"]["method"]["rank"] == 4


def test_live_fit_metrics_match_final_export(tmp_path):
    with scoped_registry():
        sess = traced_session(tmp_path, http_port=0, heartbeat_s=30.0,
                              events_buffer=64)
        sess.fit()
        srv = sess.exposition()
        assert srv is sess.exposition()
        live = urllib.request.urlopen(f"{srv.url}/metrics",
                                      timeout=10).read().decode()
        hz = http_json(f"{srv.url}/healthz")
        tr = http_json(f"{srv.url}/trace")
        sess.close()
    assert hz["status"] == "ok"
    assert {"mttkrp", "epilogue"} <= set(tr["routines"]["routines"])
    final = json.loads((tmp_path / "trace" / METRICS_FILENAME).read_text())
    assert final["fit.iterations"]["value"] == 3.0
    assert "fit_iterations 3.0" in live
    count = final["fit.iteration_ms"]["count"]
    assert f"fit_iteration_ms_count {count}" in live
    hb = json.loads((tmp_path / "trace" / HEARTBEAT_FILENAME).read_text())
    assert hb["metrics"]["fit.iterations"]["value"] == 3.0
    kinds = {json.loads(l)["kind"] for l in
             (tmp_path / "trace" / EVENTS_FILENAME).read_text().splitlines()}
    assert {"iteration", "plan"} <= kinds
    sess.close()
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"{srv.url}/healthz", timeout=1)


def test_session_without_live_config_has_no_surfaces(tmp_path):
    with scoped_registry():
        sess = traced_session(tmp_path)
        sess.fit()
        assert sess.exposition() is None
        sess.close()
    assert not (tmp_path / "trace" / HEARTBEAT_FILENAME).exists()
    assert not (tmp_path / "trace" / CRASH_FILENAME).exists()


def test_merge_snapshots_and_aggregate_dir(tmp_path):
    a, b = MetricsRegistry(), MetricsRegistry()
    a.counter("c").inc(2)
    b.counter("c").inc(3)
    a.gauge("g").set(1.0)
    b.gauge("g").set(2.0)
    for v in (1.0, 2.0):
        a.histogram("h").observe(v)
    for v in (3.0, 4.0, 5.0):
        b.histogram("h").observe(v)
    merged = merge_snapshots({"h0": a.snapshot(with_window=True),
                              "h1": b.snapshot(with_window=True)})
    assert merged["c"]["value"] == 5.0
    assert merged["c"]["hosts"] == {"h0": 2.0, "h1": 3.0}
    assert merged["g"]["value"] == 2.0
    assert merged["h"]["count"] == 5 and merged["h"]["p50"] == 3.0
    bad = MetricsRegistry()
    bad.gauge("c").set(1)
    with pytest.raises(ValueError, match="refusing to merge"):
        merge_snapshots({"h0": a.snapshot(), "h1": bad.snapshot()})
    assert aggregate_dir(tmp_path) is None
    write_host_metrics(tmp_path, "h0", registry=a)
    write_host_metrics(tmp_path, "h1", registry=b)
    out = aggregate_dir(tmp_path, write=True)
    assert out["hosts"] == ["h0", "h1"]
    assert (tmp_path / AGGREGATED_FILENAME).exists()
    assert merge_files(sorted(tmp_path.glob("metrics-h*.json")))[
        "metrics"]["c"]["value"] == 5.0
