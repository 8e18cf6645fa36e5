"""Reading a device trace by hand: the union of device intervals, the gaps
between them, and the host operator each gap is put down to."""
from cpdbench import devtrace, plugins


def test_union_and_gaps():
    spans = [(10, 20, "a"), (15, 30, "b"), (40, 50, "c"), (50, 55, "d"),
             (70, 71, "e")]
    busy, gaps = devtrace._union(spans)
    assert busy == 20 + 15 + 1
    assert gaps == [(30, 40), (55, 70)]


def test_gaps_labelled_by_the_innermost_operator():
    host = [(0, 100, "fit"), (25, 45, "aten::mm"), (30, 35, "cudaLaunch"),
            (60, 65, "aten::sum")]
    gaps = [(31, 33), (36, 44), (60, 64), (80, 90), (200, 210)]
    got = devtrace._label_gaps(gaps, host)
    want = {"cudaLaunch": 2e-6, "aten::mm": 8e-6, "aten::sum": 4e-6,
            "fit": 10e-6, devtrace.NO_OPERATOR: 10e-6}
    assert got.keys() == want.keys()
    assert all(abs(got[k] - want[k]) < 1e-15 for k in want)


def test_top_keeps_the_largest():
    got = devtrace._top({f"k{i}": float(i) for i in range(20)})
    assert len(got) == devtrace.TOP and got[0] == ["k19", 19.0]


def test_device_readers():
    rec = {"profile": {"window_s": 2.0, "busy_s": 0.5, "device_events": 9,
                       "fits": 4}}
    idle = plugins.module("metrics", "device_idle_pct").read(rec)
    busy = plugins.module("metrics", "device_busy_ms").read(rec)
    assert idle == 75.0 and busy == 125.0
    empty = {"profile": dict(rec["profile"], device_events=0)}
    assert plugins.module("metrics", "device_idle_pct").read(empty) is None
    assert plugins.module("metrics", "device_busy_ms").read(empty) is None
