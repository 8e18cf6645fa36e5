"""Reading the device trace of a traced run: the device's busy time, the
operations that took it, and the idle gaps labelled by what the host was
doing.  Adapted from ``chip_smoke.py::profiled``.

``torch.profiler`` records every kernel, copy and set on the card with its
interval, on the host's clock, beside the host's operators.  The busy time
is the union of the device intervals; an idle gap is a stretch between two
of them, and it is labelled by the innermost host operator that covers its
middle.
"""
from __future__ import annotations

import time
from collections import defaultdict

TOP = 10
NAME_CHARS = 160
NO_OPERATOR = "host: no operator"


def profile(fn, sync) -> dict:
    """Run ``fn()`` under ``torch.profiler`` (host and device) and read the
    trace: ``window_s`` (the host clock around ``fn``), ``busy_s``,
    ``device_ops`` and ``idle_gaps`` (each at most ``TOP`` pairs of a name
    and seconds), and ``device_events``, the number of device intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    sync()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    events = prof.events()
    dev, host = [], []
    for ev in events:
        span = (ev.time_range.start, ev.time_range.end)
        if span[1] <= span[0]:
            continue
        if ev.device_type == DeviceType.CUDA:
            dev.append(span + (ev.name,))
        elif ev.device_type == DeviceType.CPU:
            host.append(span + (ev.name,))
    by_name: dict[str, float] = defaultdict(float)
    for start, end, name in dev:
        by_name[name[:NAME_CHARS]] += (end - start) * 1e-6
    busy, gaps = _union(dev)
    return {
        "window_s": window_s,
        "busy_s": busy * 1e-6,
        "device_events": len(dev),
        "device_ops": _top(by_name),
        "idle_gaps": _top(_label_gaps(gaps, host)),
    }


def _union(spans):
    """Total length of the union of ``(start, end, _)`` intervals (in the
    trace's microseconds) and the gaps between them."""
    busy = 0.0
    gaps = []
    cur_start = cur_end = None
    for start, end, _ in sorted(spans):
        if cur_end is None:
            cur_start, cur_end = start, end
        elif start > cur_end:
            busy += cur_end - cur_start
            gaps.append((cur_end, start))
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    return busy, gaps


def _label_gaps(gaps, host) -> dict[str, float]:
    """Seconds of idle gap by the innermost host operator that covers each
    gap's middle (``NO_OPERATOR`` where none does: the interpreter between
    operators)."""
    host = sorted(host)
    out: dict[str, float] = defaultdict(float)
    stack = []  # host operators begun before the current middle
    i = 0
    for lo, hi in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (lo + hi)
        while i < len(host) and host[i][0] <= mid:
            stack.append(host[i])
            i += 1
        # operators nest, so the latest begun that has not ended is the
        # innermost
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else NO_OPERATOR
        out[name[:NAME_CHARS]] += (hi - lo) * 1e-6
    return out


def _top(seconds_by_name: dict[str, float]):
    return [[name, s] for name, s in sorted(
        seconds_by_name.items(), key=lambda kv: -kv[1])[:TOP]]
