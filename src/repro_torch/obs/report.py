"""Render a recorded trace as the paper's Table-III-style breakdown.

Counterpart of ``repro.obs.report``, with the same formats.

``python -m repro_torch trace <dir>`` reads ``<dir>/trace.jsonl`` (written by
:meth:`repro_torch.api.Session` when ``obs.trace_dir`` is set) and prints a
per-routine table mirroring the paper's Table III — total time, share of
the fit stage, and the per-mode impl split — followed by a dump of
``<dir>/metrics.json`` when present.

The routine rows are the span names the fit drivers emit:
``sort`` / ``mttkrp`` / ``epilogue`` on the default fused path, plus
``ata`` / ``inverse`` / ``norm`` / ``fit`` under ``obs.routines="split"``
(the paper's full routine set) and ``ttmc`` / ``svd`` for Tucker/HOOI.  A
row's time is its spans' own: a routine span nested in another (Tucker's
``svd`` in ``ttmc``) counts in its own row only.  Where the spans carry
``device_ms`` (a traced run on the card), each row gives the card's
seconds beside the host's.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

from .trace import METRICS_FILENAME, TRACE_FILENAME, read_trace

# paper ordering: Table III lists sort, MTTKRP, then the epilogue chain
ROUTINE_ORDER = ("sort", "mttkrp", "epilogue", "ata", "inverse", "norm",
                 "fit", "ttmc", "svd", "solve")
_ROUTINE_LABEL = {"inverse": "inverse (solve)", "norm": "normalize",
                  "fit": "fit calc"}


def _complete(events: Sequence[dict]) -> list[dict]:
    return [e for e in events if e.get("ph") == "X"]


def _total_s(events: Sequence[dict], name: str) -> float:
    return sum(e.get("dur", 0.0) for e in events
               if e.get("name") == name) / 1e6


def _fmt_s(x: float) -> str:
    return f"{x:.3f}" if x < 100 else f"{x:.1f}"


def routine_breakdown(events: Sequence[dict]) -> dict:
    """Aggregate routine spans: per-routine totals, call counts and the
    per-mode/per-impl split, normalized against the fit stage's wall
    time.  Returns a plain dict (the CLI formats it; tests assert on
    it)."""
    events = _complete(events)
    wall_s = 0.0
    if events:
        start = min(e["ts"] for e in events)
        end = max(e["ts"] + e.get("dur", 0.0) for e in events)
        wall_s = (end - start) / 1e6

    stages = {}
    for stage in ("ingest", "plan", "fit", "serve"):
        total = _total_s(events, f"stage.{stage}")
        if total > 0:
            stages[stage] = total

    iterations = [e for e in events if e.get("name") == "iteration"]
    methods = sorted({e.get("args", {}).get("method") for e in iterations
                      if e.get("args", {}).get("method")})
    iteration_s = sum(e.get("dur", 0.0) for e in iterations) / 1e6

    # denominator for "% fit": the fit stage when the Session recorded
    # one, else the iterations themselves (driver called directly)
    fit_s = stages.get("fit") or iteration_s or wall_s

    # host and device microseconds of the routine spans nested in each
    # routine span, by the outer span's id
    by_id = {e["args"]["id"]: e for e in events
             if "id" in e.get("args", {})}
    nested: dict = {}
    for e in events:
        outer = by_id.get(e.get("args", {}).get("parent"))
        if (e.get("name") in ROUTINE_ORDER and outer is not None
                and outer.get("name") in ROUTINE_ORDER):
            inner = nested.setdefault(outer["args"]["id"], [0.0, 0.0])
            inner[0] += e.get("dur", 0.0)
            inner[1] += e["args"].get("device_ms", 0.0)

    routines = {}
    for e in events:
        name = e.get("name")
        if name not in ROUTINE_ORDER:
            continue
        args = e.get("args", {})
        row = routines.setdefault(name, {"calls": 0, "total_s": 0.0,
                                         "modes": {}})
        inner_us, inner_ms = nested.get(args.get("id"), (0.0, 0.0))
        dur_s = (e.get("dur", 0.0) - inner_us) / 1e6
        row["calls"] += 1
        row["total_s"] += dur_s
        if "device_ms" in args:
            row["device_s"] = (row.get("device_s", 0.0)
                               + (args["device_ms"] - inner_ms) / 1e3)
        mode = args.get("mode")
        if mode is not None:
            cell = row["modes"].setdefault(
                int(mode), {"impl": args.get("impl"), "total_s": 0.0})
            cell["total_s"] += dur_s
            if args.get("impl"):
                cell["impl"] = args["impl"]

    accounted = sum(r["total_s"] for r in routines.values())
    return {
        "events": len(events),
        "wall_s": wall_s,
        "stages": stages,
        "methods": methods,
        "iterations": len(iterations),
        "iteration_s": iteration_s,
        "fit_s": fit_s,
        "routines": routines,
        "unaccounted_s": max(0.0, fit_s - accounted),
    }


def format_breakdown(summary: dict) -> str:
    """The Table-III-style markdown table for one trace."""
    lines = [f"# trace: {summary['events']} events, "
             f"wall {_fmt_s(summary['wall_s'])}s"]
    if summary["stages"]:
        lines.append("# stages: " + " | ".join(
            f"{k} {_fmt_s(v)}s" for k, v in summary["stages"].items()))
    if summary["iterations"]:
        lines.append(
            f"# fit: method={','.join(summary['methods']) or '?'} "
            f"iterations={summary['iterations']} "
            f"({_fmt_s(summary['iteration_s'])}s inside iterations)")

    fit_s = summary["fit_s"]
    routines = summary["routines"]
    if not routines:
        lines.append("# no routine spans recorded (was the fit traced?)")
        return "\n".join(lines)

    # the card's seconds beside the host's, where the spans carry them
    device = any("device_s" in row for row in routines.values())
    lines += ["",
              "| routine | calls | total_s |"
              + (" device_s |" if device else "")
              + " % fit | per-mode impl split |",
              "|---|---|---|" + ("---|" if device else "") + "---|---|"]
    for name in ROUTINE_ORDER:
        if name not in routines:
            continue
        row = routines[name]
        share = 100.0 * row["total_s"] / fit_s if fit_s > 0 else 0.0
        per_mode = " · ".join(
            f"m{m} {cell['impl'] or '-'} {_fmt_s(cell['total_s'])}s"
            for m, cell in sorted(row["modes"].items())) or "-"
        dev_cell = ""
        if device:
            dev_cell = (f" {_fmt_s(row['device_s'])} |" if "device_s" in row
                        else " - |")
        lines.append(f"| {_ROUTINE_LABEL.get(name, name)} | {row['calls']} "
                     f"| {_fmt_s(row['total_s'])} |{dev_cell} {share:5.1f}% "
                     f"| {per_mode} |")
    if summary["unaccounted_s"] > 0 and fit_s > 0:
        share = 100.0 * summary["unaccounted_s"] / fit_s
        lines.append(f"| (untraced) | - | {_fmt_s(summary['unaccounted_s'])} "
                     f"|{' - |' if device else ''} {share:5.1f}% "
                     f"| dispatch, init, convergence |")
    return "\n".join(lines)


def format_metrics(snapshot: dict) -> str:
    """Metrics dump as a markdown table (one row per instrument)."""
    lines = ["", "# metrics", "| name | type | value |", "|---|---|---|"]
    for name, m in sorted(snapshot.items()):
        kind = m.get("type", "?")
        if kind == "histogram":
            mean = m.get("mean")
            value = (f"count={m.get('count')} "
                     f"mean={mean:.3g} " if mean is not None else
                     f"count={m.get('count')} ")
            for p in ("p50", "p90", "p99"):
                if m.get(p) is not None:
                    value += f"{p}={m[p]:.3g} "
            value = value.rstrip()
        else:
            value = f"{m.get('value')}"
        lines.append(f"| {name} | {kind} | {value} |")
    return "\n".join(lines)


def trace_report(trace_dir, *, with_metrics: bool = True) -> str:
    """The full ``python -m repro_torch trace`` output for a trace directory
    (accepts the directory or a direct path to a ``trace.jsonl``)."""
    path = Path(trace_dir)
    trace_path = path if path.is_file() else path / TRACE_FILENAME
    if not trace_path.exists():
        raise FileNotFoundError(
            f"no {TRACE_FILENAME} under {path} — record one with "
            f"`python -m repro_torch fit ... --trace-dir {path}`")
    out = format_breakdown(routine_breakdown(read_trace(trace_path)))
    if with_metrics:
        metrics_path = trace_path.parent / METRICS_FILENAME
        if metrics_path.exists():
            try:
                snapshot = json.loads(metrics_path.read_text())
            except json.JSONDecodeError:
                snapshot = None
            if isinstance(snapshot, dict) and snapshot:
                out += "\n" + format_metrics(snapshot)
    return out
