"""The planner's per-mode table and the dry-run's tables (counterpart of
``repro.utils.report``): the same text for the same plan or artifacts.

``plan_report`` is printed by the front door's ``plan`` and ``fit``
subcommands and by the dry-run; the §Dry-run and §Roofline tables read the
artifact JSONs ``repro_torch.launch.dryrun`` writes:

  PYTHONPATH=src python -m repro_torch.utils.report [--dir artifacts/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path


def load_cells(d: Path) -> list[dict]:
    return [json.loads(p.read_text()) for p in sorted(d.glob("*.json"))]


def plan_report(plan, *, reorder_deltas=None, method=None,
                provenance=None) -> str:
    """Per-mode planner table for a :class:`repro_torch.plan.DecompPlan`.

    One row per mode: workspace layout, chosen impl, measured collision rate
    and padding overhead, and the predicted §V-D regime — what the dry-run
    and the serving launcher print so the per-mode choice is inspectable.

    ``reorder_deltas``: per-mode dicts of (after - before) stat deltas from
    ``repro_torch.ingest.Ingested.reorder_deltas()`` — renders a "reorder" column
    showing what the locality-aware reordering bought (negative collision /
    padding deltas are wins).

    The "costs" column states where each mode's impl costs came from —
    ``predicted`` (cost models), ``measured-fresh`` (timed on this tensor,
    just now) or ``measured-cached`` (timed earlier, replayed from the
    persistent autotune store) — followed by the per-candidate cost table
    in THE canonical candidate ordering
    (:func:`repro_torch.plan.autotune.canonical_candidates` — the same ordering
    the calibration key hashes, so the printed table and the cached entry
    can never disagree about which candidate set was scored).

    ``method``: the decomposition method executing the plan
    (``repro_torch.methods``); the "method" column renders it together with the
    kernel family each mode was scored against (``mttkrp`` / ``ttmc``).

    ``provenance``: cache counters behind this plan (what
    ``Session.plan_report`` assembles) — ``{"cache_hit": bool, "ingest":
    {"hits", "misses"}, "autotune": {"hits", "misses"}}`` — rendered as a
    footer line so warm/cold ingest and replayed/fresh calibration stop
    being internal-only counters.
    """
    head = (f"# plan: policy={plan.policy} backend={plan.backend} "
            f"rank={plan.rank}"
            + (f" method={method}" if method is not None else ""))
    rows = ["| mode | method | rows | nnz/row | collision | padding "
            "| reorder | layout | impl | costs | regime | reason |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for p in plan.modes:
        s = p.stats
        kernel = getattr(p, "kernel", "mttkrp")
        m_cell = f"{method}:{kernel}" if method is not None else kernel
        if s is not None:
            cells = (f"{s.rows} | {s.avg_nnz_per_row:.1f} "
                     f"| {s.collision_rate:.2f} | {s.padding_overhead:.2f}")
        else:  # fixed policy planned with with_stats=False
            cells = "- | - | - | -"
        if reorder_deltas is not None:
            d = reorder_deltas[p.mode]
            re_cell = (f"coll {d['collision']:+.2f} "
                       f"pad {d['padding']:+.2f}")
        else:
            re_cell = "-"
        costs_cell = getattr(p, "source", "predicted")
        if p.costs:
            from repro_torch.plan.autotune import canonical_candidates

            costs_cell += " " + " ".join(
                f"{name}={p.costs[name]:.3g}"
                for name in canonical_candidates(p.costs))
        rows.append(
            f"| {p.mode} | {m_cell} | {cells} | {re_cell} "
            f"| {p.layout} | **{p.impl}** "
            f"| {costs_cell} | {p.predicted_regime} "
            f"| {p.reason} |")
    if provenance is not None:
        rows.append(_provenance_footer(provenance))
    return "\n".join([head] + rows)


def _provenance_footer(prov: dict) -> str:
    """One ``# provenance:`` line from the Session's cache counters."""
    parts = []
    hit = prov.get("cache_hit")
    if "ingest" in prov:
        ing = prov["ingest"]
        state = "warm" if hit else "cold"
        parts.append(f"ingest-cache {state} "
                     f"(hits={ing['hits']} misses={ing['misses']})")
    else:
        parts.append("no ingest cache (cold build; attach data.cache "
                     "for warm starts)")
    if "autotune" in prov:
        at = prov["autotune"]
        parts.append(f"autotune hits={at['hits']} misses={at['misses']}")
    return "# provenance: " + " | ".join(parts)


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    return f"{x*1e3:.1f}ms"


def dryrun_table(cells: list[dict]) -> str:
    rows = ["| cell | mesh | compile | peak/dev | args/dev | collective mix |",
            "|---|---|---|---|---|---|"]
    for c in cells:
        if "skipped" in c:
            rows.append(f"| {c['cell']} | — | SKIP | — | — | {c['skipped']} |")
            continue
        mesh = "x".join(str(v) for v in c["mesh"].values())
        colls = c["roofline"]["collectives"]
        mix = " ".join(f"{k.split('-')[-1]}:{int(v['count'])}"
                       for k, v in sorted(colls.items()))
        rows.append(
            f"| {c['cell']} | {mesh} | {c['compile_s']:.1f}s "
            f"| {c['memory']['peak_estimate_gib']:.1f}GiB "
            f"| {c['memory']['argument_bytes']/2**30:.2f}GiB | {mix} |")
    return "\n".join(rows)


def roofline_table(cells: list[dict], *, single_only: bool = True) -> str:
    rows = ["| cell | compute | memory | collective | dominant | bound "
            "| MODEL_FLOPS/HLO | note |",
            "|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if "skipped" in c:
            continue
        if single_only and "__multi" in c["cell"]:
            continue
        r = c["roofline"]
        useful = r["useful_ratio"]
        note = ""
        if useful > 1.0:
            note = "HLO<6ND (sparse/active<total)"
        rows.append(
            f"| {c['cell'].replace('__single','')} | {_fmt_s(r['compute_s'])} "
            f"| {_fmt_s(r['memory_s'])} | {_fmt_s(r['collective_s'])} "
            f"| **{r['dominant']}** | {_fmt_s(r['bound_s'])} "
            f"| {useful:.2f} | {note} |")
    return "\n".join(rows)


def pick_hillclimb(cells: list[dict]) -> list[str]:
    """worst useful ratio, most collective-bound, paper-representative."""
    live = [c for c in cells if "skipped" not in c and "__single" in c["cell"]
            and not c["cell"].startswith("cpals")]
    worst = min(live, key=lambda c: min(1.0, c["roofline"]["useful_ratio"])
                / max(c["roofline"]["bound_s"], 1e-9)
                * c["roofline"]["compute_s"])
    coll = max(live, key=lambda c: c["roofline"]["collective_s"]
               / max(c["roofline"]["bound_s"], 1e-9))
    return [worst["cell"], coll["cell"], "cpals-nell2__iteration__single"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", type=Path,
                    default=Path("artifacts/dryrun_torch"))
    ap.add_argument("--section", choices=["dryrun", "roofline", "pick"],
                    default="roofline")
    args = ap.parse_args(argv)
    cells = load_cells(args.dir)
    if args.section == "dryrun":
        print(dryrun_table(cells))
    elif args.section == "roofline":
        print(roofline_table(cells))
    else:
        print(pick_hillclimb(cells))


if __name__ == "__main__":
    main()
