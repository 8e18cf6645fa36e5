"""The planner's per-mode table (counterpart of ``repro.utils.report``'s
``plan_report``): the same text for the same plan, printed by the front
door's ``plan`` and ``fit`` subcommands.

The JAX package's dry-run and roofline tables wait for the port of its
dry-run tooling.
"""
from __future__ import annotations


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
