"""sort_s: seconds of the Sort in set-up: ``ingest`` (its statistics pass)
and the warm-up fit's ``timers["sort"]`` (plan, workspace builds, ordered
streams)."""


def read(rec):
    setup = rec.get("setup")
    if not setup or "sort" not in rec.get("warmup_timers", {}):
        return None
    return setup["ingest_s"] + rec["warmup_timers"]["sort"]
