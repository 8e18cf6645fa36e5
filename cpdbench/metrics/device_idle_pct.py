"""device_idle_pct, read as ``device_idle_pct.cp`` and
``device_idle_pct.tucker``: percent of the profiled window in which no
operation ran on the card (the union of the trace's device intervals
against the host clock around the profiled fits)."""


def read(rec):
    prof = rec.get("profile")
    if not prof or prof["window_s"] <= 0 or prof["device_events"] == 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
