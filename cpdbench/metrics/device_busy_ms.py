"""device_busy_ms, read as ``device_busy_ms.cp`` and
``device_busy_ms.tucker``: milliseconds a fit in which an operation ran on
the card, over the profiled fits (the union of the trace's device
intervals).  The device's share of ``fit_s``, steadier than it: the
host's pace, which varies from run to run on a shared machine, does not
enter it."""


def read(rec):
    prof = rec.get("profile")
    if not prof or prof["device_events"] == 0 or prof["fits"] == 0:
        return None
    return 1e3 * prof["busy_s"] / prof["fits"]
