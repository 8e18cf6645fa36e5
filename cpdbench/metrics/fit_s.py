"""fit_s (read as ``fit_s.cp`` and ``fit_s.tucker``): seconds a fit in the
measured window, all its time over all the fits completed in it (the
window ends at the end of the last fit)."""


def read(rec):
    w = rec.get("window")
    if not w or w["fits"] == 0:
        return None
    return w["wall_s"] / w["fits"]
