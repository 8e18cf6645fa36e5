"""svd_ms: milliseconds a fit of HOOI's thin SVDs, the HOOI method's
``timers["svd"]``."""
from cpdbench.readers import per_fit_ms


def read(rec):
    return per_fit_ms(rec, "svd")
