"""ttmc_ms: milliseconds of TTMc a fit, the method's synchronised
``timers["ttmc"]`` over the traced run's timed fits."""
from cpdbench.readers import per_fit_ms


def read(rec):
    return per_fit_ms(rec, "ttmc")
