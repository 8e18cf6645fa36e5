"""mttkrp_ms: milliseconds of MTTKRP a fit, the methods' synchronised
``timers["mttkrp"]`` over the traced run's timed fits."""
from cpdbench.readers import per_fit_ms


def read(rec):
    return per_fit_ms(rec, "mttkrp")
