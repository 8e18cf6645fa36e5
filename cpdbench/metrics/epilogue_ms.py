"""epilogue_ms: milliseconds a fit of CP-ALS's dense epilogue, the sum of
the CP-ALS method's timers ``ata``, ``inverse``, ``norm`` and ``fit``."""
from cpdbench.readers import per_fit_ms


def read(rec):
    return per_fit_ms(rec, "ata", "inverse", "norm", "fit")
