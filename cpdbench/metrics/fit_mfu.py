"""fit_mfu, read as ``fit_mfu.cp`` and ``fit_mfu.tucker``: percent of the
card's float32 peak that a whole fit's counted operations
(``counts/<method>.py``) take over the fit's wall time in the traced run's
plain fits.  It bounds what a kernel's roofline can claim."""
from cpdbench import plugins


def read(rec):
    plain, peak = rec.get("plain"), rec.get("peak")
    if not plain or peak is None or plain["fits"] == 0:
        return None
    ops = plugins.module("counts", rec["mix"]["method"]).fit_ops(
        rec["dims"], rec["nnz"], rec["mix"])
    return 100.0 * ops * plain["fits"] / (plain["wall_s"]
                                         * peak["fp32_flop_per_s"])
