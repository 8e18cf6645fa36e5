"""ttmc_roofline: percent of the TTMc calls' roofline (counted from the COO
tensor, ``counts/ttmc.py``) that the timed TTMc reaches."""
from cpdbench.readers import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "ttmc")
