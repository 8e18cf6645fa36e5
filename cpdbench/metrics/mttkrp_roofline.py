"""mttkrp_roofline: percent of the MTTKRP calls' roofline (counted from the
COO tensor, ``counts/mttkrp.py``) that the timed MTTKRP reaches."""
from cpdbench.readers import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "mttkrp")
