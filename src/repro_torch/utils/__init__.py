"""repro_torch.utils: the H100 roofline of a dry-run and the reporting
helpers (counterpart of ``repro.utils``)."""
from . import roofline
from .report import plan_report

__all__ = ["plan_report", "roofline"]
