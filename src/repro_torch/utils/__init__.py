"""repro_torch.utils: reporting helpers (counterpart of ``repro.utils``)."""
from .report import plan_report

__all__ = ["plan_report"]
