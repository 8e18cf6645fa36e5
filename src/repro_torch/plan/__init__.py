"""repro_torch.plan: per-mode decomposition planning on predicted costs
(counterpart of ``repro.plan``; measured calibration is not ported yet)."""
from .stats import (CONTENTION_THRESHOLD, ModeStats, mode_stats,
                    tensor_stats)
from .planner import DecompPlan, ModePlan, plan_decomposition, plan_mode

__all__ = [
    "CONTENTION_THRESHOLD", "ModeStats", "mode_stats", "tensor_stats",
    "DecompPlan", "ModePlan", "plan_decomposition", "plan_mode",
]
