"""repro_torch.plan: per-mode decomposition planning on predicted or
measured costs, with a persistent autotune store (counterpart of
``repro.plan``)."""
from .stats import (CONTENTION_THRESHOLD, ModeStats, mode_stats,
                    stats_digest, tensor_stats)
from .autotune import (AutotuneStore, as_store, calibration_key,
                       canonical_candidates, registry_fingerprint)
from .planner import DecompPlan, ModePlan, plan_decomposition, plan_mode

__all__ = [
    "CONTENTION_THRESHOLD", "ModeStats", "mode_stats", "stats_digest",
    "tensor_stats",
    "AutotuneStore", "as_store", "calibration_key", "canonical_candidates",
    "registry_fingerprint",
    "DecompPlan", "ModePlan", "plan_decomposition", "plan_mode",
]
