"""repro_torch.optim: AdamW and Adafactor written out (counterpart of
``repro.optim``), not ``torch.optim``.

Both keep float32 statistics whatever the parameters' dtype, and keep the
reference's rounding order: the gradients clipped by their global norm in
float32 and cast back, the update computed in float32 and cast to the
parameter's dtype.  Adafactor factors the second moment of every leaf with
two dims or more over its last two dims.  The state is a tree of tensors at
the reference's paths, so the two packages' states and checkpoints carry
across (``repro_torch.convert.lm_opt_state_from_numpy``).
"""
from .adafactor import adafactor
from .adamw import adamw
from .base import OPTIMIZERS, Optimizer, cast_like, clip_by_global_norm

__all__ = ["adamw", "adafactor", "Optimizer", "clip_by_global_norm",
           "cast_like", "OPTIMIZERS"]
