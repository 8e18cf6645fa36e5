"""repro_torch.methods: the decomposition-method registry.

    registry.py     MethodSpec + register/get/available, DecompState
    iteration.py    per-iteration timing and the verbose line
    driver.py       fit(x, rank, method=...) capability-checked dispatch
    cp_als.py       SPLATT-style CP-ALS (the paper's Algorithm 1)

Importing this package registers ``cp_als``.
"""
from .registry import (METHODS, DecompState, MethodSpec, available_methods,
                       get_method, make_state, register_method)
from .driver import fit
from .cp_als import cp_als, cpals_state_to_decomp

__all__ = [
    "METHODS", "DecompState", "MethodSpec", "available_methods",
    "get_method", "make_state", "register_method", "fit", "cp_als",
    "cpals_state_to_decomp",
]
