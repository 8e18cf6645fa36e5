"""repro_torch.methods: the decomposition-method registry.

    registry.py     MethodSpec + register/get/available, DecompState
    iteration.py    per-iteration timing and the verbose line
    driver.py       fit(x, rank, method=...) capability-checked dispatch
    cp_als.py       SPLATT-style CP-ALS (the paper's Algorithm 1)
    cp_nn_hals.py   nonnegative CP via hierarchical ALS
    tucker_hooi.py  sparse Tucker via chain-of-modes TTMc + thin SVD
    streaming.py    online CP-ALS over ingest.reader chunk batches

Importing this package registers all four methods, in the JAX package's
order.
"""
from .registry import (METHODS, DecompState, MethodSpec, available_methods,
                       get_method, make_state, register_method)
from .driver import fit
from .cp_als import cp_als, cpals_state_to_decomp
from .cp_nn_hals import cp_nn_hals
from .tucker_hooi import TuckerDecomp, tucker_hooi
from .streaming import cp_als_streaming

__all__ = [
    "METHODS", "DecompState", "MethodSpec", "available_methods",
    "get_method", "make_state", "register_method", "fit", "cp_als",
    "cpals_state_to_decomp", "cp_nn_hals", "TuckerDecomp", "tucker_hooi",
    "cp_als_streaming",
]
