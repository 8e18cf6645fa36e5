"""Operations of one CP-ALS fit: the MTTKRPs and the dense epilogue that
Algorithm 1 needs for a mode update, counted from the shapes.

Per mode and iteration: the MTTKRP (``counts/mttkrp.py``); the Hadamard
product of the other Grams ((order - 2) R^2); the Cholesky factorisation
(R^3 / 3) and the solve against the (I_n, R) MTTKRP (2 I_n R^2); the
column norms and the scaling (3 I_n R); the new Gram, one triangle
(I_n R (R + 1)).  Per iteration, the fit: (order + 2) R^2 + 2 I_last R.
"""
from cpdbench import plugins


def fit_ops(dims, nnz: int, mix: dict) -> float:
    order = len(dims)
    rank = int(mix["rank"])
    mttkrp = plugins.module("counts", "mttkrp")
    per_iter = 0.0
    for n, d in enumerate(dims):
        per_iter += mttkrp.call(dims, nnz, (rank,) * order, n)[1]
        per_iter += (order - 2) * rank ** 2 + rank ** 3 / 3.0
        per_iter += 2.0 * d * rank ** 2 + 3.0 * d * rank + d * rank * (rank + 1)
    per_iter += (order + 2) * rank ** 2 + 2.0 * int(dims[-1]) * rank
    return per_iter * int(mix["niters"])
