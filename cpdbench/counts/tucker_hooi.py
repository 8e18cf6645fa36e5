"""Operations of one Tucker HOOI fit that are counted: the TTMcs and the
core's product G = U^T Y on the last mode of each sweep.

The thin SVDs are left out: their work depends on the solver's algorithm,
and no count of what these inputs need is fixed.  So a share of the peak
from this count is a lower bound of the fit's real share.
"""
from cpdbench import plugins


def fit_ops(dims, nnz: int, mix: dict) -> float:
    ranks = [int(r) for r in mix["rank"]]
    ttmc = plugins.module("counts", "ttmc")
    per_sweep = sum(ttmc.call(dims, nnz, ranks, n)[1]
                    for n in range(len(dims)))
    width = 1
    for r in ranks[:-1]:
        width *= r
    per_sweep += 2.0 * int(dims[-1]) * ranks[-1] * width
    return per_sweep * int(mix["niters"])
