"""repro_torch.core: sparse CP-ALS (SPLATT) and the Tucker TTMc in PyTorch,
the counterpart of ``repro.core``."""
from .coo import (PAPER_DATASETS, SparseTensor, dedupe, from_factors,
                  paper_dataset, random_sparse, read_tns, resolve_device,
                  write_tns)
from .csf import (CSF, build_all_modes, build_csf, build_csf_loop_reference)
from .linearized import Linearized, build_linearized
from .mttkrp import (REGISTRY, ImplSpec, available_impls, get_impl,
                     mttkrp, mttkrp_cuda, mttkrp_dense,
                     mttkrp_gather_scatter, mttkrp_linearized,
                     mttkrp_linearized_cuda, mttkrp_rowloop, mttkrp_segment,
                     register_impl)
from .ttmc import (TTMC_IMPLS, TTMC_REGISTRY, available_ttmc_impls,
                   get_ttmc_impl, kron_chain, register_ttmc_impl, ttmc,
                   ttmc_cuda, ttmc_dense, ttmc_gather_scatter,
                   ttmc_linearized, ttmc_linearized_cuda, ttmc_segment)
from .gram import (CHOLESKY_RIDGE, column_norms, gram, hadamard_grams,
                   kruskal_fit, kruskal_inner, kruskal_norm_sq, normalize,
                   solve_cholesky, solve_gram)
from .cpals import (CPALSState, CPDecomp, build_workspace, init_factors,
                    resolve_plan)

__all__ = [
    "PAPER_DATASETS", "SparseTensor", "dedupe", "from_factors",
    "paper_dataset", "random_sparse", "read_tns", "resolve_device",
    "write_tns",
    "CSF", "build_all_modes", "build_csf", "build_csf_loop_reference",
    "Linearized", "build_linearized",
    "REGISTRY", "ImplSpec", "available_impls", "get_impl", "mttkrp",
    "mttkrp_cuda", "mttkrp_dense", "mttkrp_gather_scatter",
    "mttkrp_linearized", "mttkrp_linearized_cuda", "mttkrp_rowloop",
    "mttkrp_segment", "register_impl",
    "TTMC_IMPLS", "TTMC_REGISTRY", "available_ttmc_impls", "get_ttmc_impl",
    "kron_chain", "register_ttmc_impl", "ttmc", "ttmc_cuda", "ttmc_dense",
    "ttmc_gather_scatter", "ttmc_linearized", "ttmc_linearized_cuda",
    "ttmc_segment",
    "CHOLESKY_RIDGE", "column_norms", "gram", "hadamard_grams",
    "kruskal_fit", "kruskal_inner", "kruskal_norm_sq", "normalize",
    "solve_cholesky", "solve_gram",
    "CPALSState", "CPDecomp", "build_workspace", "init_factors",
    "resolve_plan",
]
