"""repro_torch.core: sparse CP-ALS (SPLATT) in PyTorch, the counterpart of
``repro.core``."""
from .coo import (PAPER_DATASETS, SparseTensor, dedupe, from_factors,
                  paper_dataset, random_sparse, resolve_device)
from .csf import (CSF, build_all_modes, build_csf, build_csf_loop_reference)
from .mttkrp import (REGISTRY, ImplSpec, available_impls, get_impl,
                     mttkrp, mttkrp_cuda, mttkrp_dense,
                     mttkrp_gather_scatter, mttkrp_rowloop, mttkrp_segment,
                     register_impl)
from .gram import (CHOLESKY_RIDGE, column_norms, gram, hadamard_grams,
                   kruskal_fit, kruskal_inner, kruskal_norm_sq, normalize,
                   solve_cholesky, solve_gram)
from .cpals import (CPALSState, CPDecomp, build_workspace, init_factors,
                    resolve_plan)

__all__ = [
    "PAPER_DATASETS", "SparseTensor", "dedupe", "from_factors",
    "paper_dataset", "random_sparse", "resolve_device",
    "CSF", "build_all_modes", "build_csf", "build_csf_loop_reference",
    "REGISTRY", "ImplSpec", "available_impls", "get_impl", "mttkrp",
    "mttkrp_cuda", "mttkrp_dense", "mttkrp_gather_scatter", "mttkrp_rowloop",
    "mttkrp_segment", "register_impl",
    "CHOLESKY_RIDGE", "column_norms", "gram", "hadamard_grams",
    "kruskal_fit", "kruskal_inner", "kruskal_norm_sq", "normalize",
    "solve_cholesky", "solve_gram",
    "CPALSState", "CPDecomp", "build_workspace", "init_factors",
    "resolve_plan",
]
