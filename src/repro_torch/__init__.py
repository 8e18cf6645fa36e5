"""repro_torch: the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

    core/      SparseTensor, the CSF and linearized workspaces, the MTTKRP
               and TTMc registries, the rank-R algebra and the CP-ALS
               iteration machinery
    kernels/   hand-written CUDA kernels (MTTKRP and TTMc on CSF and on
               the linearized workspace, SYRK) for sm_90a, their plain
               PyTorch versions, and the nvcc build
    plan/      per-mode planner on predicted or measured costs, and the
               autotune store
    ingest/    the tensor content key (the rest of ingest is not ported)
    methods/   the method registry and ``fit`` (CP-ALS, Tucker HOOI)
    convert.py numpy bridges for comparing with the JAX package

Entry points run on the CUDA card unless given ``device="cpu"`` (or a CPU
tensor).  The package imports torch and numpy, never JAX or ``repro``.
"""
from . import core, ingest, kernels, methods, plan
from .methods import fit

__all__ = ["core", "ingest", "kernels", "methods", "plan", "fit"]
