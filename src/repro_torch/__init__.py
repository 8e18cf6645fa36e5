"""repro_torch: the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

    core/      SparseTensor, the CSF workspace, the MTTKRP registry, the
               rank-R algebra and the CP-ALS iteration machinery
    kernels/   hand-written CUDA kernels (MTTKRP, SYRK) for sm_90a, their
               plain PyTorch versions, and the nvcc build
    plan/      per-mode planner on predicted costs
    methods/   the method registry and ``fit`` (CP-ALS)
    convert.py numpy bridges for comparing with the JAX package

Entry points run on the CUDA card unless given ``device="cpu"`` (or a CPU
tensor).  The package imports torch and numpy, never JAX or ``repro``.
"""
from . import core, kernels, methods, plan
from .methods import fit

__all__ = ["core", "kernels", "methods", "plan", "fit"]
