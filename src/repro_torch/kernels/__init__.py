"""Hand-written Hopper kernels for the CP-ALS hot spots (MTTKRP, SYRK).

    csrc/*.cu        CUDA C++ for sm_90a, built with nvcc at first use
    _build.py        the nvcc build into build/kernels/ and the ctypes load
    mttkrp_cuda.py   wrapper of csrc/mttkrp.cu (replaces mttkrp_pallas.py)
    syrk_cuda.py     wrapper of csrc/syrk.cu (replaces syrk_pallas.py)
    ref.py           the plain PyTorch versions
    ops.py           entry points: the kernel on CUDA, the plain version on CPU

Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
