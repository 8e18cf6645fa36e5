"""Hand-written Hopper kernels for the CP-ALS hot spots (MTTKRP on the CSF
and on the linearized workspace, SYRK).

    csrc/*.cu        CUDA C++ for sm_90a, built with nvcc at first use
                     (csrc/tile.cuh: the output tile K1 and K3 share)
    _build.py        the nvcc build into build/kernels/ and the ctypes load
    mttkrp_cuda.py   wrapper of csrc/mttkrp.cu (replaces mttkrp_pallas.py)
    syrk_cuda.py     wrapper of csrc/syrk.cu (replaces syrk_pallas.py)
    linearized_cuda.py  wrapper of csrc/linearized.cu (replaces
                     linearized_pallas.py)
    ref.py           the plain PyTorch versions
    ops.py           entry points: the kernel on CUDA, the plain version on CPU

Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
