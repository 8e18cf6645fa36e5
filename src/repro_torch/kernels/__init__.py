"""Hand-written Hopper kernels for the decompositions' hot spots (MTTKRP
and the Tucker TTMc on the CSF and on the linearized workspace, SYRK).

    csrc/*.cu        CUDA C++ for sm_90a, built with nvcc at first use
                     (csrc/tile.cuh: the output tile K1 and K3 share)
    _build.py        the nvcc build into build/kernels/ and the ctypes load
    mttkrp_cuda.py   wrappers of csrc/mttkrp.cu, MTTKRP and TTMc (replace
                     mttkrp_pallas.py)
    syrk_cuda.py     wrapper of csrc/syrk.cu (replaces syrk_pallas.py)
    linearized_cuda.py  wrappers of csrc/linearized.cu, MTTKRP and TTMc
                     (replace linearized_pallas.py)
    ref.py           the plain PyTorch versions
    ops.py           entry points: the kernel on CUDA, the plain version on CPU

Each wrapper counts its launches in ``<wrapper>.launches``
(``mttkrp_cuda.ttmc.launches`` and so on).
"""
from . import ops, ref

__all__ = ["ops", "ref"]
