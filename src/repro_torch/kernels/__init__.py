"""Hand-written Hopper kernels for the decompositions' hot spots (MTTKRP
and the Tucker TTMc on the CSF and on the linearized workspace, SYRK).

    csrc/*.cu        CUDA C++ for sm_90a, built with nvcc at first use
                     (csrc/segmented.cuh: the row-segmented kernel body of
                     K1 and K3 over a stream ordered by its row)
    _build.py        the nvcc build into build/kernels/ and the ctypes load
    mttkrp_cuda.py   wrappers of csrc/mttkrp.cu, MTTKRP and TTMc (replace
                     mttkrp_pallas.py), and the row-segmented launch
                     geometries (mttkrp_geometry, ttmc_geometry)
    syrk_cuda.py     wrapper of csrc/syrk.cu (replaces syrk_pallas.py), and
                     its launch geometry
    linearized_cuda.py  wrappers of csrc/linearized.cu, MTTKRP and TTMc on
                     the sort mode (replace linearized_pallas.py) and on
                     the other modes (mttkrp_off_sort, ttmc_off_sort, over
                     the entries re-sorted by the target's row)
    sass_diff.py     two builds of a library compared kernel by kernel in
                     SASS (cuobjdump), run on the card's machine
    ref.py           the plain PyTorch versions
    ops.py           entry points: the kernel on CUDA, the plain version on CPU

Each wrapper counts its launches in ``<wrapper>.launches``
(``mttkrp_cuda.ttmc.launches`` and so on).
"""
from . import ops, ref

__all__ = ["ops", "ref"]
