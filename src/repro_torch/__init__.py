"""repro_torch: the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

    core/      SparseTensor, the CSF and linearized workspaces, the MTTKRP
               and TTMc registries, the rank-R algebra and the CP-ALS
               iteration machinery
    kernels/   hand-written CUDA kernels (MTTKRP and TTMc on CSF and on
               the linearized workspace, SYRK) for sm_90a, their plain
               PyTorch versions, and the nvcc build
    plan/      per-mode planner on predicted or measured costs, and the
               autotune store
    ingest/    .tns/.tnsb readers, relabelings, the content-addressed
               ingest cache and the ``Ingested`` handle
    methods/   the method registry and ``fit`` (CP-ALS, nonnegative CP by
               HALS, Tucker HOOI, streaming CP-ALS)
    checkpoint/ keep-k, async checkpoints of a method's state
    api/       RunConfig, Session, the executors and the CLI
               (``python -m repro_torch``): the front door
    obs/       spans, metrics, flight recorder, Prometheus exposition and
               the Table-III trace report
    serve/     the query vocabulary (values_at, top-k)
    dist/      the straggler monitor
    utils/     plan_report
    models/    the LM substrate: configs, parameter specs, layers and the
               stacked Model (every family: prefill and decode)
    configs/   the ten architecture presets and the CP-ALS workloads
    launch/    the serving launchers (``python -m repro_torch.launch.serve``)
    convert.py numpy bridges for comparing with the JAX package

Entry points run on the CUDA card unless given ``device="cpu"`` (or a CPU
tensor).  The package imports torch and numpy, never JAX or ``repro``.
"""
from . import checkpoint, core, ingest, kernels, methods, obs, plan
from .methods import fit

__all__ = ["checkpoint", "core", "ingest", "kernels", "methods", "obs",
           "plan", "fit"]
