"""repro_torch.dist: the distributed-runtime layer (counterpart of
``repro.dist``).

``collectives``
    The rank grid over a ``torch.distributed`` process group
    (:func:`make_mesh`, one process group per row axes, column axis and
    whole grid), the mesh/axis vocabulary (which axes partition CP-ALS rows
    vs columns, pod-aware batch axes), :func:`shard_map` (a body on this
    rank's blocks) and the all-reduce / reduce-scatter / all-gather
    helpers, consumed by ``repro_torch.core.distributed``.

``straggler``
    :class:`StragglerMonitor`: windowed per-worker wall-time tracking that
    flags persistently slow hosts, fed once an iteration by the method
    drivers (``ExecConfig.monitor``), with the step times exchanged across
    ranks by ``record_step_times``.

``compress``
    int8 gradient compression with error feedback over nested dicts of
    tensors (:func:`compress_grads_int8`, :func:`decompress_grads_int8`),
    used by the LM train step's ``grad_compress``.
"""
from .collectives import (CPAxes, MODEL_AXIS, Mesh, axis_product, batch_axes,
                          cpals_axes, gather_rows, make_mesh, pgram,
                          pnormalize_columns, scatter_rows, shard_map)
from .straggler import StragglerMonitor

__all__ = [
    "CPAxes", "MODEL_AXIS", "Mesh", "axis_product", "batch_axes", "cpals_axes",
    "gather_rows", "make_mesh", "pgram", "pnormalize_columns",
    "scatter_rows", "shard_map",
    "StragglerMonitor",
]
