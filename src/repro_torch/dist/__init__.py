"""repro_torch.dist: the distributed-runtime layer (counterpart of
``repro.dist``).

``straggler``
    :class:`StragglerMonitor`: windowed per-worker wall-time tracking that
    flags persistently slow hosts, fed once an iteration by the method
    drivers (``ExecConfig.monitor``).

The collectives and gradient compression come with the distributed
executor.
"""
from .straggler import StragglerMonitor

__all__ = ["StragglerMonitor"]
