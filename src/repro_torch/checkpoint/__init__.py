"""repro_torch.checkpoint: keep-k, async, restart-scanning checkpoints in
the JAX package's on-disk layout (counterpart of ``repro.checkpoint``)."""
from .manager import CheckpointManager, load_pytree, save_pytree

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]
