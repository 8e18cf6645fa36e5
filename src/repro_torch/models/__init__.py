"""LM substrate for the assigned architecture pool (counterpart of
``repro.models``): configs, parameter specs, the shared layers and the
stacked :class:`Model`, with the ``moe``, ``rec`` (RG-LRU) and ``rwkv``
block kinds beside ``attn``.  Every family runs prefill and decode; see
``transformer.py``."""
from .config import SHAPES, ModelConfig, MoEConfig, ShapeConfig, cell_is_skipped
from .transformer import Model

__all__ = ["ModelConfig", "MoEConfig", "ShapeConfig", "SHAPES",
           "cell_is_skipped", "Model"]
