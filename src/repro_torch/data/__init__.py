"""repro_torch.data: the synthetic token pipeline for LM training
(counterpart of ``repro.data``)."""
from .pipeline import TokenPipeline, make_batch_iterator

__all__ = ["TokenPipeline", "make_batch_iterator"]
