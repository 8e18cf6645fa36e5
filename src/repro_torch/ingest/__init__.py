"""repro_torch.ingest: so far only the in-memory content key
(counterpart of ``repro.ingest.cache.content_key``)."""
from .cache import content_key

__all__ = ["content_key"]
