"""repro_torch.serve: continuous-batching, multi-tenant decomposition
serving (counterpart of ``repro.serve``).

Fitted CP/Tucker decompositions become queryable models behind a batching
server.

    queries.py   query vocabulary (values_at, top_k) + bucketed padding
    registry.py  multi-tenant residency: a CUDA graph per bucket on the
                 card, hot-swap, LRU byte-budget eviction
    queue.py     request queue + coalescing worker threads (futures out)
    server.py    DecompServer front door + ServeDaemon HTTP frontend
"""
from .queries import (QUERY_KINDS, bucket_for, make_score_fn, make_top_k_fn,
                      pad_rows, resident_bytes)
from .queue import BatchQueue
from .registry import DEFAULT_BUCKETS, ModelRegistry, TenantEntry, TenantModel
from .server import DecompServer, ServeDaemon

__all__ = [
    "QUERY_KINDS", "DEFAULT_BUCKETS",
    "bucket_for", "pad_rows", "make_score_fn", "make_top_k_fn",
    "resident_bytes",
    "ModelRegistry", "TenantModel", "TenantEntry",
    "BatchQueue", "DecompServer", "ServeDaemon",
]
