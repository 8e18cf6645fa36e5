"""repro_torch.serve: the serving query vocabulary (counterpart of
``repro.serve``).

    queries.py   query vocabulary (values_at, top_k) + bucketed padding

The multi-tenant registry, the request queue and the batching server
(``registry.py``, ``queue.py``, ``server.py``) come with the serving
daemon.
"""
from .queries import (bucket_for, make_score_fn, make_top_k_fn, pad_rows,
                      resident_bytes)

__all__ = ["bucket_for", "pad_rows", "make_score_fn", "make_top_k_fn",
           "resident_bytes"]
