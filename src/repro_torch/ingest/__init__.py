"""repro_torch.ingest: streaming ingestion, locality-aware reordering and
the content-addressed workspace cache (counterpart of ``repro.ingest``).

    reader.py   chunked FROSTT .tns reader + mmap-able .tnsb binary format
    relabel.py  invertible mode relabelings / non-zero reorderings
    cache.py    content-addressed cache of COO + CSF + linearized
                workspaces + stats, in the JAX package's on-disk format
    api.py      ingest(...) -> Ingested, the handle every driver accepts
"""
from .reader import (read_tns, write_tns, read_tnsb, write_tnsb, convert_tns,
                     read_any, is_tnsb, DUPLICATE_POLICIES)
from .relabel import (Relabeling, identity_relabeling, compact, degree_sort,
                      random_block, make_reorder, REORDERINGS)
from .cache import IngestCache, content_key
from .api import Ingested, ingest

__all__ = [
    "read_tns", "write_tns", "read_tnsb", "write_tnsb", "convert_tns",
    "read_any", "is_tnsb", "DUPLICATE_POLICIES",
    "Relabeling", "identity_relabeling", "compact", "degree_sort",
    "random_block", "make_reorder", "REORDERINGS",
    "IngestCache", "content_key", "Ingested", "ingest",
]
