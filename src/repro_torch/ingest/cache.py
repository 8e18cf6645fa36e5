"""The content key of an in-memory tensor.

Counterpart of the in-memory branch of ``repro.ingest.cache.content_key``:
a sha256 over the tensor's index and value bytes plus every option that
shapes its workspaces.  For the same int32 indices and float32 values it
equals the JAX package's key.  The planner keys the autotune store with it.
The ingest cache itself, and keys of files on disk, come with the ingest
slice.
"""
from __future__ import annotations

import hashlib

from repro_torch.core.coo import SparseTensor

# the JAX package's ingest format version, which is part of its keys
CACHE_FORMAT_VERSION = 2


def content_key(
    x: SparseTensor,
    *,
    block: int,
    row_tile: int,
    reorder: str = "identity",
    compact: bool = False,
    dims=None,
    duplicates: str = "sum",
    extra: str = "",
) -> str:
    """sha256 key over the tensor's content and every option that shapes
    its ingested state.  The CP rank is not part of it: workspaces do not
    depend on it."""
    if not isinstance(x, SparseTensor):
        raise NotImplementedError(
            "content_key takes an in-memory repro_torch SparseTensor; keys "
            f"of files come with the ingest slice (got {type(x).__name__})")
    h = hashlib.sha256()
    dims_s = "infer" if dims is None else tuple(int(d) for d in dims)
    h.update(f"ingest-v{CACHE_FORMAT_VERSION}|block={block}|"
             f"row_tile={row_tile}|reorder={reorder}|compact={compact}|"
             f"dims={dims_s}|duplicates={duplicates}|"
             f"extra={extra}|".encode())
    h.update(f"mem|dims={x.dims}|nnz={x.nnz}|".encode())
    h.update(x.inds[: x.nnz].contiguous().cpu().numpy().tobytes())
    h.update(x.vals[: x.nnz].contiguous().cpu().numpy().tobytes())
    return h.hexdigest()
