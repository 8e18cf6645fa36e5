"""Streaming tensor readers and writers: FROSTT ``.tns`` text and binary
``.tnsb``.

Counterpart of ``repro.ingest.reader``, with the same rules and the same
bytes on disk, so a file written by either package is read by the other:

* :func:`read_tns`: a chunked, streaming FROSTT reader.  It skips ``#``/``%``
  comment lines and blank lines, checks that every data line has the same
  arity (naming the offending line), keeps an explicit ``dims=`` (trailing
  empty slices are not dropped) and applies a duplicate-coordinate policy.
* :func:`write_tns`: vectorized formatting with enough significant digits
  that ``read_tns(write_tns(t)) == t`` exactly.
* ``.tnsb``: a mmap-able binary format, a fixed header (magic, version,
  order, dims, nnz, dtype) then the raw index and value arrays:
  :func:`write_tnsb` / :func:`read_tnsb` / :func:`convert_tns`.
* chunk sources (:func:`open_chunk_source`), which the streaming driver
  consumes one chunk at a time.

Parsing is host-side numpy.  Arrays move to the requested device (the card
when ``device`` is None) only when a :class:`SparseTensor` is built, and a
memory map is always copied first: no tensor shares a file's pages.
"""
from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.coo import (DeviceLike, SparseTensor, dedupe,
                                  resolve_device)

_COMMENT_PREFIXES = ("#", "%")
DUPLICATE_POLICIES = ("sum", "keep", "error")


def _is_data_line(line: str) -> bool:
    s = line.lstrip()
    return bool(s) and not s.startswith(_COMMENT_PREFIXES)


def read_tns(
    path: str | os.PathLike,
    *,
    dtype=np.float32,
    dims: Optional[Sequence[int]] = None,
    duplicates: str = "sum",
    chunk_lines: int = 1 << 20,
    device: DeviceLike = None,
) -> SparseTensor:
    """Stream a FROSTT ``.tns`` text file (1-indexed ``i j k val`` lines)
    into a tensor on ``device`` (the card when None).

    ``dims``: explicit mode lengths; without it dims are max index + 1 per
    mode, which loses trailing empty slices.  ``duplicates``: ``"sum"``
    collapses repeated coordinates, ``"keep"`` keeps them, ``"error"``
    raises on the first.  ``chunk_lines``: lines parsed per chunk (a memory
    bound, not a correctness knob).
    """
    if duplicates not in DUPLICATE_POLICIES:
        raise ValueError(
            f"duplicates policy {duplicates!r} not in {DUPLICATE_POLICIES}")
    chunks = list(_iter_tns_arrays(path, chunk_lines=chunk_lines))
    if not chunks:
        raise ValueError(f"{path}: no data lines")
    raw = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
    return _assemble(raw, path=path, dtype=dtype, dims=dims,
                     duplicates=duplicates, device=device)


def _parse_batch(batch: list[str], batch_nos: list[int],
                 arity: Optional[int], path) -> np.ndarray:
    """Parse one chunk of data lines into an (n, arity) float64 array,
    checking that every line has the same number of fields."""
    rows = [line.split() for line in batch]
    counts = np.fromiter((len(r) for r in rows), dtype=np.int64,
                         count=len(rows))
    want = arity if arity is not None else int(counts[0])
    bad = np.flatnonzero(counts != want)
    if bad.size:
        i = int(bad[0])
        raise ValueError(
            f"{path}:{batch_nos[i]}: expected {want} fields "
            f"(order {want - 1} + value), got {int(counts[i])}: "
            f"{batch[i].strip()!r}")
    if want < 3:
        raise ValueError(
            f"{path}:{batch_nos[0]}: a .tns line needs at least 2 indices "
            f"+ 1 value, got {want} fields")
    flat = [tok for r in rows for tok in r]
    try:
        out = np.array(flat, dtype=np.float64)
    except ValueError as e:
        raise ValueError(f"{path}: non-numeric field in lines "
                         f"{batch_nos[0]}..{batch_nos[-1]}: {e}") from None
    return out.reshape(len(rows), want)


def _assemble(raw: np.ndarray, *, path, dtype, dims, duplicates,
              device: DeviceLike) -> SparseTensor:
    icols = raw[:, :-1]
    vals = raw[:, -1].astype(dtype)
    if not np.all(icols == np.floor(icols)):
        raise ValueError(f"{path}: non-integer index column")
    if icols.size and icols.min() < 1:
        raise ValueError(f"{path}: FROSTT indices are 1-based; found "
                         f"index {int(icols.min())}")
    inds = icols.astype(np.int64) - 1
    order = inds.shape[1]
    inferred = tuple(int(inds[:, m].max()) + 1 for m in range(order))
    if dims is not None:
        dims = tuple(int(d) for d in dims)
        if len(dims) != order:
            raise ValueError(
                f"{path}: dims={dims} has {len(dims)} modes, file has {order}")
        short = [m for m in range(order) if inferred[m] > dims[m]]
        if short:
            raise ValueError(
                f"{path}: index out of range for dims={dims} in mode(s) "
                f"{short} (max+1 per mode is {inferred})")
    else:
        dims = inferred
    t = SparseTensor(inds.astype(np.int32), vals, dims, len(vals),
                     device=device)
    if duplicates == "keep":
        return t
    if duplicates == "error":
        lin = np.ravel_multi_index(
            tuple(inds[:, m] for m in range(order)), dims)
        uniq = np.unique(lin)
        if uniq.shape[0] != lin.shape[0]:
            raise ValueError(
                f"{path}: {lin.shape[0] - uniq.shape[0]} duplicate "
                "coordinate(s) (duplicates='error')")
        return t
    return dedupe(t)


# ---------------------------------------------------------------------------
# vectorized .tns writer
# ---------------------------------------------------------------------------

def write_tns(path: str | os.PathLike, t: SparseTensor, *,
              chunk: int = 1 << 18) -> None:
    """Write FROSTT text, formatting in vectorized chunks: 9 significant
    digits for float32 values, 17 for float64, so the text round trip is
    bit-exact."""
    inds = t.inds[: t.nnz].cpu().numpy().astype(np.int64) + 1
    vals = t.vals[: t.nnz].cpu().numpy()
    vfmt = "%.9g" if vals.dtype == np.float32 else "%.17g"
    n = inds.shape[0]
    with open(path, "w") as f:
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            cols = [np.char.mod("%d", inds[s:e, m])
                    for m in range(t.order)]
            cols.append(np.char.mod(vfmt, vals[s:e].astype(np.float64)))
            line = cols[0]
            for c in cols[1:]:
                line = np.char.add(np.char.add(line, " "), c)
            f.write("\n".join(line))
            f.write("\n")


# ---------------------------------------------------------------------------
# .tnsb: mmap-able binary tensor format
# ---------------------------------------------------------------------------
#
# layout (little-endian), as the JAX package writes it:
#   magic   4s   b"TNSB"
#   version u32  1
#   order   u32
#   dtcode  u32  value dtype (index into _DTYPE_CODES)
#   nnz     u64
#   dims    i64[order]
#   inds    i32[nnz, order]  (C order)
#   vals    <dtype>[nnz]

TNSB_MAGIC = b"TNSB"
TNSB_VERSION = 1
_HEADER = struct.Struct("<4sIIIQ")
_DTYPE_CODES = {0: np.float32, 1: np.float64}
_CODE_OF = {np.dtype(v): k for k, v in _DTYPE_CODES.items()}


def write_tnsb(path: str | os.PathLike, t: SparseTensor) -> None:
    """Write the binary format atomically (tmp file + rename)."""
    inds = np.ascontiguousarray(t.inds[: t.nnz].cpu().numpy(),
                                dtype=np.int32)
    vals = np.ascontiguousarray(t.vals[: t.nnz].cpu().numpy())
    code = _CODE_OF.get(vals.dtype)
    if code is None:
        raise ValueError(f"unsupported value dtype {vals.dtype} "
                         f"(one of {list(_CODE_OF)})")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(_HEADER.pack(TNSB_MAGIC, TNSB_VERSION, t.order, code, t.nnz))
        f.write(np.asarray(t.dims, dtype=np.int64).tobytes())
        f.write(inds.tobytes())
        f.write(vals.tobytes())
    os.replace(tmp, path)


def _read_tnsb_header(path: Path):
    """``(dims, nnz, value dtype, byte offset of the index array)``."""
    with open(path, "rb") as f:
        head = f.read(_HEADER.size)
        if len(head) < _HEADER.size:
            raise ValueError(f"{path}: truncated .tnsb header")
        magic, version, order, code, nnz = _HEADER.unpack(head)
        if magic != TNSB_MAGIC:
            raise ValueError(f"{path}: not a .tnsb file (magic {magic!r})")
        if version != TNSB_VERSION:
            raise ValueError(f"{path}: .tnsb version {version}, "
                             f"expected {TNSB_VERSION}")
        if code not in _DTYPE_CODES:
            raise ValueError(f"{path}: unknown value dtype code {code}")
        dims = tuple(int(d) for d in
                     np.frombuffer(f.read(8 * order), dtype=np.int64))
        return dims, int(nnz), _DTYPE_CODES[code], f.tell()


def _tnsb_memmaps(path: Path):
    """``(dims, nnz, inds, vals)`` with the arrays memory-mapped read-only."""
    dims, nnz, vdtype, off = _read_tnsb_header(path)
    order = len(dims)
    inds = np.memmap(path, dtype=np.int32, mode="r", offset=off,
                     shape=(nnz, order))
    vals = np.memmap(path, dtype=vdtype, mode="r",
                     offset=off + 4 * nnz * order, shape=(nnz,))
    return dims, nnz, inds, vals


def read_tnsb(path: str | os.PathLike, *, mmap: bool = True,
              device: DeviceLike = None) -> SparseTensor:
    """Read the binary format into a tensor on ``device`` (the card when
    None).  With ``mmap=True`` the OS pages the arrays in from a memory
    map, which is copied before it reaches torch; else they are read with
    ``np.fromfile``."""
    path = Path(path)
    if mmap:
        dims, nnz, inds, vals = _tnsb_memmaps(path)
        inds, vals = np.array(inds), np.array(vals)
    else:
        dims, nnz, vdtype, off = _read_tnsb_header(path)
        with open(path, "rb") as f:
            f.seek(off)
            inds = np.fromfile(f, dtype=np.int32,
                               count=nnz * len(dims)).reshape(nnz, len(dims))
            vals = np.fromfile(f, dtype=vdtype, count=nnz)
    return SparseTensor(inds, vals, dims, nnz, device=device)


def convert_tns(src: str | os.PathLike, dst: str | os.PathLike,
                **read_kwargs) -> SparseTensor:
    """``.tns`` text -> ``.tnsb`` binary; returns the loaded tensor."""
    t = read_tns(src, **read_kwargs)
    write_tnsb(dst, t)
    return t


def is_tnsb(path: str | os.PathLike) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(4) == TNSB_MAGIC
    except OSError:
        return False


# ---------------------------------------------------------------------------
# chunk sources: what cp_als_streaming consumes
# ---------------------------------------------------------------------------
#
# A chunk source is a re-iterable sequence of SparseTensor chunks that all
# carry the FULL tensor dims (each chunk owns a disjoint subset of the
# non-zeros), so per-chunk kernel partials sum to the batch result.  One
# chunk at a time is on the device: the .tnsb source copies a slice of the
# memory map, the .tns source re-streams the text file, and the in-memory
# source slices the resident tensor.  Coordinates are assumed unique across
# chunks (a global duplicate sum needs the whole tensor, which streaming
# avoids); the .tnsb files the caches write are deduplicated.


class ChunkSource:
    """Re-iterable chunk sequence with known ``dims`` and ``nnz``.

    ``make_iter`` is a zero-argument callable returning a fresh iterator of
    :class:`SparseTensor` chunks; each pass calls it again, so file-backed
    sources re-stream instead of buffering.
    """

    def __init__(self, dims: Sequence[int], nnz: int, make_iter):
        self.dims = tuple(int(d) for d in dims)
        self.nnz = int(nnz)
        self._make_iter = make_iter

    def __iter__(self):
        return self._make_iter()


def scan_tns_dims(path: str | os.PathLike,
                  chunk_lines: int = 1 << 20) -> tuple[tuple[int, ...], int]:
    """One streaming pass over a ``.tns``: (inferred dims, line count),
    without building the tensor."""
    maxes: Optional[np.ndarray] = None
    count = 0
    for raw in _iter_tns_arrays(path, chunk_lines=chunk_lines):
        icols = raw[:, :-1]
        if icols.size and icols.min() < 1:
            raise ValueError(f"{path}: FROSTT indices are 1-based; found "
                             f"index {int(icols.min())}")
        m = icols.max(axis=0)
        maxes = m if maxes is None else np.maximum(maxes, m)
        count += raw.shape[0]
    if maxes is None:
        raise ValueError(f"{path}: no data lines")
    return tuple(int(v) for v in maxes), count


def _iter_tns_arrays(path, *, chunk_lines: int):
    """Yield parsed (n, arity) float64 arrays per text chunk (shared by the
    scan pass and the chunk iterator)."""
    arity: Optional[int] = None
    with open(path, "r") as f:
        lineno = 0
        batch: list[str] = []
        batch_nos: list[int] = []
        while True:
            line = f.readline()
            at_eof = not line
            if not at_eof:
                lineno += 1
                if _is_data_line(line):
                    batch.append(line)
                    batch_nos.append(lineno)
            if batch and (at_eof or len(batch) >= chunk_lines):
                raw = _parse_batch(batch, batch_nos, arity, path)
                arity = raw.shape[1]
                yield raw
                batch, batch_nos = [], []
            if at_eof:
                break


def iter_tns_chunks(path: str | os.PathLike, *, dims: Sequence[int],
                    chunk_nnz: int = 1 << 20, dtype=np.float32,
                    device: DeviceLike = None):
    """Yield :class:`SparseTensor` chunks of a FROSTT text file on
    ``device``.  ``dims`` is required: every chunk carries the FULL shape
    (:func:`scan_tns_dims` infers it in one pass).  Duplicates are kept."""
    for raw in _iter_tns_arrays(path, chunk_lines=chunk_nnz):
        yield _assemble(raw, path=path, dtype=dtype, dims=dims,
                        duplicates="keep", device=device)


def iter_tnsb_chunks(path: str | os.PathLike, *, chunk_nnz: int = 1 << 20,
                     device: DeviceLike = None):
    """Yield chunks of a binary ``.tnsb``, each a copy of one slice of the
    memory map moved to ``device``: the OS pages in only the active chunk,
    and only it is on the device."""
    dims, nnz, inds, vals = _tnsb_memmaps(Path(path))
    dev = resolve_device(device)
    chunk_nnz = max(1, int(chunk_nnz))
    for s in range(0, nnz, chunk_nnz):
        e = min(nnz, s + chunk_nnz)
        yield SparseTensor(np.array(inds[s:e]), np.array(vals[s:e]), dims,
                           e - s, device=dev)


def iter_chunks(t: SparseTensor, *, chunk_nnz: Optional[int] = None,
                n_chunks: Optional[int] = None):
    """Slice a tensor's non-zeros into chunks sharing the full dims, on the
    tensor's device."""
    if (chunk_nnz is None) == (n_chunks is None):
        raise ValueError("pass exactly one of chunk_nnz= / n_chunks=")
    if n_chunks is not None:
        chunk_nnz = -(-t.nnz // int(n_chunks))
    chunk_nnz = max(1, int(chunk_nnz))
    for s in range(0, t.nnz, chunk_nnz):
        e = min(t.nnz, s + chunk_nnz)
        yield SparseTensor(t.inds[s:e], t.vals[s:e], t.dims, e - s,
                           device=t.device)


def open_chunk_source(source, *, dims: Optional[Sequence[int]] = None,
                      chunk_nnz: int = 1 << 20,
                      n_chunks: Optional[int] = None,
                      device: DeviceLike = None) -> ChunkSource:
    """Normalize anything chunk-shaped into a re-iterable
    :class:`ChunkSource`.

    Accepts a :class:`SparseTensor` (sliced on its own device), a
    ``.tns``/``.tnsb`` path (re-streamed per pass onto ``device``, the card
    when None; a ``.tns`` without ``dims=`` costs one extra scan pass), or
    a list/tuple of same-dims chunks."""
    if isinstance(source, SparseTensor):
        if n_chunks is not None:
            chunk_nnz = -(-source.nnz // int(n_chunks))
        cn = max(1, int(chunk_nnz))
        return ChunkSource(source.dims, source.nnz,
                           lambda: iter_chunks(source, chunk_nnz=cn))
    if isinstance(source, (list, tuple)):
        chunks = list(source)
        if not chunks:
            raise ValueError("empty chunk list")
        d0 = chunks[0].dims
        for i, c in enumerate(chunks):
            if not isinstance(c, SparseTensor) or c.dims != d0:
                raise ValueError(
                    f"chunk {i} is not a SparseTensor with dims {d0}")
        return ChunkSource(d0, sum(c.nnz for c in chunks),
                           lambda: iter(chunks))
    if isinstance(source, (str, os.PathLike)):
        path = Path(source)
        dev = resolve_device(device)
        if is_tnsb(path):
            tdims, nnz, _, _ = _read_tnsb_header(path)
            if n_chunks is not None:
                chunk_nnz = -(-nnz // int(n_chunks))
            cn = max(1, int(chunk_nnz))
            return ChunkSource(tdims, nnz, lambda: iter_tnsb_chunks(
                path, chunk_nnz=cn, device=dev))
        if dims is None:
            dims, count = scan_tns_dims(path)
        else:
            count = sum(r.shape[0]
                        for r in _iter_tns_arrays(path, chunk_lines=chunk_nnz))
        if n_chunks is not None:
            chunk_nnz = -(-count // int(n_chunks))
        cn = max(1, int(chunk_nnz))
        d = tuple(int(x) for x in dims)
        return ChunkSource(d, count, lambda: iter_tns_chunks(
            path, dims=d, chunk_nnz=cn, device=dev))
    raise TypeError(
        f"cannot stream chunks from {type(source).__name__}; pass a "
        "SparseTensor, a .tns/.tnsb path, or a list of SparseTensor chunks")


def read_any(path: str | os.PathLike, *, dims=None, duplicates: str = "sum",
             device: DeviceLike = None, **read_kwargs) -> SparseTensor:
    """Dispatch on content: ``.tnsb`` by magic, FROSTT text otherwise.

    ``dims``/``duplicates`` apply to both formats: a ``.tnsb`` header's dims
    are authoritative, so an explicit ``dims`` that disagrees raises, and
    the duplicate policy is enforced on the loaded coordinates."""
    if not is_tnsb(path):
        return read_tns(path, dims=dims, duplicates=duplicates,
                        device=device, **read_kwargs)
    t = read_tnsb(path, device=device)
    if dims is not None and tuple(int(d) for d in dims) != t.dims:
        raise ValueError(
            f"{path}: .tnsb header says dims={t.dims}, caller asked "
            f"dims={tuple(dims)}")
    if duplicates == "keep":
        return t
    if duplicates not in DUPLICATE_POLICIES:
        raise ValueError(
            f"duplicates policy {duplicates!r} not in {DUPLICATE_POLICIES}")
    deduped = dedupe(t)
    if duplicates == "error" and deduped.nnz != t.nnz:
        raise ValueError(f"{path}: {t.nnz - deduped.nnz} duplicate "
                         "coordinate(s) (duplicates='error')")
    return deduped
