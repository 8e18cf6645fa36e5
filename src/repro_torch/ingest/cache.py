"""Content-addressed cache of ingest products.

Counterpart of ``repro.ingest.cache``.  :class:`IngestCache` keeps what
ingest costs to make: the relabeled COO tensor, the
:class:`~repro_torch.ingest.relabel.Relabeling` maps, one CSF workspace per
mode (SPLATT's ALLMODE policy), the shared linearized workspace and the
measured :class:`~repro_torch.plan.stats.ModeStats`, keyed by a sha256 over
the tensor's content and every option that shapes them.  A second run on
the same tensor skips parse, relabel, stats and sort.

The on-disk format is the JAX package's: ``<root>/<key[:2]>/<key>/`` holds
one ``.npy`` per array and a ``meta.json``, format version 2, so an entry
written by either package is a warm hit for the other.  The packed words
``lin_hi``/``lin_lo`` are stored as uint32, as the reference stores them;
the port holds the same bits as int32 tensors.  Writes land in a tmp
directory renamed into place, so concurrent runs at worst redo work.
``hits``/``misses`` count lookups.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.coo import DeviceLike, SparseTensor, resolve_device
from repro_torch.core.csf import CSF
from repro_torch.core.linearized import Linearized
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.recorder import record_event
from repro_torch.plan.stats import ModeStats

from .relabel import Relabeling

# v2: entries also carry the linearized workspace (lin_hi/lin_lo/lin_vals/
# lin_block_tile plus meta["lin"]).  The version is part of content_key.
CACHE_FORMAT_VERSION = 2


def content_key(
    x: Union[SparseTensor, str, os.PathLike],
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
    its ingested state (tile geometry, reorder/compact, the reader's
    ``dims`` and duplicate policy).

    For a file path the file's bytes are hashed (a warm start never parses
    the text); for an in-memory tensor its index and value buffers are.
    Either way it equals the JAX package's key.  The CP rank is not part of
    it: workspaces do not depend on it."""
    h = hashlib.sha256()
    dims_s = "infer" if dims is None else tuple(int(d) for d in dims)
    h.update(f"ingest-v{CACHE_FORMAT_VERSION}|block={block}|"
             f"row_tile={row_tile}|reorder={reorder}|compact={compact}|"
             f"dims={dims_s}|duplicates={duplicates}|"
             f"extra={extra}|".encode())
    if isinstance(x, SparseTensor):
        h.update(f"mem|dims={x.dims}|nnz={x.nnz}|".encode())
        h.update(x.inds[: x.nnz].contiguous().cpu().numpy().tobytes())
        h.update(x.vals[: x.nnz].contiguous().cpu().numpy().tobytes())
    else:
        path = Path(x)
        h.update(f"file|size={path.stat().st_size}|".encode())
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 22), b""):
                h.update(chunk)
    return h.hexdigest()


def _host(a: torch.Tensor) -> np.ndarray:
    return a.detach().contiguous().cpu().numpy()


def _words(a: torch.Tensor) -> np.ndarray:
    """A packed-word tensor (int32 storage) as the uint32 the format keeps."""
    return _host(a).view(np.uint32)


class IngestCache:
    """Content-addressed store of ingest products under ``root``."""

    def __init__(self, root: Union[str, os.PathLike]):
        self.root = Path(root)
        self.hits = 0
        self.misses = 0
        self._autotune = None

    @property
    def autotune(self):
        """The calibration store kept inside this cache
        (:class:`~repro_torch.plan.autotune.AutotuneStore` at
        ``<root>/autotune``): measured ``plan(calibrate=True)`` outcomes
        live beside the workspaces they were measured on."""
        if self._autotune is None:
            from repro_torch.plan.autotune import AutotuneStore

            self._autotune = AutotuneStore(self.root / "autotune")
        return self._autotune

    def _dir(self, key: str) -> Path:
        return self.root / key[:2] / key

    def has(self, key: str) -> bool:
        return (self._dir(key) / "meta.json").exists()

    # -- store -------------------------------------------------------------
    def store(self, key: str, t: SparseTensor,
              relabeling: Optional[Relabeling],
              csfs: list[CSF], stats: list[ModeStats],
              stats_before: Optional[list[ModeStats]] = None,
              lin: Optional[Linearized] = None) -> None:
        entry = self._dir(key)
        entry.parent.mkdir(parents=True, exist_ok=True)

        arrays: dict[str, np.ndarray] = {
            "coo_inds": _host(t.inds[: t.nnz]),
            "coo_vals": _host(t.vals[: t.nnz]),
        }
        if relabeling is not None:
            for m in range(relabeling.order):
                arrays[f"rel_new_of_old_{m}"] = _host(
                    relabeling.new_of_old[m])
                arrays[f"rel_old_of_new_{m}"] = _host(
                    relabeling.old_of_new[m])
            if relabeling.entry_perm is not None:
                arrays["rel_entry_perm"] = _host(relabeling.entry_perm)
        for c in csfs:
            m = c.mode
            arrays[f"csf{m}_row_ids"] = _host(c.row_ids)
            arrays[f"csf{m}_other_ids"] = _host(c.other_ids)
            arrays[f"csf{m}_vals"] = _host(c.vals)
            arrays[f"csf{m}_block_tile"] = _host(c.block_tile)
        if lin is not None:
            arrays["lin_hi"] = _words(lin.hi)
            arrays["lin_lo"] = _words(lin.lo)
            arrays["lin_vals"] = _host(lin.vals)
            arrays["lin_block_tile"] = _host(lin.block_tile)

        meta = {
            "version": CACHE_FORMAT_VERSION,
            "dims": list(t.dims),
            "nnz": t.nnz,
            "csf": {str(c.mode): {"block": c.block, "row_tile": c.row_tile}
                    for c in csfs},
            "lin": None if lin is None else {
                "block": lin.block, "row_tile": lin.row_tile,
                "sort_mode": lin.sort_mode},
            "relabeling": None if relabeling is None else {
                "dims_old": list(relabeling.dims_old),
                "dims_new": list(relabeling.dims_new),
                "has_entry_perm": relabeling.entry_perm is not None,
                "linearized_mode": relabeling.linearized_mode,
            },
            "stats": [dataclasses.asdict(s) for s in stats],
            "stats_before": (None if stats_before is None
                             else [dataclasses.asdict(s)
                                   for s in stats_before]),
        }

        tmp = entry.with_name(entry.name + f".tmp{os.getpid()}")
        tmp.mkdir(parents=True, exist_ok=True)
        for name, arr in arrays.items():
            np.save(tmp / f"{name}.npy", arr, allow_pickle=False)
        (tmp / "meta.json").write_text(json.dumps(meta))
        try:
            os.replace(tmp, entry)
        except OSError:
            # a concurrent run published the same key first: keep theirs
            shutil.rmtree(tmp, ignore_errors=True)

    # -- load --------------------------------------------------------------
    def load(self, key: str, *, device: DeviceLike = None):
        """``(tensor, relabeling, {mode: CSF}, lin, stats, stats_before)``
        on ``device`` (the card when None), or None on a miss; ``lin`` is
        None when the tensor's dims exceed its bit budget.  The arrays are
        memory-mapped and copied to the device.  Counts hits and misses on
        the instance and in the obs metrics registry (``ingest.cache.hit`` /
        ``ingest.cache.miss``), with a ``cache`` event each."""
        entry = self._dir(key)
        meta_path = entry / "meta.json"
        if not meta_path.exists():
            self.misses += 1
            get_registry().counter("ingest.cache.miss").inc()
            record_event("cache", store="ingest", key=key, hit=False)
            return None
        meta = json.loads(meta_path.read_text())
        if meta.get("version") != CACHE_FORMAT_VERSION:
            # evict, or the next store() would meet the directory on
            # os.replace and the entry would never heal
            shutil.rmtree(entry, ignore_errors=True)
            self.misses += 1
            get_registry().counter("ingest.cache.miss").inc()
            record_event("cache", store="ingest", key=key, hit=False)
            return None
        dev = resolve_device(device)
        arrays = {p.stem: np.load(p, mmap_mode="r")
                  for p in entry.glob("*.npy")}
        self.hits += 1
        get_registry().counter("ingest.cache.hit").inc()
        record_event("cache", store="ingest", key=key, hit=True)

        def get(name: str) -> torch.Tensor:
            a = np.array(arrays[name])
            if a.dtype == np.uint32:  # the packed words
                a = a.view(np.int32)
            return torch.from_numpy(a).to(dev)

        dims = tuple(meta["dims"])
        nnz = int(meta["nnz"])
        t = SparseTensor(get("coo_inds"), get("coo_vals"), dims, nnz,
                         device=dev)
        relabeling = None
        rmeta = meta.get("relabeling")
        if rmeta is not None:
            order = len(rmeta["dims_old"])
            relabeling = Relabeling(
                new_of_old=tuple(get(f"rel_new_of_old_{m}")
                                 for m in range(order)),
                old_of_new=tuple(get(f"rel_old_of_new_{m}")
                                 for m in range(order)),
                dims_old=tuple(rmeta["dims_old"]),
                dims_new=tuple(rmeta["dims_new"]),
                entry_perm=(get("rel_entry_perm")
                            if rmeta["has_entry_perm"] else None),
                linearized_mode=rmeta["linearized_mode"],
            )
        csfs = {}
        for mode_s, geom in meta["csf"].items():
            m = int(mode_s)
            csfs[m] = CSF(
                mode=m,
                row_ids=get(f"csf{m}_row_ids"),
                other_ids=get(f"csf{m}_other_ids"),
                vals=get(f"csf{m}_vals"),
                block_tile=get(f"csf{m}_block_tile"),
                dims=dims, nnz=nnz,
                block=int(geom["block"]), row_tile=int(geom["row_tile"]),
            )
        lin = None
        lmeta = meta.get("lin")
        if lmeta is not None:
            # widths and offsets follow from (dims, sort_mode): only the
            # arrays and the tile geometry round-trip
            lin = Linearized(
                hi=get("lin_hi"), lo=get("lin_lo"), vals=get("lin_vals"),
                block_tile=get("lin_block_tile"),
                dims=dims, nnz=nnz,
                block=int(lmeta["block"]), row_tile=int(lmeta["row_tile"]),
                sort_mode=int(lmeta["sort_mode"]),
            )
        stats = [ModeStats(**d) for d in meta["stats"]]
        stats_before = (None if meta["stats_before"] is None
                        else [ModeStats(**d) for d in meta["stats_before"]])
        return t, relabeling, csfs, lin, stats, stats_before
