"""Fault-tolerant checkpointing: atomic npz shards, keep-k, async writes,
restart scanning.

Counterpart of ``repro.checkpoint.manager``, with its on-disk layout, so a
checkpoint written by either package restores in the other:

* a tree of tensors is flattened (:func:`flatten`) into leaves and
  ``/``-joined key paths; every leaf is copied to the host and written as
  entry ``a<i>`` of ``shard0.npz``, and ``meta.json`` holds the keys,
  dtypes, shapes, the caller's ``extra`` and ``"complete": true``;
* writes go to ``<dir>/step_<n>.tmp/`` and are renamed to ``step_<n>/``,
  so a crashed write never hides the newest good checkpoint (restart scans
  for the newest complete step);
* ``keep`` bounds the steps on disk (older ones go after a good save);
* ``async_save`` writes on a worker thread, after the leaves were copied
  to the host, so the caller blocks only on the previous save.

The port has no pytrees, so :func:`flatten` walks the structures the
methods checkpoint (``DecompState``, ``CPALSState``, tuples, lists and dicts
with sorted keys, None as an empty node) and gives the leaves and key
strings that ``jax.tree_util.tree_flatten_with_path`` gives for the JAX
package's own classes: ``"0/0"`` for a state's first factor, ``"1/lmbda"``,
``"2"`` for its fit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.cpals import CPALSState
from repro_torch.methods.registry import DecompState

# The classes the checkpoint walks into, with their children in the JAX
# package's flattening order (its ``tree_flatten`` of the same class).
_NODES = {
    DecompState: ("factors", "aux", "fit", "fit_prev", "iteration"),
    CPALSState: ("factors", "lmbda", "fit", "fit_prev", "iteration"),
}


def _children(node) -> Optional[list[tuple[str, Any]]]:
    """``[(key, child), ...]`` of an inner node, None for a leaf."""
    fields = _NODES.get(type(node))
    if fields is not None:
        return [(str(i), getattr(node, f)) for i, f in enumerate(fields)]
    if isinstance(node, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(node)]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if node is None:
        return []
    return None


def flatten(tree) -> tuple[list[str], list[Any]]:
    """``(keys, leaves)`` in the order and with the key paths of the JAX
    package's checkpoint."""
    keys, leaves = [], []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            keys.append("/".join(path))
            leaves.append(node)
            return
        for k, c in kids:
            walk(c, path + [k])

    walk(tree, [])
    return keys, leaves


def unflatten(like, leaves):
    """Rebuild ``like``'s structure around ``leaves`` (in flatten order)."""
    it = iter(leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        built = [build(c) for _, c in kids]
        if isinstance(node, (tuple, list)):
            return type(node)(built)
        return dataclasses.replace(node, **dict(zip(_NODES[type(node)],
                                                    built)))

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def _to_host(v) -> np.ndarray:
    """A host copy of a leaf: a later in-place update of the caller's
    tensor cannot reach a snapshot waiting for the save thread.  numpy has
    no bfloat16, so a bfloat16 leaf is widened (exactly) to float32."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.to("cpu", copy=True).numpy()
    return np.array(v)


def _write(path: Path, keys: list[str], arrays: list[np.ndarray],
           extra: dict | None) -> None:
    """Atomic write of host arrays to ``path`` (a directory)."""
    tmp = path.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "shard0.npz",
             **{f"a{i}": a for i, a in enumerate(arrays)})
    meta = {
        "keys": keys,
        "dtypes": [str(a.dtype) for a in arrays],
        "shapes": [list(a.shape) for a in arrays],
        "extra": extra or {},
        "complete": True,
    }
    (tmp / "meta.json").write_text(json.dumps(meta))
    if path.exists():
        shutil.rmtree(path)
    os.rename(tmp, path)


def save_pytree(path: Path, tree: Any, *, extra: dict | None = None) -> None:
    """Atomic save of a tree of tensors to ``path`` (a directory)."""
    keys, leaves = flatten(tree)
    _write(Path(path), keys, [_to_host(v) for v in leaves], extra)


def load_pytree(path: Path, like: Any | None = None):
    """Load a checkpoint.  With ``like`` (a tree of the same structure) the
    arrays become tensors in its structure, each on the device of ``like``'s
    tensor at that place (the CPU where ``like`` holds no tensor), and
    ``(tree, extra)`` is returned; without it, ``(keys, host arrays,
    extra)``."""
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    if not meta.get("complete"):
        raise IOError(f"incomplete checkpoint at {path}")
    with np.load(path / "shard0.npz") as data:
        arrays = [data[f"a{i}"] for i in range(len(meta["keys"]))]
    if like is None:
        return meta["keys"], arrays, meta["extra"]
    _, like_leaves = flatten(like)
    if len(like_leaves) != len(arrays):
        raise ValueError(f"checkpoint at {path} holds {len(arrays)} arrays, "
                         f"the structure asked for {len(like_leaves)}")
    leaves = [torch.from_numpy(a).to(l.device if isinstance(l, torch.Tensor)
                                     else "cpu")
              for a, l in zip(arrays, like_leaves)]
    return unflatten(like, leaves), meta["extra"]


class CheckpointManager:
    """keep-k, async, restart-scanning checkpoint manager."""

    def __init__(self, directory: str | Path, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._worker: Optional[threading.Thread] = None
        self._save_error: Optional[BaseException] = None

    # -- writing -------------------------------------------------------------
    def save(self, step: int, tree: Any, *, extra: dict | None = None) -> None:
        self.wait()  # block on the previous async save
        extra = dict(extra or {}, step=step)
        # copy to the host BEFORE the thread starts: the snapshot
        keys, leaves = flatten(tree)
        arrays = [_to_host(v) for v in leaves]

        def work():
            try:
                _write(self.dir / f"step_{step:08d}", keys, arrays, extra)
                self._gc()
            except BaseException as e:  # raised again on the next wait()
                self._save_error = e

        if self.async_save:
            self._worker = threading.Thread(target=work, daemon=True)
            self._worker.start()
        else:
            work()
            self._raise_if_failed()

    def wait(self) -> None:
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._save_error is not None:
            e, self._save_error = self._save_error, None
            raise e

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- reading -------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "meta.json").exists():
                continue
            try:
                meta = json.loads((p / "meta.json").read_text())
            except (OSError, ValueError):
                continue
            if meta.get("complete"):
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def read_extra(self, step: int) -> dict:
        """The ``extra`` metadata of one checkpoint, without its arrays."""
        meta = json.loads(
            (self.dir / f"step_{step:08d}" / "meta.json").read_text())
        return meta.get("extra", {})

    def restore(self, like: Any, *, step: int | None = None):
        """Restore the newest complete checkpoint (or ``step``) into
        ``like``'s structure and devices (see :func:`load_pytree`).
        Returns ``(tree, extra)``."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {self.dir}")
        return load_pytree(self.dir / f"step_{step:08d}", like=like)
