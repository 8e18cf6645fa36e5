"""Parameter spec trees: one definition drives init, abstract shapes and
(later) sharding through logical axis names.

Counterpart of ``repro.models.params``.  A tree is a nested ``dict`` whose
leaves are :class:`ParamSpec`; ``init_params`` draws it from an explicit
``torch.Generator`` on a given device, ``abstract_params`` makes it on the
``meta`` device and allocates nothing.  The draws are not the reference's
``jax.random`` streams: a comparison hands parameters across by value
(``repro_torch.convert.lm_params_from_numpy``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Leaf of a parameter tree before materialization."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis name per dim
    init: str = "normal"          # normal | zeros | ones | uniform
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_items(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``(path, leaf)`` pairs, paths joined with ``.``, in sorted key order
    (the order ``jax.tree.flatten`` visits a dict)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def tree_walk(tree: Any, *rest: Any) -> Iterator[tuple]:
    """``(leaf, the node of each of rest at the leaf's path)`` for every
    leaf of ``tree``, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_walk(tree[k], *(r[k] for r in rest))
    else:
        yield (tree, *rest)


def stack_specs(spec_tree, n: int) -> Any:
    """Prepend a stacked 'layers' dim of length n to every leaf."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init,
                            s.scale), spec_tree)


def init_params(spec_tree, generator: torch.Generator, dtype: torch.dtype,
                device: torch.device) -> Any:
    """Materialize a spec tree on ``device``, drawing from ``generator``
    (which lives on ``device``'s type) leaf by leaf in path order."""
    def draw(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dtype, device=device)
        if s.init == "uniform":
            return torch.empty(s.shape, dtype=dtype, device=device).uniform_(
                -s.scale, s.scale, generator=generator)
        a = torch.randn(s.shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (a.mul_(s.scale)).to(dtype)

    drawn = {path: draw(s) for path, s in tree_items(spec_tree)}
    return _unflatten(spec_tree, drawn)


def _unflatten(tree, flat: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}.")
                for k, v in tree.items()}
    return flat[prefix[:-1]]


def abstract_params(spec_tree, dtype: torch.dtype) -> Any:
    """Tensors on the ``meta`` device: shapes and dtypes, no allocation."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), spec_tree)


def param_bytes(spec_tree, dtype: torch.dtype) -> int:
    itemsize = dtype.itemsize
    total = 0
    for _, s in tree_items(spec_tree):
        n = 1
        for d in s.shape:
            n *= d
        total += n * itemsize
    return total
