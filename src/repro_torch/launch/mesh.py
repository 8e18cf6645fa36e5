"""Production mesh + logical-axis sharding rules (MaxText-style), as DTensor
placements.

Counterpart of ``repro.launch.mesh``.  A leaf's logical axes map through a
rule table to mesh axes (:func:`spec_for`, a tuple spec that equals the
reference's ``PartitionSpec`` entry for entry), and a spec maps to DTensor
placements on the grid's ``DeviceMesh``
(``repro_torch.dist.collectives.placements``): a dim split over a tuple of
mesh axes is split over them in mesh order, JAX's pod-major order.

``make_production_mesh`` is a function, so importing this module touches
no process group.  The production grids are
  single-pod:  (data=16, model=16)          = 256 ranks
  multi-pod:   (pod=2, data=16, model=16)   = 512 ranks
and they need a process group of that world size, as the reference needs
that many devices.

Axis names and the pod-aware batch rule come from
``repro_torch.dist.collectives``, the vocabulary the distributed CP-ALS
path resolves its grid from.

:func:`place` is the counterpart of ``jax.device_put`` with a sharding:
it distributes a tree of tensors every rank holds to DTensors.
:func:`install` sets the activation hook (``models.layers.shard_act``):
a DTensor is redistributed to its spec's placements (the counterpart of
``with_sharding_constraint``), a plain tensor every rank holds is made
one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.dist.collectives import (DATA_AXIS, MODEL_AXIS, POD_AXIS,
                                          Mesh, axis_product, batch_axes,
                                          make_mesh, placements)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The production grid on the current process group; ``device`` as in
    ``make_mesh`` (the dry-run names ``"cuda"`` over its fake group, so
    DTensor picks the card's collectives)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ((POD_AXIS, DATA_AXIS, MODEL_AXIS) if multi_pod
            else (DATA_AXIS, MODEL_AXIS))
    return make_mesh(shape, axes, device=device)


# ---------------------------------------------------------------------------
# logical axis -> mesh axis rules
# ---------------------------------------------------------------------------

# baseline rules; `embed` flips to the FSDP axis for cfg.fsdp archs
BASE_RULES: dict[str, Optional[str]] = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "experts_r": None,
    "embed": None,
    "embed_out": "model",
    "rnn": "model",
    "rnn_out": None,
    "layers": None,
    "norm": None,
    "conv": None,
    "lora": None,
    "five": None,
    # caches / activations
    "cache_batch": "data",
    "cache_seq": None,
    "act_batch": "data",
    # context-parallel flash attention: shard q blocks over 'model' for
    # archs whose head count does not divide the mesh
    "flash_q": None,
}


def rules_for(cfg=None, *, multi_pod: bool = False,
              overrides: dict | None = None) -> dict:
    rules = dict(BASE_RULES)
    if cfg is not None and getattr(cfg, "fsdp", False):
        rules["embed"] = "data"
    if multi_pod:
        # batch dims extend over the pod axis (pure DP across pods), the
        # pod-aware rule the CP-ALS row partition uses
        rules["cache_batch"] = batch_axes(multi_pod=True)
        rules["act_batch"] = batch_axes(multi_pod=True)
    if overrides:
        rules.update(overrides)
    return rules


def spec_for(axes: tuple, shape: tuple, mesh: Mesh, rules: dict, *,
             allow_uneven: bool = False) -> tuple:
    """The spec of a leaf with logical ``axes``: one entry a dim, a mesh
    axis name, a tuple of them, or None; trailing Nones trimmed.

    A dim is sharded only when divisible by its mesh axes, and no mesh axis
    serves two dims (the first dim that asks for it takes it)."""
    parts = []
    used: set = set()
    for dim, ax in zip(shape, axes):
        rule = rules.get(ax) if ax is not None else None
        if rule is None:
            parts.append(None)
            continue
        mesh_axes = rule if isinstance(rule, tuple) else (rule,)
        size = axis_product(mesh, mesh_axes)
        ok = (dim % size == 0) or (allow_uneven and dim >= size)
        if ok and not (set(mesh_axes) & used):
            parts.append(rule)
            used.update(mesh_axes)
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a grid (``jax.sharding.NamedSharding``): its DTensor
    ``placements`` on the grid's ``device_mesh``."""

    mesh: Mesh
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    @property
    def device_mesh(self):
        if self.mesh.device_mesh is None:
            raise ValueError("this grid was built by hand: it has no "
                             "DeviceMesh (make_mesh makes one)")
        return self.mesh.device_mesh


def sharding_fn(mesh: Mesh, rules: dict) -> Callable:
    """``(axes, shape) -> NamedSharding`` (its ``placements``) for a
    leaf."""
    def f(axes: tuple, shape: tuple) -> NamedSharding:
        return NamedSharding(mesh, spec_for(axes, tuple(shape), mesh, rules))
    return f


def batch_sharding(mesh: Mesh, rules: dict, kind: str,
                   shape: tuple) -> NamedSharding:
    """Sharding of an input-batch leaf: its batch dim on the act_batch
    rule when it divides, else replicated."""
    brule = rules.get("act_batch", DATA_AXIS)
    baxes = brule if isinstance(brule, tuple) else (brule,)
    size = axis_product(mesh, baxes)
    if kind == "positions":       # (3, B, S)
        spec = (None, brule, None) if shape[1] % size == 0 else ()
    elif kind == "tokens":        # (B, S)
        spec = (brule, None) if shape[0] % size == 0 else ()
    elif kind == "act":           # (B, S, D)
        spec = (brule, None, None) if shape[0] % size == 0 else ()
    else:
        spec = ()
    return NamedSharding(mesh, spec)


# ---------------------------------------------------------------------------
# placing trees, and the activation hook
# ---------------------------------------------------------------------------

def _distribute(x: torch.Tensor, sh: NamedSharding):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, sh.device_mesh, sh.placements)


def _zip_leaves(fn, tree, axes):
    if isinstance(tree, dict):
        return {k: _zip_leaves(fn, v, axes[k]) for k, v in tree.items()}
    return fn(tree, axes)


def place(tree: Any, axes_tree: Any, sharding_fn: Callable) -> Any:
    """Distribute a tree of tensors, the same on every rank, to DTensors:
    each leaf by ``sharding_fn(its axes, its shape)`` (``axes_tree`` has
    the tree's structure, a tuple of logical axes a leaf).  Every rank
    calls it.  A leaf's gradient flag is kept."""
    def one(x, axes):
        d = _distribute(x.detach(), sharding_fn(axes, tuple(x.shape)))
        return d.requires_grad_(x.requires_grad)
    return _zip_leaves(one, tree, axes_tree)


def place_model(model, sharding_fn: Callable):
    """The model's parameters replaced by their DTensors, placed by their
    specs' axes (every rank holds the same parameters before), one leaf at
    a time so that a leaf's old copy can go before the next is placed;
    returns the model."""
    from torch import nn

    from repro_torch.models.params import tree_items

    axes = {path: s.axes for path, s in tree_items(model.param_specs())}
    for name in [n for n, _ in model.named_parameters()]:
        owner, _, leaf = name.rpartition(".")
        p = model.get_parameter(name)
        d = _distribute(p.detach(), sharding_fn(axes[name], tuple(p.shape)))
        setattr(model.get_submodule(owner), leaf,
                nn.Parameter(d, requires_grad=p.requires_grad))
        del p, d
    return model


def install(mesh: Mesh, rules: dict) -> None:
    """Set the activation hook of ``mesh`` and ``rules``, and the mesh
    (expert-parallel MoE reads it); ``uninstall`` clears both.  The hook
    redistributes a DTensor to ``spec_for(axes, x.shape)``'s placements,
    and makes a plain tensor every rank holds one with them."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.models.layers import set_sharding_hook

    dm = mesh.device_mesh
    if dm is None:
        raise ValueError("the activation hook needs a mesh from make_mesh")
    replicated = [Replicate()] * len(mesh.axis_names)

    def hook(x: torch.Tensor, axes: tuple) -> torch.Tensor:
        pl = placements(mesh, spec_for(axes, tuple(x.shape), mesh, rules))
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, dm, replicated, run_check=False)
        if tuple(x.placements) == pl:
            return x
        return x.redistribute(dm, pl)

    set_sharding_hook(hook, mesh)


def uninstall() -> None:
    from repro_torch.models.layers import set_sharding_hook

    set_sharding_hook(None, None)
