"""int8 gradient compression with error feedback, over nested dicts of
tensors (counterpart of ``repro.dist.compress``).

Quantising each gradient leaf to int8 plus one float32 scale cuts the
data-parallel all-reduce's volume about 4x against float32.  Plain
quantisation biases the update; error feedback (Seide et al., 2014;
Karimireddy et al., 2019) carries each element's quantisation residual into
the next step, so the accumulated update is unbiased.

Scheme, per floating-point leaf ``g`` with residual ``e``:

    a     = f32(g) + e                  # fold in last step's residual
    scale = max|a| / 127                # symmetric per-tensor scale
    q     = clip(round(a / scale))      # int8 payload (round half to even)
    e'    = a - q * scale               # residual carried forward

Non-float leaves pass through with a unit scale and a zero residual.  The
train step (``repro_torch.launch.steps.make_train_step(...,
grad_compress=True)``) keeps the residual tree in ``opt_state["ef"]`` and
runs the quantise -> dequantise loop where the all-reduce would sit.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import tree_items, tree_map

_QMAX = 127.0  # symmetric int8: [-127, 127]; -128 unused


def init_error_feedback(params):
    """Zero residual tree matching ``params`` (float32, one leaf per leaf)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _zip_map(fn, tree, other):
    """``fn(leaf, other's node at its path or None)`` over a nested dict."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, None if other is None else other[k])
                for k, v in tree.items()}
    return fn(tree, other)


@torch.no_grad()
def _quantize_leaf(g: torch.Tensor, e: torch.Tensor):
    a = g.float() + e
    scale = a.abs().max() / _QMAX
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(a / safe), -_QMAX, _QMAX).to(torch.int8)
    return q, scale, a.sub_(q.float() * scale)


@torch.no_grad()
def compress_grads_int8(grads, ef=None):
    """Quantise every float leaf of ``grads`` to (int8, float32 scale).

    Returns ``(q, scales, new_ef)``, three trees with the structure of
    ``grads``.  ``ef`` is the residual tree of the previous step (None means
    zero residuals); its tensors are overwritten with the new residuals,
    which ``new_ef`` holds.  Non-float leaves pass through in ``q``
    untouched, with a unit scale and a zero residual."""
    if ef is not None and (sorted(p for p, _ in tree_items(ef))
                           != sorted(p for p, _ in tree_items(grads))):
        raise ValueError("error-feedback tree does not match gradient tree")

    def one(g, e):
        if not g.is_floating_point():
            return (g, torch.ones((), dtype=torch.float32, device=g.device),
                    torch.zeros(g.shape, dtype=torch.float32,
                                device=g.device))
        q, s, ne = _quantize_leaf(g, 0.0 if e is None else e)
        return q, s, (ne if e is None else e.copy_(ne))

    out = _zip_map(one, grads, ef)
    return tuple(tree_map(lambda t, i=i: t[i], out) for i in range(3))


def decompress_grads_int8(q, scales):
    """Inverse of :func:`compress_grads_int8`: int8 leaves -> float32 *
    scale; passthrough leaves are returned as they are."""
    return _zip_map(lambda qq, s: qq.float() * s if qq.dtype == torch.int8
                    else qq, q, scales)


def compression_ratio(grads) -> float:
    """Wire-bytes ratio (uncompressed / compressed) for a gradient tree."""
    raw = comp = 0
    for _, g in tree_items(grads):
        n = g.numel()
        raw += n * g.element_size()
        comp += (n + 4) if g.is_floating_point() else n * g.element_size()
    return raw / max(comp, 1)
