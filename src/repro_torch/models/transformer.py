"""Config-driven stacked model: prefill / decode over a layer stack.

Counterpart of ``repro.models.transformer``.  The layer stack is
``prefix`` + ``pattern`` x reps + ``suffix``; the body's parameters (and its
cache) are stacked along a leading 'layers' dim of length reps, as in the
reference, and the forward pass loops over the reps where the reference
scans.

:class:`Model` is an ``nn.Module`` whose parameters sit at the reference's
tree paths joined with ``.`` (``embed.table``, ``stack.b0.attn.wq``,
``final_norm.w``): its ``state_dict()`` keys are the reference's leaf paths.
A new ``Model(cfg)`` holds its parameters on the ``meta`` device (nothing
allocated); ``init(generator, device)`` draws them, and
``load_state_dict(..., assign=True)`` takes given ones (see
``repro_torch.convert.lm_params_from_numpy``).

This slice ports the ``attn`` block kind with token inputs: the dense
family.  The other block kinds, the encoder-decoder, embedding inputs and
the training loss raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from repro_torch.core.coo import DeviceLike, resolve_device

from . import layers as L
from .config import ModelConfig
from .params import (ParamSpec, abstract_params, init_params, stack_specs,
                     tree_map)

# the ROADMAP items that hold what this package does not run yet
KINDS_ITEM = "ROADMAP §1 item 10b-1"
TRAIN_ITEM = "ROADMAP §1 item 10b-2"


def unported(cfg: ModelConfig) -> Optional[str]:
    """Why ``cfg`` cannot run in this package yet, or None."""
    kinds = sorted(set(cfg.prefix + cfg.pattern + cfg.suffix) - {"attn"})
    if kinds:
        return (f"{cfg.name}: block kinds {kinds} are not ported yet "
                f"({KINDS_ITEM})")
    if cfg.encdec:
        return (f"{cfg.name}: the encoder-decoder is not ported yet "
                f"({KINDS_ITEM})")
    if cfg.input_mode != "tokens" or cfg.rope == "mrope":
        return (f"{cfg.name}: embedding inputs and M-RoPE positions are not "
                f"ported yet ({KINDS_ITEM})")
    return None


# ---------------------------------------------------------------------------
# per-block specs
# ---------------------------------------------------------------------------

def block_specs(cfg: ModelConfig, kind: str) -> dict:
    if kind == "attn":
        return {"n1": L.norm_specs(cfg), "attn": L.attn_specs(cfg),
                "n2": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}
    raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                              f"({KINDS_ITEM})")


def apply_block(kind: str, p: dict, cfg: ModelConfig, x: torch.Tensor,
                ctx: dict):
    """Returns (x, new_cache, metrics)."""
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                                  f"({KINDS_ITEM})")
    cache = ctx.get("cache")
    h, acache = L.attention(
        p["attn"], cfg, L.apply_norm(p["n1"], cfg, x),
        mask_kind=ctx["mask_kind"], positions=ctx.get("positions"),
        cache=cache.get("self") if cache else None, pos=ctx.get("pos"))
    x = x + h
    new_cache = {"self": acache} if cache is not None else None
    h2 = L.mlp(p["mlp"], cfg, L.apply_norm(p["n2"], cfg, x))
    return x + h2, new_cache, {}


def _block_mask_kind(cfg: ModelConfig, kind: str) -> str:
    return "local" if cfg.attn_kind == "local" else "causal"


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def _block_cache_spec(cfg: ModelConfig, kind: str, batch: int,
                      cache_len: int) -> dict:
    """The ``attn`` kind's cache (the only kind a Model admits)."""
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    cap = min(cfg.window, cache_len) if cfg.attn_kind == "local" else cache_len
    return {"self": {
        "k": ParamSpec((batch, cap, kv, hd),
                       ("cache_batch", "cache_seq", "kv_heads", "head_dim"),
                       "zeros"),
        "v": ParamSpec((batch, cap, kv, hd),
                       ("cache_batch", "cache_seq", "kv_heads", "head_dim"),
                       "zeros"),
        "slot_pos": ParamSpec((cap,), ("cache_seq",), "zeros"),
    }}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _module_tree(tree: dict) -> nn.Module:
    """An ``nn.Module`` holding ``tree``'s tensors as parameters, one
    submodule per inner dict, so each parameter's name is its path."""
    mod = nn.Module()
    for key, val in tree.items():
        if isinstance(val, dict):
            mod.add_module(key, _module_tree(val))
        else:
            mod.register_parameter(key, nn.Parameter(val))
    return mod


def _param_tree(mod: nn.Module) -> dict:
    """The nested dict of a :func:`_module_tree` module's parameters."""
    out: dict[str, Any] = dict(mod._parameters)
    for key, sub in mod._modules.items():
        out[key] = _param_tree(sub)
    return out


class Model(nn.Module):
    """The stacked model bound to a ModelConfig (see the module doc)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        why = unported(cfg)
        if why is not None:
            raise NotImplementedError(why)
        self.cfg = cfg
        self.prefix_kinds, self.reps, self.suffix_kinds = cfg.layer_plan
        self.pattern = cfg.pattern
        for key, sub in self.abstract().items():
            self.add_module(key, _module_tree(sub))

    # -- parameter specs ----------------------------------------------------
    def param_specs(self) -> dict:
        cfg = self.cfg
        specs: dict[str, Any] = {"embed": L.embed_specs(cfg)}
        if self.prefix_kinds:
            specs["prefix"] = {f"p{i}": block_specs(cfg, k)
                               for i, k in enumerate(self.prefix_kinds)}
        unit = {f"b{i}": block_specs(cfg, k)
                for i, k in enumerate(self.pattern)}
        specs["stack"] = stack_specs(unit, self.reps)
        if self.suffix_kinds:
            specs["suffix"] = {f"s{i}": block_specs(cfg, k)
                               for i, k in enumerate(self.suffix_kinds)}
        specs["final_norm"] = L.norm_specs(cfg)
        return specs

    def init(self, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> "Model":
        """Draw every parameter on ``device`` (the card when None) from
        ``generator`` (seed 0 on ``device`` when None); returns self."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        tree = init_params(self.param_specs(), generator, self.cfg.pdtype,
                           dev)
        flat = dict(_flat(tree))
        self.load_state_dict(flat, assign=True)
        return self

    def abstract(self) -> dict:
        """The parameter tree on the ``meta`` device (no allocation)."""
        return abstract_params(self.param_specs(), self.cfg.pdtype)

    def params(self) -> dict:
        """The parameters as the reference's nested tree."""
        return {key: _param_tree(mod) for key, mod in self._modules.items()}

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    # -- cache specs ----------------------------------------------------------
    def cache_specs(self, batch: int, cache_len: int) -> dict:
        cfg = self.cfg
        mk = lambda k: _block_cache_spec(cfg, k, batch, cache_len)  # noqa: E731
        out: dict[str, Any] = {}
        if self.prefix_kinds:
            out["prefix"] = {f"p{i}": mk(k)
                             for i, k in enumerate(self.prefix_kinds)}
        unit = {f"b{i}": mk(k) for i, k in enumerate(self.pattern)}
        out["stack"] = stack_specs(unit, self.reps)
        if self.suffix_kinds:
            out["suffix"] = {f"s{i}": mk(k)
                             for i, k in enumerate(self.suffix_kinds)}
        return out

    def init_cache(self, batch: int, cache_len: int, *,
                   device: DeviceLike = None) -> dict:
        """A zeroed cache on ``device`` (the parameters' device when None):
        K/V in ``cdtype``, ``slot_pos`` int32 at the empty-slot sentinel."""
        dev = self.device if device is None else torch.device(device)
        cache = tree_map(lambda s: torch.zeros(s.shape, dtype=torch.float32,
                                               device=dev),
                         self.cache_specs(batch, cache_len))
        return self._fix_cache_dtypes(cache)

    def _fix_cache_dtypes(self, cache: dict) -> dict:
        return _fix_cache_dtypes(cache, self.cfg.cdtype)

    # -- forward ------------------------------------------------------------
    def forward(self, batch: dict, *, mode: str = "train", cache=None,
                pos=None):
        """mode: train | prefill | decode | hidden.  Returns (logits,
        new_cache, metrics); prefill and decode keep only the last
        position's logits, and update ``cache`` in place."""
        cfg = self.cfg
        params = self.params()
        x = L.embed(params["embed"], cfg, batch["tokens"])
        use_cache = cache is not None
        base_ctx = {"positions": batch.get("positions"), "pos": pos}
        new_cache: dict[str, Any] = {}

        def run_block(kind, p, x, c):
            ctx = dict(base_ctx, mask_kind=_block_mask_kind(cfg, kind),
                       cache=c)
            return apply_block(kind, p, cfg, x, ctx)

        def run_unstacked(x, part, kinds, tag):
            if use_cache:
                new_cache[part] = {}
            for i, kind in enumerate(kinds):
                c = cache[part][f"{tag}{i}"] if use_cache else None
                x, nc, _ = run_block(kind, params[part][f"{tag}{i}"], x, c)
                if use_cache:
                    new_cache[part][f"{tag}{i}"] = nc
            return x

        if self.prefix_kinds:
            x = run_unstacked(x, "prefix", self.prefix_kinds, "p")
        # the stacked body, one rep at a time (the reference's scan); the
        # cache's stacked tensors are written in place through the views
        for r in range(self.reps):
            unit = tree_map(lambda a: a[r], params["stack"])
            ucache = (tree_map(lambda a: a[r], cache["stack"])
                      if use_cache else None)
            for i, kind in enumerate(self.pattern):
                c = ucache[f"b{i}"] if use_cache else None
                x, _, _ = run_block(kind, unit[f"b{i}"], x, c)
        if use_cache:
            new_cache["stack"] = cache["stack"]
        if self.suffix_kinds:
            x = run_unstacked(x, "suffix", self.suffix_kinds, "s")

        x = L.apply_norm(params["final_norm"], cfg, x)
        if mode in ("prefill", "decode"):
            x = x[:, -1:]  # only the last position's logits are needed
        out_cache = new_cache if use_cache else None
        if mode == "hidden":
            return x, out_cache, {}
        return L.unembed(params["embed"], cfg, x), out_cache, {}

    # -- public steps ---------------------------------------------------------
    def loss(self, batch):
        raise NotImplementedError(f"Model.loss (training) is not ported yet "
                                  f"({TRAIN_ITEM})")

    @torch.no_grad()
    def prefill(self, batch: dict, cache: dict):
        logits, new_cache, _ = self.forward(batch, mode="prefill",
                                            cache=cache)
        return logits, new_cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: dict, pos, *,
                    positions=None):
        """tokens (B, 1) -> (logits (B,1,V), new_cache); ``pos`` is the
        position being written (an int)."""
        batch = {"tokens": tokens}
        if positions is not None:
            batch["positions"] = positions
        logits, new_cache, _ = self.forward(batch, mode="decode",
                                            cache=cache, pos=pos)
        return logits, new_cache


def _fix_cache_dtypes(tree: dict, cdtype: torch.dtype) -> dict:
    """K/V in ``cdtype``; ``slot_pos`` at a large POSITIVE sentinel, so
    empty slots fail ``spos <= pos``.  (Module level: a recursive closure
    would hold the model in a reference cycle.)"""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = _fix_cache_dtypes(leaf, cdtype)
        elif name == "slot_pos":
            out[name] = torch.full(leaf.shape, 2 ** 30, dtype=torch.int32,
                                   device=leaf.device)
        elif name in ("k", "v"):
            out[name] = leaf.to(cdtype)
        else:
            out[name] = leaf
    return out


def _flat(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val
