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

Every block kind runs: ``attn``, ``moe`` (``moe.py``), ``rec`` (RG-LRU,
``rglru.py``) and ``rwkv`` (``rwkv.py``), with token or embedding inputs
(M-RoPE positions ride in the batch) and the encoder-decoder (its encoder
runs on ``src_embeds``; the decoder's cross K/V are cached at prefill).
Every cache, recurrent states included, is written in place, so a cache
tree's tensors stay the same objects from step to step.

Training: :meth:`Model.loss` is the reference's float32 cross-entropy (whole
logits, or ``cfg.chunked_loss`` positions at a time), and gradients come from
``torch.autograd``.  Under ``cfg.remat`` a training forward recomputes each
rep of the stacked body in the backward pass
(``torch.utils.checkpoint``); ``remat_policy="dots"`` keeps the products
without batch dims, as JAX's ``dots_with_no_batch_dims_saveable`` does.
Each stacked leaf is split into its reps once a forward (``unbind``), so its
gradient is one ``stack`` of the reps' gradients.
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import torch
from torch import nn

from repro_torch.core.coo import DeviceLike, resolve_device

from . import layers as L
from . import moe as MOE
from . import rglru as RG
from . import rwkv as RW
from .config import ModelConfig
from .params import (ParamSpec, abstract_params, init_params, stack_specs,
                     tree_map)

# ---------------------------------------------------------------------------
# per-block specs
# ---------------------------------------------------------------------------

def block_specs(cfg: ModelConfig, kind: str, *, decoder: bool = False) -> dict:
    if kind == "attn":
        out = {"n1": L.norm_specs(cfg), "attn": L.attn_specs(cfg),
               "n2": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}
        if decoder and cfg.encdec:
            out["nx"] = L.norm_specs(cfg)
            out["xattn"] = L.attn_specs(cfg)
        return out
    if kind == "moe":
        return {"n1": L.norm_specs(cfg), "attn": L.attn_specs(cfg),
                "n2": L.norm_specs(cfg), "moe": MOE.moe_specs(cfg)}
    if kind == "rec":
        return {"n1": L.norm_specs(cfg), "rec": RG.rglru_specs(cfg),
                "n2": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}
    if kind == "rwkv":
        return {"n1": L.norm_specs(cfg), "n2": L.norm_specs(cfg),
                "rwkv": RW.rwkv_specs(cfg)}
    raise ValueError(kind)


def apply_block(kind: str, p: dict, cfg: ModelConfig, x: torch.Tensor,
                ctx: dict):
    """Returns (x, new_cache, metrics); a given cache is written in place."""
    cache = ctx.get("cache")
    metrics: dict = {}
    if kind in ("attn", "moe"):
        h, acache = L.attention(
            p["attn"], cfg, L.apply_norm(p["n1"], cfg, x),
            mask_kind=ctx["mask_kind"], positions=ctx.get("positions"),
            cache=cache.get("self") if cache else None, pos=ctx.get("pos"))
        x = _residual(x, h)
        new_cache = {"self": acache} if cache is not None else None
        if cfg.encdec and "xattn" in p:
            h, xcache = L.attention(
                p["xattn"], cfg, L.apply_norm(p["nx"], cfg, x),
                mask_kind="bidir", memory=ctx.get("memory"),
                cache=cache.get("cross") if cache else None,
                pos=ctx.get("pos"))
            x = _residual(x, h)
            if new_cache is not None:
                new_cache["cross"] = xcache
        h2 = L.apply_norm(p["n2"], cfg, x)
        if kind == "moe":
            h2, metrics = MOE.moe_ffn(p["moe"], cfg, h2)
        else:
            h2 = L.mlp(p["mlp"], cfg, h2)
        return _residual(x, h2), new_cache, metrics
    if kind == "rec":
        h, rcache = RG.rglru_block(p["rec"], cfg,
                                   L.apply_norm(p["n1"], cfg, x), cache)
        x = _residual(x, h)
        return (_residual(x, L.mlp(p["mlp"], cfg,
                                   L.apply_norm(p["n2"], cfg, x))),
                rcache, metrics)
    if kind == "rwkv":
        h, c1 = RW.time_mix(p["rwkv"], cfg, L.apply_norm(p["n1"], cfg, x),
                            cache, use_chunked=ctx.get("chunked", False))
        x = _residual(x, h)
        h2, c2 = RW.channel_mix(p["rwkv"], cfg, L.apply_norm(p["n2"], cfg, x),
                                c1)
        return _residual(x, h2), c2, metrics
    raise ValueError(kind)


# the residual stream's axes, as the embedding places the hidden
HIDDEN = ("act_batch", None, None)


def _residual(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``x + h``, ``h`` placed as the embedding places the hidden (its batch
    on the data axes, the rest whole on every rank): a block's output
    products leave ``h`` a partial sum over the model axis, and it is
    reduced here, before the next norm, as GSPMD reduces it; the next MLP
    then runs its own block of ``mlp`` on each model rank.  The sum's
    gradient is reduced the same way (``layers.pinned``)."""
    return L.pinned(x + L.shard_act(h, HIDDEN), HIDDEN)


def _block_mask_kind(cfg: ModelConfig, kind: str, *,
                     encoder: bool = False) -> str:
    if encoder:
        return "bidir"
    if kind in ("attn", "moe") and cfg.attn_kind == "local":
        return "local"
    return "causal"


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def _block_cache_spec(cfg: ModelConfig, kind: str, batch: int,
                      cache_len: int, *, src_len: int = 0,
                      decoder: bool = False) -> dict:
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    if kind in ("attn", "moe"):
        cap = (min(cfg.window, cache_len) if cfg.attn_kind == "local"
               else cache_len)
        kv_axes = ("cache_batch", "cache_seq", "kv_heads", "head_dim")
        spec = {"self": {
            "k": ParamSpec((batch, cap, kv, hd), kv_axes, "zeros"),
            "v": ParamSpec((batch, cap, kv, hd), kv_axes, "zeros"),
            "slot_pos": ParamSpec((cap,), ("cache_seq",), "zeros"),
        }}
        if decoder and cfg.encdec:
            spec["cross"] = {
                "ck": ParamSpec((batch, src_len, kv, hd), kv_axes, "zeros"),
                "cv": ParamSpec((batch, src_len, kv, hd), kv_axes, "zeros"),
            }
        return spec
    if kind == "rec":
        w = cfg.rglru_width or cfg.d_model
        return {"h": ParamSpec((batch, w), ("cache_batch", "rnn"), "zeros"),
                "conv": ParamSpec((batch, cfg.conv_width - 1, w),
                                  ("cache_batch", None, "rnn"), "zeros")}
    if kind == "rwkv":
        d, n = cfg.d_model, cfg.rwkv_head_dim
        return {
            "state": ParamSpec((batch, d // n, n, n),
                               ("cache_batch", "heads", None, None), "zeros"),
            "tm_prev": ParamSpec((batch, d), ("cache_batch", "embed"),
                                 "zeros"),
            "cm_prev": ParamSpec((batch, d), ("cache_batch", "embed"),
                                 "zeros"),
        }
    raise ValueError(kind)


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
        self.cfg = cfg
        self.prefix_kinds, self.reps, self.suffix_kinds = cfg.layer_plan
        self.pattern = cfg.pattern
        for key, sub in self.abstract().items():
            self.add_module(key, _module_tree(sub))

    # -- parameter specs ----------------------------------------------------
    def param_specs(self) -> dict:
        cfg = self.cfg
        dec = cfg.encdec
        specs: dict[str, Any] = {"embed": L.embed_specs(cfg)}
        if self.prefix_kinds:
            specs["prefix"] = {f"p{i}": block_specs(cfg, k, decoder=dec)
                               for i, k in enumerate(self.prefix_kinds)}
        unit = {f"b{i}": block_specs(cfg, k, decoder=dec)
                for i, k in enumerate(self.pattern)}
        specs["stack"] = stack_specs(unit, self.reps)
        if self.suffix_kinds:
            specs["suffix"] = {f"s{i}": block_specs(cfg, k, decoder=dec)
                               for i, k in enumerate(self.suffix_kinds)}
        specs["final_norm"] = L.norm_specs(cfg)
        if cfg.encdec:
            specs["encoder"] = {
                "stack": stack_specs({"b0": block_specs(cfg, "attn")},
                                     cfg.enc_layers),
                "final_norm": L.norm_specs(cfg),
            }
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

    def abstract(self, sharding_fn=None) -> dict:
        """The parameter tree on the ``meta`` device (no allocation); with
        ``sharding_fn``, meta DTensors with their placements."""
        return abstract_params(self.param_specs(), self.cfg.pdtype,
                               sharding_fn)

    def params(self) -> dict:
        """The parameters as the reference's nested tree."""
        return {key: _param_tree(mod) for key, mod in self._modules.items()}

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    # -- cache specs ----------------------------------------------------------
    def cache_specs(self, batch: int, cache_len: int, *,
                    src_len: int = 0) -> dict:
        cfg = self.cfg
        dec = cfg.encdec

        def mk(kind):
            return _block_cache_spec(cfg, kind, batch, cache_len,
                                     src_len=src_len, decoder=dec)

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

    def init_cache(self, batch: int, cache_len: int, *, src_len: int = 0,
                   device: DeviceLike = None) -> dict:
        """A zeroed cache on ``device`` (the parameters' device when None),
        in the reference's dtypes: recurrent ``state`` and ``h`` float32,
        ``slot_pos`` int32 at the empty-slot sentinel, the rest ``cdtype``.
        With a sharding hook installed, each leaf is placed by its logical
        axes (``cache_batch`` on the data axes, ``kv_heads`` on the model
        axis), as the reference places its cache."""
        dev = self.device if device is None else torch.device(device)
        specs = self.cache_specs(batch, cache_len, src_len=src_len)
        cache = _zero_cache(specs, self.cfg.cdtype, dev)
        if L.sharded():
            cache = _map_with_specs(lambda t, s: L.shard_act(t, s.axes),
                                    cache, specs)
        return cache

    # -- forward ------------------------------------------------------------
    def _inputs_to_x(self, params: dict, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        if cfg.input_mode == "embeds":
            # placed on the batch axes, as ``layers.embed`` places the
            # tokens' rows: a plain input that autograd saved would meet a
            # DTensor gradient in the backward
            x = L.shard_act(batch["embeds"].to(cfg.cdtype),
                            ("act_batch", None, None))
            if cfg.scale_embed:
                x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                                     device=x.device)
            return x
        return L.embed(params["embed"], cfg, batch["tokens"])

    def _encode(self, params: dict, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        x = L.shard_act(batch["src_embeds"].to(cfg.cdtype),
                        ("act_batch", None, None))
        enc = params["encoder"]
        ctx = {"mask_kind": _block_mask_kind(cfg, "attn", encoder=True)}
        reps = tree_map(lambda a: a.unbind(0), enc["stack"])
        for r in range(cfg.enc_layers):
            unit = tree_map(lambda a: a[r], reps)
            x, _, _ = apply_block("attn", unit["b0"], cfg, x, ctx)
        return L.apply_norm(enc["final_norm"], cfg, x)

    def forward(self, batch: dict, *, mode: str = "train", cache=None,
                pos=None):
        """mode: train | prefill | decode | hidden.  Returns (logits,
        new_cache, metrics); prefill and decode keep only the last
        position's logits, and update ``cache`` in place.  The metrics (the
        MoE blocks') are the reference's: the stack's averaged over its
        reps, then every block entry's averaged."""
        with L.mixed():
            return self._forward(batch, mode=mode, cache=cache, pos=pos)

    def _forward(self, batch: dict, *, mode: str, cache, pos):
        cfg = self.cfg
        params = self.params()
        x = self._inputs_to_x(params, batch)
        memory = self._encode(params, batch) if cfg.encdec else None
        use_cache = cache is not None
        # the chunked (parallel-form) WKV only under the reference's cost
        # probes; serving runs the sequential scan
        base_ctx = {"positions": batch.get("positions"), "memory": memory,
                    "pos": pos, "chunked": cfg.unroll_loops}
        metrics_acc: list[dict] = []
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
                x, nc, met = run_block(kind, params[part][f"{tag}{i}"], x, c)
                if use_cache:
                    new_cache[part][f"{tag}{i}"] = nc
                metrics_acc.append(met)
            return x

        if self.prefix_kinds:
            x = run_unstacked(x, "prefix", self.prefix_kinds, "p")

        def run_unit(x, unit, ucache):
            mets: dict = {}
            for i, kind in enumerate(self.pattern):
                c = ucache[f"b{i}"] if use_cache else None
                x, _, met = run_block(kind, unit[f"b{i}"], x, c)
                mets.update(met)
            return x, mets

        if cfg.remat and mode == "train":
            run_unit = _remat(run_unit, cfg.remat_policy)
        # the stacked body, one rep at a time (the reference's scan); the
        # cache's stacked tensors are written in place through the views
        reps = tree_map(lambda a: a.unbind(0), params["stack"])
        stack_mets: dict[str, list] = {}
        for r in range(self.reps):
            ucache = (tree_map(lambda a: a[r], cache["stack"])
                      if use_cache else None)
            x, mets = run_unit(x, tree_map(lambda a: a[r], reps), ucache)
            for k, v in mets.items():
                stack_mets.setdefault(k, []).append(v)
        if stack_mets:
            metrics_acc.append({k: torch.stack(v).mean()
                                for k, v in stack_mets.items()})
        if use_cache:
            new_cache["stack"] = cache["stack"]
        if self.suffix_kinds:
            x = run_unstacked(x, "suffix", self.suffix_kinds, "s")

        x = L.apply_norm(params["final_norm"], cfg, x)
        if mode in ("prefill", "decode"):
            x = x[:, -1:]  # only the last position's logits are needed

        metrics: dict = {}
        for m in metrics_acc:
            for k, v in m.items():
                metrics[k] = metrics.get(k, 0.0) + v / max(1, len(metrics_acc))
        out_cache = new_cache if use_cache else None
        if mode == "hidden":
            return x, out_cache, metrics
        return L.unembed(params["embed"], cfg, x), out_cache, metrics

    # -- public steps ---------------------------------------------------------
    def loss(self, batch: dict):
        """Mean next-token cross-entropy over the labels ``>= 0``, in
        float32: ``(ce, metrics)``, the metrics the forward's with ``loss``
        added (the MoE ones are reported, not added to the loss).  With
        ``cfg.chunked_loss`` the (B, S, V) logits are never whole: the
        unembedding and the cross-entropy run one sequence chunk at a
        time."""
        with L.mixed():  # around the forward too: one context, not nested
            return self._loss(batch)

    def _loss(self, batch: dict):
        cfg = self.cfg
        labels = batch["labels"]
        if cfg.chunked_loss:
            x, _, metrics = self._forward(batch, mode="hidden", cache=None,
                                          pos=None)
            c = cfg.chunked_loss
            s = x.shape[1]
            if s % c:
                raise ValueError(f"sequence {s} is not a multiple of "
                                 f"chunked_loss {c}")
            emb = self.params()["embed"]
            tot = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
            for i in range(0, s, c):
                t, n = _ce_sums(L.unembed(emb, cfg, x[:, i:i + c]),
                                labels[:, i:i + c])
                tot, cnt = tot + t, cnt + n
        else:
            logits, _, metrics = self._forward(batch, mode="train",
                                               cache=None, pos=None)
            tot, cnt = _ce_sums(logits, labels)
        ce = tot / torch.clamp(cnt, min=1.0)
        return ce, dict(metrics, loss=ce)

    @torch.no_grad()
    def prefill(self, batch: dict, cache: dict):
        logits, new_cache, _ = self.forward(batch, mode="prefill",
                                            cache=cache)
        return logits, new_cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: dict, pos, *,
                    positions=None):
        """tokens (B, 1) -> (logits (B,1,V), new_cache); ``pos`` is the
        position being written (an int).  Decode runs in token space: an
        ``embeds`` model embeds the token through its table, and an
        encoder-decoder reads the cross K/V its prefill cached (a zero
        (B, 1, D) source goes through the encoder, as in the reference)."""
        cfg = self.cfg
        batch = {"tokens": tokens}
        if cfg.input_mode == "embeds":
            batch = {"embeds": L.embed({"table": self.embed.table}, cfg,
                                       tokens)}
        if positions is not None:
            batch["positions"] = positions
        if cfg.encdec:
            batch["src_embeds"] = torch.zeros(
                (tokens.shape[0], 1, cfg.d_model), dtype=cfg.cdtype,
                device=tokens.device)
        logits, new_cache, _ = self.forward(batch, mode="decode",
                                            cache=cache, pos=pos)
        return logits, new_cache


def _ce_sums(logits: torch.Tensor, labels: torch.Tensor):
    """(sum of the float32 cross-entropy over the labels >= 0, their
    count).  A masked label gathers class 0; its term is multiplied by 0."""
    lf = logits.float()
    labels = L.shard_act(labels.long(), ("act_batch", None))
    if L.is_placed(lf):  # each rank reduces and reads its own vocab block
        lse = L.vocab_logsumexp(lf)
        gold = L.take_along_vocab(lf, labels.clamp(min=0))
    else:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels.clamp(min=0)[..., None])[..., 0]
    valid = (labels >= 0).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def _save_dots(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable`` in torch's ops: keep a
    product with no batch dims (``mm``, or the batch-of-one ``bmm`` that
    ``einsum`` folds a projection into); recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if op is aten.mm.default or (op is aten.bmm.default
                                 and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """``fn`` recomputed in the backward pass (the reference's
    ``jax.checkpoint``): everything under ``"full"``, all but the products
    without batch dims under ``"dots"``."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    # the model draws no random numbers: no RNG state to replay
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False, **kw)


# the leaves in ``cdtype`` (the reference's ``_fix_cache_dtypes``); the
# recurrent ``state`` and ``h`` are float32
_CDTYPE_LEAVES = ("k", "v", "ck", "cv", "conv", "tm_prev", "cm_prev")


def _zero_cache(specs: dict, cdtype: torch.dtype, dev) -> dict:
    """A zeroed cache for a spec tree; ``slot_pos`` at a large POSITIVE
    sentinel, so empty slots fail ``spos <= pos``.  (Module level: a
    recursive closure would hold the model in a reference cycle.)"""
    out = {}
    for name, spec in specs.items():
        if isinstance(spec, dict):
            out[name] = _zero_cache(spec, cdtype, dev)
        elif name == "slot_pos":
            out[name] = torch.full(spec.shape, 2 ** 30, dtype=torch.int32,
                                   device=dev)
        else:
            dt = cdtype if name in _CDTYPE_LEAVES else torch.float32
            out[name] = torch.zeros(spec.shape, dtype=dt, device=dev)
    return out


def _map_with_specs(fn, tree: dict, specs: dict) -> dict:
    """``fn(leaf, its spec)`` over a tree and its spec tree."""
    return {k: (_map_with_specs(fn, v, specs[k]) if isinstance(v, dict)
                else fn(v, specs[k])) for k, v in tree.items()}


def _flat(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val
