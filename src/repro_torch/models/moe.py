"""Mixture-of-Experts FFN: top-k router + sort-based capacity dispatch.

Counterpart of ``repro.models.moe``.  The single-host dispatch: tokens'
(token, expert) assignments are sorted by expert id (a stable sort, as
``jnp.argsort``), each expert takes at most ``capacity`` tokens, the expert
FFN is one batched product over the (E, C, D) buffer, and results scatter
back with the router's combine weights.  A dropped assignment writes to one
spare buffer row, sliced off afterwards (the reference's out-of-bounds
``mode="drop"``).

With a mesh installed (``repro_torch.launch.mesh.install``) and shapes
that divide it, ``moe_ffn`` takes the expert-parallel dispatch
(``moe_ffn_ep``): a ``shard_map`` over the placed tensors whose two
exchanges are differentiable ``all_to_all``s over the model axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.dist.collectives import psum, shard_map

from .config import ModelConfig
from .layers import replicated_like, shard_act
from .params import ParamSpec


def moe_specs(cfg: ModelConfig) -> dict:
    e = cfg.moe
    d, f = cfg.d_model, e.d_ff
    out = {
        "router": ParamSpec((d, e.num_experts), ("embed", "experts_r")),
        "wg": ParamSpec((e.num_experts, d, f), ("experts", "embed", "mlp")),
        "wu": ParamSpec((e.num_experts, d, f), ("experts", "embed", "mlp")),
        "wd": ParamSpec((e.num_experts, f, d), ("experts", "mlp", "embed")),
    }
    if e.num_shared:
        out["shared_wg"] = ParamSpec((d, e.num_shared * f), ("embed", "mlp"))
        out["shared_wu"] = ParamSpec((d, e.num_shared * f), ("embed", "mlp"))
        out["shared_wd"] = ParamSpec((e.num_shared * f, d), ("mlp", "embed"))
    return out


def capacity(cfg: ModelConfig, num_tokens: int) -> int:
    e = cfg.moe
    c = int(e.top_k * num_tokens * e.capacity_factor / e.num_experts)
    return max(8, -(-c // 8) * 8)  # pad to sublane multiple


def _expert_act(cfg: ModelConfig, h_g: torch.Tensor,
                h_u: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    if cfg.mlp == "geglu":
        return F.gelu(h_g, approximate="tanh") * h_u
    return F.silu(h_g) * h_u


def moe_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x (B, S, D) -> (out, metrics): the expert-parallel dispatch when a
    mesh is installed and the batch, the sequence and the experts divide
    it (the production path), the single-host dispatch otherwise."""
    from .layers import get_mesh

    mesh = get_mesh()
    if mesh is not None:
        ncol = mesh.shape["model"]
        dp = mesh.axis_size(tuple(a for a in mesh.axis_names
                                  if a != "model"))
        if (x.shape[0] % dp == 0 and x.shape[1] % ncol == 0
                and cfg.moe.num_experts % ncol == 0):
            return moe_ffn_ep(p, cfg, x, mesh)
    return _moe_ffn_dense_dispatch(p, cfg, x)


def _moe_ffn_dense_dispatch(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x (B, S, D) -> (out, metrics). Dropped tokens pass through as zeros
    from the routed experts (shared experts still contribute).

    Under a mesh (shapes that do not divide it, as a decode step's one
    position) the routing is computed whole on every rank, since ``sort``
    and ``searchsorted`` have no DTensor rule: ``x``, the router, the
    experts' output buffer and the shared experts are replicated
    explicitly, and only the expert products run on the buffer placed over
    the experts."""
    e = cfg.moe
    b, s, d = x.shape
    t = b * s
    dev = x.device
    xt = _whole(x).reshape(t, d)

    # the router runs in float32 (the reference promotes xt to it)
    logits = xt.float() @ _whole(p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, e.top_k, dim=-1)     # (T, k), descending
    topv = topv / topv.sum(dim=-1, keepdim=True)        # renormalize

    flat_e = topi.reshape(t * e.top_k)
    flat_w = topv.reshape(t * e.top_k)
    flat_tok = torch.arange(t * e.top_k, device=dev) // e.top_k

    order = torch.sort(flat_e, stable=True).indices
    se, sw, st = flat_e[order], flat_w[order], flat_tok[order]

    # rank of each entry within its expert
    starts = torch.searchsorted(se, torch.arange(e.num_experts, device=dev))
    rank = torch.arange(t * e.top_k, device=dev) - starts[se]

    cap = capacity(cfg, t)
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank,
                       torch.full_like(se, e.num_experts * cap))

    # one spare row takes every dropped assignment, then goes
    buf = torch.zeros((e.num_experts * cap + 1, d), dtype=x.dtype,
                      device=dev)
    buf[slot] = xt[st]
    h = shard_act(buf[:-1].reshape(e.num_experts, cap, d),
                  ("experts", None, None))

    h_g = torch.bmm(h, p["wg"])
    h_u = torch.bmm(h, p["wu"])
    y = shard_act(torch.bmm(_expert_act(cfg, h_g, h_u), p["wd"]),
                  ("experts", None, None))
    yt = _whole(y).reshape(e.num_experts * cap, d)

    gathered = yt[torch.clamp(slot, max=e.num_experts * cap - 1)]
    contrib = gathered * (sw * keep).to(x.dtype)[:, None]
    out = torch.zeros((t, d), dtype=x.dtype, device=dev).index_add_(
        0, st, contrib)

    if e.num_shared:
        hs = _expert_act(cfg, xt @ _whole(p["shared_wg"]),
                         xt @ _whole(p["shared_wu"]))
        out = out + hs @ _whole(p["shared_wd"])

    # load-balance metrics (Switch-style aux loss terms, reported not applied)
    frac_tokens = F.one_hot(topi[:, 0], e.num_experts).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    metrics = {
        "moe_drop_frac": 1.0 - keep.float().mean(),
        "moe_balance_loss": e.num_experts * (frac_tokens * frac_probs).sum(),
    }
    return replicated_like(out.reshape(b, s, d), x), metrics


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every rank (its gradient, the same on
    every rank, goes back to its shards); a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


# ---------------------------------------------------------------------------
# expert-parallel dispatch (shard_map + all_to_all over the 'model' axis)
# ---------------------------------------------------------------------------
#
# Tokens live on their data shard; experts are sharded over 'model'.  Each
# rank routes its local tokens, packs per-destination-column send buffers
# of static capacity, all_to_all's them across the expert axis, runs its
# local experts, and all_to_all's results back (the return all_to_all
# restores the send layout, so combine is a local scatter): the GShard /
# Switch communication pattern.

def _capacity_rounded(n: float) -> int:
    return max(8, -(-int(n) // 8) * 8)


def _dispatch_to_buffer(tokens: torch.Tensor, expert_of: torch.Tensor,
                        valid: torch.Tensor, n_buckets: int, cap: int):
    """Sort (token, bucket) pairs into an (n_buckets, cap, ...) buffer.
    Returns (buf, slot) where slot[i] is entry i's position, or
    ``n_buckets * cap`` where it was dropped (invalid, or past ``cap``).

    The bucket starts are searched in the sorted keys, invalid entries
    keyed past every bucket.  (The reference searches the sorted entries'
    own bucket ids, whose invalid tail is not sorted, so its binary search
    can miss a start: ROADMAP §3.)"""
    n = expert_of.shape[0]
    dev = tokens.device
    key = torch.where(valid, expert_of, torch.full_like(expert_of, n_buckets))
    se, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(se, torch.arange(n_buckets, device=dev,
                                                 dtype=se.dtype))
    rank = torch.arange(n, device=dev) - starts[torch.clamp(
        se, max=n_buckets - 1)]
    keep = (rank < cap) & (se < n_buckets)
    slot_sorted = torch.where(keep, se * cap + rank,
                              torch.full_like(se, n_buckets * cap))
    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    # one spare row takes every dropped entry, then goes
    buf = tokens.new_zeros((n_buckets * cap + 1,) + tuple(tokens.shape[1:]))
    buf[slot] = tokens
    return buf[:-1].reshape((n_buckets, cap) + tuple(tokens.shape[1:])), slot


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``i`` of dim 0 to the group's rank ``i``, and back: the
    reference's tiled ``all_to_all`` with split and concat axis 0,
    differentiable (its backward is the same exchange)."""
    from torch.distributed.nn.functional import all_to_all_single

    x = x.contiguous()
    return all_to_all_single(torch.empty_like(x), x, group=group)


def moe_ffn_ep(p: dict, cfg: ModelConfig, x: torch.Tensor, mesh):
    """The expert-parallel MoE FFN on ``mesh`` (a grid with a DeviceMesh):
    ``x`` (B, S, D) and the parameters placed, the output placed by the
    activation rules (batch split, sequence whole), ``moe_drop_frac``
    averaged over every rank.

    Tokens split over (data axes x model): the sequence splits over the
    expert axis, so routing and the send buffers are local.  The expert
    weights enter as their model-axis blocks: under ``cfg.fsdp`` that
    boundary is the one all-gather over the data axes, whose backward is a
    reduce-scatter."""
    e = cfg.moe
    b, s, d = x.shape
    ncol = mesh.shape["model"]
    e_loc = e.num_experts // ncol
    dp_axes = tuple(a for a in mesh.axis_names if a != "model")
    t_loc = (b // mesh.axis_size(dp_axes)) * (s // ncol)
    cap_send = _capacity_rounded(e.top_k * t_loc * e.capacity_factor / ncol)
    cap_exp = _capacity_rounded(ncol * cap_send * 1.25 / e_loc)
    group = mesh.group("model")

    def body(x_loc, router, wg, wu, wd):
        bl, sl, _ = x_loc.shape
        tl = bl * sl
        dev = x_loc.device
        xt = x_loc.reshape(tl, d)

        logits = xt.float() @ router.float()
        probs = torch.softmax(logits, dim=-1)
        topv, topi = torch.topk(probs, e.top_k, dim=-1)
        topv = topv / topv.sum(dim=-1, keepdim=True)

        flat_e = topi.reshape(tl * e.top_k)
        flat_w = topv.reshape(tl * e.top_k)
        flat_tok = torch.arange(tl * e.top_k, device=dev) // e.top_k

        # --- pack per-destination-column send buffers ---
        dest_col = flat_e // e_loc
        payload = torch.cat([xt[flat_tok],
                             flat_e[:, None].to(xt.dtype),   # global expert
                             flat_w[:, None].to(xt.dtype)],  # combine weight
                            dim=1)
        send, slot = _dispatch_to_buffer(
            payload, dest_col, torch.ones_like(dest_col, dtype=torch.bool),
            ncol, cap_send)

        # --- exchange across the expert axis ---
        recv = _all_to_all(send, group)
        r_tok = recv[..., :d].reshape(ncol * cap_send, d)
        r_e = recv[..., d].reshape(ncol * cap_send).detach().long()
        r_w = recv[..., d + 1].reshape(ncol * cap_send).detach()
        r_loc_e = r_e - mesh.axis_index("model") * e_loc
        r_valid = (r_w > 0) & (r_loc_e >= 0) & (r_loc_e < e_loc)

        # --- local expert FFN over an (e_loc, cap_exp, d) buffer ---
        ebuf, eslot = _dispatch_to_buffer(r_tok, r_loc_e, r_valid, e_loc,
                                          cap_exp)
        h_g = torch.bmm(ebuf, wg)
        h_u = torch.bmm(ebuf, wu)
        y = torch.bmm(_expert_act(cfg, h_g, h_u), wd)
        yt = y.reshape(e_loc * cap_exp, d)
        r_out = yt[torch.clamp(eslot, max=e_loc * cap_exp - 1)] \
            * r_valid[:, None].to(yt.dtype)

        # --- return trip: all_to_all back restores the send layout ---
        back = _all_to_all(r_out.reshape(ncol, cap_send, d), group)
        flat_back = back.reshape(ncol * cap_send, d)
        contrib = flat_back[torch.clamp(slot, max=ncol * cap_send - 1)]
        kept = (slot < ncol * cap_send).to(xt.dtype)
        out = torch.zeros((tl, d), dtype=xt.dtype, device=dev).index_add_(
            0, flat_tok, contrib * (flat_w * kept)[:, None].to(xt.dtype))

        # the mean of every rank's mean (equal shares): pmean over both
        drop = psum((1.0 - kept.float().mean()).detach().reshape(1), mesh,
                    mesh.axis_names)[0] / mesh.axis_size(mesh.axis_names)
        return out.reshape(bl, sl, d), drop

    mapped = shard_map(
        body, mesh=mesh,
        in_specs=((dp_axes, "model", None), (), ("model",), ("model",),
                  ("model",)),
        out_specs=((dp_axes, "model", None), ()))
    out, drop = mapped(x, p["router"], p["wg"], p["wu"], p["wd"])

    # back to the residual stream's layout (each model rank the whole
    # sequence), whose flattening of (batch, sequence) in the next block's
    # products, and in the shared experts' backward, some torch releases
    # refuse across a split sequence; the shared experts' sum is placed
    # alike, so that the two parts are added whole
    out = shard_act(out, ("act_batch", None, None))
    if e.num_shared:
        xt = x.reshape(b * s, d)
        hs = _expert_act(cfg, xt @ p["shared_wg"], xt @ p["shared_wu"])
        out = out + shard_act((hs @ p["shared_wd"]).reshape(b, s, d),
                              ("act_batch", None, None))

    return out, {"moe_drop_frac": drop}
