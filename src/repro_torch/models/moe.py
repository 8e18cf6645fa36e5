"""Mixture-of-Experts FFN: top-k router + sort-based capacity dispatch.

Counterpart of ``repro.models.moe``'s single-host dispatch: tokens'
(token, expert) assignments are sorted by expert id (a stable sort, as
``jnp.argsort``), each expert takes at most ``capacity`` tokens, the expert
FFN is one batched product over the (E, C, D) buffer, and results scatter
back with the router's combine weights.  A dropped assignment writes to one
spare buffer row, sliced off afterwards (the reference's out-of-bounds
``mode="drop"``).

The reference's expert-parallel dispatch (``moe_ffn_ep``, a shard_map over
a mesh) needs the production mesh, which this package does not have yet:
with a mesh or a sharding hook installed, ``moe_ffn`` raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import ParamSpec

MESH_ITEM = "ROADMAP §1 item 10b-3"


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
    """x (B, S, D) -> (out, metrics), by the single-host dispatch; with a
    mesh or sharding hook installed (expert parallelism) it raises."""
    from .layers import sharded

    if sharded():
        raise NotImplementedError(
            f"expert-parallel MoE dispatch needs the production mesh, which "
            f"is not ported yet ({MESH_ITEM})")
    return _moe_ffn_dense_dispatch(p, cfg, x)


def _moe_ffn_dense_dispatch(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x (B, S, D) -> (out, metrics). Dropped tokens pass through as zeros
    from the routed experts (shared experts still contribute)."""
    e = cfg.moe
    b, s, d = x.shape
    t = b * s
    dev = x.device
    xt = x.reshape(t, d)

    # the router runs in float32 (the reference promotes xt to it)
    logits = xt.float() @ p["router"].float()
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
    h = buf[:-1].reshape(e.num_experts, cap, d)

    h_g = torch.bmm(h, p["wg"])
    h_u = torch.bmm(h, p["wu"])
    y = torch.bmm(_expert_act(cfg, h_g, h_u), p["wd"])
    yt = y.reshape(e.num_experts * cap, d)

    gathered = yt[torch.clamp(slot, max=e.num_experts * cap - 1)]
    contrib = gathered * (sw * keep).to(x.dtype)[:, None]
    out = torch.zeros((t, d), dtype=x.dtype, device=dev).index_add_(
        0, st, contrib)

    if e.num_shared:
        hs = _expert_act(cfg, xt @ p["shared_wg"], xt @ p["shared_wu"])
        out = out + hs @ p["shared_wd"]

    # load-balance metrics (Switch-style aux loss terms, reported not applied)
    frac_tokens = F.one_hot(topi[:, 0], e.num_experts).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    metrics = {
        "moe_drop_frac": 1.0 - keep.float().mean(),
        "moe_balance_loss": e.num_experts * (frac_tokens * frac_probs).sum(),
    }
    return out.reshape(b, s, d), metrics
