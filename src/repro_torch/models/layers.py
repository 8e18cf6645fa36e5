"""Shared transformer layers: norms, RoPE (std + M-RoPE), GQA attention
(train / prefill / decode with full, local-window and cross variants), MLPs.

Counterpart of ``repro.models.layers``.  Everything is a function over an
explicit parameter dict, computed with plain torch ops in the order and the
precision of the reference: norms and rotary embeddings in float32 and cast
back, scores in float32 with masked entries at ``NEG_INF``, and the
blockwise ``_flash_attention`` step for step (its running max starting at
``-inf``, its output divided by ``max(l, 1e-30)``).  Head ``h`` of a GQA
layer reads KV head ``h // q_per_kv``.

A decode cache is updated in place (the reference donates it), so the cache
a call returns holds the same tensors it was given.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import ParamSpec

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# activation sharding hook
# ---------------------------------------------------------------------------
# The reference's launch layer installs a callback constraining activations
# to logical mesh axes, and the mesh beside it (expert-parallel MoE reads
# it).  This package has no production mesh yet (ROADMAP §1 item 10b-3), so
# ``shard_act`` is the identity and no hook can be set: both stay None.

_SHARDING_HOOK = None
_MESH = None


def set_sharding_hook(fn, mesh=None) -> None:
    if fn is not None or mesh is not None:
        raise NotImplementedError(
            "activation sharding needs the production mesh "
            "(launch/mesh.py), which is not ported yet (ROADMAP §1 item "
            "10b-3)")


def get_mesh():
    return _MESH


def sharded() -> bool:
    """Whether a sharding hook or a mesh is installed (never, here)."""
    return _SHARDING_HOOK is not None or _MESH is not None


def shard_act(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    return x


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"w": ParamSpec((d,), ("norm",), "ones"),
                "b": ParamSpec((d,), ("norm",), "zeros")}
    return {"w": ParamSpec((d,), ("norm",), "ones")}


def apply_norm(p: dict, cfg: ModelConfig, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["w"] + p["b"]
    else:
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["w"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def _rope_rotate(x: torch.Tensor, sin: torch.Tensor,
                 cos: torch.Tensor) -> torch.Tensor:
    """x: (..., hd) split into halves [x1 | x2] (not interleaved pairs)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def rope_sincos(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (B, S) -> sin/cos (B, S, hd/2), f32."""
    freqs = _freqs(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * freqs  # (B,S,half)
    return torch.sin(ang), torch.cos(ang)


def mrope_sincos(positions: torch.Tensor, head_dim: int, theta: float,
                 sections):
    """M-RoPE (Qwen2-VL): positions (3, B, S) for (t, h, w); the half-dim is
    split into ``sections`` (sums to hd/2), each section using its own
    position stream."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to {half}")
    freqs = _freqs(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * freqs  # (3, B, S, half)
    parts = []
    start = 0
    for i, sec in enumerate(sections):
        parts.append(ang[i, ..., start:start + sec])
        start += sec
    ang_sel = torch.cat(parts, dim=-1)  # (B, S, half)
    return torch.sin(ang_sel), torch.cos(ang_sel)


def apply_rope(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
               positions: torch.Tensor):
    """q (B,S,H,hd), k (B,S,KV,hd); positions (B,S) or (3,B,S) for mrope."""
    if cfg.rope == "none":
        return q, k
    if cfg.rope == "mrope":
        sin, cos = mrope_sincos(positions, cfg.head_dim, cfg.rope_theta,
                                cfg.mrope_sections)
    else:
        sin, cos = rope_sincos(positions, cfg.head_dim, cfg.rope_theta)
    sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    return (_rope_rotate(q.float(), sin, cos).to(q.dtype),
            _rope_rotate(k.float(), sin, cos).to(k.dtype))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_specs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }


def _sdpa(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
          v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """q (B,S,H,hd); k,v (B,T,KV,hd); mask broadcastable to (B,1,1,S,T)."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, hd)
    scale = hd ** -0.5
    scores = torch.einsum("bsngd,btnd->bngst", qg, k) * scale
    scores = torch.where(mask, scores.float(), NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bngst,btnd->bsngd", probs, v)
    return out.reshape(b, s, h, hd)


def _train_mask(kind: str, s: int, window: int, device=None) -> torch.Tensor:
    """(S, S) mask: causal / bidir / local(causal+window)."""
    if kind == "bidir":
        return torch.ones((s, s), dtype=torch.bool, device=device)
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    m = j <= i
    if kind == "local":
        m = m & (j > i - window)
    return m


# Blockwise (flash-style) attention: never materializes the (S, T) score
# matrix — running max/sum over KV blocks, batched over independent Q blocks
# (the reference's vmap), so a 4k-32k prefill stays at sane memory.
FLASH_MIN_SEQ = 4096
FLASH_QB = 1024
FLASH_KB = 1024


def _flash_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, mask_kind: str, *, qb: int = FLASH_QB,
                     kb: int = FLASH_KB,
                     block_skip: bool = False) -> torch.Tensor:
    """q (B,S,H,hd); k,v (B,T,KV,hd) -> (B,S,H,hd).

    ``block_skip``: skip KV blocks that are fully masked (strictly-future
    causal blocks / outside the local window) for the q blocks they are
    dead to; the q blocks a KV block is live for form one run, so the step
    runs on that slice only and the others keep their carry."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qb = min(qb, max(128, s // 16))
    kb = min(kb, t)
    nq, nk = s // qb, t // kb
    scale = hd ** -0.5
    qr = q.reshape(b, nq, qb, h, hd)
    qpos = (torch.arange(nq, device=q.device)[:, None] * qb
            + torch.arange(qb, device=q.device)[None, :])  # (nq, qb)

    m = torch.full((b, nq, h, qb), -float("inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, nq, h, qb), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, nq, h, qb, hd), dtype=torch.float32,
                      device=q.device)
    for ki in range(nk):
        lo, hi = 0, nq
        if block_skip and mask_kind in ("causal", "local"):
            live = [qi for qi in range(nq)
                    if not _dead_block(cfg, mask_kind, qi, ki, qb, kb)]
            if not live:
                continue
            lo, hi = live[0], live[-1] + 1
        kblk = torch.repeat_interleave(k[:, ki * kb:(ki + 1) * kb], g, dim=2)
        vblk = torch.repeat_interleave(v[:, ki * kb:(ki + 1) * kb], g, dim=2)
        sc = torch.einsum("bnqhd,bkhd->bnhqk", qr[:, lo:hi],
                          kblk).float() * scale
        if mask_kind != "bidir":
            kpos = ki * kb + torch.arange(kb, device=q.device)
            qp = qpos[lo:hi, :, None]
            msk = kpos[None, None, :] <= qp
            if mask_kind == "local":
                msk = msk & (kpos[None, None, :] > qp - cfg.window)
            sc = torch.where(msk[None, :, None], sc, NEG_INF)
        m_old = m[:, lo:hi]
        m_new = torch.maximum(m_old, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m_old - m_new)
        l_new = l[:, lo:hi] * corr + p.sum(dim=-1)
        acc_new = acc[:, lo:hi] * corr[..., None] + torch.einsum(
            "bnhqk,bkhd->bnhqd", p.to(vblk.dtype), vblk).float()
        # the carries are rebuilt, never written in place: autograd saved
        # the old ones for the backward pass
        m = _splice(m, m_new, lo, hi)
        l = _splice(l, l_new, lo, hi)
        acc = _splice(acc, acc_new, lo, hi)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    # (B, nq, H, qb, hd) -> (B, nq, qb, H, hd), cast inside the block
    out = out.permute(0, 1, 3, 2, 4).to(q.dtype)
    return out.reshape(b, s, h, hd)


def _splice(carry: torch.Tensor, new: torch.Tensor, lo: int,
            hi: int) -> torch.Tensor:
    """``carry`` with its q blocks ``[lo, hi)`` (dim 1) replaced by
    ``new``, out of place."""
    if lo == 0 and hi == carry.shape[1]:
        return new
    return torch.cat([carry[:, :lo], new, carry[:, hi:]], dim=1)


def _dead_block(cfg: ModelConfig, mask_kind: str, qi: int, ki: int, qb: int,
                kb: int) -> bool:
    """The reference's fully-masked test: first kpos > last qpos (causal),
    or last kpos <= first qpos - window (local)."""
    dead = ki * kb > qi * qb + qb - 1
    if mask_kind == "local":
        dead = dead or (ki * kb + kb - 1) <= qi * qb - cfg.window
    return dead


def attention(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    mask_kind: str,                             # causal | bidir | local
    positions: Optional[torch.Tensor] = None,   # (B,S) or (3,B,S)
    memory: Optional[torch.Tensor] = None,      # encoder output for cross-attn
    cache: Optional[dict] = None,               # decode cache for this layer
    pos: Optional[int] = None,                  # decode position
):
    """Returns (out, new_cache). Modes:
      * train/prefill: full-sequence; new_cache returned iff cache is not
        None (prefill fills it, in place);
      * decode: x is (B, 1, D), cache holds K/V (ring buffer when local),
        written in place at ``pos`` (``pos % cap`` for the ring);
      * cross (``memory`` given): a cache holding ``ck``/``cv`` is filled
        in place from ``memory`` when s > 1 and read, not recomputed, when
        s == 1.
    """
    b, s, d = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if memory is not None:
        # cross-attention: K/V from encoder memory (cached after prefill)
        if cache is not None and "ck" in cache and s == 1:
            k, v = cache["ck"], cache["cv"]
            new_cache = cache
        else:
            k = torch.einsum("btd,dnk->btnk", memory, p["wk"])
            v = torch.einsum("btd,dnk->btnk", memory, p["wv"])
            new_cache = None
            if cache is not None and "ck" in cache:  # prefill fills it
                cache["ck"].copy_(k)
                cache["cv"].copy_(v)
                new_cache = cache
            elif cache is not None:
                new_cache = {"ck": k, "cv": v}
        mask = torch.ones((1, 1, 1, s, k.shape[1]), dtype=torch.bool,
                          device=x.device)
        out = _sdpa(cfg, q, k, v, mask)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"]), new_cache

    k = torch.einsum("bsd,dnk->bsnk", x, p["wk"])
    v = torch.einsum("bsd,dnk->bsnk", x, p["wv"])

    if cache is not None and s == 1 and "k" in cache:
        # ---- decode: single new token against the cache ----
        if pos is None:
            raise ValueError("decode needs pos")
        pos = int(pos)
        q, k = apply_rope(cfg, q, k, _decode_positions(cfg, positions, pos, b,
                                                       x.device))
        ck, cv, spos = cache["k"], cache["v"], cache["slot_pos"]
        cap = ck.shape[1]
        slot = pos % cap if mask_kind == "local" else pos
        if slot >= cap:
            raise ValueError(f"decode position {pos} is past the cache's "
                             f"{cap} slots")
        ck[:, slot:slot + 1] = k.to(ck.dtype)
        cv[:, slot:slot + 1] = v.to(cv.dtype)
        spos[slot] = pos
        valid = spos <= pos
        if mask_kind == "local":
            valid = valid & (spos > pos - cfg.window)
        out = _sdpa(cfg, q, ck, cv, valid[None, None, None, None, :])
        new_cache = {"k": ck, "v": cv, "slot_pos": spos}
        return torch.einsum("bshk,hkd->bsd", out, p["wo"]), new_cache

    # ---- train / prefill: full sequence ----
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q, k = apply_rope(cfg, q, k, positions)
    if s >= FLASH_MIN_SEQ and s % FLASH_QB == 0:
        out = _flash_attention(cfg, q, k, v, mask_kind,
                               block_skip=cfg.flash_block_skip)
    else:
        mask = _train_mask(mask_kind, s, cfg.window,
                           x.device)[None, None, None, :, :]
        out = _sdpa(cfg, q, k, v, mask)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])

    new_cache = None
    if cache is not None:
        ck, cv, spos = cache["k"], cache["v"], cache["slot_pos"]
        cap = ck.shape[1]
        if cap >= s:
            ck[:, :s] = k.to(ck.dtype)
            cv[:, :s] = v.to(cv.dtype)
            spos[:s] = torch.arange(s, dtype=spos.dtype, device=spos.device)
        else:  # local ring: keep the last `cap` tokens, slot = pos % cap
            roll = (s - cap) % cap
            ck.copy_(torch.roll(k[:, s - cap:], roll, dims=1))
            cv.copy_(torch.roll(v[:, s - cap:], roll, dims=1))
            spos.copy_(torch.roll(torch.arange(s - cap, s, device=spos.device),
                                  roll, dims=0))
        new_cache = {"k": ck, "v": cv, "slot_pos": spos}
    return y, new_cache


def _decode_positions(cfg: ModelConfig, positions, pos: int, b: int, device):
    if positions is not None:
        return positions
    p = torch.full((b, 1), pos, dtype=torch.int32, device=device)
    if cfg.rope == "mrope":
        return p[None].expand(3, b, 1)
    return p


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "wg": ParamSpec((d, f), ("embed", "mlp")),
            "wu": ParamSpec((d, f), ("embed", "mlp")),
            "wd": ParamSpec((f, d), ("mlp", "embed")),
        }
    return {
        "wu": ParamSpec((d, f), ("embed", "mlp")),
        "wd": ParamSpec((f, d), ("mlp", "embed")),
    }


def mlp(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    elif cfg.mlp == "geglu":
        h = F.gelu(x @ p["wg"], approximate="tanh") * (x @ p["wu"])
    else:
        h = F.gelu(x @ p["wu"], approximate="tanh")
    return h @ p["wd"]


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_specs(cfg: ModelConfig) -> dict:
    out = {"table": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        out["head"] = ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return out


def embed(p: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = p["table"][tokens.long()].to(cfg.cdtype)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def unembed(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, p["table"].to(x.dtype))
    return torch.einsum("bsd,dv->bsv", x, p["head"].to(x.dtype))
