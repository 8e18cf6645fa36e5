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

import contextlib
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import ParamSpec

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# activation sharding hook (MaxText-style logical constraints)
# ---------------------------------------------------------------------------
# The launch layer (``repro_torch.launch.mesh.install``) installs a callback
# mapping (tensor, logical_axes) -> the tensor as a DTensor with its axes'
# placements, and the mesh beside it (expert-parallel MoE reads it).
# Without it (unit tests, one device) ``shard_act`` is the identity.

_SHARDING_HOOK = None
_MESH = None  # set together with the hook; enables the expert-parallel MoE


def set_sharding_hook(fn, mesh=None) -> None:
    global _SHARDING_HOOK, _MESH
    _SHARDING_HOOK = fn
    _MESH = mesh


def get_mesh():
    return _MESH


def sharded() -> bool:
    """Whether a sharding hook or a mesh is installed."""
    return _SHARDING_HOOK is not None or _MESH is not None


def shard_act(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    if _SHARDING_HOOK is None:
        return x
    return _SHARDING_HOOK(x, axes)


def is_placed(x) -> bool:
    """Whether ``x`` is a DTensor under an installed hook."""
    if _SHARDING_HOOK is None:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def replicated_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, a plain tensor every rank holds whole (a mask, RoPE's angles,
    a carry's start), as a replicated DTensor on ``ref``'s mesh when
    ``ref`` is a DTensor, so that autograd, which saves it, meets no plain
    tensor in the backward pass; else ``t``."""
    if _SHARDING_HOOK is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    dm = ref.device_mesh
    return DTensor.from_local(t, dm, [Replicate()] * dm.ndim,
                              run_check=False)


@contextlib.contextmanager
def _unhooked():
    """No hook and no mesh inside: a body that runs on one rank's blocks
    (plain tensors) constrains nothing."""
    global _SHARDING_HOOK, _MESH
    saved = _SHARDING_HOOK, _MESH
    _SHARDING_HOOK = _MESH = None
    try:
        yield
    finally:
        _SHARDING_HOOK, _MESH = saved


def _attend(core, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            *masks):
    """``core(q, k, v, *masks)``, the attention core (``_sdpa`` or
    ``_flash_attention``), on each rank's block of batch rows and heads
    when ``q`` is a DTensor: a ``shard_map`` over the batch and head axes,
    the same computation as the plain path's on a block, as tensor-parallel
    attention runs a head shard.  (DTensor's own einsum would flatten the
    batch dim and the head dim, both split, into one, which some torch
    releases refuse.)  The heads stay split only where the KV heads split
    with them, so a q head's KV head is on its rank; else they are
    replicated.  The masks are plain or replicated."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(q, DTensor):
        return core(q, k, v, *masks)
    dm = q.device_mesh
    heads = [i for i, p in enumerate(q.placements) if p == Shard(2)]
    if heads and k.shape[2] % math.prod(dm.size(i) for i in heads):
        heads = []
    pl = [Shard(0) if p == Shard(0) else Shard(2) if i in heads
          else Replicate() for i, p in enumerate(q.placements)]

    def block(t):
        return replicated_like(t, q).redistribute(dm, pl).to_local()

    ql, kl, vl = block(q), block(k), block(v)
    ml = [m.full_tensor() if isinstance(m, DTensor) else m for m in masks]
    with _unhooked():
        out = core(ql, kl, vl, *ml)
    return DTensor.from_local(out, dm, pl, run_check=False)


def gathered(w: torch.Tensor, dim: int) -> torch.Tensor:
    """``w`` with its split of dim ``dim`` gathered, where ``w`` is a
    DTensor split there (an FSDP weight's embed dim, on the data axes), as
    the reference's partitioner gathers an FSDP weight at its use; else
    ``w``.  (Left split, DTensor's einsum may split the output on another
    axis and then cannot unflatten a head count that axis does not
    divide.)"""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(w, DTensor) or Shard(dim) not in w.placements:
        return w
    return w.redistribute(w.device_mesh, [
        Replicate() if p == Shard(dim) else p for p in w.placements])


def split_last(y: torch.Tensor, h: int) -> torch.Tensor:
    """``y`` (..., h * n) as (..., h, n) (heads, or groups); a DTensor
    split on its last dim over axes whose size does not divide ``h`` is
    gathered there first (DTensor cannot unflatten a split that falls
    inside a group)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(y, DTensor):
        last = Shard(y.ndim - 1)
        axes = [i for i, p in enumerate(y.placements) if p == last]
        if axes and h % math.prod(y.device_mesh.size(i) for i in axes):
            y = y.redistribute(y.device_mesh, [
                Replicate() if p == last else p for p in y.placements])
    return y.reshape(*y.shape[:-1], h, y.shape[-1] // h)


def blockwise(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an ``fn`` that DTensor has no rule for (or no rule
    for its backward) and that treats the blocks of ``x``'s split dims
    apart (pointwise, or along an unsplit dim): on each rank's block of a
    DTensor ``x``, placed as ``x``; ``fn(x)`` on a plain tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return fn(x)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False)


def mixed():
    """The context an installed hook's computation runs in: a plain tensor
    that meets a DTensor there (a mask, positions, RoPE's angles, a
    constant) is one every rank holds whole, so it is taken as replicated
    (``implicit_replication``).  A no-op without a hook."""
    if not sharded():
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


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
    freqs = replicated_like(_freqs(head_dim, theta, positions.device),
                            positions)
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
    # placed positions (a batch leaf) meet the frequencies in the remat's
    # recompute too, outside ``mixed``
    freqs = replicated_like(_freqs(head_dim, theta, positions.device),
                            positions)
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
    sin = replicated_like(sin[:, :, None, :], q)
    cos = replicated_like(cos[:, :, None, :], q)
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
    scores = torch.where(replicated_like(mask, scores), scores.float(),
                         NEG_INF)
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
    # enough q blocks that they can shard over the model axis when the head
    # count cannot (context-parallel attention: rules override flash_q)
    qr = shard_act(q.reshape(b, nq, qb, h, hd),
                   ("act_batch", "flash_q", None, "heads", None))
    qpos = (torch.arange(nq, device=q.device)[:, None] * qb
            + torch.arange(qb, device=q.device)[None, :])  # (nq, qb)

    m = torch.full((b, nq, h, qb), -float("inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, nq, h, qb), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, nq, h, qb, hd), dtype=torch.float32,
                      device=q.device)
    m, l, acc = (replicated_like(c, qr) for c in (m, l, acc))
    for ki in range(nk):
        lo, hi = 0, nq
        if block_skip and mask_kind in ("causal", "local"):
            live = [qi for qi in range(nq)
                    if not _dead_block(cfg, mask_kind, qi, ki, qb, kb)]
            if not live:
                continue
            lo, hi = live[0], live[-1] + 1
        kblk = shard_act(_repeat_kv(k[:, ki * kb:(ki + 1) * kb], g),
                         ("act_batch", None, "heads", None))
        vblk = shard_act(_repeat_kv(v[:, ki * kb:(ki + 1) * kb], g),
                         ("act_batch", None, "heads", None))
        sc = torch.einsum("bnqhd,bkhd->bnhqk", qr[:, lo:hi],
                          kblk).float() * scale
        if mask_kind != "bidir":
            kpos = ki * kb + torch.arange(kb, device=q.device)
            qp = qpos[lo:hi, :, None]
            msk = kpos[None, None, :] <= qp
            if mask_kind == "local":
                msk = msk & (kpos[None, None, :] > qp - cfg.window)
            sc = torch.where(replicated_like(msk[None, :, None], sc), sc,
                             NEG_INF)
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
    out = shard_act(out.permute(0, 1, 3, 2, 4).to(q.dtype),
                    ("act_batch", "flash_q", None, "heads", None))
    return out.reshape(b, s, h, hd)


def _repeat_kv(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, T, KV, hd) -> (B, T, KV * g, hd), KV head ``n`` repeated ``g``
    times in place (``repeat_interleave`` on dim 2), as an expand and a
    reshape, which keep a DTensor sharded over its KV heads."""
    b, t, kvh, hd = x.shape
    return x[:, :, :, None].expand(b, t, kvh, g, hd).reshape(b, t, kvh * g, hd)


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
    q = shard_act(torch.einsum("bsd,dhk->bshk", x, gathered(p["wq"], 0)),
                  ("act_batch", None, "heads", None))
    if memory is not None:
        # cross-attention: K/V from encoder memory (cached after prefill)
        if cache is not None and "ck" in cache and s == 1:
            k, v = cache["ck"], cache["cv"]
            new_cache = cache
        else:
            k = torch.einsum("btd,dnk->btnk", memory, gathered(p["wk"], 0))
            v = torch.einsum("btd,dnk->btnk", memory, gathered(p["wv"], 0))
            new_cache = None
            if cache is not None and "ck" in cache:  # prefill fills it
                cache["ck"].copy_(k)
                cache["cv"].copy_(v)
                new_cache = cache
            elif cache is not None:
                new_cache = {"ck": k, "cv": v}
        mask = torch.ones((1, 1, 1, s, k.shape[1]), dtype=torch.bool,
                          device=x.device)
        out = _attend(functools.partial(_sdpa, cfg), q, k, v, mask)
        return (torch.einsum("bshk,hkd->bsd", out, gathered(p["wo"], 2)),
                new_cache)

    k = shard_act(torch.einsum("bsd,dnk->bsnk", x, gathered(p["wk"], 0)),
                  ("act_batch", None, "kv_heads", None))
    v = shard_act(torch.einsum("bsd,dnk->bsnk", x, gathered(p["wv"], 0)),
                  ("act_batch", None, "kv_heads", None))

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
        out = _attend(functools.partial(_sdpa, cfg), q, ck, cv,
                      valid[None, None, None, None, :])
        new_cache = {"k": ck, "v": cv, "slot_pos": spos}
        return (torch.einsum("bshk,hkd->bsd", out, gathered(p["wo"], 2)),
                new_cache)

    # ---- train / prefill: full sequence ----
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q, k = apply_rope(cfg, q, k, positions)
    if s >= FLASH_MIN_SEQ and s % FLASH_QB == 0:
        out = _attend(functools.partial(
            _flash_attention, cfg, mask_kind=mask_kind,
            block_skip=cfg.flash_block_skip), q, k, v)
    else:
        mask = _train_mask(mask_kind, s, cfg.window,
                           x.device)[None, None, None, :, :]
        out = _attend(functools.partial(_sdpa, cfg), q, k, v, mask)
    y = torch.einsum("bshk,hkd->bsd", out, gathered(p["wo"], 2))

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
            # along the sequence, which no rule splits
            ck.copy_(blockwise(lambda t: torch.roll(t, roll, dims=1),
                               k[:, s - cap:]))
            cv.copy_(blockwise(lambda t: torch.roll(t, roll, dims=1),
                               v[:, s - cap:]))
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
    h = shard_act(h, ("act_batch", None, "mlp"))
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
    # under a mesh the tokens are placed on the batch axes, as the
    # reference's batch is, and an FSDP table (its embed dim on the data
    # axes) is gathered; each rank then looks its own rows up
    tokens = shard_act(tokens.long(), ("act_batch", None))
    table = shard_act(p["table"], ("vocab", None))
    x = _lookup(table, tokens) if is_placed(table) else table[tokens]
    x = shard_act(x.to(cfg.cdtype), ("act_batch", None, None))
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def unembed(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        out = torch.einsum("bsd,vd->bsv", x,
                           gathered(p["table"], 1).to(x.dtype))
    else:
        out = torch.einsum("bsd,dv->bsv", x,
                           gathered(p["head"], 0).to(x.dtype))
    return shard_act(out, ("act_batch", None, "vocab"))


# ---------------------------------------------------------------------------
# vocab-parallel lookups (a row's owner answers, the others add zeros)
# ---------------------------------------------------------------------------

class _SumOverRanks(torch.autograd.Function):
    """The sum over process groups of values each rank holds a part of,
    which every rank then uses whole: all-reduce forward, identity
    backward (each rank's part gets the whole gradient)."""

    @staticmethod
    def forward(ctx, x, groups):
        import torch.distributed as dist

        x = x.clone()
        for g in groups:
            dist.all_reduce(x, group=g)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _split_offset(dm, dims: list, block: int) -> int:
    """This rank's first index of a dim split over mesh ``dims`` (mesh
    order, outermost first) in blocks of ``block``."""
    coord = dm.get_coordinate()
    idx = 0
    for i in dims:
        idx = idx * dm.size(i) + coord[i]
    return idx * block


def _vocab_take(table, ids, vocab_dim: int, take):
    """``take(local block, local ids in it)`` where each rank holds a block
    of ``table``'s ``vocab_dim`` and the ids index the whole of it: an id
    outside the block reads a clamped row that is zeroed, and the blocks'
    answers are summed over the split axes.  Returns the local answer and
    the mesh axes the ids' batch is split over."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    dm = table.device_mesh
    vdims = [i for i, p in enumerate(table.placements)
             if p == Shard(vocab_dim)]
    batch = [i for i, p in enumerate(ids.placements) if p == Shard(0)]
    # where the batch is split and the table is whole, each rank's
    # gradient is a part of the table's
    grad = [Partial() if i in batch and p == Replicate() else p
            for i, p in enumerate(table.placements)]
    local = table.to_local(grad_placements=grad)
    n = local.shape[vocab_dim]
    rel = ids.to_local() - _split_offset(dm, vdims, n)
    inside = (rel >= 0) & (rel < n)
    out = take(local, rel.clamp(0, n - 1), inside)
    if vdims:
        out = _SumOverRanks.apply(out, [dm.get_group(i) for i in vdims])
    return out, batch


def _placed_rows(out, dm, batch: list):
    """``out``, whole on every rank but split over the ``batch`` axes, as
    a DTensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    return DTensor.from_local(out, dm, [Shard(0) if i in batch
                                        else Replicate()
                                        for i in range(dm.ndim)],
                              run_check=False)


def _lookup(table, ids):
    """``table[ids]`` for a placed table (rows split over the vocab axes,
    replicated otherwise) and ids placed on the batch axes: each rank looks
    its own rows up, so the table is never gathered (Megatron's
    vocab-parallel embedding)."""
    def take(w, rel, inside):
        return F.embedding(rel, w) * inside[..., None].to(w.dtype)

    out, batch = _vocab_take(table, ids, 0, take)
    return _placed_rows(out, table.device_mesh, batch)


def take_along_vocab(logits, labels):
    """``logits[..., labels]`` (B, S) of placed (B, S, V) logits and placed
    labels, each rank reading its own vocab block (the labels placed on
    the logits' batch axes first)."""
    from torch.distributed.tensor import Replicate, Shard

    dm = logits.device_mesh
    labels = labels.redistribute(dm, [
        Shard(0) if p == Shard(0) else Replicate()
        for p in logits.placements])

    def take(lf, rel, inside):
        return torch.gather(lf, -1, rel[..., None])[..., 0] * inside

    out, batch = _vocab_take(logits, labels, 2, take)
    return _placed_rows(out, dm, batch)
