"""RWKV-6 (Finch) blocks: data-dependent-decay linear attention.

Counterpart of ``repro.models.rwkv``.  Time-mix ("attention") recurrence per
head (key dim N), per channel n:

    out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T        w_t = exp(-exp(base + lora))

with data-dependent token-shift interpolation (ddlerp) feeding r/k/v/g/w.
Channel-mix is RWKV's squared-relu FFN with token shift.

Two wkv implementations, as in the reference:
  * ``wkv_scan``    — the exact sequential recurrence, a loop over time with
    a float32 state.  Serving runs it.
  * ``wkv_chunked`` — the intra-chunk pairwise-decay form, exact too
    (pairwise log-decay differences are <= 0 for causal pairs), at the cost
    of a (B, nc, C, C, H, N) intermediate; checked against the scan.

Decode carries (state, tm_prev, cm_prev) per layer, written in place into
the given cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import ParamSpec

LORA_R = 32       # ddlerp lora rank
DECAY_LORA_R = 64


def rwkv_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    n = cfg.rwkv_head_dim
    h = d // n
    f = cfg.d_ff
    return {
        # time-mix
        "mu": ParamSpec((5, d), ("five", "embed"), "uniform", 0.5),
        "lora_a": ParamSpec((d, 5 * LORA_R), ("embed", "lora")),
        "lora_b": ParamSpec((5, LORA_R, d), ("five", "lora", "embed")),
        "w0": ParamSpec((d,), ("embed",), "uniform", 1.0),
        "wlora_a": ParamSpec((d, DECAY_LORA_R), ("embed", "lora")),
        "wlora_b": ParamSpec((DECAY_LORA_R, d), ("lora", "embed")),
        "u": ParamSpec((h, n), ("heads", "head_dim"), "uniform", 0.5),
        "wr": ParamSpec((d, d), ("embed", "embed_out")),
        "wk": ParamSpec((d, d), ("embed", "embed_out")),
        "wv": ParamSpec((d, d), ("embed", "embed_out")),
        "wg": ParamSpec((d, d), ("embed", "embed_out")),
        "wo": ParamSpec((d, d), ("embed_out", "embed")),
        "ln_w": ParamSpec((d,), ("norm",), "ones"),
        # channel-mix
        "cm_mu_k": ParamSpec((d,), ("embed",), "uniform", 0.5),
        "cm_mu_r": ParamSpec((d,), ("embed",), "uniform", 0.5),
        "cm_wk": ParamSpec((d, f), ("embed", "mlp")),
        "cm_wv": ParamSpec((f, d), ("mlp", "embed")),
        "cm_wr": ParamSpec((d, d), ("embed", "embed_out")),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """Token shift: x_{t-1}; first position uses `prev` (decode carry) or 0."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    else:
        prev = prev[:, None, :].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddlerp(p: dict, x: torch.Tensor, xs: torch.Tensor):
    """Data-dependent lerp producing the 5 mixed inputs (w,k,v,r,g)."""
    dx = xs - x
    mixed = x + dx * p["mu"][0][None, None]
    lora = torch.tanh(mixed @ p["lora_a"])
    b, s, _ = lora.shape
    lora = lora.reshape(b, s, 5, LORA_R)
    dyn = torch.einsum("bsfr,frd->bsfd", lora, p["lora_b"])  # (B,S,5,D)
    mus = p["mu"][None, None] + dyn
    return tuple(x + dx * mus[:, :, i] for i in range(5))


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             state: torch.Tensor | None = None):
    """Exact recurrence. r/k/v/w: (B,S,H,N); u: (H,N).
    Returns (out (B,S,H,N) in r's dtype, final_state (B,H,N,N) float32)."""
    b, s, h, n = r.shape
    if state is None:
        state = torch.zeros((b, h, n, n), dtype=torch.float32,
                            device=r.device)
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uu = u.float()[None, :, :, None]
    outs = []
    st = state.float()
    for t in range(s):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]
        kv = kt[..., :, None] * vt[..., None, :]            # (B,H,N,N)
        outs.append(torch.einsum("bhn,bhnm->bhm", rt, st + uu * kv))
        st = wt[..., :, None] * st + kv
    out = torch.stack(outs, dim=1)
    return out.to(r.dtype), st


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor,
                state: torch.Tensor | None = None, *, chunk: int = 32):
    """Chunked parallel form; exact (pairwise log-decay differences <= 0)."""
    b, s, h, n = r.shape
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    rc, kc, vc = (a.float().reshape(b, nc, chunk, h, n) for a in (r, k, v))
    lw = torch.log(torch.clamp(w.float(), min=1e-38)).reshape(
        b, nc, chunk, h, n)
    cum = torch.cumsum(lw, dim=2)                   # inclusive within chunk
    ex = cum - lw                                   # exclusive (sum up to t-1)

    # intra-chunk: att[b,c,t,s,h] = sum_n r_t k_s exp(ex_t - cum_s), s < t
    diff = ex[:, :, :, None] - cum[:, :, None, :, :, :]  # (B,nc,C,C,H,N)
    idx = torch.arange(chunk, device=r.device)
    tri = idx[:, None] > idx[None, :]
    # mask BEFORE exp: for s >= t the exponent is positive (would overflow)
    dec = torch.exp(torch.where(tri[None, None, :, :, None, None], diff,
                                -torch.inf))
    att = torch.einsum("bcthn,bcshn,bctshn->bctsh", rc, kc, dec)
    intra = torch.einsum("bctsh,bcshn->bcthn", att, vc)
    # current-token bonus
    bonus = torch.einsum("bcthn,bcthn->bcth", rc,
                         u.float()[None, None, None] * kc)
    intra = intra + bonus[..., None] * vc

    # inter-chunk: carry the state across chunks (a loop over S/C)
    if state is None:
        state = torch.zeros((b, h, n, n), dtype=torch.float32,
                            device=r.device)
    decay_q = torch.exp(ex)                           # safe: ex <= 0
    decay_total = torch.exp(cum[:, :, -1])            # (B,nc,H,N)
    decay_k = torch.exp(cum[:, :, -1][:, :, None] - cum)  # <= 1
    rq_all, kq_all = rc * decay_q, kc * decay_k
    st = state.float()
    inter = []
    for c in range(nc):
        inter.append(torch.einsum("bthn,bhnm->bthm", rq_all[:, c], st))
        st = decay_total[:, c][..., None] * st + torch.einsum(
            "bthn,bthm->bhnm", kq_all[:, c], vc[:, c])
    out = (intra + torch.stack(inter, dim=1)).reshape(b, s, h, n)
    return out.to(r.dtype), st


def _group_norm(x: torch.Tensor, w: torch.Tensor, n: int,
                eps: float = 64e-5) -> torch.Tensor:
    """Per-head group norm over the flattened (H*N) dim (RWKV ln_x)."""
    b, s, d = x.shape
    xg = x.reshape(b, s, d // n, n).float()
    mu = xg.mean(dim=-1, keepdim=True)
    var = xg.var(dim=-1, keepdim=True, unbiased=False)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return (xg.reshape(b, s, d) * w).to(x.dtype)


def time_mix(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict | None,
             *, use_chunked: bool = False):
    """RWKV6 attention analogue.  Returns (out, cache): ``state`` and
    ``tm_prev`` written in place when a cache is given."""
    b, s, d = x.shape
    n = cfg.rwkv_head_dim
    h = d // n
    prev = cache["tm_prev"] if cache is not None else None
    xs = _shift(x, prev)
    xw, xk, xv, xr, xg = _ddlerp(p, x, xs)

    logw = p["w0"][None, None] + torch.tanh(xw @ p["wlora_a"]) @ p["wlora_b"]
    w = torch.exp(-torch.exp(logw.float()))

    r = (xr @ p["wr"]).reshape(b, s, h, n)
    k = (xk @ p["wk"]).reshape(b, s, h, n)
    v = (xv @ p["wv"]).reshape(b, s, h, n)
    g = F.silu(xg @ p["wg"])

    state = cache["state"] if cache is not None else None
    wh = w.reshape(b, s, h, n)
    if use_chunked and s % 32 == 0 and s > 32:
        chunk = 128 if s % 128 == 0 else 32
        wkv, new_state = wkv_chunked(r, k, v, wh, p["u"], state, chunk=chunk)
    else:
        wkv, new_state = wkv_scan(r, k, v, wh, p["u"], state)

    out = _group_norm(wkv.reshape(b, s, d), p["ln_w"], n) * g
    out = out @ p["wo"]
    if cache is not None:
        cache["state"].copy_(new_state)
        cache["tm_prev"].copy_(x[:, -1])
    return out, cache


def channel_mix(p: dict, cfg: ModelConfig, x: torch.Tensor,
                cache: dict | None):
    """Returns (out, cache): ``cm_prev`` written in place when a cache is
    given."""
    prev = cache["cm_prev"] if cache is not None else None
    xs = _shift(x, prev)
    dx = xs - x
    xk = x + dx * p["cm_mu_k"][None, None]
    xr = x + dx * p["cm_mu_r"][None, None]
    k = torch.square(torch.relu(xk @ p["cm_wk"]))
    out = torch.sigmoid(xr @ p["cm_wr"]) * (k @ p["cm_wv"])
    if cache is not None:
        cache["cm_prev"].copy_(x[:, -1])
    return out, cache


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                    device=None) -> dict:
    d = cfg.d_model
    n = cfg.rwkv_head_dim
    return {
        "state": torch.zeros((batch, d // n, n, n), dtype=torch.float32,
                             device=device),
        "tm_prev": torch.zeros((batch, d), dtype=dtype, device=device),
        "cm_prev": torch.zeros((batch, d), dtype=dtype, device=device),
    }
