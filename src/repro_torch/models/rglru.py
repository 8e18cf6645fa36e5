"""RG-LRU recurrent block (Griffin / RecurrentGemma).

Counterpart of ``repro.models.rglru``.  Temporal-mixing block:
x -> (linear branch -> causal conv1d -> RG-LRU) * (linear branch -> GeLU)
  -> output projection.

RG-LRU per channel:  a_t = exp(c * log(sigmoid(L)) * sigmoid(r_t))
                     h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The recurrence is a first-order linear scan.  The reference's
``lax.associative_scan`` becomes a doubling (Hillis-Steele) scan over the
sequence: ceil(log2 S) elementwise steps, never a loop over time.  Decode
carries (h, conv buffer), written in place into the given cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import ParamSpec

C_RGLRU = 8.0


def rglru_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    w = cfg.rglru_width or d
    cw = cfg.conv_width
    return {
        "wx": ParamSpec((d, w), ("embed", "rnn")),
        "wy": ParamSpec((d, w), ("embed", "rnn")),
        "conv_w": ParamSpec((cw, w), ("conv", "rnn")),
        "conv_b": ParamSpec((w,), ("rnn",), "zeros"),
        "lam": ParamSpec((w,), ("rnn",), "uniform", 2.0),
        "w_rg": ParamSpec((w, w), ("rnn", "rnn_out")),
        "b_rg": ParamSpec((w,), ("rnn",), "zeros"),
        "w_ig": ParamSpec((w, w), ("rnn", "rnn_out")),
        "b_ig": ParamSpec((w,), ("rnn",), "zeros"),
        "wo": ParamSpec((w, d), ("rnn", "embed")),
    }


def _causal_conv1d(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   prev: torch.Tensor | None):
    """Depthwise causal conv, width CW.  prev: (B, CW-1, W) decode buffer.
    Returns (out, new_prev)."""
    cw = w.shape[0]
    if prev is None:
        prev = torch.zeros((u.shape[0], cw - 1, u.shape[-1]), dtype=u.dtype,
                           device=u.device)
    ext = torch.cat([prev.to(u.dtype), u], dim=1)  # (B, S+CW-1, W)
    s = u.shape[1]
    out = ext[:, 0:s] * w[0][None, None]
    for i in range(1, cw):
        out = out + ext[:, i:i + s] * w[i][None, None]
    new_prev = ext[:, -(cw - 1):] if cw > 1 else prev
    return out + b[None, None], new_prev


def _rglru_scan(a: torch.Tensor, b_in: torch.Tensor,
                h0: torch.Tensor | None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t by a doubling scan over dim 1.  a, b: (B,S,W)
    float32; h0: (B, W) or None."""
    if h0 is not None:
        # fold the carried state into the first step's additive term
        b_in = b_in.clone()
        b_in[:, 0] += a[:, 0] * h0
    s = a.shape[1]
    d = 1
    while d < s:
        # combine(earlier, later) = (a1 a2, a2 b1 + b2), all t >= d at once
        b_in = torch.cat([b_in[:, :d], a[:, d:] * b_in[:, :-d] + b_in[:, d:]],
                         dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b_in


def rglru_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                cache: dict | None):
    """Returns (out, new_cache); cache = {'h': (B,W) f32, 'conv':
    (B,CW-1,W)}, written in place (the returned cache is the one given)."""
    u = x @ p["wx"]
    gate = F.gelu(x @ p["wy"], approximate="tanh")

    prev_conv = cache["conv"] if cache is not None else None
    u, new_conv = _causal_conv1d(u, p["conv_w"], p["conv_b"], prev_conv)

    uf = u.float()
    rg = torch.sigmoid(uf @ p["w_rg"].float() + p["b_rg"])
    ig = torch.sigmoid(uf @ p["w_ig"].float() + p["b_ig"])
    log_a = C_RGLRU * F.logsigmoid(p["lam"].float()) * rg
    a = torch.exp(log_a)
    b_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (ig * uf)

    h0 = cache["h"] if cache is not None else None
    if x.shape[1] == 1 and h0 is not None:
        h = (a[:, 0] * h0 + b_in[:, 0])[:, None]
    else:
        h = _rglru_scan(a, b_in, h0)

    out = (h.to(x.dtype) * gate) @ p["wo"]
    if cache is not None:
        cache["h"].copy_(h[:, -1])
        cache["conv"].copy_(new_conv)
    return out, cache


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> dict:
    w = cfg.rglru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                            device=device),
    }
