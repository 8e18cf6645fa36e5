"""Architecture registry: the 10 assigned archs and the paper's own CP-ALS
workloads, reduced smoke variants, and per-cell input specs.

Counterpart of ``repro.configs``: the same presets, field for field, and the
same tables.  ``batch_shapes`` gives ``torch.dtype``s.  The decomposition
stack only consumes ``CPALS_WORKLOADS`` / ``CPALS_DATASET``; the rest is
the LM substrate (``repro_torch.models``, ``repro_torch.launch.serve``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.config import (SHAPES, ModelConfig, MoEConfig,
                                       ShapeConfig, cell_is_skipped)

from . import (dbrx_132b, gemma_7b, kimi_k2_1t_a32b, llama3_2_3b,
               mistral_large_123b, qwen2_vl_7b, recurrentgemma_9b, rwkv6_3b,
               seamless_m4t_large_v2, yi_34b)

_MODULES = {
    "gemma-7b": gemma_7b,
    "llama3.2-3b": llama3_2_3b,
    "mistral-large-123b": mistral_large_123b,
    "yi-34b": yi_34b,
    "rwkv6-3b": rwkv6_3b,
    "qwen2-vl-7b": qwen2_vl_7b,
    "dbrx-132b": dbrx_132b,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
    "recurrentgemma-9b": recurrentgemma_9b,
}

ARCH_NAMES = tuple(_MODULES)


def get(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; one of {ARCH_NAMES}")
    return _MODULES[name].config()


# ---------------------------------------------------------------------------
# reduced smoke variants: same family / pattern / features, tiny dims
# ---------------------------------------------------------------------------

def smoke_of(cfg: ModelConfig) -> ModelConfig:
    """Shrink every dimension while preserving the architecture family,
    layer pattern, attention kind, MoE topology and modality plumbing."""
    n_layers = len(cfg.prefix) + 2 * len(cfg.pattern) + len(cfg.suffix)
    kv = min(cfg.num_kv_heads, 2) if cfg.num_kv_heads > 1 else 1
    moe = None
    if cfg.moe:
        moe = MoEConfig(num_experts=8, top_k=min(cfg.moe.top_k, 2), d_ff=32,
                        num_shared=min(cfg.moe.num_shared, 1),
                        capacity_factor=2.0)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=n_layers,
        d_model=64, num_heads=4, num_kv_heads=kv, head_dim=16,
        d_ff=128, vocab=512,
        mrope_sections=(2, 3, 3) if cfg.rope == "mrope" else (),
        window=8 if cfg.attn_kind == "local" else 0,
        moe=moe,
        enc_layers=2 if cfg.encdec else 0,
        rwkv_head_dim=16,
        rglru_width=64 if cfg.rglru_width else 0,
        param_dtype="float32", compute_dtype="float32",
        remat=False,
    )


# ---------------------------------------------------------------------------
# input specs per (arch, shape) cell
# ---------------------------------------------------------------------------

def batch_shapes(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    """Input shapes/dtypes for a cell, as (shape, dtype, kind) where kind in
    {'tokens', 'act', 'positions'} names what the input holds.  Decode cells
    add the KV cache via ``Model.cache_specs`` separately."""
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    out: dict[str, tuple] = {}
    if shape.kind in ("train", "prefill"):
        if cfg.input_mode == "embeds":
            out["embeds"] = ((b, s, d), cfg.cdtype, "act")
        else:
            out["tokens"] = ((b, s), torch.int32, "tokens")
        if cfg.rope == "mrope":
            out["positions"] = ((3, b, s), torch.int32, "positions")
        if cfg.encdec:
            out["src_embeds"] = ((b, src_len(cfg, shape), d), cfg.cdtype,
                                 "act")
        if shape.kind == "train":
            out["labels"] = ((b, s), torch.int32, "tokens")
    else:  # decode: one token against a seq_len cache (text generation)
        out["tokens"] = ((b, 1), torch.int32, "tokens")
        if cfg.rope == "mrope":
            out["positions"] = ((3, b, 1), torch.int32, "positions")
    return out


def src_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Encoder source length for enc-dec cells (speech frames)."""
    return min(shape.seq_len, 4096)


# ---------------------------------------------------------------------------
# the paper's own workloads (Table I), as decomposition configs
# ---------------------------------------------------------------------------

CPALS_WORKLOADS = {
    # name: (dims, nnz, rank) — rank 35 is the paper's setting
    "cpals-yelp": ((41_000, 11_000, 75_000), 8_000_000, 35),
    "cpals-nell2": ((12_000, 9_000, 29_000), 77_000_000, 35),
    "cpals-netflix": ((480_000, 18_000, 2_000), 100_000_000, 35),
}

# workload id -> repro_torch.core.PAPER_DATASETS key (the synthetic replica
# the launchers materialize for that workload)
CPALS_DATASET = {
    "cpals-yelp": "yelp",
    "cpals-nell2": "nell-2",
    "cpals-netflix": "netflix",
}

__all__ = ["CPALS_WORKLOADS", "CPALS_DATASET", "ARCH_NAMES", "get",
           "smoke_of", "batch_shapes", "src_len", "SHAPES",
           "cell_is_skipped"]
