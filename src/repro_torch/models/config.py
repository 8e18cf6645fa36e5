"""Model / shape configuration for the assigned architecture pool.

Counterpart of ``repro.models.config``: the same frozen dataclasses, field
for field, so one configuration means the same model in both packages.
``pdtype`` and ``cdtype`` are ``torch.dtype``s here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                   # per-expert hidden
    num_shared: int = 0         # always-on shared experts (Kimi K2)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | vlm | audio | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    mlp: str = "swiglu"         # swiglu | geglu | gelu
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    rope: str = "std"           # none | std | mrope
    rope_theta: float = 10_000.0
    mrope_sections: tuple = ()  # (t, h, w) half-dim split for M-RoPE

    attn_kind: str = "full"     # full | local
    window: int = 0             # local-attention window (hybrid archs)

    # layer stacking: `prefix` leading layers, then `pattern` repeated over
    # the remaining layers (must divide), then `suffix`.  kinds: 'attn'
    # (attention+mlp), 'moe' (attention+moe), 'rec' (RG-LRU temporal block
    # + mlp), 'rwkv' (RWKV6 time-mix + channel-mix).
    pattern: tuple = ("attn",)
    prefix: tuple = ()
    suffix: tuple = ()

    moe: Optional[MoEConfig] = None
    tie_embeddings: bool = False
    scale_embed: bool = False           # gemma: x *= sqrt(d_model)
    input_mode: str = "tokens"          # tokens | embeds (vlm/audio stubs)

    # encoder-decoder (seamless): encoder layers use the same dims
    encdec: bool = False
    enc_layers: int = 0

    # recurrent families
    rwkv_head_dim: int = 64
    rglru_width: int = 0                # 0 -> d_model
    conv_width: int = 4

    # numerics / memory
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"   # full | dots
    # perf-pass knobs (off = paper-faithful base)
    flash_block_skip: bool = False   # skip fully-masked KV blocks in flash
    chunked_loss: int = 0            # CE over seq chunks (0 = full logits)
    # the reference's dry-run cost probes (no meaning in this package; kept
    # so the two configurations stay field for field equal)
    unroll_loops: bool = False
    # which logical axis the FSDP ('data') rule applies to, for >=34B archs
    fsdp: bool = False

    # --- derived -----------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def layer_plan(self) -> tuple[tuple[str, ...], int, tuple[str, ...]]:
        """(prefix, n_pattern_repeats, suffix); validates the layer count."""
        body = self.num_layers - len(self.prefix) - len(self.suffix)
        if body < 0 or (len(self.pattern) and body % len(self.pattern)):
            raise ValueError(
                f"{self.name}: {self.num_layers} layers does not decompose "
                f"into prefix {self.prefix} + k*{self.pattern} + suffix {self.suffix}"
            )
        reps = body // len(self.pattern) if self.pattern else 0
        return self.prefix, reps, self.suffix

    @property
    def attn_param_count(self) -> int:
        d, h, kv, hd = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim
        return d * h * hd + 2 * d * kv * hd + h * hd * d

    def param_count(self) -> int:
        """Total parameter count (for 6ND MODEL_FLOPS and sanity checks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        mlp_p = {"swiglu": 3 * d * f, "geglu": 3 * d * f, "gelu": 2 * d * f}[self.mlp]
        kind_counts = {}
        kind_counts["attn"] = self.attn_param_count + mlp_p + 2 * d
        if self.moe:
            e = self.moe
            moe_mlp = e.num_experts * 3 * d * e.d_ff + d * e.num_experts
            moe_mlp += e.num_shared * 3 * d * e.d_ff
            kind_counts["moe"] = self.attn_param_count + moe_mlp + 2 * d
        if "rec" in self.prefix + self.pattern + self.suffix:
            w = self.rglru_width or d
            # in/out proj + conv + rglru gates/decay + mlp + norms
            rec = 2 * d * w + self.conv_width * w + 3 * w + 2 * w * w + mlp_p + 2 * d
            kind_counts["rec"] = rec
        if "rwkv" in self.prefix + self.pattern + self.suffix:
            # r,k,v,g,o projections + decay/bonus + ddlerp lora + channel mix
            tm = 5 * d * d + 2 * d + d * 160 + 5 * 32 * d
            cm = 2 * d * f + d * d  # rwkv channel mix: k, v, r
            kind_counts["rwkv"] = tm + cm + 2 * d
        total = 0
        prefix, reps, suffix = self.layer_plan
        for kind in list(prefix) + list(self.pattern) * reps + list(suffix):
            total += kind_counts[kind]
        total += v * d  # embedding
        if not self.tie_embeddings:
            total += d * v
        total += d  # final norm
        if self.encdec:
            total += self.enc_layers * kind_counts["attn"]
            # decoder cross-attention blocks
            total += self.num_layers * (self.attn_param_count + d)
        return total

    def active_param_count(self) -> int:
        """Active (per-token) params — MoE counts top_k + shared experts."""
        if not self.moe:
            return self.param_count()
        e = self.moe
        d = self.d_model
        inactive_per_moe = (e.num_experts - e.top_k) * 3 * d * e.d_ff
        prefix, reps, suffix = self.layer_plan
        seq = list(prefix) + list(self.pattern) * reps + list(suffix)
        n_moe = sum(1 for k in seq if k == "moe")
        return self.param_count() - n_moe * inactive_per_moe


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: what step to run and at what size."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def step_name(self) -> str:
        return {"train": "train_step", "prefill": "prefill_step",
                "decode": "serve_step"}[self.kind]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# archs whose attention is sub-quadratic (fixed-state or windowed): the only
# ones that run long_500k
SUBQUADRATIC = ("rwkv6-3b", "recurrentgemma-9b")


def cell_is_skipped(arch: str, shape: str) -> str | None:
    """Return a skip reason or None."""
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return "pure full attention: 524k dense KV decode is the wrong tool"
    return None
