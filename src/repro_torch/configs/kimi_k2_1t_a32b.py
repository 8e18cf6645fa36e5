"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) vocab=163840;
MoE 384 experts top-8 + 1 shared expert, expert d_ff=2048 (per the assigned
spec; the dense first layer uses the same d_ff — see DESIGN.md), first layer
dense. Trillion-param total, ~32B active. [arXiv:2501.kimi2; unverified]"""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=2048, vocab=163_840,
        mlp="swiglu", rope="std", rope_theta=50_000.0,
        prefix=("attn",), pattern=("moe",),
        moe=MoEConfig(num_experts=384, top_k=8, d_ff=2048, num_shared=1),
        fsdp=True,
    )
