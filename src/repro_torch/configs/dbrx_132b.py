"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352; fine-grained MoE 16 experts top-4.
[hf:databricks/dbrx-base; unverified]"""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=10752, vocab=100_352,
        mlp="swiglu", norm="layernorm", rope="std", rope_theta=500_000.0,
        pattern=("moe",),
        moe=MoEConfig(num_experts=16, top_k=4, d_ff=10752),
        fsdp=True,
    )
