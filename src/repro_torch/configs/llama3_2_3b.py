"""llama3.2-3b [dense] — 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256, SwiGLU, rope theta 500k, tied embeddings.
[hf:meta-llama/Llama-3.2-3B; unverified]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b", family="dense",
        num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8,
        head_dim=128, d_ff=8192, vocab=128_256,
        mlp="swiglu", rope="std", rope_theta=500_000.0,
        tie_embeddings=True,
    )
