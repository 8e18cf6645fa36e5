"""gemma-7b [dense] — 28L d_model=3072 16H (MHA kv=16) d_ff=24576 vocab=256000,
GeGLU, head_dim=256, tied + scaled embeddings. [arXiv:2403.08295; hf]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b", family="dense",
        num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16,
        head_dim=256, d_ff=24576, vocab=256_000,
        mlp="geglu", rope="std", rope_theta=10_000.0,
        tie_embeddings=True, scale_embed=True,
    )
