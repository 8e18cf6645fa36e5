"""yi-34b [dense] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000,
llama-arch GQA. [arXiv:2403.04652; hf]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="dense",
        num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
        head_dim=128, d_ff=20480, vocab=64_000,
        mlp="swiglu", rope="std", rope_theta=5_000_000.0,
        fsdp=True,
    )
