"""mistral-large-123b [dense] — 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768. FSDP (embed axis -> data) required at this size.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b", family="dense",
        num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8,
        head_dim=128, d_ff=28672, vocab=32_768,
        mlp="swiglu", rope="std", rope_theta=1_000_000.0,
        fsdp=True,
    )
