"""rwkv6-3b [ssm] (Finch) — 32L d_model=2560 attn-free, d_ff=8960
vocab=65536; data-dependent per-channel decay; 64-dim wkv heads.
Fixed-size decode state -> runs long_500k. [arXiv:2404.05892; hf]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="ssm",
        num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40,
        head_dim=64, d_ff=8960, vocab=65_536,
        pattern=("rwkv",), rope="none", rwkv_head_dim=64,
    )
