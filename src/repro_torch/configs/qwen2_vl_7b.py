"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064; M-RoPE (t/h/w sections 16/24/24), dynamic resolution.
Backbone only: the vision frontend is a stub — input_specs() provides
precomputed patch embeddings. [arXiv:2409.12191; hf]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm",
        num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
        head_dim=128, d_ff=18944, vocab=152_064,
        mlp="swiglu", rope="mrope", rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24), input_mode="embeds",
    )
