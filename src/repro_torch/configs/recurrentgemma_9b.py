"""recurrentgemma-9b [hybrid] (Griffin) — 38L d_model=4096 16H (MQA kv=1)
head_dim=256 d_ff=12288 vocab=256000; pattern 2x RG-LRU : 1x local attention
(window 2048); GeGLU; 38 = 12*(rec,rec,attn) + (rec,rec) tail.  Fixed-size
state -> runs long_500k. [arXiv:2402.19427; unverified]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
        head_dim=256, d_ff=12288, vocab=256_000,
        mlp="geglu", rope="std", rope_theta=10_000.0,
        pattern=("rec", "rec", "attn"), suffix=("rec", "rec"),
        attn_kind="local", window=2048, rglru_width=4096,
        tie_embeddings=True, scale_embed=True,
    )
