"""seamless-m4t-large-v2 [audio] — enc-dec, 24L encoder + 24L decoder,
d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.  The speech frontend is a
stub: input_specs() provides precomputed frame embeddings for the encoder;
the decoder consumes text tokens with cross-attention. [arXiv:2308.11596; hf]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="audio",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        head_dim=64, d_ff=8192, vocab=256_206,
        mlp="gelu", norm="layernorm", rope="std",
        encdec=True, enc_layers=24,
    )
