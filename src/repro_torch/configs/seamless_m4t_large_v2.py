"""seamless-m4t-large-v2: encoder-decoder multimodal backbone [arXiv:2308.11596].  Speech frontend is a stub: the encoder consumes precomputed frame embeddings (B, S, d); 24 encoder + 24 decoder layers."""

from .base import ModelConfig, MoESpec, SSMSpec, RGLRUSpec  # noqa


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab=256206,
        mlp_variant="gelu",
        encoder_layers=24,
        frontend_stub="frame",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab=256,
        mlp_variant="gelu",
        encoder_layers=2,
        frontend_stub="frame",
    )
