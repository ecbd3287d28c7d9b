"""qwen2-0.5b: GQA kv=2 with QKV bias [arXiv:2407.10671]."""

from .base import ModelConfig, MoESpec, SSMSpec, RGLRUSpec  # noqa


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b",
        family="dense",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab=151936,
        qkv_bias=True,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=256,
        qkv_bias=True,
        tie_embeddings=True,
    )
