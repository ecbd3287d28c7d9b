"""llama3.2-1b: small llama3, GQA kv=8, 500k rope theta [hf:meta-llama]."""

from .base import ModelConfig, MoESpec, SSMSpec, RGLRUSpec  # noqa


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab=128256,
        rope_theta=500000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=256,
        rope_theta=500000.0,
        tie_embeddings=True,
    )
