"""chameleon-34b: early-fusion VLM; VQ image tokens share the vocab so the backbone is a plain decoder [arXiv:2405.09818].  The image tokenizer frontend is a stub (tokens arrive pre-quantized)."""

from .base import ModelConfig, MoESpec, SSMSpec, RGLRUSpec  # noqa


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b",
        family="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab=65536,
        frontend_stub="patch",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=256,
        frontend_stub="patch",
    )
