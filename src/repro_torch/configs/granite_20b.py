"""granite-20b code model: llama-arch dense, MQA (kv=1) [arXiv:2405.04324]."""

from .base import ModelConfig, MoESpec, SSMSpec, RGLRUSpec  # noqa


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b",
        family="dense",
        n_layers=52,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        vocab=49152,
        mlp_variant="gelu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=256,
        vocab=256,
        mlp_variant="gelu",
    )
