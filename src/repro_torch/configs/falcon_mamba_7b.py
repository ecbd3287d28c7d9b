"""falcon-mamba-7b: Mamba-1 SSM, attention-free [arXiv:2410.05355]."""

from .base import ModelConfig, MoESpec, SSMSpec, RGLRUSpec  # noqa


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4096,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab=65024,
        ssm=SSMSpec(state_dim=16, conv_width=4, expand=2),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab=256,
        ssm=SSMSpec(state_dim=4, conv_width=4, expand=2),
    )
