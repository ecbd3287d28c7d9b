"""mixtral-8x7b: 8 experts top-2, sliding-window attention [arXiv:2401.04088]."""

from .base import ModelConfig, MoESpec, SSMSpec, RGLRUSpec  # noqa


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=32000,
        sliding_window=4096,
        moe=MoESpec(num_experts=8, top_k=2, d_ff=14336),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        sliding_window=32,
        moe=MoESpec(num_experts=4, top_k=2, d_ff=128, capacity_factor=2.0),
    )
