"""recurrentgemma-9b: Griffin hybrid, RG-LRU + local attention 1:2, MQA [arXiv:2402.19427]."""

from .base import ModelConfig, MoESpec, SSMSpec, RGLRUSpec  # noqa


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        d_ff=12288,
        vocab=256000,
        rglru=RGLRUSpec(lru_width=4096, conv_width=4, window=2048),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-smoke",
        family="hybrid",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=256,
        vocab=256,
        rglru=RGLRUSpec(lru_width=64, conv_width=4, window=32),
    )
