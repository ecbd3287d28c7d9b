"""h2o-danube-1.8b: llama+mistral mix with sliding-window attention [arXiv:2401.16818]."""

from .base import ModelConfig, MoESpec, SSMSpec, RGLRUSpec  # noqa


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6912,
        vocab=32000,
        sliding_window=4096,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=256,
        sliding_window=32,
    )
