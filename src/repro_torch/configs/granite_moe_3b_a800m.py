"""granite-moe-3b-a800m: fine-grained MoE, 40 experts top-8, d_ff=512 [hf:ibm-granite].  The assignment lists both '40e top-8' and '32 experts'; we follow the explicit MoE field (40 experts)."""

from .base import ModelConfig, MoESpec, SSMSpec, RGLRUSpec  # noqa


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab=49155,
        moe=MoESpec(num_experts=40, top_k=8, d_ff=512),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        moe=MoESpec(num_experts=8, top_k=2, d_ff=128, capacity_factor=4.0),
    )
