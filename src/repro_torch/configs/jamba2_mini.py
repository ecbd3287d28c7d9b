"""jamba2-mini: blocks of 8 layers, 7 Mamba-1 mixers to 1 GQA attention
layer without positions, an FFN after every mixer that is 16 experts
(top-2, gates not renormalised) in every other layer and a dense SwiGLU
between [arXiv:2403.19887; hf:ai21labs/AI21-Jamba2-Mini config.json].
The order of the layer types is transformers' ``JambaConfig`` rule:
attention where ``i % 8 == 4``, experts where ``i % 2 == 1``."""

from .jamba import JambaConfig, JambaSSMSpec
from .mla import SharedMoESpec


def config() -> JambaConfig:
    return JambaConfig(
        name="jamba2-mini",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=65536,
        head_dim=128,
        norm_eps=1e-6,
        moe=SharedMoESpec(num_experts=16, top_k=2, d_ff=14336,
                          norm_topk_prob=False),
        ssm=JambaSSMSpec(state_dim=16, conv_width=4, expand=2, dt_rank=256),
    )


def smoke_config() -> JambaConfig:
    return JambaConfig(
        name="jamba2-mini-smoke",
        family="hybrid",
        n_layers=8,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=192,
        vocab=256,
        head_dim=32,
        norm_eps=1e-6,
        # capacity 16/2: a training forward drops nothing
        moe=SharedMoESpec(num_experts=16, top_k=2, d_ff=96,
                          norm_topk_prob=False, capacity_factor=8.0),
        ssm=JambaSSMSpec(state_dim=4, conv_width=4, expand=2, dt_rank=8),
    )
