"""deepseek-v2-lite: multi-head latent attention, DeepSeekMoE with 2 shared
and 64 routed experts (top-6), one leading dense layer, YaRN rotary
[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite config.json]."""

from .mla import MLAConfig, MLASpec, SharedMoESpec, YaRN


def config() -> MLAConfig:
    return MLAConfig(
        name="deepseek-v2-lite",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,
        vocab=102400,
        head_dim=192,
        rope_theta=10_000.0,
        norm_eps=1e-6,
        moe=SharedMoESpec(num_experts=64, top_k=6, d_ff=1408, n_shared=2,
                          norm_topk_prob=False, routed_scaling_factor=1.0),
        mla=MLASpec(kv_lora_rank=512, qk_nope_head_dim=128,
                    qk_rope_head_dim=64, v_head_dim=128),
        rope_scaling=YaRN(factor=40.0, original_max_position=4096,
                          beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                          mscale_all_dim=0.707),
        first_k_dense=1,
    )


def smoke_config() -> MLAConfig:
    return MLAConfig(
        name="deepseek-v2-lite-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=192,
        vocab=256,
        head_dim=24,
        # capacity 8/3: a training forward drops nothing (as the other
        # smoke MoEs, capacity_factor = num_experts / top_k)
        moe=SharedMoESpec(num_experts=8, top_k=3, d_ff=32, n_shared=2,
                          norm_topk_prob=False, routed_scaling_factor=1.0,
                          capacity_factor=8 / 3),
        mla=MLASpec(kv_lora_rank=32, qk_nope_head_dim=16,
                    qk_rope_head_dim=8, v_head_dim=16),
        rope_scaling=YaRN(factor=40.0, original_max_position=64,
                          beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                          mscale_all_dim=0.707),
        first_k_dense=1,
    )
