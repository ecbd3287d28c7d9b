"""Weights and work counts of a latent-attention MoE model (DeepSeek-V2's
layers: ``repro_torch/configs/mla.py``).

``weights`` makes the model's weights on the device from the seed, in
the port's tree (the leading dense layers a list under ``"lead"``, the
MoE layers stacked under ``"unit"`` / ``"b0"``) and in the types the port
serves them in: bf16 matrices (the router too, as published), float32
norm gains.  Scales: each matrix ``N(0, 1) * fan_in**-0.5`` (an
expert's by its own fan-in); the embedding ``N(0, 1) * d_model**-0.5``;
norm gains ``N(0, 0.1)`` (the norm's gain is ``1 + w``).  The stacked
leaves are drawn a layer at a time into their bf16 home, so no float32
copy of a whole stack is ever made.

``token_flops`` and ``attention_flops`` count the model's FLOPs (2 a
multiply-add) in the expanded form of its equations, as the plain
reference computes them; ``expert_bytes`` is the bytes one routed
expert's three matrices take.
"""

from __future__ import annotations

import torch

BF16 = 2


def weights(mc, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    d, H, V, m, moe = (mc.d_model, mc.n_heads, mc.vocab, mc.mla, mc.moe)
    r, qk, rope_d, vd = (m.kv_lora_rank, m.qk_head_dim, m.qk_rope_head_dim,
                         m.v_head_dim)
    E, f, shared = moe.num_experts, moe.d_ff, moe.n_shared * moe.d_ff
    L = mc.n_layers - mc.first_k_dense

    def normal(shape, fan_in, layers=None, dtype=torch.bfloat16):
        scale = fan_in ** -0.5 if fan_in else 0.1
        full = shape if layers is None else (layers,) + shape
        out = torch.empty(full, dtype=dtype, device=device)
        for part in ([out] if layers is None else out):
            part.copy_(torch.randn(part.shape, generator=gen,
                                   device=device) * scale)
        return out

    def norm(n, layers=None):
        return normal((n,), None, layers, torch.float32)

    def attn(layers=None):
        return {"wq": normal((d, H, qk), d, layers),
                "w_dkv": normal((d, r + rope_d), d, layers),
                "kv_norm": norm(r, layers),
                "w_uk": normal((r, H, m.qk_nope_head_dim), r, layers),
                "w_uv": normal((r, H, vd), r, layers),
                "wo": normal((H, vd, d), H * vd, layers)}

    def swiglu(width, layers=None):
        return {"w_gate": normal((d, width), d, layers),
                "w_up": normal((d, width), d, layers),
                "w_down": normal((width, d), width, layers)}

    lead = [{"ln1": norm(d), "attn": attn(), "ln2": norm(d),
             "mlp": swiglu(mc.d_ff)} for _ in range(mc.first_k_dense)]
    experts = {"router": normal((d, E), d, L),
               "w_gate": normal((E, d, f), d, L),
               "w_up": normal((E, d, f), d, L),
               "w_down": normal((E, f, d), f, L),
               "shared": swiglu(shared, L)}
    unit = {"ln1": norm(d, L), "attn": attn(L), "ln2": norm(d, L),
            "moe": experts}
    return {"embed": normal((V, d), d), "lead": lead, "unit": {"b0": unit},
            "final_norm": norm(d), "head": normal((d, V), d)}


def token_flops(mc) -> int:
    """Forward FLOPs of one token through the matmuls: MLA's projections
    (the query, the latent and rotary key, the per-head keys and values
    decompressed, the output), the dense FFN of the leading layers, the
    router, the shared and the top-k routed experts of the others, and
    the head."""
    d, H, m, moe = mc.d_model, mc.n_heads, mc.mla, mc.moe
    r = m.kv_lora_rank
    attn = (d * H * m.qk_head_dim + d * (r + m.qk_rope_head_dim)
            + r * H * (m.qk_nope_head_dim + m.v_head_dim)
            + H * m.v_head_dim * d)
    k = mc.first_k_dense
    dense = 3 * d * mc.d_ff
    routed = d * moe.num_experts + (moe.top_k + moe.n_shared) * 3 * d \
        * moe.d_ff
    return 2 * (mc.n_layers * attn + k * dense + (mc.n_layers - k) * routed
                + d * mc.vocab)


def attention_flops(mc, keys) -> int:
    """Forward FLOPs of one query attending over ``keys`` keys in every
    layer: the scores over ``qk_head_dim`` and the weighted sum of values
    over ``v_head_dim``, per head."""
    m = mc.mla
    return 2 * mc.n_layers * mc.n_heads * (m.qk_head_dim + m.v_head_dim) \
        * keys


def expert_bytes(mc) -> int:
    """Bytes of one routed expert's gate, up and down matrices."""
    return 3 * mc.d_model * mc.moe.d_ff * BF16
