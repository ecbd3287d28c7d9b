"""Weights of a dense GQA LM made from the seed on the device, in the
port's tree layout (layers stacked under ``"unit"`` / ``"b0"``) and in
the types the port serves them in: bf16 matrices, embeddings and qkv
biases, float32 norm gains.  One draw per leaf covers every layer.

Scales: each matrix ``N(0, 1) * fan_in**-0.5``; the embedding table
``N(0, 1) * d_model**-0.5`` (a tied head then gives logits of unit
spread); norm gains and biases ``N(0, 0.1)`` (the norm's gain is
``1 + w``), so every term of the layer equations is exercised.
"""

from __future__ import annotations

import torch


def lm_weights(mc, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    L, d, H, KV, hd, f, V = (mc.n_layers, mc.d_model, mc.n_heads,
                             mc.n_kv_heads, mc.hd, mc.d_ff, mc.vocab)

    def normal(shape, scale, dtype=torch.bfloat16):
        w = torch.randn(shape, generator=gen, device=device)
        return (w * scale).to(dtype)

    attn = {"wq": normal((L, d, H, hd), d ** -0.5),
            "wk": normal((L, d, KV, hd), d ** -0.5),
            "wv": normal((L, d, KV, hd), d ** -0.5),
            "wo": normal((L, H, hd, d), (H * hd) ** -0.5)}
    if mc.qkv_bias:
        attn["bq"] = normal((L, H, hd), 0.1)
        attn["bk"] = normal((L, KV, hd), 0.1)
        attn["bv"] = normal((L, KV, hd), 0.1)
    block = {"ln1": normal((L, d), 0.1, torch.float32), "attn": attn,
             "ln2": normal((L, d), 0.1, torch.float32),
             "mlp": {"w_gate": normal((L, d, f), d ** -0.5),
                     "w_up": normal((L, d, f), d ** -0.5),
                     "w_down": normal((L, f, d), f ** -0.5)}}
    params = {"embed": normal((V, d), d ** -0.5), "unit": {"b0": block},
              "final_norm": normal((d,), 0.1, torch.float32)}
    if not mc.tie_embeddings:
        params["head"] = normal((d, V), d ** -0.5)
    return params
