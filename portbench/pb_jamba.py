"""Weights and work counts of a Jamba hybrid (``repro_torch/configs/
jamba.py``: Mamba-1 mixers and position-free GQA attention, each followed
by a dense or a routed FFN).

``weights`` makes the model's weights on the device from the seed, in
the port's tree (one attention period of layers stacked under
``"unit"`` / ``"b0"`` ... ``"b7"``, the stacked axis the periods) and in
the types the port serves them in: bf16 matrices (the router too, as
published) and the conv's bias, float32 vectors.  Scales: each matrix
``N(0, 1) * fan_in**-0.5`` (an expert's by its own fan-in, the conv's
by its width); the embedding ``N(0, 1) * d_model**-0.5``; norm gains
``N(0, 0.1)`` (the norm's gain is ``1 + w``); the conv's bias ``N(0,
0.1)``.  The Mamba mixer's own leaves follow Mamba's initialisation:
``A_log = log(1 .. d_state)`` on every channel, ``D = 1``, and the time
step's bias the inverse softplus of a step drawn log-uniformly from
[0.001, 0.1].  The stacked leaves are drawn a layer at a time into their
home dtype, so no float32 copy of a whole stack is ever made.

``token_flops`` and ``attention_flops`` count the model's FLOPs (2 a
multiply-add) as the plain reference computes them; ``expert_bytes`` is
the bytes one routed expert's three matrices take; ``mixer_flops`` and
``mixer_weight_bytes`` are a Mamba mixer's matmul FLOPs for some tokens
and the bytes its weights take as served; ``scan_chunk_bytes`` is the
least bytes of one chunk through the chunk-scan kernel.
"""

from __future__ import annotations

import math

import torch

BF16, F32 = 2, 4


def _mixer_dims(mc):
    s = mc.ssm
    return s.expand * mc.d_model, s.dt_rank, s.state_dim, s.conv_width


def weights(mc, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    d, H, KV, hd, V = (mc.d_model, mc.n_heads, mc.n_kv_heads, mc.hd,
                       mc.vocab)
    di, dtr, st, cw = _mixer_dims(mc)
    E, f = mc.moe.num_experts, mc.moe.d_ff
    unit, L, _ = mc.scan_plan()

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

    def dt_bias():
        lo, hi = math.log(1e-3), math.log(1e-1)
        out = torch.empty((L, di), dtype=torch.float32, device=device)
        for part in out:
            dt = torch.exp(torch.rand(part.shape, generator=gen,
                                      device=device) * (hi - lo) + lo)
            part.copy_(dt + torch.log(-torch.expm1(-dt)))
        return out

    def mixer():
        f32 = dict(dtype=torch.float32, device=device)
        return {"in_proj": normal((d, 2 * di), d, L),
                "conv_w": normal((cw, di), cw, L),
                "conv_b": normal((di,), None, L),
                "x_proj": normal((di, dtr + 2 * st), di, L),
                "dt_w": normal((dtr, di), dtr, L),
                "dt_b": dt_bias(),
                "A_log": torch.log(torch.arange(1, st + 1, **f32))
                .expand(L, di, st).contiguous(),
                "D": torch.ones((L, di), **f32),
                "out_proj": normal((di, d), di, L),
                "dt_norm": norm(dtr, L), "b_norm": norm(st, L),
                "c_norm": norm(st, L)}

    def attn():
        return {"wq": normal((d, H, hd), d, L),
                "wk": normal((d, KV, hd), d, L),
                "wv": normal((d, KV, hd), d, L),
                "wo": normal((H, hd, d), H * hd, L)}

    def ffn(i):
        if mc.moe_at(i):
            return "moe", {"router": normal((d, E), d, L),
                           "w_gate": normal((E, d, f), d, L),
                           "w_up": normal((E, d, f), d, L),
                           "w_down": normal((E, f, d), f, L)}
        return "mlp", {"w_gate": normal((d, mc.d_ff), d, L),
                       "w_up": normal((d, mc.d_ff), d, L),
                       "w_down": normal((mc.d_ff, d), mc.d_ff, L)}

    blocks = {}
    for i, t in enumerate(unit):
        b = {"ln1": norm(d, L)}
        if t == "attn":
            b["attn"] = attn()
        else:
            b["ssm"] = mixer()
        b["ln2"] = norm(d, L)
        kind, p = ffn(i)
        b[kind] = p
        blocks[f"b{i}"] = b
    return {"embed": normal((V, d), d), "unit": blocks,
            "final_norm": norm(d), "head": normal((d, V), d)}


def _counts(mc):
    types = mc.layer_types()
    n_attn = types.count("attn")
    n_moe = sum(mc.moe_at(i) for i in range(mc.n_layers))
    return n_attn, len(types) - n_attn, n_moe, mc.n_layers - n_moe


def mixer_matmul_params(mc) -> int:
    """Multiply-adds of one token through a Mamba mixer's matmuls: the
    input projection, ``x_proj``, ``dt_proj`` and the output
    projection."""
    d = mc.d_model
    di, dtr, st, _ = _mixer_dims(mc)
    return d * 2 * di + di * (dtr + 2 * st) + dtr * di + di * d


def mixer_flops(mc, tokens: int) -> int:
    """Matmul FLOPs of ``tokens`` tokens through one Mamba mixer."""
    return 2 * tokens * mixer_matmul_params(mc)


def mixer_weight_bytes(mc) -> int:
    """Bytes of one Mamba mixer's weights as served: bf16 matrices and
    conv bias, float32 vectors (the time step's bias, ``A_log``, ``D``,
    the norms' gains)."""
    di, dtr, st, cw = _mixer_dims(mc)
    bf16 = mixer_matmul_params(mc) + cw * di + di
    f32 = di + di * st + di + dtr + 2 * st
    return BF16 * bf16 + F32 * f32


def token_flops(mc) -> int:
    """Forward FLOPs of one token through the matmuls: the Mamba mixers'
    projections, the attention layers' q, k, v and output projections,
    the dense FFNs, the router and the top-k routed experts, and the
    head."""
    d, hq, hkv = mc.d_model, mc.n_heads * mc.hd, mc.n_kv_heads * mc.hd
    n_attn, n_ssm, n_moe, n_dense = _counts(mc)
    moe = mc.moe
    attn = d * (hq + 2 * hkv) + hq * d
    dense = 3 * d * mc.d_ff
    routed = d * moe.num_experts + moe.top_k * 3 * d * moe.d_ff
    return 2 * (n_attn * attn + n_ssm * mixer_matmul_params(mc)
                + n_dense * dense + n_moe * routed + d * mc.vocab)


def attention_flops(mc, keys) -> int:
    """Forward FLOPs of one query attending over ``keys`` keys in every
    attention layer: scores and the weighted sum of values, per head.
    The Mamba mixers' scan is no matmul and is not counted."""
    n_attn = _counts(mc)[0]
    return 2 * 2 * n_attn * mc.n_heads * mc.hd * keys


def scan_chunk_bytes(a_shape, h_shape) -> int:
    """Least bytes of one chunk through the chunk-scan kernel: its float32
    decay and input ``a_shape`` (B, T, ...) read once, its states of the
    same shape written once, the state before it ``h_shape`` read once."""
    return F32 * (3 * math.prod(a_shape) + math.prod(h_shape))


def expert_bytes(mc) -> int:
    """Bytes of one routed expert's gate, up and down matrices."""
    return 3 * mc.d_model * mc.moe.d_ff * BF16
