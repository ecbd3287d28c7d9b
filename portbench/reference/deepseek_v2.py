"""Plain float32 reference of DeepSeek-V2 (arXiv:2405.04434): multi-head
latent attention without query compression (§2.1) and DeepSeekMoE with
shared experts (§2.2), after ``first_k_dense`` leading dense layers.

Per layer, RMSNorm ``x / sqrt(mean(x^2) + eps) * (1 + g)`` (the gain
stored as its offset from 1):

* ``x = RMSNorm(h, ln1)``; ``q = x W_q`` per head, split into ``q_nope``
  and ``q_pe``; ``a = x W_dkv``, split into the latent ``c =
  RMSNorm(a[:r], kv_norm)`` and one rotary key ``k_pe = a[r:]`` for all
  heads; ``q_pe`` and ``k_pe`` rotated by YaRN's frequencies, each pair
  ``(2i, 2i + 1)`` together (laid out de-interleaved, as DeepSeek's
  released code does); ``k_nope = c W_uk``, ``v = c W_uv`` per head;
  scores ``(q_nope . k_nope + q_pe . k_pe) * qk_head_dim**-0.5 *
  mscale**2``, causal softmax, ``h += (p v) W_o``;
* ``f = RMSNorm(h, ln2)``; a leading layer adds the dense SwiGLU of
  ``f``; a MoE layer adds the shared experts' SwiGLU of ``f`` and the
  routed sum ``sum_{i in top-k} p_i SwiGLU_i(f)``, ``p = softmax(f
  W_router)`` in float32, the greedy top-k, the gates not renormalised
  unless ``norm_topk_prob``, times ``routed_scaling_factor``;

then a final RMSNorm and the untied head.  Everything is float32 with
TF32 off, one sequence at a time, layer by layer; the weights are the
bf16 tensors the benchmark made (the port's tree: ``"lead"`` the leading
layers, ``"unit"``/``"b0"`` the MoE layers stacked), widened to float32
one layer at a time.  The attention is the expanded form: the port's
decode regroups the same products (``W_uk`` into the query, ``W_uv``
into the output), which this file does not.

``quant="fp8"`` is the control: every matmul of a projection, an expert,
the shared experts, the dense FFN and the head takes its operands
through float8 e4m3 (``lm._fp8``'s scales), accumulating in float32; the
router stays in float32, as fp8 deployments keep it.
"""

from __future__ import annotations

import math

import torch

from .lm import _mm, _rmsnorm, no_tf32, served_gaps  # noqa: F401


def _mscale(scale, m):
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn_inv_freq(dim, theta, ys, device=None):
    """YaRN's inverse frequencies (DeepSeek's ``yarn_find_correction_range``
    and linear ramp) from the numbers of ``ys``: ``factor``,
    ``original_max_position``, ``beta_fast``, ``beta_slow``."""
    def corr(rot):
        return dim * math.log(ys.original_max_position
                              / (rot * 2 * math.pi)) / (2 * math.log(theta))
    low = max(math.floor(corr(ys.beta_fast)), 0)
    high = min(math.ceil(corr(ys.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    f = 1.0 / (theta ** (2 * i / dim))
    r = torch.clamp((i - low) / (high - low), 0, 1)
    return f / ys.factor * r + f * (1 - r)


def _rope(x, pos, inv, scale):
    """x: (S, heads, d): pairs (2i, 2i+1) rotated by ``pos * inv[i]``,
    the result de-interleaved (evens, then odds); cos and sin times
    ``scale``."""
    ang = pos[:, None].to(torch.float32) * inv[None, :]
    cos = (torch.cos(ang) * scale)[:, None, :]
    sin = (torch.sin(ang) * scale)[:, None, :]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)


def _swiglu(x, p, quant):
    return _mm(torch.nn.functional.silu(_mm(x, p["w_gate"], quant))
               * _mm(x, p["w_up"], quant), p["w_down"], quant)


def forward(w: dict, mc, tokens: torch.Tensor, quant=None) -> torch.Tensor:
    """float32 logits ``(S, vocab)`` of one sequence ``tokens (S,)``, with
    no autograd."""
    with no_tf32(), torch.no_grad():
        return logits_of(w, mc, tokens, quant)


def _layers(w, mc):
    """Each layer's weights as float32, one layer at a time."""
    f32 = torch.float32
    for li in range(mc.n_layers):
        if li < mc.first_k_dense:
            lw = w["lead"][li]
            yield {k: ({n: t.to(f32) for n, t in v.items()}
                       if isinstance(v, dict) else v.to(f32))
                   for k, v in lw.items()}
            continue
        j = li - mc.first_k_dense

        def widen(t):
            if isinstance(t, dict):
                return {n: widen(v) for n, v in t.items()}
            return t[j].to(f32)
        yield widen(w["unit"]["b0"])


def logits_of(w: dict, mc, tokens: torch.Tensor, quant=None):
    """float32 logits ``(S, vocab)`` of one sequence ``tokens (S,)``.

    ``mc`` gives the sizes: ``n_layers``, ``d_model``, ``n_heads``,
    ``norm_eps``, ``rope_theta``, ``first_k_dense``, ``mla``
    (``kv_lora_rank``, ``qk_nope_head_dim``, ``qk_rope_head_dim``,
    ``v_head_dim``), ``rope_scaling`` (YaRN's numbers) and ``moe``
    (``num_experts``, ``top_k``, ``n_shared``, ``norm_topk_prob``,
    ``routed_scaling_factor``)."""
    f32 = torch.float32
    dev = w["embed"].device
    tokens = tokens.to(dev).long()
    S, d, H, eps = tokens.shape[0], mc.d_model, mc.n_heads, mc.norm_eps
    m, ys, moe = mc.mla, mc.rope_scaling, mc.moe
    r, nope, rope_d, vd = (m.kv_lora_rank, m.qk_nope_head_dim,
                           m.qk_rope_head_dim, m.v_head_dim)
    inv = yarn_inv_freq(rope_d, mc.rope_theta, ys, dev)
    cos_scale = _mscale(ys.factor, ys.mscale) / _mscale(ys.factor,
                                                        ys.mscale_all_dim)
    scale = (nope + rope_d) ** -0.5 * _mscale(ys.factor,
                                              ys.mscale_all_dim) ** 2
    pos = torch.arange(S, device=dev)
    keep = pos[None, :] <= pos[:, None]
    h = w["embed"][tokens].to(f32)
    for lw in _layers(w, mc):
        at = lw["attn"]
        x = _rmsnorm(h, lw["ln1"], eps)
        q = _mm(x, at["wq"].reshape(d, -1), quant).reshape(S, H, nope
                                                            + rope_d)
        a = _mm(x, at["w_dkv"], quant)
        c = _rmsnorm(a[:, :r], at["kv_norm"], eps)
        k_pe = _rope(a[:, None, r:], pos, inv, cos_scale)        # (S, 1, .)
        q_pe = _rope(q[..., nope:], pos, inv, cos_scale)
        k_nope = _mm(c, at["w_uk"].reshape(r, -1), quant).reshape(S, H, nope)
        v = _mm(c, at["w_uv"].reshape(r, -1), quant).reshape(S, H, vd)
        s = (torch.einsum("qhd,khd->hqk", q[..., :nope], k_nope)
             + torch.einsum("qhd,kd->hqk", q_pe, k_pe[:, 0])) * scale
        s = s.masked_fill(~keep[None], float("-inf"))
        o = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)
        del s
        h = h + _mm(o.reshape(S, H * vd), at["wo"].reshape(H * vd, d), quant)
        f = _rmsnorm(h, lw["ln2"], eps)
        if "mlp" in lw:
            h = h + _swiglu(f, lw["mlp"], quant)
            continue
        ex = lw["moe"]
        probs = torch.softmax(f @ ex["router"], -1)
        gate, idx = torch.topk(probs, moe.top_k, dim=-1)
        if moe.norm_topk_prob:
            gate = gate / gate.sum(-1, keepdim=True)
        gate = gate * moe.routed_scaling_factor
        y = (_swiglu(f, ex["shared"], quant) if moe.n_shared
             else torch.zeros_like(f))
        for e in range(moe.num_experts):
            tok, slot = torch.nonzero(idx == e, as_tuple=True)
            if tok.numel():
                pe = {n: ex[n][e] for n in ("w_gate", "w_up", "w_down")}
                y = y.index_add(0, tok, gate[tok, slot, None]
                                * _swiglu(f[tok], pe, quant))
        h = h + y
    h = _rmsnorm(h, w["final_norm"].to(f32), eps)
    return _mm(h, w["head"].to(f32), quant)
