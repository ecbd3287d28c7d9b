"""Plain float32 reference of a dense decoder-only GQA language model.

One function covers both configurations of the benchmark (Qwen2,
arXiv:2407.10671; H2O-Danube, arXiv:2401.16818): token embedding; per
layer RMSNorm, q/k/v projections with the optional qkv bias, rotary
embedding (rotate-half, ``theta ** (-i / (hd / 2))``), causal attention
over the grouped key/value heads with the optional sliding window, the
output projection and the residual, RMSNorm, a SwiGLU MLP and the
residual; a final RMSNorm and the output head (the embedding table's
transpose when tied).  RMSNorm is ``x / sqrt(mean(x^2) + eps) * (1 +
g)``, the gain stored as its offset from 1 (the same map as a gain of
``1 + g``).  Everything is float32 with TF32 off, one sequence at a time,
layer by layer; the weights are the bf16 tensors the benchmark made,
widened to float32 one layer at a time.

``quant="fp8"`` is the control: every matmul of a projection, the MLP and
the head takes its operands through float8 e4m3 (a scale per output
column of the weight, per row of the activation), accumulating in
float32, as an fp8 deployment of the bf16 model would.
"""

from __future__ import annotations

import math

import torch

F8_MAX = 448.0     # largest finite float8 e4m3fn


def _fp8(v, dim):
    """``v`` rounded through float8 e4m3 with one scale per slice along
    the reduced dimension ``dim`` (float32 in and out; the gradient
    passes the rounding unchanged, as fp8 training's does)."""
    amax = torch.clamp(v.detach().abs().amax(dim=dim, keepdim=True),
                       min=1e-12)
    s = amax / F8_MAX
    q = (v.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return v + (q - v.detach())


def _mm(x, w, quant):
    """``x (S, K) @ w (K, N)`` in float32, or through fp8."""
    if quant == "fp8":
        return _fp8(x, 1) @ _fp8(w, 0)
    return x @ w


def _rmsnorm(x, g, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1 + g)


def _rope(x, pos, theta):
    """x: (S, heads, hd); rotate-half rotary embedding at ``pos``."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = pos[:, None].to(torch.float32) * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)


class no_tf32:
    """Float32 matmuls in float32 (TF32 off) inside the block."""

    def __enter__(self):
        self.prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.prev


def forward(w: dict, mc, tokens: torch.Tensor, quant=None) -> torch.Tensor:
    """float32 logits ``(S, vocab)`` of one sequence ``tokens (S,)``, with
    no autograd."""
    with no_tf32(), torch.no_grad():
        return logits_of(w, mc, tokens, quant)


def logits_of(w: dict, mc, tokens: torch.Tensor, quant=None):
    """float32 logits ``(S, vocab)`` of one sequence ``tokens (S,)``
    (autograd records it when the caller asks).

    ``w`` is the tree the benchmark made (``pb_weights.lm_weights``), or
    the same tree in float32; ``mc`` gives the sizes: ``n_layers``,
    ``d_model``, ``n_heads``, ``n_kv_heads``, ``hd``, ``qkv_bias``,
    ``sliding_window``, ``rope_theta``, ``norm_eps``,
    ``tie_embeddings``."""
    f32 = torch.float32
    dev = w["embed"].device
    tokens = tokens.to(dev).long()
    S, d, H, KV, hd = (tokens.shape[0], mc.d_model, mc.n_heads,
                       mc.n_kv_heads, mc.hd)
    pos = torch.arange(S, device=dev)
    keep = pos[None, :] <= pos[:, None]
    if mc.sliding_window:
        keep &= pos[None, :] > pos[:, None] - mc.sliding_window
    h = w["embed"][tokens].to(f32)
    b = w["unit"]["b0"]
    for li in range(mc.n_layers):
        at = {k: v[li].to(f32) for k, v in b["attn"].items()}
        x = _rmsnorm(h, b["ln1"][li].to(f32), mc.norm_eps)
        q = _mm(x, at["wq"].reshape(d, H * hd), quant).reshape(S, H, hd)
        k = _mm(x, at["wk"].reshape(d, KV * hd), quant).reshape(S, KV, hd)
        v = _mm(x, at["wv"].reshape(d, KV * hd), quant).reshape(S, KV, hd)
        if mc.qkv_bias:
            q, k, v = q + at["bq"], k + at["bk"], v + at["bv"]
        q = _rope(q, pos, mc.rope_theta)
        k = _rope(k, pos, mc.rope_theta)
        g = H // KV
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
        s = s.masked_fill(~keep[None], float("-inf"))
        o = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)
        h = h + _mm(o.reshape(S, H * hd), at["wo"].reshape(H * hd, d),
                    quant)
        ml = {k_: v_[li].to(f32) for k_, v_ in b["mlp"].items()}
        x = _rmsnorm(h, b["ln2"][li].to(f32), mc.norm_eps)
        gate = _mm(x, ml["w_gate"], quant)
        up = _mm(x, ml["w_up"], quant)
        h = h + _mm(torch.nn.functional.silu(gate) * up, ml["w_down"],
                    quant)
    h = _rmsnorm(h, w["final_norm"].to(f32), mc.norm_eps)
    head = w["embed"].T if mc.tie_embeddings else w["head"]
    return _mm(h, head.to(f32), quant)


def served_gaps(logits: torch.Tensor, prompt_len: int, served) -> list:
    """How far below the reference's best each served token's logit lies:
    token ``i`` of ``served`` was chosen after position ``prompt_len - 1
    + i`` of the sequence ``prompt + served``."""
    at = logits[prompt_len - 1:prompt_len - 1 + len(served)]
    idx = torch.as_tensor(list(served), device=at.device)
    chosen = at.gather(1, idx[:, None])[:, 0]
    return (at.max(-1).values - chosen).tolist()
