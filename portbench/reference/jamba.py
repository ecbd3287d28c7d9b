"""Plain float32 reference of Jamba (arXiv:2403.19887; the equations of
transformers' ``JambaForCausalLM``, its slow path): Mamba-1 mixers and
grouped-query attention without positions, each followed by a dense or a
routed SwiGLU FFN.

Token embedding; per layer ``x = RMSNorm(h, ln1)``, ``h += mixer(x)``,
``f = RMSNorm(h, ln2)``, ``h += FFN(f)``; a final RMSNorm and the untied
head.  RMSNorm is ``x / sqrt(mean(x^2) + eps) * (1 + g)``, the gain
stored as its offset from 1 (the same map as a gain of ``1 + g``).

* The Mamba mixer: ``[xs, z] = x W_in`` (no bias); a causal depthwise
  conv of width ``d_conv`` with its bias over ``xs``, then SiLU;
  ``[dt, B, C] = xs W_x`` split into ``dt_rank``, ``d_state`` and
  ``d_state``; each through its RMSNorm with a gain (Jamba's
  ``dt_layernorm``, ``b_layernorm``, ``c_layernorm``); ``dt =
  softplus(dt W_dt + b_dt)``; ``A = -exp(A_log)``; step by step
  ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t`` from ``h = 0`` and
  ``y_t = C_t . h_t + D x_t``; ``(y * SiLU(z)) W_out`` (no bias).
* Attention: q, k, v projections (no bias), causal softmax over the
  grouped key and value heads with no positional embedding (Jamba's
  attention has none), ``hd**-0.5`` on the scores, the output
  projection.
* FFN: a layer's routed experts (``moe_at``) or the dense SwiGLU; the
  router's probabilities a float32 softmax, its greedy top-k, the gates
  left unnormalised, no shared expert.

Everything is float32 with TF32 off (matmuls and cuDNN), one sequence at
a time, layer by layer, no autograd; the weights are the bf16 tensors
the benchmark made (the port's tree: one period of layers stacked under
``"unit"``, ``"b0"`` ...), widened to float32 one layer at a time and an
expert's matrices one expert at a time.

Departures from the published model: the weights are random; the
router's logits are computed in float32 from its bf16 weights
(transformers computes them in the model's dtype before its float32
softmax); the model is the first ``n_layers`` layers of the published
stack with the final norm and the head after them (a pipeline's first
stage, closed into a language model so that tokens can be served).

``quant="fp8"`` is the control: every matmul of a projection, an expert,
the dense FFN and the head takes its operands through float8 e4m3
(``lm._fp8``'s scales), accumulating in float32; the router and the
scan stay in float32, as fp8 deployments keep them.

``routes`` puts given experts in the router's place: per MoE layer in
order, a ``(n, top_k)`` index tensor for the sequence's first ``n``
positions (the experts a served path chose there), each gated by the
reference's own probability of it.  ``record`` (a dict) receives per
MoE layer the experts used at every position (``"routes"``) and each
position's route margin (``"margin"``): how far, in router logits, the
weakest expert used lies below the reference's own ``top_k``-th best
there (0 where the reference would choose the same experts).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .lm import _mm, _rmsnorm, served_gaps  # noqa: F401

#: time steps whose discretized decay and input are formed at once
STEPS = 256


class no_tf32:
    """Float32 matmuls and convolutions in float32 (TF32 off) inside the
    block."""

    def __enter__(self):
        b = torch.backends
        self.prev = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
        b.cuda.matmul.allow_tf32 = False
        b.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        b = torch.backends
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = self.prev


def forward(w: dict, mc, tokens: torch.Tensor, quant=None, routes=None,
            record=None) -> torch.Tensor:
    """float32 logits ``(S, vocab)`` of one sequence ``tokens (S,)``, with
    no autograd."""
    with no_tf32(), torch.no_grad():
        return logits_of(w, mc, tokens, quant, routes, record)


def _layer(w, mc, li):
    """Layer ``li``'s weights, its stacked leaves indexed; the small ones
    widened to float32, the expert stacks left to ``_moe``."""
    period = len(w["unit"])
    lw = w["unit"][f"b{li % period}"]
    j = li // period

    def take(t, widen):
        if isinstance(t, dict):
            return {n: take(v, widen and n != "moe") for n, v in t.items()}
        return t[j].to(torch.float32) if widen else t[j]
    return take(lw, True)


def _swiglu(x, p, quant):
    return _mm(F.silu(_mm(x, p["w_gate"], quant))
               * _mm(x, p["w_up"], quant), p["w_down"], quant)


def _mamba(x, p, mc, quant):
    """The Mamba-1 mixer over ``x (S, d)``."""
    S = x.shape[0]
    s = mc.ssm
    di, dtr, st = s.expand * mc.d_model, s.dt_rank, s.state_dim
    u = _mm(x, p["in_proj"], quant)
    xs, z = u[:, :di], u[:, di:]
    cw = p["conv_w"].shape[0]
    xp = torch.cat([xs.new_zeros((cw - 1, di)), xs])
    xs = F.silu(sum(xp[k:k + S] * p["conv_w"][k] for k in range(cw))
                + p["conv_b"])
    dbc = _mm(xs, p["x_proj"], quant)
    eps = mc.norm_eps
    dt = _rmsnorm(dbc[:, :dtr], p["dt_norm"], eps)
    B = _rmsnorm(dbc[:, dtr:dtr + st], p["b_norm"], eps)
    C = _rmsnorm(dbc[:, dtr + st:], p["c_norm"], eps)
    dt = F.softplus(_mm(dt, p["dt_w"], quant) + p["dt_b"])      # (S, di)
    A = -torch.exp(p["A_log"])                                  # (di, st)
    h = x.new_zeros((di, st))
    y = torch.empty_like(xs)
    for c0 in range(0, S, STEPS):
        c1 = min(c0 + STEPS, S)
        decay = torch.exp(dt[c0:c1, :, None] * A)
        inp = (dt[c0:c1] * xs[c0:c1])[:, :, None] * B[c0:c1, None, :]
        hs = torch.empty_like(decay)
        for t in range(c1 - c0):
            h = torch.addcmul(inp[t], decay[t], h, out=hs[t])
        y[c0:c1] = torch.einsum("tdn,tn->td", hs, C[c0:c1])
        del decay, inp, hs
    y = y + p["D"] * xs
    return _mm(y * F.silu(z), p["out_proj"], quant)


def _attention(x, p, mc, quant):
    """Causal GQA over ``x (S, d)``, no positions; a key head's group of
    query heads at a time."""
    S, d = x.shape
    H, KV, hd = mc.n_heads, mc.n_kv_heads, mc.hd
    g = H // KV
    q = _mm(x, p["wq"].reshape(d, -1), quant).reshape(S, KV, g, hd)
    k = _mm(x, p["wk"].reshape(d, -1), quant).reshape(S, KV, hd)
    v = _mm(x, p["wv"].reshape(d, -1), quant).reshape(S, KV, hd)
    pos = torch.arange(S, device=x.device)
    keep = pos[None, :] <= pos[:, None]
    o = torch.empty((S, KV, g, hd), dtype=x.dtype, device=x.device)
    for j in range(KV):
        s_ = torch.einsum("qgd,kd->gqk", q[:, j], k[:, j]) * hd ** -0.5
        s_ = s_.masked_fill(~keep[None], float("-inf"))
        o[:, j] = torch.einsum("gqk,kd->qgd", torch.softmax(s_, -1),
                               v[:, j])
        del s_
    return _mm(o.reshape(S, H * hd), p["wo"].reshape(H * hd, d), quant)


def _moe(f, ex, mc, quant, forced=None, record=None):
    """Top-k of the float32 softmax router, gates not renormalised; each
    expert widened to float32 in turn, over its own tokens.  ``forced``:
    the experts of the first positions (``forward``'s ``routes``)."""
    moe = mc.moe
    logits = f @ ex["router"].to(torch.float32)
    probs = torch.softmax(logits, -1)
    gate, idx = torch.topk(probs, moe.top_k, dim=-1)
    if forced is not None:
        n = forced.shape[0]
        idx = torch.cat([forced.to(idx.device).long(), idx[n:]])
        gate = probs.gather(1, idx)
    if record is not None:
        kth = torch.topk(logits, moe.top_k, dim=-1).values[:, -1]
        record.setdefault("routes", []).append(idx)
        record.setdefault("margin", []).append(
            (kth - logits.gather(1, idx).amin(-1)).clamp(min=0))
    y = torch.zeros_like(f)
    for e in range(moe.num_experts):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            pe = {n: ex[n][e].to(torch.float32)
                  for n in ("w_gate", "w_up", "w_down")}
            y = y.index_add(0, tok, gate[tok, slot, None]
                            * _swiglu(f[tok], pe, quant))
            del pe
    return y


def logits_of(w: dict, mc, tokens: torch.Tensor, quant=None, routes=None,
              record=None):
    """float32 logits ``(S, vocab)`` of one sequence ``tokens (S,)``
    (``routes`` and ``record`` as ``forward``'s).

    ``mc`` gives the sizes: ``n_layers``, ``d_model``, ``n_heads``,
    ``n_kv_heads``, ``hd``, ``norm_eps``, the layer plan
    (``layer_types``, ``moe_at``), ``ssm`` (``expand``, ``dt_rank``,
    ``state_dim``) and ``moe`` (``num_experts``, ``top_k``)."""
    f32 = torch.float32
    dev = w["embed"].device
    tokens = tokens.to(dev).long()
    eps = mc.norm_eps
    h = w["embed"][tokens].to(f32)
    routes = iter(routes) if routes is not None else None
    for li, kind in enumerate(mc.layer_types()):
        lw = _layer(w, mc, li)
        x = _rmsnorm(h, lw["ln1"], eps)
        h = h + (_attention(x, lw["attn"], mc, quant) if kind == "attn"
                 else _mamba(x, lw["ssm"], mc, quant))
        f = _rmsnorm(h, lw["ln2"], eps)
        if "moe" in lw:
            forced = next(routes) if routes is not None else None
            h = h + _moe(f, lw["moe"], mc, quant, forced, record)
        else:
            h = h + _swiglu(f, lw["mlp"], quant)
        del lw
    h = _rmsnorm(h, w["final_norm"].to(f32), eps)
    return _mm(h, w["head"].to(f32), quant)
