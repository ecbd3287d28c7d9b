"""Mixture-of-Experts FFN: sort-based capacity dispatch for training,
dropless grouped experts for prefill and decode.

The counterpart of ``repro.models.moe``.  A training forward
(``mode="train"``) dispatches as the reference does: sort-based (a
stable argsort by expert id + within-expert rank via an exclusive
running count), which avoids the O(T*E*C) one-hot dispatch tensors of
the Switch formulation, into buffers of a fixed capacity that drop the
pairs past it.  The reference's ``vmap`` over dispatch chunks is a loop
over them.

Prefill and decode are dropless: every routed (token, expert) pair is
computed, so a served token does not depend on its batchmates (a
bucket's pad tokens, a decode step's idle lanes).  The routed rows are
sorted by expert and each expert's FFN runs over its own rows:
``torch._grouped_mm`` with the experts' row offsets on the card, a loop
over the experts elsewhere.

DeepSeekMoE's parts (``configs/mla.SharedMoESpec``, DeepSeek-V2 §2.2):
shared experts, one SwiGLU of width ``n_shared * d_ff`` that every token
takes and that is added to the routed sum; gates left as the raw top-k
probabilities when ``norm_topk_prob`` is false; ``routed_scaling_factor``
on the gates.

Order of the sums: the dispatch scatter writes each kept (token, expert)
pair to its own slot and adds exact zeros for dropped ones, so it is
exact in any order.  The combine adds ``top_k`` bf16 contributions per
token; the reference's scatter-add takes them in sorted order (by expert
id), rounding to bf16 after each add.  The port adds them in that same
fixed order instead of through an atomic ``index_add_``, whose order on
the GPU varies run to run, so a token's output does not depend on the
device's scheduling.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import trace
from . import common
from .common import dense_init, mlp_apply, shard, silu
from .qweight import dq


def moe_init(key, cfg, device=None) -> dict:
    spec = cfg.moe
    d, e, f = cfg.d_model, spec.num_experts, spec.d_ff
    ks = common.split_keys(key, 5)
    p = {
        "router": dense_init(ks[0], (d, e), dtype=torch.float32,
                             device=device),
        "w_gate": dense_init(ks[1], (e, d, f), device=device),
        "w_up": dense_init(ks[2], (e, d, f), device=device),
        "w_down": dense_init(ks[3], (e, f, d), in_axis=1, device=device),
    }
    shared = getattr(spec, "n_shared", 0) * f
    if shared:
        p["shared"] = {"w_gate": dense_init(ks[4], (d, shared), device=device),
                       "w_up": dense_init(ks[4], (d, shared), device=device),
                       "w_down": dense_init(ks[4], (shared, d),
                                            device=device)}
    return p


def _capacity(tokens: int, spec) -> int:
    c = int(tokens * spec.top_k * spec.capacity_factor / spec.num_experts)
    return max(spec.top_k, -(-c // 8) * 8)


def _chunks_for(t: int, requested: int) -> int:
    c = max(1, min(requested, t))
    while t % c:
        c -= 1
    return c


def _dispatch(xc, gate_c, eidx_c, e, k, cap):
    """One chunk's sort-based dispatch: the ``(e, cap, d)`` expert buffer
    and what the combine needs to undo it."""
    tc, d = xc.shape
    dev = xc.device
    fe = eidx_c.reshape(-1)                                 # (Tc*k,)
    fg = gate_c.reshape(-1)
    tok = torch.arange(tc, device=dev).repeat_interleave(k)
    order = torch.argsort(fe, stable=True)
    se, stok = fe[order], tok[order]
    # bincount(fe, minlength=e) with a static shape (fe < e), which fake
    # tensors and DTensor can trace
    counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add(
        0, fe, torch.ones_like(fe))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(tc * k, device=dev) - starts[se]
    keep = rank < cap
    slot = se * cap + torch.where(keep, rank, 0)
    # ``new_zeros`` follows ``xc`` (fake in a dry-run, a DTensor on a mesh)
    buf = xc.new_zeros((e * cap, d))
    buf = buf.index_add(0, slot, torch.where(keep[:, None], xc[stok], 0))
    return buf.reshape(e, cap, d), (order, keep, slot, fg)


def _combine(y_c, meta, tc, k, dtype):
    """Each token's ``k`` expert outputs, gate-weighted, summed in sorted
    (expert id) order with a bf16 rounding after each add."""
    order, keep, slot, fg = meta
    e_cap, d = y_c.shape[0] * y_c.shape[1], y_c.shape[2]
    ye = y_c.reshape(e_cap, d)[slot]
    contrib = torch.where(keep[:, None],
                          ye * fg[order][:, None].to(dtype), 0)
    return _sum_by_token(contrib, order, tc, k)


def _sum_by_token(contrib, order, t, k):
    """Each token's ``k`` rows of ``contrib`` (in sorted order: row ``i``
    is the pair ``order[i]`` of the flat ``(token, choice)`` list), summed
    in ascending sorted position with a rounding after each add."""
    # sorted position of each (token, choice) pair; per token, ascending
    # sorted position is the reference's scatter order
    sorted_at = torch.argsort(order)          # order's inverse permutation
    by_token = torch.sort(sorted_at.reshape(t, k), dim=1).values
    out = contrib.new_zeros((t, contrib.shape[1]))
    for j in range(k):
        out = out + contrib[by_token[:, j]]
    return out


def _expert_ffn(params, rows, counts):
    """Each expert's SwiGLU over its rows: ``rows`` (N, d) sorted by
    expert, ``counts`` (E,) rows per expert."""
    wg, wu, wd = (dq(params[n]) for n in ("w_gate", "w_up", "w_down"))
    if rows.is_cuda:
        offs = torch.cumsum(counts, 0).to(torch.int32)
        h = silu(torch._grouped_mm(rows, wg, offs=offs)) \
            * torch._grouped_mm(rows, wu, offs=offs)
        return torch._grouped_mm(h, wd, offs=offs)
    out, start = [], 0
    for i, n in enumerate(counts.tolist()):
        r = rows[start:start + n]
        out.append((silu(r @ wg[i]) * (r @ wu[i])) @ wd[i])
        start += n
    return torch.cat(out)


def _dropless(params, x, gate, eidx, e, layer, decode):
    """Every routed pair of the tokens ``x`` (T, d): the rows sorted by
    expert (stable, so a token's pairs keep their order), each expert's
    FFN over its rows, and the gate-weighted sum per token in that sorted
    order.  Counts the rows per expert on the device (``trace``)."""
    t, k = eidx.shape
    with trace.span("moe.experts"):
        fe = eidx.reshape(-1)
        order = torch.argsort(fe, stable=True)
        tok = torch.arange(t, device=x.device).repeat_interleave(k)
        counts = torch.zeros(e, dtype=torch.int64, device=x.device) \
            .scatter_add(0, fe, torch.ones_like(fe))
        if trace.recording():
            trace.count_device("moe.expert_rows", counts, layer)
            if decode:
                trace.count_device("moe.decode_expert_hits", counts > 0,
                                   layer)
        y = _expert_ffn(params, x[tok[order]], counts)
    with trace.span("moe.combine"):
        contrib = y * gate.reshape(-1)[order][:, None].to(x.dtype)
        return _sum_by_token(contrib, order, t, k)


def moe_apply(params, x, cfg, mode="train", layer=0):
    """x: (B, S, d) -> (B, S, d); load-balance aux loss returned too.

    ``mode`` ``"train"`` dispatches with capacity (the reference's), any
    other mode drops nothing; ``layer`` is the row of the device
    counters."""
    spec = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = spec.num_experts, spec.top_k
    trace.count("moe.calls")
    trace.count("moe.routed_rows", t * k)
    if mode != "train":
        with trace.span("moe.route"):
            xf = x.reshape(t, d)
            logits = xf.to(torch.float32) @ dq(
                params["router"], torch.float32).to(torch.float32)
            gate, eidx = _gates(torch.softmax(logits, dim=-1), spec)
        out = _dropless(params, xf, gate, eidx, e, layer, mode == "decode")
        if "shared" in params:
            with trace.span("moe.shared"):
                out = mlp_apply(params["shared"], xf) + out
        return out.reshape(b, s, d), 0.0
    return _capacity_apply(params, x, cfg)


def _gates(probs, spec):
    """The top-k gates and experts of each token's router probabilities."""
    # descending like lax.top_k; ties may pick another index than the
    # reference (the tests hold dispatch exactly on inputs without ties)
    gate, eidx = torch.topk(probs, spec.top_k, dim=-1)
    if getattr(spec, "norm_topk_prob", True):
        gate = gate / torch.sum(gate, dim=-1, keepdim=True)
    scale = getattr(spec, "routed_scaling_factor", 1.0)
    if scale != 1.0:
        gate = gate * scale
    return gate, eidx


def _capacity_apply(params, x, cfg):
    """The training forward: per-chunk capacity dispatch."""
    spec = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = spec.num_experts, spec.top_k
    X = _chunks_for(t, spec.dispatch_chunks)
    tc = t // X
    cap = _capacity(tc, spec)
    xf = x.reshape(X, tc, d)
    xf = shard(xf, "batch", None, None)

    logits = xf.to(torch.float32) @ dq(params["router"],
                                       torch.float32).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                       # (X, Tc, E)
    gate, eidx = _gates(probs, spec)                            # (X, Tc, k)

    # aux load-balancing loss (Switch-style, over all tokens)
    density = torch.mean(F.one_hot(eidx[..., 0], e).to(torch.float32),
                         dim=(0, 1))
    density_prob = torch.mean(probs, dim=(0, 1))
    aux = e * torch.sum(density * density_prob)

    # ---- per-chunk sort-based dispatch (local capacity) -------------------
    bufs, metas = zip(*(_dispatch(xf[c], gate[c], eidx[c], e, k, cap)
                        for c in range(X)))
    buf = shard(torch.stack(bufs), "batch", "model", None, None)

    # ---- expert FFN --------------------------------------------------------
    h = silu(torch.einsum("xecd,edf->xecf", buf, dq(params["w_gate"]))) \
        * torch.einsum("xecd,edf->xecf", buf, dq(params["w_up"]))
    y = torch.einsum("xecf,efd->xecd", h, dq(params["w_down"]))
    y = shard(y, "batch", "model", None, None)

    # ---- per-chunk combine -------------------------------------------------
    out = torch.stack([_combine(y[c], metas[c], tc, k, x.dtype)
                       for c in range(X)])
    out = shard(out, "batch", None, None)
    if "shared" in params:
        out = mlp_apply(params["shared"], x.reshape(X, tc, d)) + out
    return out.reshape(b, s, d), aux
