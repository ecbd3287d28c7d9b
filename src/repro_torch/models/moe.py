"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The counterpart of ``repro.models.moe``.  Dispatch is sort-based (a
stable argsort by expert id + within-expert rank via an exclusive
running count), which avoids the O(T*E*C) one-hot dispatch tensors of
the Switch formulation.  The reference's ``vmap`` over dispatch chunks
is a loop over them.

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

from . import common
from .common import dense_init, shard, silu
from .qweight import dq


def moe_init(key, cfg, device=None) -> dict:
    spec = cfg.moe
    d, e, f = cfg.d_model, spec.num_experts, spec.d_ff
    ks = common.split_keys(key, 4)
    return {
        "router": dense_init(ks[0], (d, e), dtype=torch.float32,
                             device=device),
        "w_gate": dense_init(ks[1], (e, d, f), device=device),
        "w_up": dense_init(ks[2], (e, d, f), device=device),
        "w_down": dense_init(ks[3], (e, f, d), in_axis=1, device=device),
    }


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
    # sorted position of each (token, choice) pair; per token, ascending
    # sorted position is the reference's scatter order
    sorted_at = torch.argsort(order)          # order's inverse permutation
    by_token = torch.sort(sorted_at.reshape(tc, k), dim=1).values
    out = y_c.new_zeros((tc, d), dtype=dtype)
    for j in range(k):
        out = out + contrib[by_token[:, j]]
    return out


def moe_apply(params, x, cfg):
    """x: (B, S, d) -> (B, S, d); load-balance aux loss returned too."""
    spec = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = spec.num_experts, spec.top_k
    X = _chunks_for(t, spec.dispatch_chunks)
    tc = t // X
    cap = _capacity(tc, spec)
    xf = x.reshape(X, tc, d)
    xf = shard(xf, "batch", None, None)

    logits = xf.to(torch.float32) @ dq(params["router"], torch.float32)
    probs = torch.softmax(logits, dim=-1)                       # (X, Tc, E)
    # descending like lax.top_k; ties may pick another index than the
    # reference (the tests hold dispatch exactly on inputs without ties)
    gate, eidx = torch.topk(probs, k, dim=-1)                   # (X, Tc, k)
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)

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
    return out.reshape(b, s, d), aux
