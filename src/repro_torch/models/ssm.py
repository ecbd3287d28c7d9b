"""Mamba-1 selective SSM block (falcon-mamba style, attention-free).

The counterpart of ``repro.models.ssm``.  A spec with ``inner_norms``
(Jamba's, ``configs/jamba.JambaSSMSpec``) applies RMSNorms with gains to
the time step's low-rank input and to B and C, between ``x_proj`` and
``dt_proj``, as Jamba's mixer does.

The scan streams: the discretized ``exp(dt A)`` and ``dt B x`` and the
read-out through C are formed one time chunk at a time
(``recurrence.streamed_linear_scan``), so no ``(B, S, d_inner,
d_state)`` tensor exists and any length is taken (the last chunk
ragged).  At lengths that are multiples of the chunk the results are
those of forming them over the whole sequence, bit for bit."""

from __future__ import annotations

import torch

from .. import trace
from . import common
from .common import dense_init, rmsnorm, shard, silu, softplus
from .qweight import dq
from .recurrence import causal_conv, linear_scan_step, streamed_linear_scan


def _dims(cfg):
    di = cfg.ssm.expand * cfg.d_model
    dtr = cfg.ssm.dt_rank or -(-cfg.d_model // 16)
    return di, dtr, cfg.ssm.state_dim


def _inner_norms(cfg) -> bool:
    return getattr(cfg.ssm, "inner_norms", False)


def ssm_init(key, cfg, device=None) -> dict:
    d = cfg.d_model
    di, dtr, st = _dims(cfg)
    cw = cfg.ssm.conv_width
    ks = common.split_keys(key, 6)
    f32 = dict(dtype=torch.float32, device=device)
    p = {
        "in_proj": dense_init(ks[0], (d, 2 * di), device=device),
        "conv_w": dense_init(ks[1], (cw, di), device=device),
        "conv_b": torch.zeros((di,), dtype=torch.bfloat16, device=device),
        "x_proj": dense_init(ks[2], (di, dtr + 2 * st), device=device),
        "dt_w": dense_init(ks[3], (dtr, di), device=device),
        "dt_b": torch.full((di,), -4.6, **f32),     # softplus^-1(0.01)
        "A_log": torch.log(torch.arange(1, st + 1, **f32)[None, :]
                           .repeat(di, 1)),
        "D": torch.ones((di,), **f32),
        "out_proj": dense_init(ks[4], (di, d), device=device),
    }
    if _inner_norms(cfg):
        p.update(dt_norm=torch.zeros((dtr,), **f32),
                 b_norm=torch.zeros((st,), **f32),
                 c_norm=torch.zeros((st,), **f32))
    return p


def _ssm_inner(params, xi, dt_r, Bm, Cm, h0, chunk):
    """Selective-SSM recurrence.  xi: (B,S,di) post-conv/silu."""
    # the reference's f32 @ bf16 promotes the raw bf16 leaf to f32
    dt = softplus(dt_r.to(torch.float32)
                  @ dq(params["dt_w"], torch.float32).to(torch.float32)
                  + params["dt_b"])                              # (B,S,di)
    A = -torch.exp(params["A_log"])                              # (di,st)
    xf = xi.to(torch.float32)

    def parts(c0, c1):
        """The chunk's decay and input, each (B, c1 - c0, di, st)."""
        d = dt[:, c0:c1]
        return (torch.exp(d[..., None] * A),
                (d * xf[:, c0:c1])[..., None] * Bm[:, c0:c1, None, :])

    def read(c0, c1, hc):
        return torch.einsum("bsdn,bsn->bsd", hc, Cm[:, c0:c1])

    S = xi.shape[1]
    if S == 1:                                                   # decode
        decay, bx = parts(0, 1)
        h = linear_scan_step(decay[:, 0], bx[:, 0], h0)
        y = read(0, 1, h[:, None])
    else:
        chunk = min(chunk, S)
        trace.count("ssm.prefill_tokens", xi.shape[0] * S)
        trace.count("ssm.scan_chunks", -(-S // chunk))
        y, h = streamed_linear_scan(parts, h0, S, chunk, emit=read)
    y = y + params["D"] * xf                                     # (B,S,di)
    return y, h


def ssm_apply(params, x, cfg, *, cache=None, chunk: int = 256):
    """x: (B, S, d).  cache: {"conv": (B,CW-1,di), "h": (B,di,st)} or None.

    Spans ``ssm.conv`` (the causal depthwise conv and its SiLU) and
    ``ssm.scan`` (time step, discretization, scan, read-out through C and
    the skip through D); counters ``ssm.prefill_tokens`` (B x S of a
    call over more than one token) and ``ssm.scan_chunks`` (its
    chunks)."""
    di, dtr, st = _dims(cfg)
    u = x @ dq(params["in_proj"])
    xi, z = torch.chunk(u, 2, dim=-1)
    xi = shard(xi, "batch", None, "model")
    conv_state = cache["conv"] if cache else None
    with trace.span("ssm.conv"):
        xi, new_conv = causal_conv(xi, params["conv_w"], params["conv_b"],
                                   conv_state)
        xi = silu(xi)

    # DTensor (torch 2.11) cannot feed this product's model-split sum to
    # the dt matmul: it is reduced here (an all-reduce on "model")
    dbc = shard(xi @ dq(params["x_proj"]), "batch", None, None)
    dt_r = dbc[..., :dtr]
    Bm = dbc[..., dtr:dtr + st]
    Cm = dbc[..., dtr + st:]
    if _inner_norms(cfg):
        dt_r = rmsnorm(dt_r, params["dt_norm"], cfg.norm_eps)
        Bm = rmsnorm(Bm, params["b_norm"], cfg.norm_eps)
        Cm = rmsnorm(Cm, params["c_norm"], cfg.norm_eps)

    h0 = cache["h"] if cache else torch.zeros(
        (x.shape[0], di, st), dtype=torch.float32, device=x.device)
    with trace.span("ssm.scan"):
        y, h = _ssm_inner(params, xi, dt_r, Bm.to(torch.float32),
                          Cm.to(torch.float32), h0, chunk)

    out = (y.to(x.dtype) * silu(z)) @ dq(params["out_proj"])
    out = shard(out, "batch", None, None)
    new_cache = {"conv": new_conv, "h": h}
    return out, new_cache


def ssm_init_cache(cfg, batch: int, device=None) -> dict:
    di, dtr, st = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm.conv_width - 1, di),
                            dtype=torch.bfloat16, device=device),
        "h": torch.zeros((batch, di, st), dtype=torch.float32,
                         device=device),
    }
