"""Mamba-1 selective SSM block (falcon-mamba style, attention-free).

The counterpart of ``repro.models.ssm``."""

from __future__ import annotations

import torch

from . import common
from .common import dense_init, shard, silu, softplus
from .qweight import dq
from .recurrence import causal_conv, chunked_linear_scan, linear_scan_step


def _dims(cfg):
    di = cfg.ssm.expand * cfg.d_model
    dtr = cfg.ssm.dt_rank or -(-cfg.d_model // 16)
    return di, dtr, cfg.ssm.state_dim


def ssm_init(key, cfg, device=None) -> dict:
    d = cfg.d_model
    di, dtr, st = _dims(cfg)
    cw = cfg.ssm.conv_width
    ks = common.split_keys(key, 6)
    f32 = dict(dtype=torch.float32, device=device)
    return {
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


def _ssm_inner(params, xi, dt_r, Bm, Cm, h0, chunk):
    """Selective-SSM recurrence.  xi: (B,S,di) post-conv/silu."""
    # the reference's f32 @ bf16 promotes the raw bf16 leaf to f32
    dt = softplus(dt_r.to(torch.float32)
                  @ dq(params["dt_w"], torch.float32).to(torch.float32)
                  + params["dt_b"])                              # (B,S,di)
    A = -torch.exp(params["A_log"])                              # (di,st)
    decay = torch.exp(dt[..., None] * A)                         # (B,S,di,st)
    bx = (dt * xi.to(torch.float32))[..., None] * Bm[:, :, None, :]
    if xi.shape[1] == 1:                                         # decode
        h = linear_scan_step(decay[:, 0], bx[:, 0], h0)
        hs = h[:, None]
    else:
        hs, h = chunked_linear_scan(decay, bx, h0, chunk=chunk)
    y = torch.einsum("bsdn,bsn->bsd", hs, Cm)                    # (B,S,di)
    y = y + params["D"] * xi.to(torch.float32)
    return y, h


def ssm_apply(params, x, cfg, *, cache=None, chunk: int = 256):
    """x: (B, S, d).  cache: {"conv": (B,CW-1,di), "h": (B,di,st)} or None."""
    di, dtr, st = _dims(cfg)
    u = x @ dq(params["in_proj"])
    xi, z = torch.chunk(u, 2, dim=-1)
    xi = shard(xi, "batch", None, "model")
    conv_state = cache["conv"] if cache else None
    xi, new_conv = causal_conv(xi, params["conv_w"], params["conv_b"],
                               conv_state)
    xi = silu(xi)

    dbc = xi @ dq(params["x_proj"])
    dt_r = dbc[..., :dtr]
    Bm = dbc[..., dtr:dtr + st].to(torch.float32)
    Cm = dbc[..., dtr + st:].to(torch.float32)

    h0 = cache["h"] if cache else torch.zeros(
        (x.shape[0], di, st), dtype=torch.float32, device=x.device)
    y, h = _ssm_inner(params, xi, dt_r, Bm, Cm, h0, chunk)

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
