"""RG-LRU recurrent block (RecurrentGemma / Griffin).

The counterpart of ``repro.models.rglru``."""

from __future__ import annotations

import torch

from . import common
from .common import dense_init, gelu, shard, sigmoid, softplus
from .qweight import dq
from .recurrence import causal_conv, chunked_linear_scan, linear_scan_step

_C = 8.0   # Griffin's fixed scaling constant in a_t = exp(-c*softplus(L)*r)


def rglru_init(key, cfg, device=None) -> dict:
    d = cfg.d_model
    w = cfg.rglru.lru_width or d
    cw = cfg.rglru.conv_width
    ks = common.split_keys(key, 6)
    return {
        "wx": dense_init(ks[0], (d, w), device=device),
        "wy": dense_init(ks[1], (d, w), device=device),
        "conv_w": dense_init(ks[2], (cw, w), device=device),
        "conv_b": torch.zeros((w,), dtype=torch.bfloat16, device=device),
        "wi": dense_init(ks[3], (w, w), device=device),
        "wr": dense_init(ks[4], (w, w), device=device),
        "lambda_p": torch.full((w,), 1.0, dtype=torch.float32,
                               device=device),
        "out": dense_init(ks[5], (w, d), device=device),
    }


def rglru_apply(params, x, cfg, *, cache=None, chunk: int = 256):
    """x: (B, S, d); cache: {"conv": (B,CW-1,w), "h": (B,w)} or None."""
    xb = x @ dq(params["wx"])
    xb = shard(xb, "batch", None, "model")
    conv_state = cache["conv"] if cache else None
    xb, new_conv = causal_conv(xb, params["conv_w"], params["conv_b"],
                               conv_state)

    i_g = sigmoid(xb @ dq(params["wi"])).to(torch.float32)
    r_g = sigmoid(xb @ dq(params["wr"])).to(torch.float32)
    log_a = -_C * softplus(params["lambda_p"]) * r_g
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) \
        * (i_g * xb.to(torch.float32))

    h0 = cache["h"] if cache else torch.zeros(
        (x.shape[0], xb.shape[-1]), dtype=torch.float32, device=x.device)
    if x.shape[1] == 1:                                  # decode
        h = linear_scan_step(a[:, 0], gated[:, 0], h0)
        hs = h[:, None]
    else:
        hs, h = chunked_linear_scan(a, gated, h0, chunk=chunk)

    y = hs.to(x.dtype) * gelu(x @ dq(params["wy"]))
    out = y @ dq(params["out"])
    out = shard(out, "batch", None, None)
    return out, {"conv": new_conv, "h": h}


def rglru_init_cache(cfg, batch: int, device=None) -> dict:
    w = cfg.rglru.lru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.rglru.conv_width - 1, w),
                            dtype=torch.bfloat16, device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }
