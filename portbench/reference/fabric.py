"""Plain reference of a W{w}A{a} linear on the Compute RAM fabric.

The fabric computes the product of symmetric integer codes exactly (an
integer accumulator wide enough for any K) and rescales it in float32:

    q_x, s_x = quantize(x, a bits, one scale per row)
    q_w, s_w = quantize(w, w bits, one scale per output column)
    y        = bf16((f32(q_x @ q_w) * s_w[None, :]) * s_x[:, None])

``quantize`` takes ``max(|v|) * f32(1 / qmax)`` as the scale (a multiply
by the float32 reciprocal, as the quantizer the fabric is fed computes
it) and rounds ``v / scale`` half to even, clamped to ``[-qmax - 1,
qmax]``.  The product is numpy's int64 matmul.  Every step is IEEE
float32 or exact, so the reference gives the bit pattern the fabric must
give, and any difference is a fault.
"""

from __future__ import annotations

import numpy as np
import torch


def quantize(v: torch.Tensor, bits: int, axis: int):
    """(int64 codes, float32 scales) of a float32 ``v``, one scale per
    slice along ``axis`` (2-D ``v``)."""
    qmax = (1 << (bits - 1)) - 1
    amax = torch.amax(torch.abs(v), dim=1 - axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) * torch.tensor(
        1 / qmax, dtype=torch.float32)
    q = torch.clamp(torch.round(v / scale), -qmax - 1, qmax)
    return q.to(torch.int64), scale.reshape(-1)


def linear(x: torch.Tensor, w: torch.Tensor, weight_bits: int,
           act_bits: int) -> torch.Tensor:
    """The W/A-bit linear of bf16 ``x (M, K)`` and ``w (K, N)``, on the
    host: bf16 ``(M, N)``."""
    x = x.detach().to("cpu", torch.float32)
    w = w.detach().to("cpu", torch.float32)
    qx, sx = quantize(x, act_bits, axis=0)
    qw, sw = quantize(w, weight_bits, axis=1)
    acc = torch.from_numpy(qx.numpy() @ qw.numpy())
    y = (acc.to(torch.float32) * sw[None, :]) * sx[:, None]
    return y.to(torch.bfloat16)


def control(x: torch.Tensor, w: torch.Tensor, weight_bits: int,
            act_bits: int) -> torch.Tensor:
    """The reference in the nearest precision below the stated one, run
    on ``x``'s device: with 8-bit activations, the activations in 4 bits
    (int4 for int8); with 4-bit activations, whose codes have nothing
    below them, the product of the dequantized codes as a bf16 GEMM (a
    bf16 product for the exact integer one)."""
    dev = x.device
    xf = x.detach().to("cpu", torch.float32)
    wf = w.detach().to("cpu", torch.float32)
    if act_bits > 4:
        return linear(x, w, weight_bits, 4).to(dev)
    qx, sx = quantize(xf, act_bits, axis=0)
    qw, sw = quantize(wf, weight_bits, axis=1)
    a = (qx.to(torch.float32) * sx[:, None]).to(dev, torch.bfloat16)
    b = (qw.to(torch.float32) * sw[None, :]).to(dev, torch.bfloat16)
    return a @ b


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements whose bf16 bit patterns differ (a shape mismatch counts
    every element)."""
    got = got.detach().to("cpu")
    want = want.detach().to("cpu")
    if got.shape != want.shape or got.dtype != want.dtype:
        return int(np.prod(want.shape))
    return int((got.view(torch.int16) != want.view(torch.int16)).sum())
