"""PIM-backed linear layers: the paper's technique as a framework feature.

The counterpart of ``repro.pim.linear``.  A Compute RAM is a *dual-mode*
block: the same bits serve storage and compute.  The framework analogue:
a linear layer whose weights are *stored* bit-plane packed (int32 plane
words, the storage mode) and *consumed* directly by the bit-serial
matmul kernels (the compute mode) -- no dequantized copy ever exists in
device memory.

Backends (``PimConfig.mode``):

* ``off``      -- ordinary dense matmul in the weights' dtype.
* ``pallas``   -- packed weights unpacked inside the thread block, int8
                  products with int32 accumulation (``quant_matmul``; the
                  mode keeps the reference's name so configs carry over).
* ``popcount`` -- packed weights and activations, AND/popcount bit-serial
                  arithmetic (PIM-faithful path, ``popcount_matmul``).
* ``ref``      -- the plain oracle of the packed path (``kernels.ref``).
* ``fabric``   -- not ported yet: raises ``NotImplementedError``.

Activations are dynamically quantized to int8 per call in packed modes
(standard W4A8/W8A8 serving).  The kernels run where the tensors lie:
CUDA tensors launch the CUDA kernels, CPU tensors their plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

__all__ = ["PimConfig", "linear_init", "pack_linear", "linear_apply",
           "fused_linear_apply", "params_from_numpy"]

_FABRIC_NOT_PORTED = (
    "PimConfig(mode='fabric') is not ported yet: it waits for the execute "
    "side of pim/fabric.py (ROADMAP.md, 'Still to port')")


@dataclasses.dataclass(frozen=True)
class PimConfig:
    mode: str = "off"            # off | ref | pallas | popcount | fabric
    weight_bits: int = 4
    act_bits: int = 8
    # fabric mode only (kept so configs carry over; fabric is not ported)
    fabric: Optional[object] = None
    fabric_autotune: bool = False
    fabric_session: Optional[object] = None

    @property
    def packed(self) -> bool:
        return self.mode != "off"


def linear_init(key: torch.Generator, d_in: int, d_out: int,
                cfg: PimConfig, dtype=torch.bfloat16,
                scale: Optional[float] = None, device=None) -> dict:
    """Init a linear layer's params (dense; pack separately if desired).

    ``key`` is a seeded ``torch.Generator``; the weights are drawn on its
    device in float32 and moved to ``device`` (``None``: the GPU), so one
    CPU generator gives the same weights on every device.
    """
    dev = resolve_device(device)
    std = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=key, dtype=torch.float32,
                    device=key.device) * std
    return {"w": w.to(device=dev, dtype=dtype)}


def pack_linear(params: dict, cfg: PimConfig) -> dict:
    """Convert a dense layer to packed storage (offline weight prep)."""
    w = params["w"].to(torch.float32)
    q, scale = kops.quantize(w, bits=cfg.weight_bits, axis=1)
    packed = kops.pack_bitplanes(q, cfg.weight_bits, axis=0)
    return {"w_packed": packed, "w_scale": scale}


def linear_apply(params: dict, x: torch.Tensor,
                 cfg: PimConfig) -> torch.Tensor:
    """y = x @ W with the configured backend.  x: (..., d_in)."""
    if not cfg.packed:
        return x @ params["w"]
    if cfg.mode == "fabric":
        raise NotImplementedError(_FABRIC_NOT_PORTED)

    orig_shape = x.shape
    xf = x.reshape(-1, orig_shape[-1])
    qx, sx = kops.quantize(xf.to(torch.float32), bits=cfg.act_bits, axis=0)

    wp, ws = params["w_packed"], params["w_scale"]
    if cfg.mode == "ref":
        acc = kref.quant_matmul(qx, wp, ws, bits=cfg.weight_bits)
    elif cfg.mode == "pallas":
        acc = kops.quant_matmul(qx, wp, ws, bits=cfg.weight_bits)
    elif cfg.mode == "popcount":
        ap = kops.pack_bitplanes(qx, cfg.act_bits, axis=1)
        raw = kops.popcount_matmul(ap, wp)
        acc = raw.to(torch.float32) * ws[None, :]
    else:
        raise ValueError(cfg.mode)

    y = acc.to(torch.float32) * sx[:, None]
    return y.reshape(orig_shape[:-1] + (y.shape[-1],)).to(x.dtype)


def fused_linear_apply(params_list, x: torch.Tensor, cfg: PimConfig):
    """Apply several linears sharing the input (the QKV projections).

    Returns a tuple ``(x @ W_0, x @ W_1, ...)``, one per entry of
    ``params_list``: :func:`linear_apply` per layer, as the reference
    does outside ``fabric`` mode.
    """
    if cfg.mode == "fabric":
        raise NotImplementedError(_FABRIC_NOT_PORTED)
    return tuple(linear_apply(p, x, cfg) for p in params_list)


def _tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")               # a writable copy
    if a.dtype == np.uint32:                # packed plane words
        return torch.from_numpy(a.view(np.int32))
    if a.dtype.name == "bfloat16":          # ml_dtypes.bfloat16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, device=None):
    """A JAX linear's params, as numpy arrays, as the port's tensors.

    ``tree`` is ``{"w": bf16|f32}`` or ``{"w_packed": uint32 (bits, K/32,
    N), "w_scale": f32 (N,)}``, or lists, tuples or dicts of these.
    uint32 words become int32 words of the same bits; bfloat16 arrays
    become torch bfloat16 of the same bits.  Placed on ``device``
    (``None``: the GPU).
    """
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v) for v in t)
        return _tensor_from_numpy(np.asarray(t)).to(dev)

    return conv(tree)
