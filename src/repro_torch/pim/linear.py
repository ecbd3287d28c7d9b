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
* ``fabric``   -- the whole GEMM scheduled across a simulated Compute RAM
                  block grid (``repro_torch.pim.fabric``): storage/compute
                  mode allocation, per-round block launches on ``x``'s
                  device, exact integer arithmetic on the cycle-accurate
                  simulator.  Operands are packed on the host.

Activations are dynamically quantized to int8 per call in packed modes
(standard W4A8/W8A8 serving).  The kernels run where the tensors lie:
CUDA tensors launch the CUDA kernels, CPU tensors their plain versions.

``fused_linear_apply`` applies several linears sharing one input (the
QKV projections); in ``fabric`` mode they run as ONE multi-GEMM
``FabricProgram`` with shared activation residency.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core.engine import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

__all__ = ["PimConfig", "linear_init", "pack_linear", "linear_apply",
           "fused_linear_apply", "params_from_numpy"]

@dataclasses.dataclass(frozen=True)
class PimConfig:
    mode: str = "off"            # off | ref | pallas | popcount | fabric
    weight_bits: int = 4
    act_bits: int = 8
    # fabric mode only: the block grid to schedule onto (a
    # repro_torch.pim.fabric.FabricConfig; None = that module's default)
    fabric: Optional[object] = None
    # fabric mode only: pick the grid split per GEMM shape with
    # repro_torch.pim.fabric.search_program (costmodel argmin), on the
    # grid's own block geometry so tuning compiles no extra program.
    fabric_autotune: bool = False
    # fabric mode only: a repro_torch.pim.fabric.FabricSession carrying
    # warm resident-tile state across sequential fused_linear_apply calls
    # (compares and hashes by identity, so the config stays frozen).
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
        # one pipeline for single and fused fabric GEMMs: the fused path
        # with a single weight IS the single-GEMM schedule
        return fused_linear_apply((params,), x, cfg)[0]

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
    ``params_list``.  In ``fabric`` mode the projections are fused into
    ONE :class:`repro_torch.pim.fabric.FabricProgram`: one grid
    allocation, shared activation residency, batched wide-block
    launches on ``x``'s device.  Bit-identical to calling
    :func:`linear_apply` per layer -- the activation quantization is per
    call and deterministic, so the fused path shares it exactly.  Other
    modes simply loop :func:`linear_apply`.
    """
    params_list = list(params_list)
    if cfg.mode != "fabric":
        return tuple(linear_apply(p, x, cfg) for p in params_list)

    from repro_torch.pim import fabric as fabric_mod

    with trace.span("pim.fused_linear"):
        orig_shape = x.shape
        with trace.span("pim.quantize"):
            xf = x.reshape(-1, orig_shape[-1])
            qx, sx = kops.quantize(xf.to(torch.float32), bits=cfg.act_bits,
                                   axis=0)
            qx_host = qx.cpu().numpy().astype(np.int64)
        with trace.span("pim.unpack_weights"):
            qws = [kref.unpack_bitplanes(p["w_packed"], axis=0, signed=True)
                   for p in params_list]
            qws_host = [qw.cpu().numpy().astype(np.int64) for qw in qws]
        fcfg = cfg.fabric if cfg.fabric is not None \
            else fabric_mod.FabricConfig()
        nbits = max(cfg.act_bits, cfg.weight_bits)
        prog = None
        if cfg.fabric_autotune:
            specs = tuple(fabric_mod.GemmSpec(f"proj{g}", qx.shape[0],
                                              qx.shape[1], qw.shape[1])
                          for g, qw in enumerate(qws))
            with trace.span("fabric.schedule"):
                prog = fabric_mod.search_program(
                    specs, nbits, base=fcfg, signed=True,
                    geometries=((fcfg.rows, fcfg.cols),)).schedule
        res = fabric_mod.fabric_fused_matmul(
            qx_host, qws_host, nbits=nbits, cfg=fcfg, signed=True,
            program=prog,
            names=tuple(f"proj{g}" for g in range(len(qws))),
            session=cfg.fabric_session, device=x.device)
        outs = []
        with trace.span("pim.dequant"):
            for raw, p in zip(res.outs, params_list):
                acc = torch.from_numpy(raw.astype(np.float32)).to(x.device) \
                    * p["w_scale"][None, :]
                y = acc * sx[:, None]
                outs.append(
                    y.reshape(orig_shape[:-1] + (y.shape[-1],)).to(x.dtype))
        return tuple(outs)


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
