"""Public API over the hand-written kernels.

The counterpart of ``repro.kernels.ops``.  The reference chooses Pallas
interpret mode off the TPU; here the device of the inputs chooses:
CUDA tensors launch the CUDA kernel, CPU tensors run its plain PyTorch
version.  The Pallas-only arguments (``interpret=``, the block sizes)
are not carried over: each kernel picks its own tiling.
"""

from __future__ import annotations

import torch

from . import ref as kref
from .bitserial_matmul import popcount_matmul, quant_matmul  # noqa: F401

pack_bitplanes = kref.pack_bitplanes
unpack_bitplanes = kref.unpack_bitplanes
plane_coefs = kref.plane_coefs

__all__ = ["quant_matmul", "popcount_matmul", "quantize", "pack_bitplanes",
           "unpack_bitplanes", "plane_coefs"]


def quantize(x: torch.Tensor, *, bits: int, axis: int = 0):
    """Symmetric per-channel quantization to signed ``bits`` integers.

    Returns (q int8, scale f32) with ``x ~= q * scale`` and one scale per
    slice of ``axis`` (the max magnitude over the other axes).
    """
    reduce_axes = tuple(i for i in range(x.ndim) if i != axis)
    amax = torch.amax(torch.abs(x), dim=reduce_axes, keepdim=True)
    qmax = (1 << (bits - 1)) - 1
    # The reference's ``max(amax, 1e-8) / qmax`` is lowered by XLA as a
    # multiply by the float32 reciprocal of the constant; a true division
    # differs from it by one ulp in some rows, so multiply the same way.
    scale = torch.clamp(amax, min=1e-8) * torch.tensor(
        1 / qmax, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax).to(torch.int8)
    return q, scale.reshape(x.shape[axis]).to(torch.float32)
