"""Plain torch oracles for the bit-plane GEMM kernels.

The counterpart of ``repro.kernels.ref``.  The bit-plane identity
(paper §II-B, adapted):

    x = -2^{B-1} * b_{B-1} + sum_{i<B-1} 2^i * b_i      (two's complement)
    A @ W = sum_{i,j} coef_i * coef_j * (A_i @ W_j)     (A_i, W_j in {0,1})

so a bit-plane-decomposed matmul is *exactly* the integer matmul.

Packed planes are ``torch.int32`` words (torch's ``uint32`` has no shifts
or adds); bit ``j`` of a word is element ``32w + j`` and bit 31 is the
sign.  Every right shift below is followed by ``& 1``, so the arithmetic
shift of int32 gives the reference's bits.

torch has no integer matmul on CUDA, so the oracles multiply in float64:
every operand and every partial sum here is an integer below 2**53 in
magnitude, so the float64 product is exact in any summation order.
"""

from __future__ import annotations

import torch

__all__ = ["plane_coefs", "pack_bitplanes", "unpack_bitplanes",
           "quant_matmul", "popcount_matmul", "exact_matmul"]

WORD = 32


def plane_coefs(bits: int, signed: bool) -> list:
    """Weight of each bit plane (MSB negative for two's complement)."""
    coefs = [1 << i for i in range(bits)]
    if signed:
        coefs[-1] = -coefs[-1]
    return coefs


def pack_bitplanes(x: torch.Tensor, bits: int, axis: int) -> torch.Tensor:
    """Pack an integer tensor into bit planes along ``axis``.

    Returns int32 words with a new leading plane dimension and ``axis``
    shrunk 32x: plane ``b``, word ``w`` packs bits ``b`` of elements
    ``32w .. 32w+31``.  ``axis`` length must be a multiple of 32.
    """
    k = x.shape[axis]
    if k % WORD:
        raise ValueError(f"pack axis must be multiple of 32, got {k}")
    u = x.to(torch.int32) & ((1 << bits) - 1)        # two's complement view
    u = torch.movedim(u, axis, -1)
    u = u.reshape(u.shape[:-1] + (k // WORD, WORD)).to(torch.int64)
    weights = torch.ones(WORD, dtype=torch.int64, device=x.device) \
        << torch.arange(WORD, dtype=torch.int64, device=x.device)
    planes = []
    for b in range(bits):
        word = torch.sum(((u >> b) & 1) * weights, dim=-1)   # [0, 2^32)
        # wrap to two's complement explicitly: bit 31 becomes the sign
        word = (word - ((word >> 31) << 32)).to(torch.int32)
        planes.append(torch.movedim(word, -1, axis))
    return torch.stack(planes, dim=0)


def unpack_bitplanes(planes: torch.Tensor, axis: int, signed: bool,
                     dtype=torch.int32) -> torch.Tensor:
    """Inverse of :func:`pack_bitplanes` (axis in the *unpacked* tensor)."""
    coefs = plane_coefs(planes.shape[0], signed)
    shifts = torch.arange(WORD, dtype=torch.int32, device=planes.device)
    out = None
    for b, c in enumerate(coefs):
        p = torch.movedim(planes[b], axis, -1)
        # & 1 masks sign fill; DTensor's ``>>`` drops the broadcast
        bitvals = torch.bitwise_right_shift(p[..., :, None], shifts) & 1
        v = bitvals.reshape(p.shape[:-1] + (-1,)).to(dtype) * c
        out = v if out is None else out + v
    return torch.movedim(out, -1, axis)


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer ``a @ b`` as int32, computed exactly in float64 (operands
    and sums below 2**53), on any device."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def quant_matmul(a: torch.Tensor, w_packed: torch.Tensor,
                 scale_w: torch.Tensor, bits: int,
                 out_dtype=torch.float32) -> torch.Tensor:
    """Oracle: C = (A @ unpack(W)) * scale_w, int32 accumulation.

    a: (M, K) int8;  w_packed: (bits, K//32, N) int32 words;
    scale_w: (N,) per-output-channel dequant scale.
    """
    w = unpack_bitplanes(w_packed, axis=0, signed=True)      # (K, N) int32
    acc = exact_matmul(a, w)
    return (acc.to(torch.float32) * scale_w[None, :]).to(out_dtype)


def popcount_matmul(a_packed: torch.Tensor, w_packed: torch.Tensor,
                    a_signed: bool, w_signed: bool) -> torch.Tensor:
    """Oracle for the PIM-faithful popcount path.

    a_packed: (Ba, M, K//32); w_packed: (Bw, K//32, N) -> (M, N) int32.
    """
    ca = plane_coefs(a_packed.shape[0], a_signed)
    cw = plane_coefs(w_packed.shape[0], w_signed)
    shifts = torch.arange(WORD, dtype=torch.int32, device=a_packed.device)

    def bits_of(p):   # (..., W) int32 -> (..., W*32) int32 in {0,1}
        b = (p[..., None] >> shifts) & 1
        return b.reshape(p.shape[:-1] + (-1,))

    out = 0
    for i, ci in enumerate(ca):
        ai = bits_of(a_packed[i])                            # (M, K)
        for j, cj in enumerate(cw):
            wj = bits_of(torch.movedim(w_packed[j], 0, -1))  # (N, K)
            out = out + ci * cj * exact_matmul(ai, wj.T)
    return out
