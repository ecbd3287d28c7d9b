"""Bit-plane-decomposed ("bit-serial") matmul: two CUDA kernels, each
beside its plain PyTorch version.

The counterpart of ``repro.kernels.bitserial_matmul``.  Operands stay
**bit-plane packed** in device memory (the Compute RAM "storage mode")
and are consumed packed (the "compute mode"):

* :func:`quant_matmul` -- the performance path.  Packed int32 weight
  planes are expanded to int8 in registers, as the A operand of the int8
  tensor cores (``wgmma``), and multiplied by int8 activations with int32
  accumulation, then scaled per output channel
  (``csrc/quant_matmul.cu``).
* :func:`popcount_matmul` -- the PIM-faithful path.  Both operands stay
  as bit planes and partial products are ``popcount(AND)`` per plane
  pair with power-of-two recombination.  The kernel computes the same
  integer sum on the int8 tensor cores: it unpacks both operands' planes
  to 8-bit values inside the thread block (``csrc/popcount_matmul.cu``).

Both dispatch on the device of their inputs: CUDA tensors launch the
kernel (counted in ``<kernel>_cuda.launches``), CPU tensors run the
plain version.  Each kernel picks its own tiling; a shape it does not
take raises, it never computes on another path.  Both are exact: the
kernels and the plain versions are bit-identical to ``ref``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import WORD, plane_coefs

__all__ = [
    "quant_matmul", "quant_matmul_torch", "quant_matmul_cuda",
    "popcount_matmul", "popcount_matmul_torch", "popcount_matmul_cuda",
    "popcount32", "MAX_PLANES",
]

#: most bit planes per operand the kernels take; must equal
#: QM_MAX_BITS / PC_MAX_PLANES in csrc/.
MAX_PLANES = 8

#: K elements per exact float32 partial product of the plain
#: quant_matmul: 512 * 128 * 128 = 2**23 < 2**24, so every partial sum
#: of int8 x (<= 8-bit) products is an integer float32 holds exactly.
_QM_CHUNK_K = 512


def _device_of(*xs) -> torch.device:
    devs = {x.device for x in xs}
    if len(devs) != 1:
        raise ValueError(
            f"inputs on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_quant(a, w_packed, scale_w, bits):
    if a.dtype != torch.int8 or a.ndim != 2:
        raise TypeError(
            f"a must be (M, K) int8, got {a.dtype} {tuple(a.shape)}")
    if w_packed.dtype != torch.int32 or w_packed.ndim != 3:
        raise TypeError(f"w_packed must be (bits, K/32, N) int32 words, got "
                        f"{w_packed.dtype} {tuple(w_packed.shape)}")
    m, k = a.shape
    n = w_packed.shape[-1]
    if not 1 <= bits <= MAX_PLANES:
        raise ValueError(f"bits must be in 1..{MAX_PLANES}, got {bits}")
    if k % WORD or k == 0 or m == 0 or n == 0:
        raise ValueError(f"need M, N >= 1 and K a positive multiple of 32, "
                         f"got M={m} K={k} N={n}")
    if tuple(w_packed.shape) != (bits, k // WORD, n):
        raise ValueError(f"w_packed shape {tuple(w_packed.shape)} != "
                         f"{(bits, k // WORD, n)}")
    if tuple(scale_w.shape) != (n,) or scale_w.dtype != torch.float32:
        raise ValueError(f"scale_w must be ({n},) float32, got "
                         f"{scale_w.dtype} {tuple(scale_w.shape)}")
    return m, k, n


def _check_popcount(a_packed, w_packed):
    for name, t in (("a_packed", a_packed), ("w_packed", w_packed)):
        if t.dtype != torch.int32 or t.ndim != 3:
            raise TypeError(f"{name} must be 3-D int32 words, got "
                            f"{t.dtype} {tuple(t.shape)}")
    ba, m, kw = a_packed.shape
    bw, kw2, n = w_packed.shape
    if kw != kw2:
        raise ValueError(f"K words differ: {kw} != {kw2}")
    if not (1 <= ba <= MAX_PLANES and 1 <= bw <= MAX_PLANES):
        raise ValueError(f"planes must be in 1..{MAX_PLANES}, got "
                         f"Ba={ba} Bw={bw}")
    if m == 0 or n == 0 or kw == 0:
        raise ValueError(f"need M, N, K/32 >= 1, got M={m} K/32={kw} N={n}")
    return ba, bw, m, kw, n


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------
def quant_matmul_torch(a, w_packed, scale_w, *, bits: int,
                       out_dtype=torch.float32):
    """Plain version of :func:`quant_matmul`, on any device.

    Mirrors the kernel: walk K, unpack each chunk of weight planes as
    ``sum_b coef_b * bit`` (MSB negative), accumulate the chunk's
    products in int32, scale once at the end.  torch has no integer
    matmul on CUDA, so a chunk's product is taken in float32, where it
    is exact (see ``_QM_CHUNK_K``).
    """
    m, k, n = _check_quant(a, w_packed, scale_w, bits)
    coefs = plane_coefs(bits, signed=True)
    shifts = torch.arange(WORD, dtype=torch.int32, device=a.device)
    acc = torch.zeros((m, n), dtype=torch.int32, device=a.device)
    step = _QM_CHUNK_K // WORD
    for c0 in range(0, k // WORD, step):
        wp = w_packed[:, c0:c0 + step, :]                   # (bits, cw, N)
        cw = wp.shape[1]
        w = torch.zeros((cw * WORD, n), dtype=torch.int32, device=a.device)
        for b, c in enumerate(coefs):
            # & 1 masks the sign fill of int32's arithmetic shift
            bitv = (wp[b][:, None, :] >> shifts[None, :, None]) & 1
            w += c * bitv.reshape(cw * WORD, n)
        ac = a[:, c0 * WORD:(c0 + cw) * WORD]
        acc += (ac.to(torch.float32) @ w.to(torch.float32)).to(torch.int32)
    return (acc.to(torch.float32) * scale_w[None, :]).to(out_dtype)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each int32 word (as its uint32 pattern), SWAR.

    Counts bit 31 apart so that every step runs on non-negative values:
    no step overflows int32, and the arithmetic right shift equals the
    logical one.
    """
    top = (x < 0).to(torch.int32)
    x = x & 0x7FFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = (x + (x >> 16)) & 0x3F
    return x + top


def popcount_matmul_torch(a_packed, w_packed, *, a_signed: bool = True,
                          w_signed: bool = True):
    """Plain version of :func:`popcount_matmul`, on any device.

    Mirrors the kernel: for each K word, ``popcount(a_i & w_j)`` over all
    plane pairs, accumulated in int32 with coefficient ``c_i * c_j``.
    Works through K in chunks so the ``(M, chunk, N)`` AND stays small.
    """
    ba, bw, m, kw, n = _check_popcount(a_packed, w_packed)
    ca = plane_coefs(ba, a_signed)
    cw = plane_coefs(bw, w_signed)
    acc = torch.zeros((m, n), dtype=torch.int32, device=a_packed.device)
    step = max(1, (1 << 22) // (m * n))
    for c0 in range(0, kw, step):
        for i, ci in enumerate(ca):
            ai = a_packed[i, :, c0:c0 + step]                # (M, s)
            for j, cj in enumerate(cw):
                wj = w_packed[j, c0:c0 + step, :]            # (s, N)
                pc = popcount32(ai[:, :, None] & wj[None, :, :])
                acc += (ci * cj) * pc.sum(dim=1, dtype=torch.int32)
    return acc


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
@functools.cache
def _quant_kernel():
    fn = ctypes.CDLL(str(build.library("quant_matmul"))).quant_matmul_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _popcount_kernel():
    fn = ctypes.CDLL(str(build.library("popcount_matmul"))) \
        .popcount_matmul_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(name, *xs):
    for x in xs:
        if x.device.type != "cuda":
            raise ValueError(f"{name} needs CUDA tensors, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors, got shape "
                             f"{tuple(x.shape)} strides {x.stride()}")
    _device_of(*xs)


def quant_matmul_cuda(a, w_packed, scale_w, *, bits: int):
    """CUDA ``(M, N)`` float32 ``(a @ unpack(w_packed)) * scale_w``.

    ``a`` (M, K) int8, ``w_packed`` (bits, K/32, N) int32 words,
    ``scale_w`` (N,) float32, all contiguous on one CUDA device;
    ``1 <= bits <= 8``; ``a`` starts on a 16-byte boundary (the kernel
    copies its rows 16 bytes at a time).  Launches
    ``csrc/quant_matmul.cu`` on the current stream (no sync) and counts
    it in ``quant_matmul_cuda.launches``.
    """
    m, k, n = _check_quant(a, w_packed, scale_w, bits)
    _check_cuda("quant_matmul_cuda", a, w_packed, scale_w)
    if a.data_ptr() % 16:
        raise ValueError("quant_matmul_cuda needs a 16-byte aligned a")
    fn = _quant_kernel()
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), w_packed.data_ptr(), scale_w.data_ptr(),
                 out.data_ptr(), m, k, n, bits, stream)
    if err != 0:
        raise RuntimeError(
            f"quant_matmul kernel launch failed: CUDA error {err}")
    quant_matmul_cuda.launches += 1
    return out


quant_matmul_cuda.launches = 0


def popcount_matmul_cuda(a_packed, w_packed, *, a_signed: bool = True,
                         w_signed: bool = True):
    """CUDA ``(M, N)`` int32 ``sum_ij c_i c_j popcount(A_i & W_j)``.

    ``a_packed`` (Ba, M, K/32) and ``w_packed`` (Bw, K/32, N) int32
    words, contiguous on one CUDA device, ``1 <= Ba, Bw <= 8``.
    Launches ``csrc/popcount_matmul.cu`` on the current stream (no
    sync) and counts it in ``popcount_matmul_cuda.launches``.
    """
    ba, bw, m, kw, n = _check_popcount(a_packed, w_packed)
    _check_cuda("popcount_matmul_cuda", a_packed, w_packed)
    fn = _popcount_kernel()
    out = torch.empty((m, n), dtype=torch.int32, device=a_packed.device)
    with torch.cuda.device(a_packed.device):
        stream = torch.cuda.current_stream(a_packed.device).cuda_stream
        err = fn(a_packed.data_ptr(), w_packed.data_ptr(), out.data_ptr(),
                 ba, bw, m, kw, n, int(a_signed), int(w_signed), stream)
    if err != 0:
        raise RuntimeError(
            f"popcount_matmul kernel launch failed: CUDA error {err}")
    popcount_matmul_cuda.launches += 1
    return out


popcount_matmul_cuda.launches = 0


# ---------------------------------------------------------------------------
# Dispatch by the device of the inputs
# ---------------------------------------------------------------------------
def quant_matmul(a, w_packed, scale_w, *, bits: int,
                 out_dtype=torch.float32):
    """C = (A @ unpack(W_packed)) * scale_w, exact int32 accumulation.

    a: (M, K) int8;  w_packed: (bits, K//32, N) int32;  scale_w: (N,)
    f32.  CUDA inputs run the kernel, CPU inputs the plain version.
    """
    if _device_of(a, w_packed, scale_w).type == "cuda":
        out = quant_matmul_cuda(a, w_packed, scale_w, bits=bits)
        return out if out_dtype == torch.float32 else out.to(out_dtype)
    return quant_matmul_torch(a, w_packed, scale_w, bits=bits,
                              out_dtype=out_dtype)


def popcount_matmul(a_packed, w_packed, *, a_signed: bool = True,
                    w_signed: bool = True):
    """(M, N) int32 = bit-serial matmul of packed planes (exact).

    a_packed: (Ba, M, K//32) int32;  w_packed: (Bw, K//32, N) int32.
    CUDA inputs run the kernel, CPU inputs the plain version.
    """
    if _device_of(a_packed, w_packed).type == "cuda":
        return popcount_matmul_cuda(a_packed, w_packed, a_signed=a_signed,
                                    w_signed=w_signed)
    return popcount_matmul_torch(a_packed, w_packed, a_signed=a_signed,
                                 w_signed=w_signed)
