"""Flash attention (online softmax, causal or full): a CUDA kernel beside
its plain PyTorch version.

The counterpart of ``repro.kernels.flash_attention``.  Scores and the
online-softmax state (running max, sum, accumulator) are float32 and
never leave the thread block; both products run on the tensor cores
(``csrc/flash_attention.cu``: bf16 with P split into two bf16 terms,
float32 as 3xTF32).  CUDA inputs
launch the kernel (counted in ``flash_attention_cuda.launches``); CPU
inputs run :func:`flash_attention_torch`, the blockwise loop of the
reference kernel.  :func:`attention_ref` is the naive oracle.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["NEG_INF", "flash_attention", "flash_attention_torch",
           "flash_attention_cuda", "attention_ref", "FLASH_HEAD_DIMS"]

NEG_INF = -1e30

#: head dims the CUDA kernel takes (multiples of its 16-wide MMA steps,
#: accumulator in registers)
FLASH_HEAD_DIMS = (32, 64, 96, 128)

#: keys per block of the plain version's loop (the reference's block_k)
BLOCK_K = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v):
    if q.ndim != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share one (BH, S, hd) shape, got "
            f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"q, k, v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k, v on different devices")


def flash_attention_torch(q, k, v, *, causal: bool = True):
    """Plain version of :func:`flash_attention`, on any device.

    The reference kernel's loop: key blocks of :data:`BLOCK_K` from key 0
    up, scores ``(q @ k^T) * hd**-0.5`` in float32, masked with
    ``NEG_INF``, online softmax, denominator clamped at 1e-30.  Every
    query row is processed at once.
    """
    _check(q, k, v)
    bh, s, hd = q.shape
    scale = hd ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((bh, s, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, s, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, s, hd), dtype=torch.float32, device=q.device)
    rows = torch.arange(s, device=q.device)[:, None]
    for t0 in range(0, s, BLOCK_K):
        kb, vb = kf[:, t0:t0 + BLOCK_K], vf[:, t0:t0 + BLOCK_K]
        sc = (qf @ kb.transpose(1, 2)) * scale
        if causal:
            cols = torch.arange(t0, t0 + kb.shape[1], device=q.device)[None]
            sc = torch.where(cols <= rows, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ vb
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


@functools.cache
def _kernel():
    fn = ctypes.CDLL(str(build.library("flash_attention"))) \
        .flash_attention_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, *, causal: bool = True):
    """CUDA attention: ``q, k, v`` (BH, S, hd) contiguous float32 or
    bfloat16 tensors on one CUDA device, ``hd`` in
    :data:`FLASH_HEAD_DIMS`, any ``S >= 1``; returns (BH, S, hd) in
    ``q.dtype``.  Launches ``csrc/flash_attention.cu`` on the current
    stream (no sync) and counts it in ``flash_attention_cuda.launches``.
    """
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention_cuda takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda needs contiguous q, k, v")
    bh, s, hd = q.shape
    if hd not in FLASH_HEAD_DIMS or s < 1 or not 1 <= bh <= 65535:
        raise ValueError(f"flash_attention_cuda: unsupported (BH, S, hd) = "
                         f"{(bh, s, hd)} (hd in {FLASH_HEAD_DIMS}, S >= 1, "
                         f"1 <= BH <= 65535)")
    # the kernel copies 16-byte chunks (cp.async): a view that starts off
    # that alignment is staged in a fresh tensor
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    fn = _kernel()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, s, hd, _DTYPE_CODE[q.dtype], int(causal), hd ** -0.5,
                 stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention(q, k, v, *, causal: bool = True):
    """q, k, v: (BH, S, hd) -> (BH, S, hd) in ``q.dtype``.  Heads folded
    into the batch dim (callers reshape (B, S, H, hd) -> (B*H, S, hd)).
    CUDA inputs run the kernel, CPU inputs the plain version."""
    _check(q, k, v)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return flash_attention_torch(q, k, v, causal=causal)


def attention_ref(q, k, v, causal: bool = True):
    """Naive oracle."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) \
        * (q.shape[-1] ** -0.5)
    if causal:
        sq, sk = s.shape[-2:]
        mask = torch.tril(torch.ones((sq, sk), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
