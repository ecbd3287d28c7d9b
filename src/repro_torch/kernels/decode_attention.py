"""GQA / MQA decode attention over a bf16 ring-buffer KV cache.

One query a lane and head against its lane's cache, as
``models/attention.py``'s ``_attend_cache`` computes it on the cache
widened to float32 and repeated to one row per query head, from:

* ``q`` ``(B, H, hd)`` float32 or bf16: the rotated query, not yet
  scaled;
* ``k``, ``v`` ``(B, cap, KV, hd)`` bf16: the cache as it is, query head
  ``h`` reading KV head ``h // (H // KV)``;
* ``pos`` ``(B, cap)`` int32: each slot's position, -1 for an empty slot;
* ``cur`` ``(B,)`` int32: each lane's current position.

Slot ``t`` of lane ``b`` is valid when ``0 <= pos[b, t] <= cur[b]`` and,
with a ``window``, ``pos[b, t] > cur[b] - window``.  Scores are
``(q * scale) . k`` in float32, the softmax and the ``P . V`` sum too;
the result is ``(B, H, hd)`` float32.

The work is split over the cache in chunks of :data:`CHUNK` slots
(flash-decoding): each chunk's partial ``(m, l, acc)`` is its own
softmax's max, sum and ``P . V``; a chunk without a valid slot is skipped
(its slots would add ``exp(-1e30 - m) = 0``); the partials are merged in
chunk order.  :func:`decode_attention_cuda` launches the hand-written
kernel (``csrc/decode_attention.cu``) on CUDA tensors, reading each live
cache row once a KV head and widening it in registers;
:func:`decode_attention_torch`, the kernel's body chunk by chunk in
plain torch on any device, is what the tests hold to ``_attend_cache``
and the kernel to.  ``models/attention.py``'s ``attn_decode`` calls the
kernel for a bf16 cache in plain CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["decode_attention_torch", "decode_attention_cuda", "CHUNK",
           "MAX_HEAD_DIM", "MAX_GROUP"]

#: cache slots a chunk; DA_CHUNK in csrc/decode_attention.cu
CHUNK = 64
#: the widest head; DA_MAX_HD there (head widths are multiples of 8)
MAX_HEAD_DIM = 256
#: most query heads a KV head; DA_MAX_GROUP there
MAX_GROUP = 64

NEG_INF = -1e30

_Q_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, pos, cur, window):
    """What both versions take: dtypes, shapes, head widths and groups."""
    if q.dtype not in _Q_DTYPES or k.dtype != torch.bfloat16 \
            or v.dtype != torch.bfloat16:
        raise TypeError(f"decode_attention takes a float32 or bf16 query "
                        f"and a bf16 cache, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if pos.dtype != torch.int32 or cur.dtype != torch.int32:
        raise TypeError(f"decode_attention needs int32 positions, got "
                        f"{pos.dtype} and {cur.dtype}")
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention needs q (B, H, hd) and k, v "
                         f"(B, cap, KV, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, hd = q.shape
    _, cap, kv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != hd or cap < 1 \
            or tuple(pos.shape) != (b, cap) or tuple(cur.shape) != (b,):
        raise ValueError(f"decode_attention: shapes disagree: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, pos "
                         f"{tuple(pos.shape)}, cur {tuple(cur.shape)}")
    if b < 1 or kv < 1 or h % kv or not 1 <= h // kv <= MAX_GROUP \
            or hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention takes head widths 8-"
                         f"{MAX_HEAD_DIM} in steps of 8 and 1-{MAX_GROUP} "
                         f"query heads a KV head, got hd {hd}, {h} query "
                         f"and {kv} KV heads")
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window {window} < 1")
    if len({t.device for t in (q, k, v, pos, cur)}) != 1:
        raise ValueError("decode_attention needs all its tensors on one "
                         "device")


def decode_attention_torch(q, k, v, pos, cur, *, window=None, scale=None):
    """Plain torch version of the kernel, on any device: chunks of
    :data:`CHUNK` slots, each lane's dead chunks marked ``l = 0`` and a
    chunk dead in every lane skipped, the partials merged in chunk
    order."""
    _check(q, k, v, pos, cur, window)
    b, h, hd = q.shape
    cap, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = hd ** -0.5 if scale is None else scale
    qf = (q.to(torch.float32) * scale).reshape(b, kv, g, hd)
    now = cur.long()[:, None]
    parts = []
    for c0 in range(0, cap, CHUNK):
        pc = pos[:, c0:c0 + CHUNK].long()
        valid = (pc >= 0) & (pc <= now)
        if window is not None:
            valid = valid & (pc > now - window)
        live = valid.any(dim=1)                                 # (B,)
        if not live.any():
            continue
        s = torch.einsum("bkgd,bckd->bkgc", qf,
                         k[:, c0:c0 + CHUNK].to(torch.float32))
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        m = s.amax(dim=-1)                                      # (B, KV, g)
        p = torch.exp(s - m[..., None])
        acc = torch.einsum("bkgc,bckd->bkgd", p,
                           v[:, c0:c0 + CHUNK].to(torch.float32))
        dead = ~live[:, None, None]
        parts.append((torch.where(dead, NEG_INF, m),
                      torch.where(dead, 0.0, p.sum(dim=-1)),
                      torch.where(dead[..., None], 0.0, acc)))
    out = qf.new_zeros((b, kv, g, hd))
    if parts:
        big = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        total = torch.zeros_like(big)
        for m, l, acc in parts:
            w = torch.where(l > 0, torch.exp(m - big), 0.0)
            total = total + w * l
            out = out + w[..., None] * acc
        out = out / torch.clamp(total, min=1e-30)[..., None]
    return out.reshape(b, h, hd)


def _check_layout(q, k, v, pos, cur):
    """The layouts the kernel reads: contiguous ``q``, ``pos``, ``cur``;
    cache rows contiguous and 16-byte aligned (its 16-byte loads)."""
    if not (q.is_contiguous() and pos.is_contiguous()
            and cur.is_contiguous()):
        raise ValueError("decode_attention_cuda needs contiguous q, pos "
                         "and cur")
    if k.stride(-1) != 1 or v.stride(-1) != 1 \
            or any(s % 8 for s in k.stride()[:3] + v.stride()[:3]) \
            or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention_cuda needs a cache layout whose "
                         "rows are contiguous and 16-byte aligned")


@functools.cache
def _kernel():
    fn = ctypes.CDLL(str(build.library("decode_attention"))) \
        .decode_attention_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 \
        + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 6 \
        + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_attention_cuda(q, k, v, pos, cur, *, window=None, scale=None):
    """The kernel: CUDA tensors as the module docstring gives them, ``q``,
    ``pos`` and ``cur`` contiguous, ``k`` and ``v`` of unit last stride
    with every row 16-byte aligned (any other strides).  Launches
    ``csrc/decode_attention.cu``'s two passes on the current stream (no
    sync) into a fresh ``torch.empty`` partial scratch and output, and
    counts the call in ``decode_attention_cuda.launches``.  Raises on any
    input the kernel does not take; it never computes on another path."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    _check(q, k, v, pos, cur, window)
    _check_layout(q, k, v, pos, cur)
    b, h, hd = q.shape
    cap, kv = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    chunks = -(-cap // CHUNK)
    fn = _kernel()
    part = torch.empty((b, h, chunks, hd + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(),
                 v.data_ptr(), pos.data_ptr(), cur.data_ptr(),
                 part.data_ptr(), out.data_ptr(), b, h, kv, cap, hd,
                 *k.stride()[:3], *v.stride()[:3],
                 -1 if window is None else int(window), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
