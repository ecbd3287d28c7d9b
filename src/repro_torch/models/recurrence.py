"""Shared recurrence machinery: causal conv + chunked linear scans.

The counterpart of ``repro.models.recurrence``.  Both Mamba's selective
SSM and RecurrentGemma's RG-LRU are linear recurrences
h_t = a_t * h_{t-1} + b_t  (elementwise).  They are evaluated as a loop
over fixed-size time chunks (bounded working set; the last chunk takes
what is left) and a scan inside each chunk.  The reference's in-chunk
``jax.lax.associative_scan`` has no torch counterpart;
:func:`_inclusive_scan` is a log-depth (Hillis-Steele) scan over the
same operator, so its float32 results differ from XLA's in the last
bits.  Off the host every chunk is scanned by one hand-written kernel
(``kernels/linear_scan.py``, through the ``repro_torch::linear_scan``
operator, which has a backward) whose results are this plain scan's,
bit for bit; DTensor chunks are scanned shard by shard.
"""

from __future__ import annotations

import torch

from ..kernels import linear_scan
from . import common


def causal_conv(x, w, b, state=None):
    """Depthwise causal conv.  x: (B, S, D); w: (CW, D); b: (D,).

    ``state``: (B, CW-1, D) trailing inputs from the previous step (decode);
    returns (y, new_state).
    """
    cw = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], cw - 1, x.shape[-1]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)                 # (B, S+CW-1, D)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(cw))
    new_state = xp[:, -(cw - 1):, :] if cw > 1 else state
    return y + b, new_state


def _assoc(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


def _inclusive_scan(a, b):
    """Inclusive scan of :func:`_assoc` over axis 1: after step ``d``
    each position holds the composition of the ``2d`` elements ending at
    it (Hillis-Steele)."""
    d = 1
    while d < a.shape[1]:
        na, nb = _assoc((a[:, :-d], b[:, :-d]), (a[:, d:], b[:, d:]))
        a = torch.cat([a[:, :d], na], dim=1)
        b = torch.cat([b[:, :d], nb], dim=1)
        d *= 2
    return a, b


def streamed_linear_scan(parts, h0, length: int, chunk: int = 256,
                         emit=None):
    """h_t = a_t * h_{t-1} + b_t  over ``length`` steps, a chunk at a time.

    ``parts(c0, c1)`` gives the chunk's ``a`` and ``b`` (B, c1 - c0, ...);
    ``emit(c0, c1, hc)`` turns the chunk's states ``hc`` into its output
    (``None``: the states themselves).  The last chunk may be shorter.
    Returns (the outputs concatenated along axis 1, h_last); no tensor
    of the whole sequence's states exists unless ``emit`` keeps them."""
    h, out = h0, []
    for c0 in range(0, length, chunk):
        c1 = min(c0 + chunk, length)
        hc = _scan_chunk(*parts(c0, c1), h)           # (B, c1 - c0, ...)
        h = hc[:, -1]
        out.append(hc if emit is None else emit(c0, c1, hc))
    return torch.cat(out, dim=1), h


def _on_host(t) -> bool:
    return t.device.type == "cpu"


def _scan_chunk(a, b, h):
    """A chunk's states from its ``a``, ``b`` and the state ``h`` before
    it: this plain version on the host, the hand-written kernel
    everywhere else (a chunk not in float32 raises there)."""
    if _on_host(a):
        pa, pb = _inclusive_scan(a, b)
        return pa * h[:, None] + pb
    if common._is_dtensor(a):
        return _scan_shards(a, b, h)
    return torch.ops.repro_torch.linear_scan(a, b, h)


def _scan_shards(a, b, h):
    """The kernel on each rank's shards of a DTensor chunk: the
    recurrence runs along time and is elementwise in every other dim, so
    a shard of ``a`` and ``b`` and the matching shard of ``h`` scan on
    their own.  A partial sum is reduced first; time must not be split.
    """
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    mesh = a.device_mesh
    at, ht = [], []
    for p in a.placements:
        if isinstance(p, Shard):
            d = p.dim % a.ndim
            if d == 1:
                raise ValueError("linear scan of a chunk split along time")
            at.append(p)
            ht.append(Shard(d - 1 if d else 0))
        else:
            at.append(Replicate())
            ht.append(Replicate())

    def placed(t, want):
        if common._is_dtensor(t):
            return t.redistribute(mesh, want)
        return distribute_tensor(t, mesh, want)

    a = a.redistribute(mesh, at)
    return common.per_shard(
        lambda a_, b_, h_: torch.ops.repro_torch.linear_scan(a_, b_, h_),
        a, placed(b, at), placed(h, ht), out_like=a)


def chunked_linear_scan(a, b, h0, chunk: int = 256):
    """h_t = a_t * h_{t-1} + b_t  over axis 1 (time).

    a, b: (B, S, ...) same shape; h0: (B, ...).  Returns (h_all, h_last)
    with h_all: (B, S, ...); any S (the last chunk ragged).  Peak memory
    ~ (B, chunk, ...) per step beside ``a``, ``b`` and ``h_all``.
    """
    S = a.shape[1]
    return streamed_linear_scan(
        lambda c0, c1: (a[:, c0:c1], b[:, c0:c1]), h0, S, min(chunk, S))


def linear_scan_step(a, b, h):
    """Single decode step of the same recurrence."""
    return a * h + b
