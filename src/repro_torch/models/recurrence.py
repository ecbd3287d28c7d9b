"""Shared recurrence machinery: causal conv + chunked linear scans.

The counterpart of ``repro.models.recurrence``.  Both Mamba's selective
SSM and RecurrentGemma's RG-LRU are linear recurrences
h_t = a_t * h_{t-1} + b_t  (elementwise).  They are evaluated as a loop
over fixed-size time chunks (bounded working set) and a scan inside each
chunk.  The reference's in-chunk ``jax.lax.associative_scan`` has no
torch counterpart; :func:`_inclusive_scan` is a log-depth (Hillis-Steele)
scan over the same operator, so its float32 results differ from XLA's in
the last bits.
"""

from __future__ import annotations

import torch


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


def chunked_linear_scan(a, b, h0, chunk: int = 256):
    """h_t = a_t * h_{t-1} + b_t  over axis 1 (time).

    a, b: (B, S, ...) same shape; h0: (B, ...).  Returns (h_all, h_last)
    with h_all: (B, S, ...).  Peak memory ~ (B, chunk, ...) per step.
    """
    S = a.shape[1]
    chunk = min(chunk, S)
    assert S % chunk == 0, (S, chunk)
    h, hs = h0, []
    for c0 in range(0, S, chunk):
        pa, pb = _inclusive_scan(a[:, c0:c0 + chunk], b[:, c0:c0 + chunk])
        hc = pa * h[:, None] + pb                     # (B, chunk, ...)
        h = hc[:, -1]
        hs.append(hc)
    return torch.cat(hs, dim=1), h


def linear_scan_step(a, b, h):
    """Single decode step of the same recurrence."""
    return a * h + b
