"""Shared model utilities: norms, rope, init, and the sharding hook.

The counterpart of ``repro.models.common``.  The port runs a model on one
card, so the reference's sharding layer is the identity here:
``shard(x, *spec)`` returns ``x`` and keeps the call sites reading as the
reference's.  The mesh helpers behind it (``_active_mesh``,
``batch_axes``, ``resolve_spec``, ``spec_for``) serve only the
reference's multi-device launch code and have no counterpart on one
card.
"""

from __future__ import annotations

import numpy as np
import torch


def shard(x, *spec):
    """The reference's sharding constraint; the identity on one card."""
    return x


# ---------------------------------------------------------------------------
# Activations: ``jax.nn``'s, primitive by primitive.  XLA rounds every
# bf16 intermediate of these to bf16, and so do torch's bf16 ops one by
# one; torch's fused ``F.silu``/``F.gelu`` round once, which differs from
# the reference in a third to a half of all bf16 outputs, enough to move
# a recurrent model's logits past the tolerance it is held to.
# ---------------------------------------------------------------------------
def _const(v, x):
    """A constant in ``x``'s dtype, as a jaxpr literal is."""
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def sigmoid(x):
    """``jax.nn.sigmoid``: XLA expands ``logistic`` as 1 / (1 + exp(-x))."""
    return 1 / (1 + torch.exp(-x))


def silu(x):
    return x * sigmoid(x)


def gelu(x):
    """``jax.nn.gelu`` with its default tanh approximation."""
    cube = _const(0.044715, x) * (x * x * x)
    inner = _const(np.sqrt(2 / np.pi), x) * (x + cube)
    return x * (_const(0.5, x) * (1 + torch.tanh(inner)))


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
def rmsnorm(x, w, eps=1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + w)).to(x.dtype)


def rope(q, positions, theta):
    """Rotary embedding.  q: (..., S, H, hd); positions: (..., S)."""
    hd = q.shape[-1]
    half = hd // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(-log_theta * torch.arange(
        half, dtype=torch.float32, device=q.device) / half)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..,S,half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    q1, q2 = q[..., :half], q[..., half:]
    out = torch.cat([q1 * cos - q2 * sin, q2 * cos + q1 * sin], -1)
    return out.to(q.dtype)


def dense_init(key, shape, in_axis=0, dtype=torch.bfloat16, device=None):
    """Normal * fan_in**-0.5 in float32, cast to ``dtype`` on ``device``.

    ``key`` is a seeded ``torch.Generator`` (drawn on its own device) or a
    numpy ``Generator`` (drawn on the host: the same weights on every
    machine).  The draws cannot reproduce ``jax.random`` and do not try
    to; weights made by the reference are carried across by
    ``convert.params_from_numpy``.
    """
    fan_in = shape[in_axis]
    if isinstance(key, np.random.Generator):
        w = torch.from_numpy(key.standard_normal(shape, dtype=np.float32))
    else:
        w = torch.randn(shape, generator=key, dtype=torch.float32,
                        device=key.device)
    return (w * fan_in ** -0.5).to(device=device, dtype=dtype)


def split_keys(key, n):
    """A stateful generator needs no splitting: its ``n`` users draw from
    it in call order."""
    return [key] * n
