"""Shared model utilities: the sharding hook, norms, rope, init.

The counterpart of ``repro.models.common``.  Sharding specs are written
with the reference's logical axes (``"batch"``, ``"model"``, ``None``);
``resolve_spec`` drops the axes a mesh lacks and those that do not
divide a dimension, and ``spec_to_placements`` turns the result into
DTensor placements on a ``torch.distributed`` ``DeviceMesh`` with the
reference's axis names.  ``with use_mesh(mesh):`` makes a mesh active,
as ``with mesh:`` does in JAX; under it ``shard(x, *spec)`` redistributes
a DTensor ``x`` to its resolved placements (the reference's
``with_sharding_constraint``).  Outside a mesh, and on a plain tensor,
``shard`` is the identity, so a one-device run is unchanged.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .qweight import dq


# ---------------------------------------------------------------------------
# Sharding: specs are written with logical axes; `shard()` silently drops
# axes the active mesh doesn't have ("pod" on single-pod runs) and is a
# no-op outside a mesh context (unit tests on one device).
# ---------------------------------------------------------------------------
_MESHES: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh (the reference's ``with mesh:``).

    Plain tensors that meet a DTensor inside count as replicated
    (``implicit_replication``): the model's constants, ``arange``
    positions and zero-filled buffers are the same on every rank."""
    from torch.distributed.tensor.experimental import implicit_replication
    _MESHES.append(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _MESHES.pop()


def _active_mesh():
    return _MESHES[-1] if _MESHES else None


def _axes(mesh) -> dict:
    """Axis name -> size of a ``DeviceMesh`` (or of anything with
    ``mesh_dim_names`` and a ``shape`` tuple)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh=None):
    mesh = mesh if mesh is not None else _active_mesh()
    if mesh is None:
        return ("data",)
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _axis_size(mesh, s):
    if s is None:
        return 1
    if isinstance(s, tuple):
        out = 1
        for a in s:
            out *= _axes(mesh)[a]
        return out
    return _axes(mesh)[s]


def resolve_spec(mesh, shape, spec):
    """Resolve a logical spec against a mesh *and* a shape: logical axes
    missing from the mesh or not dividing the dimension are dropped.
    Returns a tuple with the entries of the reference's
    ``PartitionSpec``."""
    names = set(mesh.mesh_dim_names)

    def fix(s, dim):
        if s == "batch":
            s = tuple(a for a in ("pod", "data") if a in names)
            if not s:
                return None
            s = s if len(s) > 1 else s[0]
        elif isinstance(s, str):
            s = s if s in names else None
        elif isinstance(s, tuple):
            t = tuple(a for a in s if a in names)
            s = t if t else None
        if s is None:
            return None
        if dim is not None and dim % _axis_size(mesh, s) != 0:
            return None                      # uneven: leave replicated
        return s

    dims = list(shape) + [None] * (len(spec) - len(shape))
    return tuple(fix(s, d) for s, d in zip(spec, dims))


def spec_for(mesh, *spec) -> tuple:
    """Resolve a logical spec to a concrete spec for ``mesh``."""
    names = set(mesh.mesh_dim_names)

    def fix(s):
        if s == "batch":
            ax = tuple(a for a in ("pod", "data") if a in names)
            return ax if len(ax) > 1 else (ax[0] if ax else None)
        if isinstance(s, str):
            return s if s in names else None
        if isinstance(s, tuple):
            t = tuple(a for a in s if a in names)
            return t if t else None
        return s

    return tuple(fix(s) for s in spec)


def spec_to_placements(mesh, spec) -> list:
    """One DTensor placement per mesh axis for a resolved spec: ``Shard(i)``
    on each axis that names tensor dim ``i``, ``Replicate()`` on the
    others and on any axis of size 1 (a 1-way split is no split).  A dim
    split over several axes (``("pod", "data")``) is split over them
    major to minor in mesh order, as ``PartitionSpec`` splits it.  E.g.
    ``("batch", None)`` on a (pod, data, model) mesh gives
    ``[Shard(0), Shard(0), Replicate()]``."""
    from torch.distributed.tensor import Replicate, Shard
    order = list(mesh.mesh_dim_names)
    sizes = _axes(mesh)
    out = [Replicate() for _ in order]
    for dim, s in enumerate(spec):
        if s is None:
            continue
        axes = s if isinstance(s, tuple) else (s,)
        if [order.index(a) for a in axes] != sorted(order.index(a)
                                                   for a in axes):
            raise ValueError(f"spec {spec}: axes {axes} out of mesh order "
                             f"{order}")
        for a in axes:
            if sizes[a] > 1:
                out[order.index(a)] = Shard(dim)
    return out


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard(x, *spec):
    """with_sharding_constraint with mesh/shape-aware axis filtering.

    spec entries: None, "model", "batch" (expands to present pod/data axes),
    or explicit axis names / tuples.  Axes that don't divide the dimension
    (e.g. 14 heads on a 16-way model axis) are silently dropped.  The
    identity outside a mesh and on a plain tensor.
    """
    mesh = _active_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    return x.redistribute(mesh, spec_to_placements(
        mesh, resolve_spec(mesh, x.shape, spec)))


def shard_like(x, ref):
    """``x`` on ``ref``'s placements when both are DTensors, else ``x``:
    an updated cache leaf keeps its layout, as the reference's donated
    cache keeps its sharding."""
    if not (_is_dtensor(x) and _is_dtensor(ref)):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def per_shard(fn, *args, out_like):
    """``fn(*args)`` on each rank's shards when ``out_like`` is a DTensor,
    its output placed like ``out_like``; off a mesh ``fn(*args)``.  For
    attention, which is independent across the batch and the heads it is
    split on: DTensor would flatten the two split dims for its batched
    matmuls, which torch 2.11 refuses.  Every tensor argument must be a
    DTensor split as the computation needs."""
    if not _is_dtensor(out_like):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    if not all(_is_dtensor(a) for a in args if isinstance(a, torch.Tensor)):
        raise ValueError("per_shard: a plain tensor beside DTensors")
    return local_map(
        fn, out_placements=(tuple(out_like.placements),),
        in_placements=tuple(tuple(a.placements) if _is_dtensor(a) else None
                            for a in args),
        device_mesh=out_like.device_mesh)(*args)


def split_on(x, axis, dim):
    """The index of mesh axis ``axis`` when ``x`` is a DTensor split along
    ``dim`` on that axis and on no other, else ``None`` (a plain tensor,
    a mesh without ``axis``, a 1-way axis, a dim left whole)."""
    if not _is_dtensor(x) or axis not in x.device_mesh.mesh_dim_names:
        return None
    from torch.distributed.tensor import Shard
    dim %= x.ndim
    split = [i for i, p in enumerate(x.placements)
             if isinstance(p, Shard) and p.dim % x.ndim == dim]
    i = x.device_mesh.mesh_dim_names.index(axis)
    return i if split == [i] else None


def replicate(x):
    """``x`` replicated on every axis of its mesh (a DTensor), else ``x``:
    for an operand of an op that DTensor has no sharding strategy for.
    Each call site is listed in ``PERF.md`` with the collective it adds."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


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


def mlp_apply(params, x):
    """The dense FFN: SwiGLU (``w_gate``, ``w_up``, ``w_down``) or GELU."""
    if "w_gate" in params:
        h = silu(x @ dq(params["w_gate"])) * (x @ dq(params["w_up"]))
    else:
        h = gelu(x @ dq(params["w_up"]))
    h = shard(h, "batch", None, "model")
    return shard(h @ dq(params["w_down"]), "batch", None, None)


def yarn_inv_freq(dim: int, theta: float, yarn, device=None):
    """YaRN's float32 inverse frequencies of a ``dim``-wide rotary
    embedding, as DeepSeek's released code computes them: ``f_i =
    theta**(-2i/dim)``, ``r_i`` the linear ramp from 0 to 1 over the
    pairs ``yarn.correction_range``, and ``f_i / factor * r_i + f_i * (1
    - r_i)``."""
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    f = 1.0 / (theta ** (2 * i / dim))
    low, high = yarn.correction_range(dim, theta)
    if low == high:
        high += 0.001
    r = torch.clamp((i - low) / (high - low), 0, 1)
    return f / yarn.factor * r + f * (1 - r)


def rope_pairs(x, positions, inv_freq, scale: float = 1.0):
    """DeepSeek's rotary embedding: the pairs ``(2i, 2i + 1)`` of ``x``
    (..., S, H, d) rotate together by ``positions * inv_freq[i]``; as the
    released code does, the result is laid out de-interleaved (the even
    members, then the odd), a permutation that the dot products of
    queries and keys rotated alike do not see.  cos and sin carry
    ``scale``."""
    ang = positions[..., :, None].to(torch.float32) * inv_freq
    cos = (torch.cos(ang) * scale)[..., None, :]
    sin = (torch.sin(ang) * scale)[..., None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


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
