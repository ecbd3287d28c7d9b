"""Parameter / input / cache sharding rules, as DTensor placements.

The counterpart of ``repro.launch.sharding``.  Rules are path+shape
based; stacked layers (a leading layer dim) get a leading ``None``.
Anything whose dimension doesn't divide the mesh axis stays replicated
on that dim (``resolve_spec`` guard) -- e.g. qwen2's 14 heads on a
16-way model axis.

Paths are the reference's pytree keys: dict keys, ``"[i]"`` for list
items, field names for ``OptState``, and ``0``/``1`` for the planes and
scale of a ``PackedWeight`` (a registered pytree in the reference, whose
children carry flattened-index keys: so its ``"planes"`` rule below
never fires there, and packed weights stay replicated in both
packages).  Each rule gives a :class:`NamedSharding` per leaf;
:func:`distribute` turns a tree of tensors (real or fake) into DTensors
by them.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.common import resolve_spec, spec_to_placements
from repro_torch.models.qweight import PackedWeight
from repro_torch.train.optimizer import OptState

# logical specs by parameter name; "+L" variants handled by rank check
_RULES = {
    # name: (ndim-without-stack, spec)
    "embed": (2, ("model", None)),
    "head": (2, (None, "model")),
    "wq": (3, (None, "model", None)),
    "wk": (3, (None, "model", None)),
    "wv": (3, (None, "model", None)),
    "wo": (3, ("model", None, None)),
    "bq": (2, ("model", None)),
    "bk": (2, ("model", None)),
    "bv": (2, ("model", None)),
    "w_gate": (2, (None, "model")),
    "w_up": (2, (None, "model")),
    "w_down": (2, ("model", None)),
    "router": (2, (None, None)),
    "in_proj": (2, (None, "model")),
    "x_proj": (2, ("model", None)),
    "dt_w": (2, (None, "model")),
    "dt_b": (1, ("model",)),
    "A_log": (2, ("model", None)),
    "D": (1, ("model",)),
    "out_proj": (2, ("model", None)),
    "conv_w": (2, (None, "model")),
    "conv_b": (1, ("model",)),
    "wx": (2, (None, "model")),
    "wy": (2, (None, "model")),
    "wi": (2, (None, "model")),
    "wr": (2, (None, "model")),
    "lambda_p": (1, ("model",)),
    "out": (2, ("model", None)),
}
# MoE expert-stacked weights: experts on the model axis (EP)
_MOE_RULES = {
    "w_gate": (3, ("model", None, None)),
    "w_up": (3, ("model", None, None)),
    "w_down": (3, ("model", None, None)),
}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's sharding: the resolved spec (the entries of the
    reference's ``PartitionSpec``) and its placements on ``mesh``."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> list:
        return spec_to_placements(self.mesh, self.spec)

    def shard_shape(self, shape) -> tuple:
        """The shape of each rank's shard of a leaf of ``shape``."""
        sizes = dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))
        out = list(shape)
        for i, s in enumerate(self.spec):
            for a in (s if isinstance(s, tuple) else (s,) if s else ()):
                out[i] //= sizes[a]
        return tuple(out)


def map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *same leaves of rest)`` over a tree's tensor
    leaves, with the reference's pytree keys as ``path``; keeps dicts,
    lists, tuples, ``OptState`` and ``PackedWeight`` nodes."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest),
                                 path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, PackedWeight):
        return PackedWeight(
            fn(path + (0,), tree.planes, *(r.planes for r in rest)),
            fn(path + (1,), tree.scale, *(r.scale for r in rest)),
            tree.shape)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, getattr(tree, f),
                                          *(getattr(r, f) for r in rest),
                                          path=path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, *(r[i] for r in rest),
                                        path=path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def _spec_for_path(path, leaf):
    keys = list(path)
    name = keys[-1]
    # storage-mode quantized weights: {"q","scale"} / PackedWeight planes
    if name == "q" and len(keys) >= 2:
        name = keys[-2]
    elif name == "planes":           # (.., K//32, N): K folds the TP axis
        return (None,) * (leaf.ndim - 2) + ("model", None)
    elif name == "scale":
        return (None,) * leaf.ndim
    in_moe = "moe" in keys
    rules = _MOE_RULES if (in_moe and name in _MOE_RULES) else _RULES
    if name not in rules:
        return (None,) * leaf.ndim
    nd, spec = rules[name]
    if leaf.ndim == nd + 1:          # scanned stack
        return (None,) + tuple(spec)
    if leaf.ndim == nd:
        return tuple(spec)
    return (None,) * leaf.ndim


def params_sharding(params, mesh):
    """NamedSharding tree for a params (or grads/opt moment) tree."""
    def one(path, leaf):
        spec = _spec_for_path(path, leaf)
        return NamedSharding(mesh, resolve_spec(mesh, leaf.shape, spec))
    return map_with_path(one, params)


def batch_sharding(batch, mesh):
    def one(_, leaf):
        spec = ("batch",) + (None,) * (leaf.ndim - 1)
        return NamedSharding(mesh, resolve_spec(mesh, leaf.shape, spec))
    return map_with_path(one, batch)


def cache_sharding(cache, mesh):
    """Decode caches: (stack, B, ...) -> batch on dim 1, heads/features on
    the model axis where divisible."""
    def one(keys, leaf):
        name = keys[-1]
        stack = (None,) if "unit" in keys else ()   # stacked layers only
        if name in ("k", "v"):       # (B, cap, KV, hd)
            spec = stack + ("batch", None, "model", None)
        elif name in ("k_s", "v_s"):  # (B, cap, KV) int8-cache scales
            spec = stack + ("batch", None, "model")
        elif name == "pos":          # (B, cap)
            spec = stack + ("batch", None)
        elif name == "h":            # ssm (B, di, st) | rglru (B, w)
            spec = stack + (("batch", "model", None)
                            if leaf.ndim - len(stack) == 3
                            else ("batch", "model"))
        elif name == "conv":         # (B, cw-1, di)
            spec = stack + ("batch", None, "model")
        else:
            spec = (None,) * leaf.ndim
        assert len(spec) == leaf.ndim, (keys, leaf.shape, spec)
        return NamedSharding(mesh, resolve_spec(mesh, leaf.shape, spec))
    return map_with_path(one, cache)


def opt_sharding(opt_state, params_shardings, mesh):
    """Optimizer state mirrors parameter shardings; step is replicated."""
    rep = NamedSharding(mesh, ())
    return OptState(step=rep, mu=params_shardings, nu=params_shardings)


def distribute(tree, shardings, mesh):
    """``tree``'s tensors (real or fake, each the full global tensor, the
    same on every rank) as DTensors placed by ``shardings``; each rank
    keeps its own shard and nothing is communicated."""
    from torch.distributed.tensor import distribute_tensor

    def one(_, leaf, sh):
        return distribute_tensor(leaf, mesh, sh.placements,
                                 src_data_rank=None)
    return map_with_path(one, tree, shardings)
